"""Host ms per call of the port's bundle adjustments and essential graph
with three ways of summing per camera and per vertex, timed in turns in
one process on one CUDA card.

    python3 sum_order_ab.py [--rounds N]

The three ways, each patched in turn into ops/ba.py and ops/posegraph.py
(their `segments` and `segment_sum`):
  * `segment_reduce`: the entries gathered in segment order and added one
    after another per segment by `torch.segment_reduce` (a fixed order);
  * `gather_sum`: the entries gathered into a zero-padded [K, L, ...]
    block and summed over L by one reduction (another fixed order);
  * `index_add`: a float `index_add_` over every entry, which adds in the
    order its atomics land (the sums before the fixed-order ones).

The solves are the ones chip_smoke.py records and replays: the first local
BA of its 40-frame slice, and the first global BA and essential graph of
its loop phase (the loop world's 591-frame figure-8, run here through
chip_smoke.py's `run_slice` and `run_loop`, which print the loop digests
and ATE as chip_smoke.py does). Each of N rounds (default 10) calls every
solve once with every way, in an order that rotates with the round,
synchronised before and after each call. Per solve and way it prints the
median, min and max host ms and the N ratios to `index_add` in the same
round.

The verdict (the decision rule written in PERF.md §6): a way "exceeds"
`index_add` on a solve when at least 80% of its paired ratios are above
1.15, is "within" when at least 80% are at most 1.15, and is "unresolved"
otherwise. `segment_reduce` stays unless, on some solve, it exceeds while
`gather_sum` is within. The last line is one JSON object with every
number and the verdict. It exits non-zero when no CUDA card is visible.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

import chip_smoke as smoke
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.kernels import build
from orbslam2_tpu_torch.ops import ba, posegraph

LIMIT = 1.15
SHARE = 0.8


def _key(idx, K, keep):
    return torch.where(keep.reshape(-1), idx.reshape(-1), K)


def segment_reduce_segments(idx, K, keep):
    key = _key(idx, K, keep)
    offsets = F.pad(torch.cumsum(torch.bincount(key, minlength=K + 1)[:K], 0), (1, 0))
    return torch.argsort(key, stable=True)[:int(offsets[-1])], offsets


def segment_reduce_sum(seg, x):
    order, offsets = seg
    return torch.segment_reduce(x[order], "sum", offsets=offsets, axis=0, unsafe=True)


def gather_segments(idx, K, keep):
    key = _key(idx, K, keep)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=K + 1)[:K]
    L, n = torch.stack([counts.max(), counts.sum()]).tolist() if K else (0, 0)
    k = key[order[:n]]
    rank = torch.arange(n, device=key.device) - (torch.cumsum(counts, 0) - counts)[k]
    slots = torch.full((K, L), key.numel(), dtype=torch.int64, device=key.device)
    slots[k, rank] = order[:n]
    return slots


def gather_sum(slots, x):
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, 1))[slots].sum(dim=1)


def index_add_segments(idx, K, keep):
    return idx.reshape(-1), K


def index_add_sum(seg, x):
    idx, K = seg
    return torch.zeros((K, *x.shape[1:]), dtype=x.dtype, device=x.device).index_add_(0, idx, x)


WAYS = {"segment_reduce": (segment_reduce_segments, segment_reduce_sum),
        "gather_sum": (gather_segments, gather_sum),
        "index_add": (index_add_segments, index_add_sum)}


@contextlib.contextmanager
def summing(way):
    """ops/ba.py and ops/posegraph.py with `way`'s sums."""
    segments, segment_sum = WAYS[way]
    saved = ba.segments, ba.segment_sum, posegraph.segments, posegraph.segment_sum
    ba.segments = posegraph.segments = segments
    ba.segment_sum = posegraph.segment_sum = segment_sum
    try:
        yield
    finally:
        ba.segments, ba.segment_sum, posegraph.segments, posegraph.segment_sum = saved


def recorded_solves():
    """{name: (fn, args, kwargs)}: the first local BA of chip_smoke.py's
    slice and the first global BA and essential graph of its loop phase."""
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    _, frames = world.render_sequence(smoke.N_FRAMES, step=0.06)
    local_ba = smoke.run_slice(world, smoke.slam_config(world), frames, "cuda")[7]
    smoke.check(local_ba is not None, "no local BA was recorded on the slice")
    *_, graph, global_ba = smoke.run_loop()
    out = {}
    for name, (args, kwargs, _) in (("local BA", local_ba), ("global BA", global_ba)):
        out[name] = (ba.ba_solve_pm_interruptible, args,
                     {k: v for k, v in kwargs.items() if k != "should_abort"})
    out["essential graph"] = (posegraph.optimize_essential_graph, graph[0], graph[1])
    return out


def verdict(ratios):
    over = sum(r > LIMIT for r in ratios)
    if over >= SHARE * len(ratios):
        return "exceeds"
    if len(ratios) - over >= SHARE * len(ratios):
        return "within"
    return "unresolved"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    smoke.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    build.load()
    solves = recorded_solves()
    ways = list(WAYS)
    out = {"card": smi, "rounds": args.rounds, "limit": LIMIT, "share": SHARE, "solves": {}}
    for name, (fn, a, kw) in solves.items():
        for w in ways:  # warm every way once
            with summing(w):
                fn(*a, **kw)
        times = {w: [] for w in ways}
        for r in range(args.rounds):
            for w in ways[r % len(ways):] + ways[:r % len(ways)]:
                with summing(w):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(*a, **kw)
                    torch.cuda.synchronize()
                    times[w].append((time.perf_counter() - t0) * 1e3)
        row = {w: dict(median_ms=statistics.median(t), min_ms=min(t), max_ms=max(t), ms=t) for w, t in times.items()}
        for w in ("segment_reduce", "gather_sum"):
            ratios = [a_ / b_ for a_, b_ in zip(times[w], times["index_add"])]
            row[w].update(ratios=ratios, median_ratio=statistics.median(ratios),
                          above_limit=sum(x > LIMIT for x in ratios), verdict=verdict(ratios))
        out["solves"][name] = row
        print(f"{name}: " + "; ".join(
            f"{w} median {v['median_ms']:.2f} ms (min {v['min_ms']:.2f}, max {v['max_ms']:.2f})"
            + (f", ratio to index_add median {v['median_ratio']:.3f}, {v['above_limit']}/{args.rounds} above "
               f"{LIMIT}: {v['verdict']}" if "verdict" in v else "") for w, v in row.items()))
    switch = [n for n, row in out["solves"].items()
              if row["segment_reduce"]["verdict"] == "exceeds" and row["gather_sum"]["verdict"] == "within"]
    out["keep"] = "gather_sum" if switch else "segment_reduce"
    out["decided_by"] = switch
    print(f"verdict: keep {out['keep']}" + (f" (segment_reduce exceeds on {switch})" if switch else ""))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
