"""Run-to-run differences of the port on the card, on the first frames of
chip_smoke.py's loop phase.

    python3 loop_repro_probe.py [N_FRAMES]

Renders the first N_FRAMES (default 150) frames of the loop world's
figure-8 (as chip_smoke.py does) and tracks them with
`System("assets/vocab_generic.npz", cfg)` on the card four times: twice as
the port runs, then twice under
`torch.use_deterministic_algorithms(True, warn_only=True)`, which swaps in
the deterministic versions of the ops that have one and warns on those
that have none. For each pair it prints the first frame whose pose is not
bit-identical, the largest pose difference and the first local BA whose
problem or result differs. During the first run it counts every ATen op
called on a CUDA tensor (a `TorchDispatchMode`) and prints those that may
add or sort in another order (scatter, index_add, cumsum, sort, the
linear algebra), with their dtypes; then the warnings. Writes the same to
chiprun_out/loop_repro_probe.txt. It needs a CUDA card.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import multiprocessing
import os
import sys
import time
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as cs
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.ops import ba
from orbslam2_tpu_torch.slam.system import System

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
SUSPECTS = ("index_add", "scatter", "index_put", "put_", "cumsum", "cumprod", "bincount", "histc", "median",
            "sort", "kthvalue", "topk", "unique", "mm", "bmm", "linalg", "inv", "cholesky", "eigh", "svd",
            "solve", "dot", "segment_reduce")


class OpCensus(TorchDispatchMode):
    """Counts ATen ops by name and the device and dtype of their first
    tensor argument."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        first = next((a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)), None)
        where = "" if first is None else f"{first.device.type}:{first.dtype}"
        self.ops[f"{func.name()} {where}"] += 1
        return func(*args, **kwargs)


def track(frames, label, census=None):
    """(per-frame poses, a hash per local BA of its problem and result)."""
    system = System(cs.VOCAB, cs.slam_config(SyntheticWorld(**cs.LOOP_WORLD)))
    poses, ba_hashes = [], []
    solve = ba.ba_solve_pm_interruptible

    def solve_hashed(prob, *a, **k):
        res = solve(prob, *a, **k)
        h = hashlib.sha256()
        for t in (prob.poses, prob.points, res.poses, res.points):
            h.update(t.detach().cpu().numpy().tobytes())
        ba_hashes.append(h.hexdigest())
        return res

    ba.ba_solve_pm_interruptible = solve_hashed
    t0 = time.perf_counter()
    try:
        with census if census is not None else contextlib.nullcontext():
            for i, (imL, imR) in enumerate(frames):
                T = system.track_stereo(imL, imR, timestamp=i / 20.0)
                poses.append(None if T is None else np.asarray(T, np.float32).copy())
    finally:
        ba.ba_solve_pm_interruptible = solve
    torch.cuda.synchronize()
    print(f"{label}: {time.perf_counter() - t0:.1f} s, {system.map.n_keyframes()} keyframes, "
          f"{len(ba_hashes)} local BAs", flush=True)
    return poses, ba_hashes


def differ(a, b, label):
    first, worst = None, 0.0
    for i, (x, y) in enumerate(zip(a[0], b[0])):
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            first = i if first is None else first
            if x is not None and y is not None:
                worst = max(worst, float(np.abs(x - y).max()))
    first_ba = next((j for j, (x, y) in enumerate(zip(a[1], b[1])) if x != y), None)
    return (f"{label}: first frame whose pose differs {first}, max |dT| {worst:.3e}, local BAs {len(a[1])} vs "
            f"{len(b[1])}, first local BA whose problem or result differs {first_ba}")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    if not torch.cuda.is_available():
        raise SystemExit("loop_repro_probe.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    world = SyntheticWorld(**cs.LOOP_WORLD)
    poses_gt, _ = world.trajectory_figure8()
    with multiprocessing.get_context("spawn").Pool(cs.RENDER_WORKERS, initializer=cs._render_init,
                                                   initargs=(poses_gt,)) as pool:
        frames = list(pool.imap(cs._render, range(n), chunksize=1))
    census = OpCensus()
    lines = [differ(track(frames, "run 1 (op census)", census), track(frames, "run 2"), "runs 1 and 2")]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            lines.append(differ(track(frames, "deterministic run 1"), track(frames, "deterministic run 2"),
                                "deterministic runs 1 and 2"))
    finally:
        torch.use_deterministic_algorithms(False)
    for msg, k in collections.Counter(str(w.message)[:200] for w in caught).items():
        lines.append(f"warning x{k}: {msg}")
    for op, k in sorted(census.ops.items()):
        if "cuda" in op and any(s in op for s in SUSPECTS):
            lines.append(f"op {op}: {k} calls")
    with open(os.path.join(OUT, "loop_repro_probe.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
