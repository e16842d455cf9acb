"""Time the port's DBoW2 text parser against the Python loop it replaced.

Writes a generated vocabulary of ORBvoc.txt's shape (k 10, depth 6:
1,111,111 nodes with the root, 10^6 leaf words; random descriptor bytes and weights
from `--seed`) in DBoW2's text format to a temporary directory, parses it
with `orbslam2_tpu_torch.vocab.bow.parse_dbow2_text` (one pass of
numpy's text reader) and with the line-by-line loop that `load_dbow2_text` ran
before, checks that both give the same arrays, and prints one JSON line
with each parser's best wall time over `--rounds` runs. A CPU figure:
nothing here touches a card.

    python3 vocab_text_probe.py [--k 10] [--depth 6] [--rounds 3] [--seed 0]
"""

import argparse
import json
import os
import platform
import tempfile
import time

import numpy as np

from orbslam2_tpu_torch.vocab import bow


def write_tree(path: str, k: int, depth: int, rng) -> int:
    """A full k-ary tree of `depth` levels below the root, breadth-first,
    one DBoW2 node line each; returns the number of nodes (root included)."""
    sizes = [k ** level for level in range(depth + 1)]
    n = sum(sizes)
    first = np.cumsum([0] + sizes)  # first node id of each level
    parents = np.empty(n, np.int64)
    parents[0] = -1
    for level in range(1, depth + 1):
        parents[first[level]:first[level + 1]] = np.repeat(np.arange(first[level - 1], first[level]), k)
    leaf = np.zeros(n, np.int64)
    leaf[first[depth]:] = 1
    desc = rng.integers(0, 256, (n, 32))
    weight = np.where(leaf == 1, rng.uniform(0.0, 12.0, n), 0.0)
    cols = np.concatenate([parents[:, None], leaf[:, None], desc], axis=1)[1:]
    with open(path, "w") as f:
        f.write(f"{k} {depth} 0 0\n")
        # DBoW2 writes each weight with the stream's default 6 significant
        # digits (TemplatedVocabulary.h:1382-1416)
        np.savetxt(f, np.concatenate([cols, weight[1:, None]], axis=1), fmt=["%d"] * 34 + ["%.6g"])
    return n


def parse_loop(path: str):
    """The per-line parser `load_dbow2_text` used before (the JAX package's
    Python fallback, orbslam2_tpu/vocab/bow.py:287-296)."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, descs, weights, leaves = [-1], [np.zeros(32, np.uint8)], [0.0], [False]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaves.append(bool(int(parts[1])))
            descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))
    return (k, L, np.array(parents, np.int32), np.array(leaves, bool), np.stack(descs),
            np.array(weights, np.float32))


def best_of(fn, rounds):
    times, out = [], None
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return min(times), out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "voc.txt")
        n = write_tree(path, args.k, args.depth, np.random.default_rng(args.seed))
        t_numpy, got = best_of(lambda: bow.parse_dbow2_text(path), args.rounds)
        t_loop, want = best_of(lambda: parse_loop(path), args.rounds)
        size = os.path.getsize(path)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    print(json.dumps({"nodes": n, "file_bytes": size, "numpy_s": t_numpy, "loop_s": t_loop,
                      "rounds": args.rounds, "cpu": platform.processor() or platform.machine(),
                      "equal": True}))


if __name__ == "__main__":
    main()
