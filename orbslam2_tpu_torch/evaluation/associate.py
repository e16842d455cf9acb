#!/usr/bin/env python
"""Timestamp association between two stamped data files.

The reference ships the classic TUM RGB-D `associate.py` alongside its
evaluation script (reference associate.py:49-115) for pairing two
timestamped streams (e.g. rgb.txt and depth.txt, or an estimate and a
ground truth). Same CLI contract here, rebuilt on the vectorized
greedy-nearest matcher. A copy of orbslam2_tpu/evaluation/associate.py,
so that the port imports nothing of the JAX package:

  python -m orbslam2_tpu_torch.evaluation.associate FIRST SECOND \
      [--first_only] [--offset 0.0] [--max_difference 0.02]

Output: `stamp1 data1... stamp2+offset data2...` per matched pair (or
only the first file's lines with --first_only), sorted by stamp1.
"""

from __future__ import annotations

import argparse
import sys


def read_file_list(filename: str, remove_bounds: bool = False) -> dict:
    """Parse `stamp d1 d2 ...` lines -> {stamp: [d1, d2, ...]}.

    Comma/tab separators are tolerated and `#` comment lines skipped, as
    in the reference reader (associate.py:49-71). remove_bounds drops the
    first/last 100 lines (the reference's option for trimming sequence
    edges).
    """
    with open(filename) as f:
        lines = f.read().replace(",", " ").replace("\t", " ").split("\n")
    if remove_bounds:
        lines = lines[100:-100]
    out = {}
    for line in lines:
        if not line or line.lstrip().startswith("#"):
            continue
        vals = [v.strip() for v in line.split(" ") if v.strip()]
        if len(vals) > 1:
            out[float(vals[0])] = vals[1:]
    return out


def associate(first_list: dict, second_list: dict, offset: float,
              max_difference: float) -> list:
    """Greedy best-first matching of two stamp dicts, the reference's
    algorithm (associate.py:73-108): enumerate all pairs within
    max_difference, sort by |dt|, take each stamp at most once.

    Returns sorted (stamp1, stamp2) pairs (stamp2 WITHOUT the offset
    applied, matching the reference's return convention).
    """
    import numpy as np

    a = np.array(sorted(first_list.keys()))
    b = np.array(sorted(second_list.keys()))
    if len(a) == 0 or len(b) == 0:
        return []
    # candidate pairs: |a - (b + offset)| < max_difference — each a matches
    # a contiguous range of b, found with two searchsorteds
    lo = np.searchsorted(b, a - offset - max_difference, side="left")
    hi = np.searchsorted(b, a - offset + max_difference, side="right")
    ia = np.repeat(np.arange(len(a)), hi - lo)
    ib = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)]) if len(ia) else \
        np.zeros(0, np.int64)
    if len(ia) == 0:
        return []
    dt = np.abs(a[ia] - (b[ib] + offset))
    keep = dt < max_difference  # strict, as in the reference
    ia, ib, dt = ia[keep], ib[keep], dt[keep]
    if len(ia) == 0:
        return []
    order = np.argsort(dt, kind="stable")
    used_a = np.zeros(len(a), bool)
    used_b = np.zeros(len(b), bool)
    matches = []
    for k in order:
        i, j = ia[k], ib[k]
        if not used_a[i] and not used_b[j]:
            used_a[i] = used_b[j] = True
            matches.append((a[i], b[j]))
    matches.sort()
    return matches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Associate two timestamped data files (TUM format)."
    )
    parser.add_argument("first_file", help="first text file (format: timestamp data)")
    parser.add_argument("second_file", help="second text file (format: timestamp data)")
    parser.add_argument("--first_only", action="store_true",
                        help="only output associated lines from first file")
    parser.add_argument("--offset", type=float, default=0.0,
                        help="time offset added to the second file's stamps")
    parser.add_argument("--max_difference", type=float, default=0.02,
                        help="maximum allowed time difference for a match")
    parser.add_argument("--remove_bounds", action="store_true",
                        help="drop the first/last 100 lines of each file")
    args = parser.parse_args(argv)

    first = read_file_list(args.first_file, args.remove_bounds)
    second = read_file_list(args.second_file, args.remove_bounds)
    for t1, t2 in associate(first, second, args.offset, args.max_difference):
        if args.first_only:
            print(f"{t1:f} {' '.join(first[t1])}")
        else:
            print(
                f"{t1:f} {' '.join(first[t1])} "
                f"{t2 - args.offset:f} {' '.join(second[t2])}"
            )
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. piped into `head`
        sys.exit(0)
