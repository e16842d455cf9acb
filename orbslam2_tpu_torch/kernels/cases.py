"""Edge cases of kernel K3 (`csrc/hamming_best2.cu`) in each of its modes.

`k3_cases(device)` builds small inputs that the gated modes' pruning and
exact gates must get right, each with its plain version's answer defined
by `hamming.best2_plain` / `best2_gated_plain`:

  * coordinates on a 0.25 px grid and representable radii, so that many
    pairs sit at |du| == r, |dv| == r or |ur_cur - ur_pt| == r exactly,
    and columns moved one ulp in or out of those boundaries;
  * `fuse` pairs whose reprojection chi2 ((du du + dv dv) + er er) isig
    lands exactly on 7.8 or 5.99 in float32, or one rounding step above
    (`fuse_chi2_boundary`);
  * a complement descriptor as a row's sole candidate (distance 256);
  * rows with no candidate, all-invalid columns, N == 1, M == 0, and
    3000 and 12000 columns (several per thread of the kernel's sort, and
    more than 48 KB of shared memory for it);
  * invalid rows holding inf or NaN coordinates and radii, and valid rows
    at inf or NaN;
  * tie-heavy descriptors (words from [0, 1, 3, -1, -2^31]).

`chip_smoke.py` and `tests/test_torch_kernels.py` hold the kernel to its
plain version on them on the card; `tests/test_torch_matchers.py` holds
the candidate rule (`hamming.candidate_buckets`) on them on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hamming

TIE_WORDS = np.array([0, 1, 3, -1, -(2**31)], np.int32)
#: 1 / sigma^2 per octave at scale factor 1.2 (Frontend.inv_level_sigma2)
INV_SIGMA2 = (1.0 / 1.44 ** np.arange(8)).astype(np.float32)


def _descs(rng, n, ties):
    if ties:
        return TIE_WORDS[rng.integers(0, len(TIE_WORDS), (n, 8))]
    return rng.integers(-(2**31), 2**31, (n, 8), dtype=np.int64).astype(np.int32)


def _nudge(rng, a, frac):
    """Move a fraction of the entries one float32 ulp up or down."""
    a = a.astype(np.float32)
    step = np.where(rng.uniform(size=a.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
    return np.where(rng.uniform(size=a.shape) < frac, np.nextafter(a, step), a)


def grid_case(rng, mode, n, m, ties=False, oct_mode="both", extent=12.0):
    """Random rows and columns of one gated mode on a 0.25 px grid inside an
    `extent` px square, with representable radii: numpy arrays (A, B,
    fields of a `hamming.Gate`)."""
    f32 = np.float32
    steps = int(extent * 4)
    row_uv = (rng.integers(0, steps, (n, 2)) * 0.25).astype(f32)
    col_uv = _nudge(rng, rng.integers(0, steps, (m, 2)) * 0.25, 0.3)
    g = dict(
        mode=mode, row_uv=row_uv, row_r=rng.choice([0.5, 1.0, 2.0, 2.5, 4.0], n).astype(f32),
        row_oct=rng.integers(0, 8, n).astype(np.int32), row_valid=rng.uniform(size=n) < 0.9,
        col_uv=col_uv, col_oct=rng.integers(0, 8, m).astype(np.int32),
        col_valid=rng.uniform(size=m) < 0.9, oct_mode=oct_mode,
    )
    if mode == "stereo":
        g["row_umin"] = (row_uv[:, 0] - 3.25).astype(f32)
    if mode in ("points", "fuse"):
        g["row_ur"] = (row_uv[:, 0] - 2.5).astype(f32)
        ur = _nudge(rng, col_uv[:, 0] - 2.5 + rng.integers(-8, 9, m) * 0.25, 0.3)
        g["col_ur"] = np.where(rng.uniform(size=m) < 0.7, ur, -1.0).astype(f32)
    if mode == "fuse":
        g["col_isig"] = INV_SIGMA2[g["col_oct"]]
    return _descs(rng, n, ties), _descs(rng, m, ties), g


def _sole_complement(rng, mode, n):
    """Row i's only candidate is column i, at its exact position, holding
    the bitwise complement of row i's descriptor: distance 256."""
    A, _, g = grid_case(rng, mode, n, n)
    uv = np.stack([np.full(n, 5.0), 30.0 * np.arange(n)], axis=1).astype(np.float32)
    g.update(row_uv=uv, col_uv=uv.copy(), row_valid=np.ones(n, bool), col_valid=np.ones(n, bool),
             row_oct=np.full(n, 2, np.int32), col_oct=np.full(n, 2, np.int32),
             oct_mode="both", row_r=np.full(n, 2.0, np.float32))
    if mode == "stereo":
        g["row_umin"] = uv[:, 0] - 3.0
    if mode in ("points", "fuse"):
        g["row_ur"] = uv[:, 0] - 1.0
        g["col_ur"] = uv[:, 0] - 1.0
    return A, ~A, g


def _non_finite_rows(rng, mode, n, m):
    """A grid case whose first rows hold inf and NaN coordinates or radii:
    invalid ones, then valid ones."""
    A, B, g = grid_case(rng, mode, n, m)
    bad = np.array([[np.inf, 3.0], [3.0, np.inf], [np.nan, 3.0], [3.0, np.nan], [-np.inf, -np.inf]],
                   np.float32)
    k = len(bad)
    g["row_uv"][:k] = bad
    g["row_uv"][k:2 * k] = bad
    g["row_valid"][:k] = False
    g["row_valid"][k:2 * k] = True
    g["row_r"][2 * k] = np.nan
    g["row_r"][2 * k + 1] = np.inf
    g["row_r"][:2] = np.nan
    return A, B, g


def _chi2_isig(e2, th):
    """Float32 isig values around the chi2 boundary of e2: (the largest isig
    with fl(e2 * isig) <= th, the smallest with fl(e2 * isig) > th)."""
    f32 = np.float32
    x = f32(th) / f32(e2)
    for _ in range(8):
        x = np.nextafter(x, f32(np.inf)) if f32(e2) * x <= f32(th) else np.nextafter(x, f32(0))
    while f32(e2) * x > f32(th):
        x = np.nextafter(x, f32(0))
    return x, np.nextafter(x, f32(np.inf))


def fuse_chi2_boundary(rng, n):
    """Row i's only candidate is column i at an offset (du, dv) on a
    0.0625 px grid inside the window, with a right u for half the columns
    (er on the same grid): the stereo test ((du du + dv dv) + er er) isig
    <= 7.8, the mono one (du du + dv dv) isig <= 5.99. The column's isig is
    the last float32 at which the test passes (half the rows, many of them
    exactly on 7.8 or 5.99) or the first at which it fails."""
    f32 = np.float32
    A, B, g = grid_case(rng, "fuse", n, n)
    du, dv, er = (rng.integers(-40, 41, n) * 0.0625 for _ in range(3))
    du[0], dv[0], er[0] = 1.0, 0.0, 0.0  # e2 == 1: isig == 7.8f and 5.99f exactly
    stereo = rng.uniform(size=n) < 0.5
    row_uv = np.stack([np.full(n, 100.0), 100.0 + 30.0 * np.arange(n)], axis=1).astype(f32)
    col_uv = (row_uv + np.stack([du, dv], axis=1)).astype(f32)
    isig = np.empty(n, f32)
    for i in range(n):
        d, e = f32(col_uv[i, 0] - row_uv[i, 0]), f32(col_uv[i, 1] - row_uv[i, 1])
        e2 = f32(d * d) + f32(e * e)
        if stereo[i]:
            e2 = e2 + f32(f32(er[i]) * f32(er[i]))
        if e2 == 0:
            e2 = f32(1.0)
            col_uv[i, 0] += 1.0
        isig[i] = _chi2_isig(e2, 7.8 if stereo[i] else 5.99)[i % 2]
    row_ur = np.full(n, 50.0, f32)
    g.update(row_uv=row_uv, col_uv=col_uv, row_r=np.full(n, 4.0, f32), row_valid=np.ones(n, bool),
             col_valid=np.ones(n, bool), row_oct=np.full(n, 3, np.int32), col_oct=np.full(n, 3, np.int32),
             row_ur=row_ur, col_ur=np.where(stereo, row_ur - er, -1.0).astype(f32), col_isig=isig)
    return A, B, g


def k3_cases(device, seed: int = 0):
    """[(name, A, B, gate)]: torch tensors on `device`; `gate` is a
    `hamming.Gate` for the gated modes or a bool [N, M] mask for mask mode."""
    rng = np.random.default_rng(seed)
    raw = []
    for mode, oct_modes in (("stereo", ["both"]), ("frame", ["forward", "backward", "both"]),
                            ("points", ["both"]), ("fuse", ["both"])):
        for om in oct_modes:
            tag = f"{mode}/{om}" if mode == "frame" else mode
            raw.append((f"{tag} grid", *grid_case(rng, mode, 300, 400, oct_mode=om)))
        raw.append((f"{mode} grid ties", *grid_case(rng, mode, 300, 400, ties=True)))
        raw.append((f"{mode} spread over 480 px", *grid_case(rng, mode, 1200, 1200, extent=480.0)))
        raw.append((f"{mode} complement sole candidate", *_sole_complement(rng, mode, 64)))
        A, B, g = grid_case(rng, mode, 50, 80)
        g["row_uv"][:, 1] += 1000.0  # every row far below every column
        raw.append((f"{mode} rows without candidate", A, B, g))
        A, B, g = grid_case(rng, mode, 50, 80)
        g["col_valid"][:] = False
        raw.append((f"{mode} all columns invalid", A, B, g))
        A, B, g = grid_case(rng, mode, 1, 80)
        g["row_valid"][:] = True
        raw.append((f"{mode} N == 1", A, B, g))
        raw.append((f"{mode} M == 0", *grid_case(rng, mode, 20, 0)))
        raw.append((f"{mode} inf and NaN rows", *_non_finite_rows(rng, mode, 40, 120)))
    # several columns per thread of the kernel's sort, and more than the
    # 48 KB of shared memory a launch gets without asking
    raw.append(("stereo M == 3000", *grid_case(rng, "stereo", 600, 3000, extent=120.0)))
    raw.append(("frame M == 12000", *grid_case(rng, "frame", 300, 12000, extent=480.0)))
    raw.append(("fuse chi2 boundary", *fuse_chi2_boundary(rng, 400)))
    out = []
    for name, A, B, g in raw:
        t = {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device) if isinstance(v, np.ndarray) else v)
             for k, v in g.items()}
        out.append((name, torch.from_numpy(A).to(device), torch.from_numpy(B).to(device), hamming.Gate(**t)))
    for name, (n, m) in (("mask M == 0", (20, 0)), ("mask N == 1", (1, 80))):
        A, B = _descs(rng, n, False), _descs(rng, m, False)
        mask = torch.from_numpy(rng.uniform(size=(n, m)) < 0.3).to(device)
        out.append((name, torch.from_numpy(A).to(device), torch.from_numpy(B).to(device), mask))
    return out


def k3(A, B, gate):
    """K3's wrapper for a case: `best2` under a mask, else `best2_gated`."""
    if isinstance(gate, hamming.Gate):
        return hamming.best2_gated(A, B, gate)
    return hamming.best2(A, B, gate)


def k3_plain(A, B, gate):
    """K3's plain version for a case."""
    if isinstance(gate, hamming.Gate):
        return hamming.best2_gated_plain(A, B, gate)
    return hamming.best2_plain(A, B, gate)
