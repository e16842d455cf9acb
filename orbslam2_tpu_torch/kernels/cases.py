"""Edge cases of kernels K3 (`csrc/hamming_best2.cu`, in each of its modes)
and K4 (`csrc/bow_transform.cu`).

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
  * tie-heavy descriptors (words from [0, 1, 3, -1, -2^31]);
  * `nodes` mode (`nodes_case`): rows whose node no column holds, rows and
    columns at node -1, every column in one node, invalid rows and
    columns, tie-heavy descriptors, N == 1, M == 0, and 12000 columns.

`chip_smoke.py` and `tests/test_torch_kernels.py` hold the kernel to its
plain version on them on the card; `tests/test_torch_matchers.py` holds
the candidate rule (`hamming.candidate_buckets`) on them on the CPU.

`k4_cases(device)` builds vocabulary trees and descriptors for K4:
  * a hand-built ragged tree (`ragged_tree`): a leaf one step below the
    root, a missing child between two present ones, a node with no child
    slot filled past the first, children with equal descriptors (ties go
    to the lowest child index), queries equal to node descriptors, their
    complements, all-zero and all-ones descriptors, invalid slots, every
    FeatureVector level;
  * a random tree with k = 40 > 32 children (two passes of the warp) and
    tie-heavy descriptors;
  * N == 0.
`tests/test_torch_vocab_pnp.py` holds the plain version to the JAX
package's `transform_words_nodes` on them on the CPU.

`k5_raw_cases()` builds pose LM problems for K5 (`csrc/pose_lm.cu`):
mixed mono and stereo edges with 25% outliers, mono-only edges, points
behind the camera and (invalid) at |z| < 1e-6 under T0, no valid edge (H = 0), every
edge an outlier after round 0, and one at the main path's N = 1200 with
half the edges invalid. `k6_raw_cases()` builds masked FAST scores for K6
(`csrc/select_keypoints.cu`): a level smaller than its budget (the
k < n_target padding), tie-heavy scores, scores at the key's clamp, a
level whose 30 px cells straddle the grid's cells, and a frame's 8 levels
of random sparse scores. `tests/test_torch_select_pose_cases.py` holds the
plain versions to the JAX package's functions on them on the CPU.

`k5_cluster_raw_cases()` adds problems for K5's cluster (each CTA sums a
slice of the edges, warp 0 of every CTA runs the LM step): N = 0, N < 32
(fewer edges than CTAs x warps), N that the cluster's slices do not divide,
every edge an outlier from the start, an indefinite H (every pivot <= 0),
a NaN in H (a NaN pivot in every pass), and steps that stay in the
retract's small-angle branch. `k6_block_raw_cases()` adds levels for K6's
blocks (30-row bands by 240-column chunks, grid cells merged from the
blocks they straddle): a level of one grid cell, ragged right and bottom
cells, all-zero and all-hi levels, a budget above the candidate count
(c = 4), grid cells wider than a chunk and taller than three bands, and
the best keys of grid cells on the rows and columns where bands and
chunks meet. `tests/test_torch_kernels.py` and `chip_smoke.py` hold the
kernels to their plain versions on both sets on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hamming
from ..vocab import bow

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


def nodes_case(rng, n, m, n_nodes, ties=False):
    """Rows and columns of `nodes` mode: node ids drawn from n_nodes values
    spread over a vocabulary-sized range, -1 (no node) for a tenth of
    each, a tenth of the rows at nodes no column holds, 90% valid."""
    ids = np.sort(rng.choice(88950, n_nodes, replace=False)).astype(np.int32)
    col_node = ids[rng.integers(0, n_nodes, m)]
    row_node = ids[rng.integers(0, n_nodes, n)]
    row_node[rng.uniform(size=n) < 0.1] = 88950 + rng.integers(0, 10)  # absent from the columns
    row_node[rng.uniform(size=n) < 0.1] = -1
    col_node[rng.uniform(size=m) < 0.1] = -1
    g = dict(mode="nodes", row_valid=rng.uniform(size=n) < 0.9, col_valid=rng.uniform(size=m) < 0.9,
             row_node=row_node.astype(np.int32), col_node=col_node.astype(np.int32))
    return _descs(rng, n, ties), _descs(rng, m, ties), g


def _nodes_cases(rng):
    out = [("nodes 1200x1200 over 300 nodes", *nodes_case(rng, 1200, 1200, 300)),
           ("nodes ties", *nodes_case(rng, 300, 400, 20, ties=True))]
    A, B, g = nodes_case(rng, 300, 400, 1, ties=True)
    g["col_node"][:] = g["row_node"][g["row_node"] >= 0][0]
    out.append(("nodes all columns in one node", A, B, g))
    A, B, g = nodes_case(rng, 200, 300, 50)
    g["col_node"][:] = -1
    out.append(("nodes every column at node -1", A, B, g))
    A, B, g = nodes_case(rng, 200, 300, 50)
    g["row_node"][:] = -1
    g["col_node"][:] = -1
    g["row_valid"][:] = g["col_valid"][:] = True
    out.append(("nodes rows and columns at node -1", A, B, g))
    A, B, g = nodes_case(rng, 100, 300, 50)
    g["col_valid"][:] = False
    out.append(("nodes all columns invalid", A, B, g))
    A, B, g = nodes_case(rng, 1, 300, 2)
    g["row_valid"][:] = True
    g["row_node"][:] = g["col_node"][g["col_node"] >= 0][0]
    out.append(("nodes N == 1", A, B, g))
    out.append(("nodes M == 0", *nodes_case(rng, 20, 0, 5)))
    out.append(("nodes M == 12000", *nodes_case(rng, 600, 12000, 2000)))
    return out


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
    raw += _nodes_cases(rng)
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


# ---------------------------------------------------------------------------
# K4: vocabulary trees
# ---------------------------------------------------------------------------


def _tree_arrays(children: dict, n_nodes: int, k: int, node_desc: np.ndarray):
    """(children_desc uint32 [n_nodes, k, 8], children_idx, node_word,
    word_weight) of a tree given as {node: [child id or -1 per slot]}; a
    node without entry, or with only -1, is a leaf."""
    children_idx = np.full((n_nodes, k), -1, np.int32)
    children_desc = np.zeros((n_nodes, k, 8), np.uint32)
    for node, ch in children.items():
        for j, c in enumerate(ch):
            children_idx[node, j] = c
            if c >= 0:
                children_desc[node, j] = node_desc[c]
    leaf = (children_idx < 0).all(axis=1)
    leaf[0] = False
    node_word = np.full(n_nodes, -1, np.int32)
    node_word[leaf] = np.arange(int(leaf.sum()), dtype=np.int32)
    word_weight = np.linspace(0.5, 2.0, int(leaf.sum())).astype(np.float32)
    return children_desc, children_idx, node_word, word_weight


def ragged_tree(rng):
    """A hand-built tree, k = 4, depth 3, as numpy arrays (the JAX
    package's `Vocabulary` fields, descriptors as uint32): node 1 is a leaf
    one step below the root and ties with node 2 there; node 2 misses its
    slot 1 between present slots; nodes 7, 8 and 9 hold one descriptor
    (a three-way tie), as do nodes 4 and 6; node 5 has two children and
    two missing slots."""
    n_nodes = 13
    children = {0: [1, 2, 3, -1], 2: [4, -1, 5, 6], 3: [7, 8, 9, 10], 5: [11, 12, -1, -1]}
    # each child is its parent with ~24 bits flipped, as a trained tree's
    # clusters lie near their parent, so that queries reach every node
    node_desc = np.zeros((n_nodes, 8), np.uint32)
    node_desc[0] = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
    for parent in (0, 2, 3, 5):
        for c in children[parent]:
            if c >= 0:
                flips = (rng.uniform(size=(8, 32)) < 0.1) << np.arange(32, dtype=np.uint64)
                node_desc[c] = node_desc[parent] ^ flips.sum(axis=1).astype(np.uint32)
    node_desc[2] = node_desc[1] ^ np.array([1, 1, 0, 0, 0, 0, 0, 0], np.uint32)
    node_desc[8] = node_desc[9] = node_desc[7]
    node_desc[6] = node_desc[4]
    return (*_tree_arrays(children, n_nodes, 4, node_desc), 4, 3), node_desc


def wide_tree(rng, k=40):
    """A random tree with k children per node (some missing), depth 2,
    tie-heavy descriptors: two passes of K4's warp over the children."""
    kids = {0: list(range(1, k + 1))}
    nxt = k + 1
    for node in range(1, k + 1):
        m = int(rng.integers(0, k + 1))
        slots = [-1] * k
        for j in sorted(rng.choice(k, m, replace=False)):
            slots[j] = nxt
            nxt += 1
        kids[node] = slots
    node_desc = TIE_WORDS[rng.integers(0, len(TIE_WORDS), (nxt, 8))].view(np.uint32)
    return (*_tree_arrays(kids, nxt, k, node_desc), k, 2), node_desc


def dfs_tree(rng, k, p_child, leaves=()):
    """A random tree numbered depth-first, as DBoW2 numbers its trees (a
    node's subtree takes the ids after it): below level l each of a node's
    k slots holds a child with probability p_child[l], len(p_child) levels
    deep; the nodes at the slot paths in `leaves` (tuples of child slots
    from the root) get no children. Each child is its parent with ~10% of
    its bits flipped. Returns the arrays and the node descriptors."""
    depth = len(p_child)
    children, descs = {}, [rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)]

    def grow(node, path):
        if len(path) == depth or path in leaves:
            return
        slots = [-1] * k
        for j in range(k):
            if rng.uniform() < p_child[len(path)]:
                slots[j] = len(descs)
                flips = (rng.uniform(size=(8, 32)) < 0.1) << np.arange(32, dtype=np.uint64)
                descs.append(descs[node] ^ flips.sum(axis=1).astype(np.uint32))
                grow(slots[j], path + (j,))
        children[node] = slots

    grow(0, ())
    node_desc = np.stack(descs)
    return (*_tree_arrays(children, len(descs), k, node_desc), k, depth), node_desc


def _queries(rng, node_desc, n_near, n_random):
    """Node descriptors with one bit flipped (walks that reach every part
    of the tree, leaves inside it too), and random descriptors."""
    near = node_desc[rng.integers(0, len(node_desc), n_near)].copy()
    near[np.arange(n_near), rng.integers(0, 8, n_near)] ^= np.uint32(1) << rng.integers(0, 32, n_near).astype(np.uint32)
    rand = rng.integers(0, 2**32, (n_random, 8), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([node_desc, near, rand])


def k4_raw_cases(seed: int = 0):
    """[(name, (children_desc, children_idx, node_word, word_weight, k,
    depth), desc uint32 [N, 8], valid [N], node_level)] as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    voc, node_desc = ragged_tree(rng)
    q = [node_desc, ~node_desc, np.zeros((2, 8), np.uint32), np.full((2, 8), 0xFFFFFFFF, np.uint32),
         rng.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)]
    desc = np.concatenate(q)
    # single-bit neighbours of the tied descriptors (node 1 with bit 0 of
    # word 0 or 1 flipped lies at 1 from both nodes 1 and 2)
    near = np.repeat(node_desc[[1, 2, 4, 7]], 32, axis=0)
    near[np.arange(128), np.arange(128) % 8] ^= np.uint32(1) << (np.arange(128) % 32).astype(np.uint32)
    desc = np.concatenate([desc, near])
    valid = rng.uniform(size=len(desc)) < 0.9
    valid[: 2 * len(node_desc) + 4] = True
    for level in (1, 2, 3):
        out.append((f"ragged tree, level {level}", voc, desc, valid, level))
    voc, node_desc = wide_tree(rng)
    desc = np.concatenate([node_desc[rng.integers(0, len(node_desc), 200)],
                           TIE_WORDS[rng.integers(0, len(TIE_WORDS), (200, 8))].view(np.uint32)])
    out.append(("k = 40 tree, ties", voc, desc, rng.uniform(size=len(desc)) < 0.9, 1))
    out.append(("N == 0", voc, np.zeros((0, 8), np.uint32), np.zeros(0, bool), 2))
    # K4 stages the top levels of a tree (2 at k = 10, up to 3 in the
    # checks at every staging): trees numbered depth-first, as the generic
    # vocabulary is, deeper than the staged levels and no deeper
    voc, node_desc = dfs_tree(rng, 10, (1.0, 0.5, 0.4, 0.3, 0.3))
    desc = _queries(rng, node_desc, 600, 200)
    valid = rng.uniform(size=len(desc)) < 0.9
    for level in (1, 4):
        out.append((f"depth-first k 10 depth 5 ({len(node_desc)} nodes), level {level}", voc, desc, valid, level))
    # ORBvoc's shape (k 10, depth 6) cut by raggedness, with leaves inside
    # the staged levels: the root's first child (level 1) and grandchildren
    # through its second and third (level 2)
    voc, node_desc = dfs_tree(rng, 10, (1.0, 0.5, 0.4, 0.2, 0.2, 0.2),
                              leaves={(0,), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)})
    desc = _queries(rng, node_desc, 600, 200)
    valid = rng.uniform(size=len(desc)) < 0.9
    for level in (2, 5):
        out.append((f"ORBvoc-shaped k 10 depth 6 ({len(node_desc)} nodes, leaves at levels 1 and 2), level "
                    f"{level}", voc, desc, valid, level))
    for p_child in ((0.7,), (0.8, 0.5)):
        voc, node_desc = dfs_tree(rng, 10, p_child)
        desc = _queries(rng, node_desc, 100, 100)
        out.append((f"depth {len(p_child)} k 10, no deeper than the staged levels", voc, desc,
                    rng.uniform(size=len(desc)) < 0.9, len(p_child)))
    return out


def k4_cases(device, seed: int = 0):
    """[(name, vocabulary, desc int32 [N, 8], valid [N], node_level)] on
    `device`: `k4_raw_cases` as the port's tensors."""
    out = []
    for name, voc, desc, valid, level in k4_raw_cases(seed):
        out.append((name, bow.from_arrays(*voc, device=device),
                    torch.from_numpy(np.ascontiguousarray(desc).view(np.int32).copy()).to(device),
                    torch.from_numpy(valid.copy()).to(device), level))
    return out


# ---------------------------------------------------------------------------
# K5: the pose LM
# ---------------------------------------------------------------------------

#: the synthetic worlds' 752x480 camera (fx, fy, cx, cy, bf, width, height)
K5_CAMERA = (458.0, 457.0, 376.0, 240.0, 47.9, 752, 480)


def _rodrigues(w):
    th = float(np.linalg.norm(w))
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1.0 - np.cos(th)) / th**2 * K @ K


def _pose(w, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = _rodrigues(np.asarray(w, np.float64)), t
    return T


def _project(T, pw):
    fx, fy, cx, cy, bf = K5_CAMERA[:5]
    pc = pw @ T[:3, :3].T + T[:3, 3]
    u = fx * pc[:, 0] / pc[:, 2] + cx
    return np.stack([u, fy * pc[:, 1] / pc[:, 2] + cy, u - bf / pc[:, 2]], axis=1)


def _k5_problem(rng, n, outlier_frac=0.25, stereo_frac=0.8, noise=0.3):
    pw = rng.uniform([-5, -3, 4], [5, 3, 25], (n, 3))
    T_true = _pose([0.02, -0.03, 0.01], [0.3, -0.2, 0.15])
    obs = _project(T_true, pw)
    obs[:, :2] += rng.normal(0, noise, (n, 2))
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    obs[out, :2] += rng.uniform(15, 60, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    is_stereo = rng.uniform(size=n) < stereo_frac
    inv_sigma2 = 1.0 / 1.44 ** rng.integers(0, 3, n)
    T0 = _pose([0.01, 0.02, -0.01], [0.08, -0.06, 0.05]) @ T_true
    return [T0.astype(np.float32), pw.astype(np.float32), obs.astype(np.float32), inv_sigma2.astype(np.float32),
            is_stereo, np.ones(n, bool)]


def k5_raw_cases(seed: int = 0):
    """[(name, [T0 [4,4], pw [N,3], obs [N,3], inv_sigma2 [N] float32,
    is_stereo [N], valid [N] bool])] as numpy, for the camera K5_CAMERA."""
    rng = np.random.default_rng(seed)
    out = [("mixed, 25% outliers", _k5_problem(rng, 300))]
    a = _k5_problem(rng, 300, stereo_frac=0.0)
    out.append(("mono only", a))
    a = _k5_problem(rng, 300)
    T0 = a[0].astype(np.float64)
    pc = np.zeros((40, 3))
    pc[:20] = rng.uniform([-3, -2, -8], [3, 2, -1], (20, 3))  # behind the camera
    pc[20:, :2] = rng.uniform(-2, 2, (20, 2))
    pc[20:, 2] = rng.uniform(-9e-7, 9e-7, 20)  # |z| < 1e-6
    Rt = T0[:3, :3].T
    a[1][:40] = ((pc - T0[:3, 3]) @ Rt.T).astype(np.float32)
    a[2][:40] = rng.uniform([0, 0, -20], [752, 480, 700], (40, 3)).astype(np.float32)
    # an active edge at z ~ 1e-7 would dominate H by ~1e20: those stay
    # invalid, and are evaluated (weight 0) in every pass all the same
    a[5][20:40] = False
    out.append(("points behind the camera and at |z| < 1e-6", a))
    a = _k5_problem(rng, 300)
    a[5][:] = False
    out.append(("no valid edge (H = 0)", a))
    a = _k5_problem(rng, 200, outlier_frac=0.0)
    a[2][:, :2] += (rng.uniform(80, 200, (200, 2)) * rng.choice([-1, 1], (200, 2))).astype(np.float32)
    out.append(("every edge an outlier after round 0", a))
    a = _k5_problem(rng, 1200, outlier_frac=0.1, stereo_frac=0.6)
    a[5][rng.uniform(size=1200) < 0.5] = False
    out.append(("N = 1200, half invalid", a))
    return out


def k5_cases(device, seed: int = 0):
    """[(name, args, camera)] on `device`: `k5_raw_cases` as the port's
    tensors, args in `pose_opt.pose_optimize`'s order."""
    from ..geometry.camera import make_camera

    cam = make_camera(*K5_CAMERA)
    return [(name, tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in args), cam)
            for name, args in k5_raw_cases(seed)]


# ---------------------------------------------------------------------------
# K6: keypoint selection
# ---------------------------------------------------------------------------


def _nms3(score):
    """where(score is its 3x3 neighbourhood's (tied) max and > 0, score, 0),
    outside the image -inf: K2's output from a raw score."""
    B, h, w = score.shape
    p = np.full((B, h + 2, w + 2), -np.inf, np.float32)
    p[:, 1:-1, 1:-1] = score
    neigh = np.max(np.stack([p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]), axis=0)
    return np.where((score >= neigh) & (score > 0), score, 0).astype(np.float32)


def _sparse_scores(rng, B, h, w, density=0.08, high=120.0):
    s = np.where(rng.uniform(size=(B, h, w)) < density, rng.uniform(1.0, high, (B, h, w)), 0.0)
    return s.astype(np.float32)


def k6_raw_cases(seed: int = 0):
    """[(name, [masked scores float32 [B, h, w] per level], [budget per
    level])] as numpy; the scores are already NMS-masked, as K2 gives them."""
    rng = np.random.default_rng(seed)
    out = [("level smaller than its budget (k < n_target)", [_nms3(_sparse_scores(rng, 2, 40, 44, 0.3))], [500])]
    ties = rng.integers(0, 4, (2, 97, 131)).astype(np.float32) * 7.0
    out.append(("tie-heavy scores (4 values)", [ties], [150]))
    flat = np.where(rng.uniform(size=(1, 120, 150)) < 0.5, 21.0, 0.0).astype(np.float32)
    out.append(("every kept score equal", [flat], [90]))
    big = _sparse_scores(rng, 2, 480, 752, 0.05, 3000.0)
    big[:, 100:140, 200:260] = 1023.75  # 4 s = 4095 = the clamp at 19 position bits
    out.append(("scores at and above the key's clamp", [_nms3(big)], [261]))
    # 30 px cells without a hi pixel next to cells with one, on a level whose
    # grid cells (c = 6 for 300 keypoints) straddle the 30 px cells
    s = _sparse_scores(rng, 2, 113, 167, 0.1, 19.0)  # all below ini_th 20
    s[:, 30:60, 60:90] = np.where(rng.uniform(size=(2, 30, 30)) < 0.1, 35.0, s[:, 30:60, 60:90])
    s[:, :, 120:] = np.where(s[:, :, 120:] > 0, s[:, :, 120:] * 0.3, 0.0)  # below min_th 7 too
    out.append(("30 px cells straddling the grid, fallback and none", [_nms3(s)], [300]))
    levels, budgets = [], [261, 217, 181, 151, 126, 105, 87, 72]
    for lvl in range(8):
        h, w = int(round(480 / 1.2**lvl)), int(round(752 / 1.2**lvl))
        levels.append(_nms3(_sparse_scores(rng, 2, h, w, 0.06)))
    out.append(("8 levels of a 752x480 stereo pair, random scores", levels, budgets))
    return out


def k6_cases(device, seed: int = 0):
    """[(name, [scores per level], [budgets])] on `device`."""
    return [(name, [torch.from_numpy(s).to(device) for s in levels], budgets)
            for name, levels, budgets in k6_raw_cases(seed)]


# ---------------------------------------------------------------------------
# K5 and K6: cases of the cluster and block layouts
# ---------------------------------------------------------------------------


def k5_cluster_raw_cases(seed: int = 0):
    """[(name, [T0, pw, obs, inv_sigma2, is_stereo, valid])] as numpy (as
    `k5_raw_cases`), for the camera K5_CAMERA."""
    rng = np.random.default_rng(seed)
    out = [("N = 0", [a[:0] if i else a for i, a in enumerate(_k5_problem(rng, 8))])]
    out.append(("N = 20 (< 32)", _k5_problem(rng, 20)))
    out.append(("N = 1203 (the slices of 8 CTAs differ by one)", _k5_problem(rng, 1203, outlier_frac=0.15)))
    out.append(("N = 37", _k5_problem(rng, 37, outlier_frac=0.1)))
    a = _k5_problem(rng, 1203, outlier_frac=0.0)
    a[2][:, :2] += (rng.uniform(300, 500, (1203, 2)) * rng.choice([-1, 1], (1203, 2))).astype(np.float32)
    out.append(("every edge an outlier from the start", a))
    a = _k5_problem(rng, 300)
    a[3][:] = -1.0
    out.append(("indefinite H (negative weights: every pivot <= 0)", a))
    a = _k5_problem(rng, 300)
    a[3][7] = np.nan
    out.append(("a NaN weight (NaN pivots)", a))
    # T0 off the true pose by a translation only, noise-free stereo
    # observations: the steps' rotations stay below theta2 = 1e-8
    pw = rng.uniform([-5, -3, 4], [5, 3, 25], (400, 3))
    T_true = _pose([0.02, -0.03, 0.01], [0.3, -0.2, 0.15])
    T0 = T_true.copy()
    T0[:3, 3] += [0.002, -0.001, 0.003]
    out.append(("small steps (the retract's theta2 < 1e-8 branch)",
                [T0.astype(np.float32), pw.astype(np.float32), _project(T_true, pw).astype(np.float32),
                 np.ones(400, np.float32), np.ones(400, bool), np.ones(400, bool)]))
    return out


def k5_cluster_cases(device, seed: int = 0):
    """`k5_cluster_raw_cases` as (name, args, camera) on `device`."""
    from ..geometry.camera import make_camera

    cam = make_camera(*K5_CAMERA)
    return [(name, tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in args), cam)
            for name, args in k5_cluster_raw_cases(seed)]


def k6_block_raw_cases(seed: int = 0):
    """[(name, [masked scores per level], [budget per level])] as numpy (as
    `k6_raw_cases`)."""
    rng = np.random.default_rng(seed)
    out = [("a level of one grid cell", [_nms3(_sparse_scores(rng, 2, 10, 10, 0.5))], [1])]
    out.append(("ragged right and bottom cells (333 x 517)", [_nms3(_sparse_scores(rng, 2, 333, 517, 0.05))], [150]))
    out.append(("all zeros", [np.zeros((2, 200, 300), np.float32)], [80]))
    out.append(("every pixel above ini_th", [np.full((2, 130, 260), 50.0, np.float32)], [60]))
    out.append(("a budget above the candidates (c = 4)", [_nms3(_sparse_scores(rng, 2, 100, 120, 0.2))], [2000]))
    out.append(("grid cells wider than a chunk (c = 283)", [_nms3(_sparse_scores(rng, 2, 480, 752, 0.02))], [4]))
    # each grid cell's best keys on the rows and columns where the cell
    # pass's bands (30 rows) and chunks (240 columns) meet
    s = _sparse_scores(rng, 2, 300, 520, 0.02, 60.0)
    for y in (29, 30, 59, 60, 89, 90, 149, 150, 239, 240):
        s[:, y, 17:-17:3] = rng.uniform(150, 250, (2, len(range(17, 520 - 17, 3))))
    for x in (239, 240, 479, 480):
        s[:, 17:-17:2, x] = rng.uniform(150, 250, (2, len(range(17, 300 - 17, 2))))
    out.append(("best keys where bands and chunks meet", [_nms3(s)], [120]))
    return out


def k6_block_cases(device, seed: int = 0):
    """`k6_block_raw_cases` on `device`."""
    return [(name, [torch.from_numpy(s).to(device) for s in levels], budgets)
            for name, levels, budgets in k6_block_raw_cases(seed)]
