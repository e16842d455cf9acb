"""Bag-of-binary-words vocabulary as dense tensors, and kernel K4.

Port of orbslam2_tpu/vocab/bow.py (reference Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h): the k^L tree of 256-bit descriptors is four
tensors on the System's device,

    children_desc [n_nodes, k, 8] int32 -- child descriptors per node
    children_idx  [n_nodes, k] int32 -- child node ids (-1 = missing)
    node_word     [n_nodes] int32 -- leaf word index (-1 for internal)
    word_weight   [n_words] float32 -- idf weights

with the descriptors' bits in int32 words, as the port keeps every
descriptor (`convert.py`), and two tables K4 reads, built once when the
vocabulary is made: `children_word` [n_nodes, k] (each child's word, so
the winning child brings it) and `stage`, the top `stage_levels` levels
of the tree laid out breadth-first for shared memory (`stage_table`).
`transform_words_nodes` descends the tree for all N descriptors of a
frame: on a CUDA tensor it launches K4 (`csrc/bow_transform.cu`, one warp
per descriptor, the staged levels in shared memory); on a CPU tensor it
takes `transform_words_nodes_plain`, a loop of `depth` gather + XOR +
popcount + masked argmin steps. The sparse tf-idf vector and the L1 score
run on the host in numpy, as in the JAX package; the dense vector
(`bow_vector`) and DBoW2's six scores (`score`) are plain PyTorch.

`load_dbow2_text` parses a DBoW2 text file in one pass of numpy's text
reader, where the JAX package uses its native parser (native/src/
vocab_parse.cc, with a Python loop as the fallback): no library to build
at first use, and the same parents, flags, descriptor bytes and float32
weights as both.

K4's launch counter is counted under a lock: the mapping worker thread
indexes keyframes beside the tracker's relocalization attempts.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build
from ..ops import hamming

#: a missing child's distance (the JAX package's `1 << 30`)
MISSING = 1 << 30
#: bytes of one staged child: its 32-byte row, its global id and its word
STAGE_ENTRY_BYTES = 40
#: shared memory a K4 block may take for the staged levels: the most levels
#: whose table fits are staged. k = 10 gets 2 levels (4,400 bytes): on the
#: H100 they beat 3 (44,400 bytes, whose copy costs more than the step it
#: saves) and 1 (PERF.md §6)
STAGE_BYTES = 8 * 1024
#: the most shared memory a block may take on sm_90 (the H100's opt-in
#: limit, which the launcher reads from the device)
MAX_STAGE_BYTES = 232448
_TABLES = ("children_desc", "children_idx", "node_word", "word_weight", "children_word", "stage")


class Vocabulary(NamedTuple):
    children_desc: torch.Tensor  # [n_nodes, k, 8] int32 (the JAX package's uint32 bits)
    children_idx: torch.Tensor  # [n_nodes, k] int32 (-1 = missing child)
    node_word: torch.Tensor  # [n_nodes] int32, word id for leaves else -1
    word_weight: torch.Tensor  # [n_words] float32 (idf)
    k: int
    depth: int
    children_word: torch.Tensor  # [n_nodes, k] int32: node_word of each child, -1 when missing
    stage: torch.Tensor  # int32: `stage_table` of the top `stage_levels` levels
    stage_levels: int

    @property
    def n_words(self) -> int:
        return self.word_weight.shape[0]

    @property
    def device(self) -> torch.device:
        return self.children_desc.device


def from_arrays(children_desc, children_idx, node_word, word_weight, k: int, depth: int,
                device="cuda") -> Vocabulary:
    """A `Vocabulary` on `device` from numpy-convertible arrays; descriptor
    words may be uint32 or int32 (the same bits). Checks the table shapes
    and that every child id names a node, since K4 follows them unchecked."""
    cd = np.ascontiguousarray(np.asarray(children_desc))
    cd = cd.astype(np.uint32, copy=False).view(np.int32) if cd.dtype != np.int32 else cd
    ci = np.asarray(children_idx, np.int32)
    nw = np.asarray(node_word, np.int32)
    ww = np.asarray(word_weight, np.float32)
    n_nodes = nw.shape[0]
    if cd.shape != (n_nodes, k, 8) or ci.shape != (n_nodes, k):
        raise ValueError(f"vocabulary tables: children_desc {cd.shape}, children_idx {ci.shape}, "
                         f"{n_nodes} nodes, k = {k}")
    if ci.size and int(ci.max()) >= n_nodes:
        raise ValueError(f"vocabulary: child id {int(ci.max())} >= {n_nodes} nodes")
    if depth < 1:
        raise ValueError(f"vocabulary depth {depth} < 1")
    cw = np.where(ci >= 0, nw[np.maximum(ci, 0)], -1).astype(np.int32)
    levels = stage_levels(k, depth)
    tables = dict(children_desc=cd, children_idx=ci, node_word=nw, word_weight=ww, children_word=cw,
                  stage=stage_table(cd, ci, cw, k, levels))
    dev = torch.device(device)
    return Vocabulary(k=int(k), depth=int(depth), stage_levels=levels,
                      **{f: torch.from_numpy(a.copy()).to(dev) for f, a in tables.items()})


def to_device(voc: Vocabulary, device) -> Vocabulary:
    """`voc` with its tables on `device`."""
    dev = torch.device(device)
    return voc._replace(**{f: getattr(voc, f).to(dev) for f in _TABLES})


def n_staged_children(k: int, levels: int) -> int:
    """Children of the nodes of the top `levels` levels in a full k-ary
    tree: k + k^2 + ... + k^levels (K4's staged table entries)."""
    return sum(k ** (level + 1) for level in range(levels))


def stage_levels(k: int, depth: int, budget: int = STAGE_BYTES) -> int:
    """The most levels (at most `depth`) whose staged table fits `budget`
    bytes: with STAGE_BYTES, 2 for k = 10 (4,400 bytes), 1 for k = 40."""
    levels = 0
    while levels < depth and n_staged_children(k, levels + 1) * STAGE_ENTRY_BYTES <= budget:
        levels += 1
    return levels


def stage_table(children_desc: np.ndarray, children_idx: np.ndarray, children_word: np.ndarray, k: int,
                levels: int) -> np.ndarray:
    """K4's staged top of the tree, as int32 words: the nodes of the top
    `levels` levels in a full k-ary breadth-first numbering (node 0 the
    root, the children of staged node s at s * k + 1 + j; a missing child
    leaves a hole whose children are all missing), and per staged node s
    and slot j, entry e = s * k + j:

        [e] the row's low 16 bytes, [E + e] its high 16 bytes (int4 units),
        then [e] (the child's global id, its word) (int2 units),

    E = `n_staged_children(k, levels)`, the whole padded to 16 bytes. The
    kernel walks the first `levels` steps in this table by local index and
    carries the global id, which it reads below the staged levels."""
    n_nodes_staged = sum(k ** level for level in range(levels))
    glob = np.full(n_nodes_staged, -1, np.int64)
    if n_nodes_staged:
        glob[0] = 0
    first, width = 0, 1
    for _ in range(levels - 1):
        parents = np.arange(first, first + width)
        g = glob[parents]
        glob[parents[:, None] * k + 1 + np.arange(k)] = np.where(
            g[:, None] >= 0, children_idx[np.maximum(g, 0)], -1)
        first, width = first + width, width * k
    has, g = glob >= 0, np.maximum(glob, 0)
    ci = np.where(has[:, None], children_idx[g], -1)
    cw = np.where(has[:, None], children_word[g], -1)
    cd = np.where(has[:, None, None], children_desc[g], 0).astype(np.int32)
    flat = np.concatenate([cd[..., :4].reshape(-1), cd[..., 4:].reshape(-1),
                           np.stack([ci, cw], -1).reshape(-1)]).astype(np.int32)
    return np.concatenate([flat, np.zeros(-len(flat) % 4, np.int32)])


def with_stage_levels(voc: Vocabulary, levels: int) -> Vocabulary:
    """`voc` with K4's table staging `levels` levels in place of the
    default (to compare stagings); at most `stage_levels(k, depth,
    MAX_STAGE_BYTES)`."""
    if not 0 <= levels <= stage_levels(voc.k, voc.depth, MAX_STAGE_BYTES):
        raise ValueError(f"{levels} staged levels do not fit a block (k {voc.k}, depth {voc.depth})")
    cpu = [getattr(voc, f).cpu().numpy() for f in ("children_desc", "children_idx", "children_word")]
    table = stage_table(*cpu, voc.k, levels)
    return voc._replace(stage=torch.from_numpy(table).to(voc.device), stage_levels=levels)


def feature_node_level(depth: int) -> int:
    """Tree level (steps from the root) of the FeatureVector grouping node:
    DBoW2 transforms with levelsup=4 (reference KeyFrame.cpp:51-53), so 4
    levels above the leaves, at least level 1."""
    return max(1, depth - 4)


def transform_words(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """desc [N, 8] int32 -> word ids [N] int32 (-1 for invalid slots)."""
    words, _ = transform_words_nodes(voc, desc, valid, node_level=1)
    return words


def transform_words_nodes_plain(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
                                node_level: int | None = None):
    """Plain version of K4: (word ids [N] int32, FeatureVector node ids [N]
    int32), both -1 for invalid slots. At each of `depth` steps the child
    of least Hamming distance, a missing child counting MISSING, ties to
    the lowest child index; a node without children stays put. The node id
    is the one reached after `node_level` steps."""
    if node_level is None:
        node_level = feature_node_level(voc.depth)
    n = desc.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=desc.device)
    level_node = node
    for step in range(voc.depth):
        cd = voc.children_desc[node]  # [N, k, 8]
        ci = voc.children_idx[node]  # [N, k]
        dist = hamming.popcount32(torch.bitwise_xor(cd, desc[:, None, :])).sum(dim=-1)
        dist = torch.where(ci >= 0, dist, MISSING)
        if ci.shape[1]:
            nxt = torch.gather(ci, 1, torch.argmin(dist, dim=1, keepdim=True))[:, 0].long()
        else:
            nxt = node
        node = torch.where(torch.all(ci < 0, dim=1), node, nxt)
        if step == node_level - 1:
            level_node = node
    words = voc.node_word[node]
    return (torch.where(valid, words, -1).to(torch.int32),
            torch.where(valid, level_node, -1).to(torch.int32))


class _K4Args(ctypes.Structure):
    """`BowArgs` of csrc/bow_transform.cu. The launcher sets `n_blocks` to
    the blocks it launched."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("desc", "valid", "children_desc", "children_idx", "children_word", "node_word", "stage",
                 "out")] + [
        (name, ctypes.c_int) for name in ("n", "k", "depth", "node_level", "n_nodes", "stage_levels",
                                          "stage_ints", "n_blocks")
    ]


_count_lock = threading.Lock()


def transform_words_nodes(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
                          node_level: int | None = None):
    """(word ids [N] int32, FeatureVector node ids [N] int32), -1 for
    invalid slots (orbslam2_tpu/vocab/bow.py::transform_words_nodes). CPU
    tensors take `transform_words_nodes_plain`; CUDA tensors take one
    launch of K4, `bow_transform_launch`, which raises if refused."""
    if node_level is None:
        node_level = feature_node_level(voc.depth)
    if desc.device.type == "cpu":
        return transform_words_nodes_plain(voc, desc, valid, node_level)
    dev = hamming._device(desc, "transform_words_nodes")
    n = desc.shape[0]
    if desc.dtype != torch.int32 or desc.shape[1:] != (8,):
        raise ValueError(f"K4 takes int32 [N, 8] descriptors, got {desc.dtype} {tuple(desc.shape)}")
    if valid.dtype != torch.bool or valid.shape != (n,) or valid.device != dev:
        raise ValueError(f"K4: valid must be bool [{n}] on {dev}, got {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    if voc.device != dev:
        raise ValueError(f"K4: the vocabulary lies on {voc.device}, the descriptors on {dev}")
    if not 1 <= node_level <= voc.depth:
        raise ValueError(f"K4: node_level {node_level} outside 1..{voc.depth}")
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    desc, cd, stage = (hamming._aligned(t) for t in (desc, voc.children_desc, voc.stage))
    valid = valid.contiguous()
    args = _K4Args(desc=desc.data_ptr(), valid=valid.data_ptr(), children_desc=cd.data_ptr(),
                   children_idx=voc.children_idx.contiguous().data_ptr(),
                   children_word=voc.children_word.contiguous().data_ptr(),
                   node_word=voc.node_word.contiguous().data_ptr(), stage=stage.data_ptr(), out=out.data_ptr(),
                   n=n, k=voc.k, depth=voc.depth, node_level=node_level,
                   n_nodes=voc.node_word.shape[0], stage_levels=voc.stage_levels, stage_ints=stage.numel())
    build.launch("bow_transform_launch", args)
    if args.n_blocks:
        with _count_lock:
            transform_words_nodes.launches += 1
    return out[0], out[1]


transform_words_nodes.launches = 0


# ---------------------------------------------------------------------------
# sparse BoW vectors (host, numpy)
# ---------------------------------------------------------------------------


def bow_sparse(words: np.ndarray, word_weight: np.ndarray):
    """Sparse tf-idf BoW vector from per-descriptor word ids: (sorted unique
    word ids [M] int64, L1-normalized weights [M] float32), the DBoW2
    BowVector (BowVector.cpp addWeight + normalize)."""
    uw, counts = np.unique(words[words >= 0], return_counts=True)
    w = word_weight[uw] * counts
    s = float(w.sum())
    if s > 0:
        w = w / s
    return uw.astype(np.int64), w.astype(np.float32)


def l1_score_sparse(a, b) -> float:
    """L1 score of two sparse BoW vectors in O(shared words): 1 - 0.5
    ||v - w||_1 over L1-normalized vectors is the sum over shared words of
    min(v_i, w_i) (ScoringObject.cpp L1Scoring)."""
    wid1, wv1 = a
    wid2, wv2 = b
    _, i1, i2 = np.intersect1d(wid1, wid2, assume_unique=True, return_indices=True)
    if i1.size == 0:
        return 0.0
    return float(np.minimum(wv1[i1], wv2[i2]).sum())


# ---------------------------------------------------------------------------
# dense BoW vectors and DBoW2's six scores (ScoringObject.cpp); the
# reference's ORB vocabulary selects L1 (TemplatedVocabulary.h:468-471).
# Each score expects vectors built with the norm in SCORING_NORM[method].
# ---------------------------------------------------------------------------

_LOG_EPS = float(np.log(np.finfo(np.float64).eps))

#: normalization each scorer expects (ScoringObject.h:74-89)
SCORING_NORM = {
    "l1": "l1",
    "l2": "l2",
    "chi_square": "l1",
    "kl": "l1",
    "bhattacharyya": "l1",
    "dot_product": None,
}


def bow_vector(voc: Vocabulary, words: torch.Tensor, norm: str | None = "l1") -> torch.Tensor:
    """Dense tf-idf vector [n_words] float32 from word ids (-1 ignored):
    each word's idf weight times its count, normalized by norm "l1", "l2"
    or None (the dot-product scorer), as orbslam2_tpu/vocab/bow.py::
    bow_vector."""
    counts = torch.bincount(words[words >= 0].long(), minlength=voc.n_words)
    v = voc.word_weight * counts.to(torch.float32)
    if norm is None:
        return v
    n = torch.sqrt(torch.sum(v * v)) if norm == "l2" else torch.sum(torch.abs(v))
    return v / torch.where(n > 0, n, torch.ones_like(n))


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """1 - 0.5 ||v - w||_1 on L1-normalized vectors, in [0, 1]
    (ScoringObject.cpp:23-68)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2))


def l2_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """1 - sqrt(1 - <v, w>) on L2-normalized vectors, in [0, 1]
    (ScoringObject.cpp:73-119)."""
    return 1.0 - torch.sqrt(1.0 - torch.clamp(torch.sum(v1 * v2), max=1.0))


def chi_square_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """2 sum(v w / (v + w)) on L1-normalized vectors, in [0, 1]
    (ScoringObject.cpp:125-169)."""
    denom = v1 + v2
    return 2.0 * torch.sum(torch.where(denom > 0, v1 * v2 / torch.where(denom > 0, denom, 1.0), 0.0))


def kl_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """KL divergence of v1 from v2 on L1-normalized vectors: the sum over
    v_i > 0 of v log(v / w), log(eps) standing in where w_i == 0
    (ScoringObject.cpp:174-221). Unscaled; lower is better."""
    logw = torch.where(v2 > 0, torch.log(torch.where(v2 > 0, v2, 1.0)), _LOG_EPS)
    logv = torch.log(torch.where(v1 > 0, v1, 1.0))
    return torch.sum(torch.where(v1 > 0, v1 * (logv - logw), 0.0))


def bhattacharyya_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """sum(sqrt(v w)) on L1-normalized vectors, in [0, 1]
    (ScoringObject.cpp:226-262)."""
    return torch.sum(torch.sqrt(v1 * v2))


def dot_product_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """<v, w> on unnormalized vectors (ScoringObject.cpp:267-303). Unscaled."""
    return torch.sum(v1 * v2)


_SCORERS = {
    "l1": l1_score,
    "l2": l2_score,
    "chi_square": chi_square_score,
    "kl": kl_score,
    "bhattacharyya": bhattacharyya_score,
    "dot_product": dot_product_score,
}


def score(v1: torch.Tensor, v2: torch.Tensor, method: str = "l1") -> torch.Tensor:
    """Score two dense BoW vectors with any DBoW2 metric; they must be built
    with bow_vector(..., norm=SCORING_NORM[method])."""
    return _SCORERS[method](v1, v2)


# ---------------------------------------------------------------------------
# construction and files
# ---------------------------------------------------------------------------


def build_from_nodes(parents: np.ndarray, descriptors: np.ndarray, weights: np.ndarray,
                     is_leaf: np.ndarray, k: int, depth: int, device="cuda") -> Vocabulary:
    """A vocabulary from a DBoW2 node table: parents [n_nodes] (-1 for the
    root, node 0), descriptors [n_nodes, 32] uint8 (root row ignored),
    weights [n_nodes] (leaf idf weights), is_leaf [n_nodes]. A node's
    children take its slots in node order."""
    n_nodes = len(parents)
    desc_u32 = np.ascontiguousarray(descriptors, np.uint8).view(np.uint32).reshape(n_nodes, 8)
    node_word = np.full(n_nodes, -1, np.int32)
    leaf_ids = np.nonzero(is_leaf)[0]
    node_word[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
    word_weight = weights[leaf_ids].astype(np.float32)
    children_idx = np.full((n_nodes, k), -1, np.int32)
    children_desc = np.zeros((n_nodes, k, 8), np.uint32)
    if n_nodes > 1:
        # a node's slot is its rank within its parent's group, by a stable
        # sort on the parent (a per-node loop crawls at ORBvoc's ~1M nodes)
        nodes = np.arange(1, n_nodes, dtype=np.int32)
        p = parents[1:]
        order = np.argsort(p, kind="stable")
        ps = p[order]
        group_start = np.concatenate([[0], np.nonzero(np.diff(ps))[0] + 1])
        starts = np.zeros(len(ps), np.int64)
        starts[group_start] = group_start
        starts = np.maximum.accumulate(starts)
        slot = np.arange(len(ps)) - starts
        keep = slot < k
        children_idx[ps[keep], slot[keep]] = nodes[order][keep]
        children_desc[ps[keep], slot[keep]] = desc_u32[nodes[order][keep]]
    return from_arrays(children_desc, children_idx, node_word, word_weight, k, depth, device)


#: numbers per node line: parent, is_leaf, 32 descriptor bytes, weight
_NODE_FIELDS = 35


def parse_dbow2_text(path: str):
    """A DBoW2 text vocabulary (the ORBvoc.txt format, reference System.cpp:
    38-39; writer TemplatedVocabulary.h:1382-1416) as arrays: (k, L,
    parents [n] int32, is_leaf [n] bool, descriptors [n, 32] uint8, weights
    [n] float32), node 0 the implicit root. The header is `k L scoring
    weighting`, then each node line `parent_id is_leaf d0..d31 weight`.
    The node lines are read in one pass by numpy's text reader (written
    in C) as a float64 table: exact for the integers, and each weight
    rounded once to float32 from the correctly rounded double, as the
    native parser's `(float)strtod` and the Python loop's `float()` do. A
    line with another number of fields raises."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # a vocabulary of the root alone
            rows = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if rows.size == 0:
        rows = np.zeros((0, _NODE_FIELDS))
    if rows.shape[1] != _NODE_FIELDS:
        raise ValueError(f"{path}: {rows.shape[1]} numbers per node line, not {_NODE_FIELDS}")
    n = rows.shape[0] + 1
    parents = np.full(n, -1, np.int32)
    parents[1:] = rows[:, 0]
    is_leaf = np.zeros(n, bool)
    is_leaf[1:] = rows[:, 1] != 0
    descs = np.zeros((n, 32), np.uint8)
    descs[1:] = rows[:, 2:34]
    weights = np.zeros(n, np.float32)
    weights[1:] = rows[:, 34]
    return k, L, parents, is_leaf, descs, weights


def load_dbow2_text(path: str, device="cuda") -> Vocabulary:
    """A DBoW2 text vocabulary file (`parse_dbow2_text`) as a Vocabulary on
    `device`."""
    k, L, parents, is_leaf, descs, weights = parse_dbow2_text(path)
    return build_from_nodes(parents, descs, weights, is_leaf, k, L, device)


def save_npz(voc: Vocabulary, path: str):
    """The JAX package's .npz layout (descriptor words as uint32)."""
    np.savez_compressed(
        path,
        children_desc=voc.children_desc.cpu().numpy().view(np.uint32),
        children_idx=voc.children_idx.cpu().numpy(),
        node_word=voc.node_word.cpu().numpy(),
        word_weight=voc.word_weight.cpu().numpy(),
        k=voc.k,
        depth=voc.depth,
    )


def load_npz(path: str, device="cuda") -> Vocabulary:
    z = np.load(path)
    return from_arrays(z["children_desc"], z["children_idx"], z["node_word"], z["word_weight"],
                       int(z["k"]), int(z["depth"]), device)
