"""K4's staged top of the vocabulary tree (`vocab/bow.py::stage_table`)
against the JAX package's `transform_words_nodes`, on the CPU.

The kernel walks the first `stage_levels` steps in the staged table by
local index and the rest in `children_desc` / `children_idx` /
`children_word` by global id; `staged_walk` below is that walk in plain
PyTorch, read from the same tables with the kernel's offsets. It must
give exactly the JAX package's word and FeatureVector node ids (and so
`transform_words_nodes_plain`'s), for every staging that fits a block,
from none up:
  * on the generic vocabulary (`assets/vocab_generic.npz`, k 10, depth 5,
    numbered depth-first) with a rendered frame's descriptors and random
    ones, at the default FeatureVector level;
  * on every tree of `kernels/cases.py::k4_raw_cases` (ragged, tie-heavy,
    k = 40, depth-first numbering, depth 1 and 2, leaves inside the staged
    levels, an ORBvoc-shaped k 10 depth 6 tree) at its node level.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_parity import matcher_pair

from orbslam2_tpu.vocab import bow as jax_bow
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.kernels import cases
from orbslam2_tpu_torch.ops import hamming
from orbslam2_tpu_torch.vocab import bow

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "vocab_generic.npz")


def staged_walk(voc: bow.Vocabulary, desc: torch.Tensor, valid: torch.Tensor, node_level: int):
    """csrc/bow_transform.cu's walk in plain PyTorch: (word ids, node ids),
    -1 for invalid slots."""
    k, L = voc.k, min(voc.stage_levels, voc.depth)
    E = bow.n_staged_children(k, L)
    st = voc.stage
    assert st.numel() % 4 == 0 and st.numel() >= 10 * E
    rows = torch.cat([st[:4 * E].view(E, 4), st[4 * E:8 * E].view(E, 4)], dim=1)  # [E, 8]
    iw = st[8 * E:10 * E].view(E, 2)
    c_rows = voc.children_desc.reshape(-1, 8)
    c_iw = torch.stack([voc.children_idx.reshape(-1), voc.children_word.reshape(-1)], dim=1)
    n = desc.shape[0]
    s = torch.zeros(n, dtype=torch.int64)  # local index while in the staged levels
    g = torch.zeros(n, dtype=torch.int64)  # global id
    word = voc.node_word[0].long().expand(n).clone()
    level = torch.full((n,), -1, dtype=torch.int64)
    slots = torch.arange(k)
    for step in range(voc.depth):
        e = (s if step < L else g)[:, None] * k + slots  # [n, k]
        r, cw = (rows[e], iw[e]) if step < L else (c_rows[e], c_iw[e])
        present = cw[..., 0] >= 0
        dist = hamming.popcount32(torch.bitwise_xor(r, desc[:, None, :])).sum(-1)
        j = torch.argmin(torch.where(present, dist, bow.MISSING), dim=1)
        win = cw[torch.arange(n), j].long()
        has = present.any(dim=1)  # a node without children stays put
        g = torch.where(has, win[:, 0], g)
        word = torch.where(has, win[:, 1], word)
        s = torch.where(has, s * k + 1 + j, s)
        if step == node_level - 1:
            level = g
    return torch.where(valid, word, -1).int(), torch.where(valid, level, -1).int()


def _jax_words_nodes(jvoc, desc_u32, valid, level):
    jw, jn = jax.jit(lambda d, v: jax_bow.transform_words_nodes(jvoc, d, v, level))(
        jnp.asarray(desc_u32), jnp.asarray(valid))
    return np.asarray(jw), np.asarray(jn)


def _check_stagings(voc, desc_u32, valid, level, want, name):
    desc = torch.from_numpy(np.ascontiguousarray(desc_u32).view(np.int32).copy())
    v = torch.from_numpy(valid.copy())
    plain = bow.transform_words_nodes_plain(voc, desc, v, level)
    for got, w in zip(plain, want):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=f"{name}: plain")
    for levels in range(bow.stage_levels(voc.k, voc.depth, bow.MAX_STAGE_BYTES) + 1):
        staged = bow.with_stage_levels(voc, levels)
        for got, w, what in zip(staged_walk(staged, desc, v, level), want, ("words", "nodes")):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f"{name}: {what}, {levels} staged levels")


def test_staged_walk_generic_vocabulary():
    jvoc = jax_bow.load_npz(VOCAB)
    voc = convert.vocabulary_to_torch(jvoc, "cpu")
    assert (voc.k, voc.depth, voc.stage_levels) == (10, 5, 2)
    assert voc.stage.numel() * 4 == bow.n_staged_children(10, 2) * bow.STAGE_ENTRY_BYTES == 4400
    # the table is a remap: node 0's children are not nodes 1..10
    assert voc.children_idx[0, 1] != 2
    _, eyes = matcher_pair(n_features=1200)
    rng = np.random.default_rng(3)
    desc = np.concatenate([eyes[0]["desc"], rng.integers(0, 2**32, (100, 8), dtype=np.uint64).astype(np.uint32)])
    valid = np.concatenate([eyes[0]["valid"], rng.uniform(size=100) < 0.8])
    level = bow.feature_node_level(voc.depth)
    want = _jax_words_nodes(jvoc, desc, valid, level)
    assert (want[0] >= 0).sum() == valid.sum()
    _check_stagings(voc, desc, valid, level, want, "generic vocabulary")


def test_staged_walk_edge_case_trees():
    seen = set()
    for name, arrays, desc, valid, level in cases.k4_raw_cases():
        voc = bow.from_arrays(*arrays, device="cpu")
        jvoc = jax_bow.Vocabulary(*(jnp.asarray(a) for a in arrays[:4]), arrays[4], arrays[5])
        want = _jax_words_nodes(jvoc, desc, valid, level)
        _check_stagings(voc, desc, valid, level, want, name)
        seen.add((voc.k, voc.depth, voc.stage_levels))
    # default stagings: whole small trees, 2 levels of k = 10, 1 of k = 40
    assert {(4, 3, 3), (40, 2, 1), (10, 6, 2), (10, 1, 1), (10, 2, 2)} <= seen, seen
