"""Hierarchical binary k-means vocabulary training.

The reference assumes a pre-trained ORBvoc.txt (not shipped in its
snapshot — SURVEY.md notes the Vocabulary/ directory is absent). This
module trains a DBoW2-compatible k^L tree from a descriptor corpus:
k-means over binary descriptors with the bitwise-majority mean
(DBoW2 FORB::meanValue, Thirdparty/DBoW2/DBoW2/FORB.cpp:13-60) and
tf-idf leaf weights (TemplatedVocabulary::setNodeWeights).

Port of orbslam2_tpu/vocab/train.py: the same numpy k-means, so that the
same corpus and seed give the same tree, bit for bit; the tree becomes a
`Vocabulary` on `device` through the port's `bow.build_from_nodes`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .bow import Vocabulary, build_from_nodes


def _unpack_bits(desc_u8: np.ndarray) -> np.ndarray:
    return np.unpackbits(desc_u8, axis=-1)


def _majority_mean(bits: np.ndarray) -> np.ndarray:
    """Bitwise majority of [n, 256] -> [256] (FORB::meanValue)."""
    return (bits.mean(axis=0) >= 0.5).astype(np.uint8)


def _hamming(bits_a: np.ndarray, bits_b: np.ndarray) -> np.ndarray:
    return (bits_a[:, None, :] != bits_b[None, :, :]).sum(axis=-1)


def _binary_kmeans(bits: np.ndarray, k: int, rng, n_iter: int = 8):
    """k-means with majority means; returns (centers [k,256], assign [n])."""
    n = len(bits)
    k_eff = min(k, n)
    centers = bits[rng.choice(n, k_eff, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(n_iter):
        d = _hamming(bits, centers)
        new_assign = d.argmin(axis=1)
        if np.array_equal(new_assign, assign):
            assign = new_assign
            break
        assign = new_assign
        for c in range(k_eff):
            m = assign == c
            if m.any():
                centers[c] = _majority_mean(bits[m])
            else:  # re-seed empty cluster at the farthest point
                far = d.min(axis=1).argmax()
                centers[c] = bits[far]
    return centers, assign


def train_vocabulary(
    descriptors: np.ndarray,  # [n, 32] uint8 or [n, 8] uint32
    k: int = 10,
    depth: int = 4,
    seed: int = 0,
    doc_ids: Optional[np.ndarray] = None,  # per-descriptor document (image) id
    device="cuda",
) -> Vocabulary:
    if descriptors.dtype == np.uint32:
        descriptors = np.ascontiguousarray(descriptors).view(np.uint8)
    bits = _unpack_bits(descriptors)
    rng = np.random.default_rng(seed)

    parents: List[int] = [-1]
    descs: List[np.ndarray] = [np.zeros(32, np.uint8)]
    weights: List[float] = [0.0]
    is_leaf: List[bool] = [False]
    leaf_members: List[np.ndarray] = [np.empty(0, np.int64)]

    def grow(node_id: int, member_idx: np.ndarray, level: int):
        if level == depth or len(member_idx) <= 1:
            is_leaf[node_id] = True
            leaf_members[node_id] = member_idx
            return
        centers, assign = _binary_kmeans(bits[member_idx], k, rng)
        for c in range(len(centers)):
            sub = member_idx[assign == c]
            if len(sub) == 0:
                continue
            child = len(parents)
            parents.append(node_id)
            descs.append(np.packbits(centers[c]))
            weights.append(0.0)
            is_leaf.append(False)
            leaf_members.append(np.empty(0, np.int64))
            grow(child, sub, level + 1)

    grow(0, np.arange(len(bits)), 0)

    # idf weights per leaf (TemplatedVocabulary::setNodeWeights, TF_IDF)
    if doc_ids is None:
        doc_ids = np.zeros(len(bits), np.int64)
    n_docs = max(len(np.unique(doc_ids)), 1)
    leaf_rows = [i for i, l in enumerate(is_leaf) if l]
    for i in leaf_rows:
        n_docs_with_word = len(np.unique(doc_ids[leaf_members[i]])) if len(
            leaf_members[i]
        ) else 0
        weights[i] = float(np.log(n_docs / max(n_docs_with_word, 1e-9))) if n_docs_with_word else 1.0
        if weights[i] <= 0:
            weights[i] = 1e-3  # every-doc words keep a tiny weight

    return build_from_nodes(
        np.array(parents, np.int32),
        np.stack(descs),
        np.array(weights, np.float32),
        np.array(is_leaf, bool),
        k,
        depth,
        device,
    )
