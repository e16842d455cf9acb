"""Keyframe database: BoW inverted file + candidate detection.

Port of orbslam2_tpu/vocab/database.py (reference src/KeyFrameDatabase.cpp):
word-id -> keyframe inverted file, shared-word accumulation, the
0.8*maxCommonWords gate, covisibility-group score accumulation and the
0.75*bestAccScore cut, for loop candidates (:51-172, excluding covisible
keyframes and applying minScore) and relocalization candidates (:174-284,
no exclusion, no minScore). Host code in numpy, as in the JAX package.

Storage is sparse (the DBoW2 design, BowVector.cpp): per keyframe a
sorted (word id, weight) pair of arrays, scored by merge-intersection. The
inverted file is a flat postings store (word, keyframe) with amortized
doubling; a query is one membership + bincount pass over it.

One deliberate divergence: the JAX class's `add` leaves a re-added
keyframe's earlier postings in the store, so its shared words count twice.
Here `add` drops a keyframe's postings before it appends the new ones.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..slam.map import SlamMap
from .bow import l1_score_sparse


class KeyFrameDatabase:
    def __init__(self, n_words: int):
        self.n_words = n_words
        self.kf_words: Dict[int, np.ndarray] = {}  # kf -> sorted unique word ids
        self.kf_bow: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}  # sparse (wid, w)
        #: kf -> per-feature FeatureVector node ids [N] int32 (-1 invalid),
        #: the reference KeyFrame's mFeatVec (KeyFrame.cpp:51-53)
        self.kf_nodes: Dict[int, np.ndarray] = {}
        #: flat postings store (word, kf), the inverted file as two arrays
        self._post_w = np.empty(1 << 14, np.int64)
        self._post_kf = np.empty(1 << 14, np.int64)
        self._post_n = 0
        self._erased: Set[int] = set()

    def add(self, kf: int, words: np.ndarray, bow, nodes: np.ndarray = None):
        """words: per-descriptor word ids [N] (-1 invalid); bow: sparse
        (word ids, weights) from bow_sparse; nodes: per-descriptor
        FeatureVector node ids [N] (-1 invalid). A keyframe added again
        replaces its postings."""
        if kf in self.kf_words or kf in self._erased:
            self._drop_postings(kf)
        uw = np.unique(words[words >= 0])
        self.kf_words[kf] = uw
        self.kf_bow[kf] = bow
        if nodes is not None:
            self.kf_nodes[kf] = nodes
        self._erased.discard(kf)
        n, m = self._post_n, len(uw)
        while n + m > len(self._post_w):
            self._post_w = np.concatenate([self._post_w, np.empty_like(self._post_w)])
            self._post_kf = np.concatenate([self._post_kf, np.empty_like(self._post_kf)])
        self._post_w[n : n + m] = uw
        self._post_kf[n : n + m] = kf
        self._post_n = n + m

    def _drop_postings(self, kf: int):
        n = self._post_n
        keep = self._post_kf[:n] != kf
        m = int(keep.sum())
        self._post_w[:m] = self._post_w[:n][keep]
        self._post_kf[:m] = self._post_kf[:n][keep]
        self._post_n = m

    def erase(self, kf: int):
        if kf in self.kf_words:
            self._erased.add(kf)
        self.kf_words.pop(kf, None)
        self.kf_bow.pop(kf, None)
        self.kf_nodes.pop(kf, None)

    def clear(self):
        self.kf_words.clear()
        self.kf_bow.clear()
        self.kf_nodes.clear()
        self._post_n = 0
        self._erased.clear()

    # ------------------------------------------------------------------

    def _common_words(self, words: np.ndarray, exclude: Set[int]):
        """Shared-word counts per keyframe: one membership + bincount pass
        over the flat postings store."""
        n = self._post_n
        if n == 0:
            return {}
        qw = np.unique(words[words >= 0])
        if qw.size == 0:
            return {}
        sel = np.isin(self._post_w[:n], qw, assume_unique=False)
        kf_hits = self._post_kf[:n][sel]
        if kf_hits.size == 0:
            return {}
        counts = np.bincount(kf_hits)
        kfs = np.nonzero(counts)[0]
        skip = self._erased | exclude
        return {int(k): int(counts[k]) for k in kfs if int(k) not in skip}

    @staticmethod
    def _l1_score(v1, v2) -> float:
        return l1_score_sparse(v1, v2)

    def _accumulate_groups(self, scored: Dict[int, float], slam_map: SlamMap,
                           min_score_gate: Optional[float]) -> List[int]:
        """Covisibility-group accumulation + 0.75*bestAccScore cut
        (reference KeyFrameDatabase.cpp:115-171)."""
        best_acc = 0.0
        groups = []  # (acc_score, best_kf)
        for kf, sc in scored.items():
            acc = sc
            best_kf, best_sc = kf, sc
            for nb in slam_map.covisible_keyframes(kf, 10):
                if nb in scored:
                    acc += scored[nb]
                    if scored[nb] > best_sc:
                        best_kf, best_sc = nb, scored[nb]
            groups.append((acc, best_kf))
            best_acc = max(best_acc, acc)
        min_to_retain = 0.75 * best_acc
        out, seen = [], set()
        for acc, kf in groups:
            if acc > min_to_retain and kf not in seen:
                seen.add(kf)
                out.append(kf)
        return out

    def detect_loop_candidates(self, kf: int, min_score: float, slam_map: SlamMap) -> List[int]:
        exclude = set(slam_map.covisible_keyframes(kf))
        exclude.add(kf)
        counts = self._common_words(self.kf_words.get(kf, np.empty(0)), exclude)
        if not counts:
            return []
        min_common = 0.8 * max(counts.values())
        bow = self.kf_bow[kf]
        scored = {}
        for okf, c in counts.items():
            if c > min_common:
                s = self._l1_score(bow, self.kf_bow[okf])
                if s >= min_score:
                    scored[okf] = s
        if not scored:
            return []
        return self._accumulate_groups(scored, slam_map, min_score)

    def detect_relocalization_candidates(self, words: np.ndarray, bow, slam_map: SlamMap) -> List[int]:
        counts = self._common_words(words, set())
        if not counts:
            return []
        min_common = 0.8 * max(counts.values())
        scored = {}
        for okf, c in counts.items():
            if c > min_common:
                scored[okf] = self._l1_score(bow, self.kf_bow[okf])
        if not scored:
            return []
        return self._accumulate_groups(scored, slam_map, None)
