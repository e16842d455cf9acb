"""Map store: keyframes, map points, covisibility, spanning tree.

Functional-state redesign of the reference's pointer web (KeyFrame /
MapPoint / Map classes, src/KeyFrame.cpp, src/MapPoint.cpp, src/Map.cpp):
struct-of-arrays numpy state on the host with integer ids, no per-object
mutexes (device work is purely functional; the threaded pipeline
serializes map access behind one map lock, mirroring the reference's
mMutexMapUpdate — Tracking.cpp:260). Device kernels get dense array views
assembled from this store.

Point state is DENSE ARRAYS indexed by point id (ids are monotonically
allocated, never reused; tombstoned via the `pt_valid` mask), per the
SURVEY §7 stance: per-frame map admin is vectorized gathers/scatters, not
per-object dict walks. Keyframe state stays dict-keyed (cardinality is
hundreds, not hundreds of thousands).

Conventions: keyframe ids and point ids are stable ints; `-1` means none.
Deleted rows are masked via `kf_valid` / `pt_valid` (tombstones), matching
the reference's SetBadFlag protocol (KeyFrame.cpp:443-536).

This file is a copy of orbslam2_tpu/slam/map.py with three differences.
What `from .frontend import FrameHost` resolves to: the JAX package's
`slam/frontend.py` imports JAX, so its map module cannot be imported where
JAX is absent; here the import names the port's `FrameHost`, which keeps
the same host fields (descriptors as uint32 words). `clear` keeps the
keyframe database's erase hook, which the JAX package's drops. And
`remove_keyframe` erases every observation the keyframe holds, where the
JAX package's erases only those its point slots still name. Merging
the two copies by moving the import under `TYPE_CHECKING` is a roadmap
item.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from .frontend import FrameHost

COVIS_THRESHOLD = 15  # min shared points for a covisibility edge (KeyFrame.cpp:277-368)


_POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.uint8)


def hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Popcount Hamming distance between uint32-word descriptor arrays."""
    x = np.bitwise_xor(a, b).view(np.uint8)
    return np.unpackbits(x, axis=-1).sum(axis=-1)


class IdSet:
    """Set-like view over a dense bool mask (ascending iteration order).

    Supports the set API the pipeline uses (`in`, add/discard, len, iter)
    plus vectorized membership (`mask_of`) and id extraction (`ids`) so
    hot paths never loop per element.
    """

    __slots__ = ("_mask", "_n")

    def __init__(self, cap: int = 1024):
        self._mask = np.zeros(cap, bool)
        self._n = 0

    def _ensure(self, pid: int):
        if pid >= len(self._mask):
            new = np.zeros(max(pid + 1, 2 * len(self._mask)), bool)
            new[: len(self._mask)] = self._mask
            self._mask = new

    def add(self, pid: int):
        pid = int(pid)
        self._ensure(pid)
        if not self._mask[pid]:
            self._mask[pid] = True
            self._n += 1

    def add_range(self, base: int, n: int):
        if n <= 0:
            return
        self._ensure(base + n - 1)
        seg = self._mask[base : base + n]
        self._n += int(n - seg.sum())
        seg[:] = True

    def discard(self, pid: int):
        pid = int(pid)
        if 0 <= pid < len(self._mask) and self._mask[pid]:
            self._mask[pid] = False
            self._n -= 1

    def __contains__(self, pid) -> bool:
        pid = int(pid)
        return 0 <= pid < len(self._mask) and bool(self._mask[pid])

    def __iter__(self):
        return iter(np.nonzero(self._mask)[0].tolist())

    def __len__(self) -> int:
        return self._n

    def ids(self) -> np.ndarray:
        """All member ids, ascending."""
        return np.nonzero(self._mask)[0]

    def __eq__(self, other):
        if isinstance(other, IdSet):
            return np.array_equal(self.ids(), other.ids())
        return set(iter(self)) == set(other)

    def mask_of(self, ids) -> np.ndarray:
        """Vectorized membership test for an int array (negatives -> False)."""
        ids = np.asarray(ids)
        ok = (ids >= 0) & (ids < len(self._mask))
        out = np.zeros(ids.shape, bool)
        out[ok] = self._mask[ids[ok]]
        return out


class SlamMap:
    _PT_CAP0 = 4096

    def __init__(self, n_kp: int, n_levels: int = 8, scale_factor: float = 1.2):
        self.n_kp = n_kp
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.log_scale = np.log(scale_factor)
        self.scale_factors = scale_factor ** np.arange(n_levels)

        # --- keyframes (dict-of-arrays keyed by kf id) ---
        self.kf_pose: Dict[int, np.ndarray] = {}  # Tcw [4,4]
        self.kf_frame: Dict[int, FrameHost] = {}  # feature snapshot
        self.kf_point: Dict[int, np.ndarray] = {}  # [N] point id per kp (-1)
        self.kf_frame_id: Dict[int, int] = {}
        self.kf_timestamp: Dict[int, float] = {}
        #: IdSet: set API plus vectorized membership (`mask_of`) for the
        #: hot covisibility passes
        self.kf_valid = IdSet(256)
        self._next_kf = 0

        # local map points for drawing (reference Map::SetReferenceMapPoints,
        # Map.cpp:36-40); set by Tracking, read by MapDrawer
        self.reference_points: List[int] = []

        # covisibility + spanning tree (reference KeyFrame.cpp:110-441)
        self.covis: Dict[int, Dict[int, int]] = {}  # kf -> {kf: weight}
        self.parent: Dict[int, int] = {}  # spanning tree
        self.children: Dict[int, Set[int]] = {}
        self.loop_edges: Dict[int, Set[int]] = {}
        self.kf_first_connection: Dict[int, bool] = {}
        self.Tcp: Dict[int, np.ndarray] = {}  # pose relative to parent at cull time

        # --- map points: dense arrays indexed by pid ---
        cap = self._PT_CAP0
        self.pt_pos = np.zeros((cap, 3), np.float64)
        self.pt_desc = np.zeros((cap, 8), np.uint32)
        self.pt_normal = np.zeros((cap, 3), np.float64)
        self.pt_min_dist = np.zeros(cap, np.float64)
        self.pt_max_dist = np.zeros(cap, np.float64)
        self.pt_ref_kf = np.full(cap, -1, np.int64)
        self.pt_first_kf_id = np.full(cap, -1, np.int64)
        self.pt_visible = np.zeros(cap, np.int64)
        self.pt_found = np.zeros(cap, np.int64)
        # cached observation count with the reference's stereo-counts-double
        # rule (MapPoint.cpp:83-86), maintained incrementally so
        # n_observations() is O(1) and vectorizable
        self.pt_nobs = np.zeros(cap, np.int64)
        self.pt_obs: Dict[int, Dict[int, int]] = {}  # pid -> {kf: feat_idx}
        # dense mirror of pt_obs for vectorized passes (covisibility votes,
        # BA assembly, connection updates): per point a compacted row of
        # (kf id, feature idx) pairs; column count doubles on demand.
        # The dicts above remain the source of truth for scalar lookups.
        self.pt_obs_kf = np.full((cap, 16), -1, np.int32)
        self.pt_obs_idx = np.full((cap, 16), -1, np.int32)
        self.pt_obs_n = np.zeros(cap, np.int32)
        self.pt_valid = IdSet(cap)
        self.pt_replaced: Dict[int, int] = {}  # pid -> replacement pid
        self._next_pt = 0

        self.keyframe_origins: List[int] = []
        self.big_change_idx = 0
        #: bumped whenever point geometry/descriptors change in bulk (BA
        #: write-back, loop corrections, per-keyframe maintenance): the
        #: tracker's device-resident candidate cache re-uploads on change
        self.version = 0
        self.on_keyframe_removed = None  # callback(kf) — database erase hook

        # The one map-update lock (reference mMutexMapUpdate, Map.hpp /
        # Tracking.cpp:260): in threaded mode the tracker holds it for its
        # host map-admin sections and the mapping worker holds it for
        # mutations, releasing around device waits. Re-entrant so nested
        # stage calls on one thread are safe; uncontended cost is ~100ns.
        import threading

        self.lock = threading.RLock()

    # ------------------------------------------------------------------
    # point-row allocation
    # ------------------------------------------------------------------

    def _pt_capacity(self) -> int:
        return len(self.pt_max_dist)

    def ensure_pt_capacity(self, need: int):
        cap = self._pt_capacity()
        if need <= cap:
            return
        new_cap = cap
        while new_cap < need:
            new_cap *= 2

        def grow(a, fill=0):
            out = np.full((new_cap,) + a.shape[1:], fill, a.dtype)
            out[:cap] = a
            return out

        self.pt_pos = grow(self.pt_pos)
        self.pt_desc = grow(self.pt_desc)
        self.pt_normal = grow(self.pt_normal)
        self.pt_min_dist = grow(self.pt_min_dist)
        self.pt_max_dist = grow(self.pt_max_dist)
        self.pt_ref_kf = grow(self.pt_ref_kf, -1)
        self.pt_first_kf_id = grow(self.pt_first_kf_id, -1)
        self.pt_visible = grow(self.pt_visible)
        self.pt_found = grow(self.pt_found)
        self.pt_nobs = grow(self.pt_nobs)
        self.pt_obs_kf = grow(self.pt_obs_kf, -1)
        self.pt_obs_idx = grow(self.pt_obs_idx, -1)
        self.pt_obs_n = grow(self.pt_obs_n)

    def _alloc_points(self, n: int) -> int:
        """Reserve n fresh contiguous point ids; returns the base id."""
        base = self._next_pt
        self._next_pt += n
        self.ensure_pt_capacity(self._next_pt)
        self.pt_valid.add_range(base, n)
        ids = np.arange(base, base + n)
        self.pt_visible[ids] = 1
        self.pt_found[ids] = 1
        self.pt_nobs[ids] = 0
        return base

    def pt_ids(self) -> np.ndarray:
        """All valid point ids, ascending."""
        return self.pt_valid.ids()

    def valid_mask(self, ids) -> np.ndarray:
        """Vectorized `pid in pt_valid` over an int array."""
        return self.pt_valid.mask_of(ids)

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------

    def add_keyframe(self, frame: FrameHost, Tcw: np.ndarray) -> int:
        kf = self._next_kf
        self._next_kf += 1
        self.kf_pose[kf] = np.asarray(Tcw, np.float32).copy()
        self.kf_frame[kf] = frame
        self.kf_point[kf] = frame.point_ids.copy()
        self.kf_frame_id[kf] = frame.frame_id
        self.kf_timestamp[kf] = frame.timestamp
        self.kf_valid.add(kf)
        self.covis[kf] = {}
        self.children[kf] = set()
        self.loop_edges[kf] = set()
        self.kf_first_connection[kf] = True
        idxs = np.nonzero(frame.point_ids >= 0)[0]
        pids = frame.point_ids[idxs]
        ok = self.valid_mask(pids)
        self.add_observations_batch(pids[ok], kf, idxs[ok])
        return kf

    def kf_center(self, kf: int) -> np.ndarray:
        T = self.kf_pose[kf]
        return (-T[:3, :3].T @ T[:3, 3]).astype(np.float64)

    def n_keyframes(self) -> int:
        return len(self.kf_valid)

    def update_connections(self, kf: int):
        """Recount shared points -> covisibility weights; maintain spanning
        tree parent (reference KeyFrame::UpdateConnections). One bincount
        over the dense observation mirror replaces the per-point dict walk
        (O(points x observations) python in the reference-layout version)."""
        pids = self.kf_point[kf]
        ids = pids[self.valid_mask(pids)]
        if ids.size == 0:
            return
        rows = self.pt_obs_kf[ids]  # [M, D] kf ids, -1 empty
        flat = rows[rows >= 0]
        flat = flat[flat != kf]
        flat = flat[self.kf_valid.mask_of(flat)]
        if flat.size == 0:
            return
        counts = np.bincount(flat)
        best_kf = int(np.argmax(counts))
        best_w = int(counts[best_kf])
        cand = np.nonzero(counts >= COVIS_THRESHOLD)[0]
        new_edges = {int(c): int(counts[c]) for c in cand}
        if not new_edges:
            new_edges = {best_kf: best_w}
        # remove stale edges pointing at kf
        for okf in list(self.covis[kf]):
            if okf not in new_edges:
                self.covis[okf].pop(kf, None)
        self.covis[kf] = dict(new_edges)
        for okf, w in new_edges.items():
            self.covis[okf][kf] = w
        if self.kf_first_connection.get(kf, True) and kf != 0:
            self.parent[kf] = best_kf
            self.children[best_kf].add(kf)
            self.kf_first_connection[kf] = False

    def covisible_keyframes(self, kf: int, k: Optional[int] = None) -> List[int]:
        """Neighbors ordered by weight desc (GetBestCovisibilityKeyFrames)."""
        items = sorted(self.covis.get(kf, {}).items(), key=lambda x: -x[1])
        kfs = [c for c, _ in items if c in self.kf_valid]
        return kfs if k is None else kfs[:k]

    # ------------------------------------------------------------------
    # map points
    # ------------------------------------------------------------------

    def add_point(
        self, pos: np.ndarray, ref_kf: int, desc: np.ndarray
    ) -> int:
        pid = self._alloc_points(1)
        self.pt_pos[pid] = np.asarray(pos, np.float64)
        self.pt_desc[pid] = np.asarray(desc, np.uint32)
        self.pt_normal[pid] = 0.0
        self.pt_min_dist[pid] = 0.0
        self.pt_max_dist[pid] = 0.0
        self.pt_obs[pid] = {}
        self.pt_ref_kf[pid] = ref_kf
        self.pt_first_kf_id[pid] = ref_kf
        return pid

    def add_stereo_points_batch(self, frame: FrameHost, kf: int, idxs, cam):
        """Create one single-observation point per keypoint index: the
        batched equivalent of the add_point/add_observation/descriptor/
        normal sequence used by stereo initialization and keyframe creation
        (reference Tracking.cpp:545-556, :935-957). For a fresh point the
        distinctive descriptor IS the sole observation's descriptor, and
        the normal/depth formulas are closed-form — computed vectorized.
        `cam` is the camera config (fx/fy/cx/cy attributes)."""
        idxs = np.asarray(idxs, np.int64)
        if idxs.size == 0:
            return np.zeros(0, np.int64)
        T = self.kf_pose[kf].astype(np.float64)
        cam_center = (-T[:3, :3].T @ T[:3, 3])
        f = frame
        # unproject all indices at once (reference Frame::UnprojectStereo)
        z = f.depth[idxs].astype(np.float64)
        uv = f.uv[idxs].astype(np.float64)
        x = (uv[:, 0] - cam.cx) * z / cam.fx
        y = (uv[:, 1] - cam.cy) * z / cam.fy
        pc = np.stack([x, y, z], axis=1)
        Twc = np.linalg.inv(T)
        pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
        v = pw - cam_center
        dist = np.linalg.norm(v, axis=1)
        normals = v / np.maximum(dist, 1e-12)[:, None]
        levels = f.octave[idxs]
        maxd = dist * self.scale_factors[levels]
        mind = maxd / self.scale_factors[-1]

        n = len(idxs)
        base = self._alloc_points(n)
        pids = np.arange(base, base + n)
        self.pt_pos[pids] = pw
        self.pt_desc[pids] = f.desc[idxs].astype(np.uint32)
        self.pt_normal[pids] = normals
        self.pt_min_dist[pids] = mind
        self.pt_max_dist[pids] = maxd
        self.pt_ref_kf[pids] = kf
        self.pt_first_kf_id[pids] = kf
        self.pt_nobs[pids] = np.where(f.u_right[idxs] >= 0, 2, 1)
        for j in range(n):
            self.pt_obs[base + j] = {kf: int(idxs[j])}
        # dense mirror (rows are freshly allocated, already -1)
        self.pt_obs_kf[pids, 0] = kf
        self.pt_obs_idx[pids, 0] = idxs
        self.pt_obs_n[pids] = 1
        self.kf_point[kf][idxs] = pids
        return pids

    def _obs_weight(self, kf: int, idx: int) -> int:
        """Stereo observations count double (reference MapPoint.cpp:83-86)."""
        return 2 if self.kf_frame[kf].u_right[idx] >= 0 else 1

    # ---- pt_obs dense mirror maintenance (kept in lockstep with the
    # pt_obs dicts; consumers: vectorized covisibility votes, connection
    # updates, BA assembly) ----

    def _grow_obs_cols(self):
        cap, D = self.pt_obs_kf.shape
        new_kf = np.full((cap, 2 * D), -1, np.int32)
        new_idx = np.full((cap, 2 * D), -1, np.int32)
        new_kf[:, :D] = self.pt_obs_kf
        new_idx[:, :D] = self.pt_obs_idx
        self.pt_obs_kf = new_kf
        self.pt_obs_idx = new_idx

    def _obs_set(self, pid: int, kf: int, idx: int):
        n = int(self.pt_obs_n[pid])
        hit = np.nonzero(self.pt_obs_kf[pid, :n] == kf)[0]
        if hit.size:
            self.pt_obs_idx[pid, hit[0]] = idx
            return
        if n == self.pt_obs_kf.shape[1]:
            self._grow_obs_cols()
        self.pt_obs_kf[pid, n] = kf
        self.pt_obs_idx[pid, n] = idx
        self.pt_obs_n[pid] = n + 1

    def _obs_del(self, pid: int, kf: int):
        n = int(self.pt_obs_n[pid])
        hit = np.nonzero(self.pt_obs_kf[pid, :n] == kf)[0]
        if not hit.size:
            return
        j, last = int(hit[0]), n - 1
        self.pt_obs_kf[pid, j] = self.pt_obs_kf[pid, last]
        self.pt_obs_idx[pid, j] = self.pt_obs_idx[pid, last]
        self.pt_obs_kf[pid, last] = -1
        self.pt_obs_idx[pid, last] = -1
        self.pt_obs_n[pid] = last

    def _obs_clear(self, pid: int):
        n = int(self.pt_obs_n[pid])
        self.pt_obs_kf[pid, :n] = -1
        self.pt_obs_idx[pid, :n] = -1
        self.pt_obs_n[pid] = 0

    def rebuild_obs_mirror(self):
        """Re-derive the dense mirror from the pt_obs dicts (checkpoint
        restore path)."""
        self.pt_obs_kf[:] = -1
        self.pt_obs_idx[:] = -1
        self.pt_obs_n[:] = 0
        for pid, obs in self.pt_obs.items():
            for kf, idx in obs.items():
                self._obs_set(pid, kf, idx)

    def add_observation(self, pid: int, kf: int, idx: int):
        if kf not in self.pt_obs[pid]:
            self.pt_nobs[pid] += self._obs_weight(kf, idx)
        self.pt_obs[pid][kf] = idx
        self._obs_set(pid, kf, idx)
        self.kf_point[kf][idx] = pid

    def add_observations_batch(self, pids: np.ndarray, kf: int, idxs: np.ndarray):
        """Register many (point, feature) observations of ONE new keyframe
        in vectorized passes (keyframe insertion registers hundreds; the
        per-point path was ~10 ms of host time per keyframe). The keyframe
        must not already observe any of the points."""
        pids = np.asarray(pids, np.int64)
        idxs = np.asarray(idxs, np.int64)
        if pids.size == 0:
            return
        f = self.kf_frame[kf]
        self.pt_nobs[pids] += np.where(f.u_right[idxs] >= 0, 2, 1)
        n = self.pt_obs_n[pids]
        while int(n.max()) >= self.pt_obs_kf.shape[1]:
            self._grow_obs_cols()
        self.pt_obs_kf[pids, n] = kf
        self.pt_obs_idx[pids, n] = idxs
        self.pt_obs_n[pids] = n + 1
        for p, i in zip(pids.tolist(), idxs.tolist()):
            self.pt_obs[p][kf] = i
        self.kf_point[kf][idxs] = pids

    def erase_observation(self, pid: int, kf: int):
        idx = self.pt_obs[pid].pop(kf, None)
        self._obs_del(pid, kf)
        if idx is not None:
            if kf in self.kf_valid:
                self.pt_nobs[pid] -= self._obs_weight(kf, idx)
            if kf in self.kf_point and self.kf_point[kf][idx] == pid:
                self.kf_point[kf][idx] = -1
        if self.pt_ref_kf[pid] == kf and self.pt_obs[pid]:
            self.pt_ref_kf[pid] = next(iter(self.pt_obs[pid]))
        if len(self.pt_obs[pid]) <= 1 and pid in self.pt_valid:
            self.remove_point(pid)

    def n_observations(self, pid: int) -> int:
        """Observation count with the reference's stereo-counts-double rule
        (cached; maintained incrementally by the observation mutators)."""
        return int(self.pt_nobs[pid])

    def remove_point(self, pid: int):
        for kf, idx in list(self.pt_obs.get(pid, {}).items()):
            if kf in self.kf_point and self.kf_point[kf][idx] == pid:
                self.kf_point[kf][idx] = -1
        self.pt_obs[pid] = {}
        self._obs_clear(pid)
        self.pt_nobs[pid] = 0
        self.pt_valid.discard(pid)

    def replace_point(self, pid: int, by: int, refresh_desc: bool = True):
        """MapPoint::Replace — merge pid into `by`, keeping stats.

        refresh_desc=False defers the distinctive-descriptor update:
        bulk merge passes (fusion, loop correction) refresh the whole
        batch once at the end via compute_distinctive_descriptors_batch —
        the per-merge refresh was the dominant host cost of a loop
        correction (r3 on-chip: a fusion pass spent minutes in it)."""
        if pid == by or pid not in self.pt_valid:
            return
        for kf, idx in list(self.pt_obs[pid].items()):
            if kf not in self.pt_obs[by]:
                self.add_observation(by, kf, idx)
            else:
                if self.kf_point[kf][idx] == pid:
                    self.kf_point[kf][idx] = -1
        self.pt_found[by] += self.pt_found[pid]
        self.pt_visible[by] += self.pt_visible[pid]
        self.pt_obs[pid] = {}
        self._obs_clear(pid)
        self.pt_nobs[pid] = 0
        self.pt_valid.discard(pid)
        self.pt_replaced[pid] = by
        if refresh_desc:
            self.compute_distinctive_descriptor(by)
        # the survivor's descriptor changed: invalidate device-resident
        # candidate caches keyed on `version` (cache contract, tracking.py)
        self.version += 1

    def resolve_replaced(self, pid: int) -> int:
        seen = set()
        while pid in self.pt_replaced and pid not in seen:
            seen.add(pid)
            pid = self.pt_replaced[pid]
        return pid

    def compute_distinctive_descriptor(self, pid: int):
        """Min-median-Hamming descriptor over observations
        (reference MapPoint.cpp:224-289)."""
        obs = [
            self.kf_frame[kf].desc[idx]
            for kf, idx in self.pt_obs[pid].items()
            if kf in self.kf_valid
        ]
        if not obs:
            return
        D = np.stack(obs)
        dists = hamming_np(D[:, None, :], D[None, :, :])
        medians = np.median(dists, axis=1)
        self.pt_desc[pid] = D[int(np.argmin(medians))]
        self.version += 1

    def update_normal_and_depth(self, pid: int):
        """Reference MapPoint.cpp:341-399."""
        obs = self.pt_obs.get(pid, {})
        if not obs or pid not in self.pt_valid:
            return
        pos = self.pt_pos[pid]
        normals = []
        for kf in obs:
            if kf in self.kf_valid:
                v = pos - self.kf_center(kf)
                n = np.linalg.norm(v)
                if n > 1e-12:
                    normals.append(v / n)
        if not normals:
            return
        self.pt_normal[pid] = np.mean(normals, axis=0)
        ref = int(self.pt_ref_kf[pid])
        if ref not in self.kf_valid:
            # deterministic fallback: the smallest-id valid observer
            # (dict order and the dense mirror's slot order diverge after
            # swap-removes; min-id is representation-independent)
            ref = min(k for k in obs if k in self.kf_valid)
        dist = np.linalg.norm(pos - self.kf_center(ref))
        idx = obs.get(ref)
        level = int(self.kf_frame[ref].octave[idx]) if idx is not None else 0
        self.pt_max_dist[pid] = dist * self.scale_factors[level]
        self.pt_min_dist[pid] = self.pt_max_dist[pid] / self.scale_factors[-1]
        self.version += 1

    # ---- batched variants of the per-point maintenance methods: the
    # per-keyframe pipeline touches hundreds-to-thousands of points per
    # step, and per-point numpy calls dominated the host profile. Same
    # semantics as the scalar versions above (reference MapPoint.cpp:224-289
    # and :341-399), one vectorized pass.

    def compute_distinctive_descriptors_batch(self, pids):
        """Batched ComputeDistinctiveDescriptors over many points
        (reference MapPoint.cpp:206-270: per point, the observation
        descriptor with the least median Hamming distance to the others).

        Gathers ride the dense observation mirror and are vectorized per
        OBSERVING KEYFRAME — the per-point dict walk held the GIL for tens
        of milliseconds per fusion pass, stretching the tracker's locked
        host sections (r5 profile). Tie-breaking among equal medians picks
        the first observation slot, as the reference's running-min does
        over its (equally arbitrary) observation order."""
        self.version += 1
        pids = np.asarray(
            pids if isinstance(pids, np.ndarray) else list(pids), np.int64
        )
        if pids.size == 0:
            return
        pids = pids[self.valid_mask(pids)]
        if pids.size == 0:
            return
        rows = self.pt_obs_kf[pids]  # [P, D] observing kf ids (-1 empty)
        idxs = self.pt_obs_idx[pids]
        ok = (rows >= 0) & self.kf_valid.mask_of(rows)
        cnt = ok.sum(axis=1)
        alive = cnt >= 1
        pids, rows, idxs, ok, cnt = (
            pids[alive], rows[alive], idxs[alive], ok[alive], cnt[alive]
        )
        if pids.size == 0:
            return
        P, D = rows.shape
        arr = np.zeros((P, D, 8), np.uint32)
        for k in np.unique(rows[ok]):
            m = ok & (rows == k)
            arr[m] = self.kf_frame[int(k)].desc[idxs[m]]
        # compact valid observations to the front, trim to the max count
        order = np.argsort(~ok, axis=1, kind="stable")
        arr = np.take_along_axis(arr, order[:, :, None], axis=1)
        Dm = int(cnt.max())
        arr = arr[:, :Dm]

        single = cnt == 1
        if single.any():
            self.pt_desc[pids[single]] = arr[single, 0]
        multi = ~single
        if not multi.any():
            return
        arr, cnt, pids = arr[multi], cnt[multi], pids[multi]
        x = np.bitwise_xor(arr[:, :, None, :], arr[:, None, :, :]).view(np.uint8)
        dist = _POPCOUNT8[x].sum(axis=-1).astype(np.float64)  # [P, Dm, Dm]
        # mask invalid columns to +inf so sorting pushes them past the
        # valid prefix; np.median over the valid count via two middles
        col_valid = np.arange(Dm)[None, :] < cnt[:, None]
        dist = np.where(col_valid[:, None, :], dist, np.inf)
        dist.sort(axis=-1)
        lo = (cnt - 1) // 2
        hi = cnt // 2
        Pm = len(pids)
        lo_v = np.take_along_axis(
            dist, np.broadcast_to(lo[:, None, None], (Pm, Dm, 1)), axis=2
        )[..., 0]
        hi_v = np.take_along_axis(
            dist, np.broadcast_to(hi[:, None, None], (Pm, Dm, 1)), axis=2
        )[..., 0]
        med = 0.5 * (lo_v + hi_v)  # [P, Dm]
        med = np.where(col_valid, med, np.inf)
        best = np.argmin(med, axis=1)
        self.pt_desc[pids] = arr[np.arange(Pm), best]

    def update_normals_batch(self, pids):
        """Batched UpdateNormalAndDepth over many points, fully
        vectorized over the dense observation mirror — the per-point dict
        walk held the map lock ~0.5-1 s at whole-map scale (essential
        graph / GBA write-backs refresh all ~23k points)."""
        self.version += 1
        pids = np.asarray(pids, np.int64).ravel()
        if pids.size == 0:
            return
        pids = pids[self.valid_mask(pids)]
        if pids.size == 0:
            return
        rows_kf = self.pt_obs_kf[pids]  # [M,D]
        rows_ix = self.pt_obs_idx[pids]
        ok = self.kf_valid.mask_of(rows_kf)
        has = ok.any(axis=1)
        pids, rows_kf, rows_ix, ok = (
            pids[has], rows_kf[has], rows_ix[has], ok[has],
        )
        if pids.size == 0:
            return
        M = len(pids)
        # reference keyframe per point (falling back to the smallest-id
        # valid observer when the recorded ref is gone — matches the
        # scalar update_normal_and_depth)
        ref = self.pt_ref_kf[pids].copy()
        ref_ok = self.kf_valid.mask_of(ref)
        ar = np.arange(M)
        min_valid = np.where(
            ok, rows_kf.astype(np.int64), np.iinfo(np.int64).max
        ).min(axis=1)
        ref = np.where(ref_ok, ref, min_valid)
        # camera centers of every involved keyframe (observers + refs)
        uk = np.unique(np.concatenate([rows_kf[ok], ref]))
        C = np.stack([self.kf_center(int(k)) for k in uk])
        lut = np.full(int(uk.max()) + 2, 0, np.int64)
        lut[uk] = np.arange(len(uk))
        crow = lut[np.clip(rows_kf, 0, len(lut) - 1)]
        pos = self.pt_pos[pids]
        diff = pos[:, None, :] - C[crow]  # [M,D,3]
        n = np.linalg.norm(diff, axis=2)
        okn = ok & (n > 1e-12)
        unit = np.where(
            okn[..., None], diff / np.maximum(n, 1e-12)[..., None], 0.0
        )
        cnt = okn.sum(axis=1).astype(np.float64)
        sums = unit.sum(axis=1)
        # scale band: octave of the ref keyframe's observation (0 when the
        # ref does not observe the point — dict-version semantics)
        is_ref = ok & (rows_kf == ref[:, None])
        ref_has = is_ref.any(axis=1)
        ref_idx = rows_ix[ar, np.argmax(is_ref, axis=1)]
        lvl = np.zeros(M, np.int64)
        for k in np.unique(ref[ref_has]).tolist():
            selk = ref_has & (ref == k)
            lvl[selk] = self.kf_frame[k].octave[ref_idx[selk]]
        dist = np.linalg.norm(
            pos - C[lut[np.clip(ref, 0, len(lut) - 1)]], axis=1
        )
        maxd = dist * self.scale_factors[lvl]
        mind = maxd / self.scale_factors[-1]
        upd = cnt > 0
        self.pt_normal[pids[upd]] = sums[upd] / cnt[upd, None]
        self.pt_max_dist[pids[upd]] = maxd[upd]
        self.pt_min_dist[pids[upd]] = mind[upd]

    def predict_scale(self, pid: int, dist: float) -> int:
        """Reference MapPoint::PredictScale (MapPoint.cpp:367-399)."""
        ratio = self.pt_max_dist[pid] / max(dist, 1e-9)
        level = int(np.ceil(np.log(ratio) / self.log_scale))
        return min(max(level, 0), self.n_levels - 1)

    # ------------------------------------------------------------------
    # keyframe culling support
    # ------------------------------------------------------------------

    def remove_keyframe(self, kf: int):
        """SetBadFlag: detach observations, re-parent children via the
        covisibility-weighted BFS (reference KeyFrame.cpp:443-536, simplified
        to best-parent-candidate per child).

        Every observation the keyframe holds is erased, found through the
        observation mirror (`pt_obs_kf`), whether or not the keyframe's
        point slot still names the point: a slot goes stale when its point
        is replaced or moved. The JAX package erases only through the slots
        and so can leave a culled keyframe's observation behind."""
        if kf == 0 or kf not in self.kf_valid:
            return
        for okf in list(self.covis.get(kf, {})):
            self.covis[okf].pop(kf, None)
        for pid in np.nonzero((self.pt_obs_kf == kf).any(axis=1))[0].tolist():
            if pid not in self.pt_valid:
                continue
            obs = self.pt_obs[pid]
            idx = obs.pop(kf)
            self._obs_del(pid, kf)
            self.pt_nobs[pid] -= self._obs_weight(kf, int(idx))
            if self.pt_ref_kf[pid] == kf and obs:
                self.pt_ref_kf[pid] = next(iter(obs))
            if len(obs) <= 1:
                self.remove_point(pid)
        # re-parent children: candidates = parent + existing parents chain
        parent = self.parent.get(kf, 0)
        candidates = {parent}
        children = set(self.children.get(kf, ()))
        while children:
            best, best_w, best_parent = None, -1, None
            for ch in children:
                for cand in candidates:
                    w = self.covis.get(ch, {}).get(cand, 0)
                    if w > best_w:
                        best, best_w, best_parent = ch, w, cand
            if best is None or best_w <= 0:
                break
            self.parent[best] = best_parent
            self.children[best_parent].add(best)
            candidates.add(best)
            children.discard(best)
        for ch in children:  # leftovers hang from the original parent
            self.parent[ch] = parent
            self.children[parent].add(ch)
        self.children.get(parent, set()).discard(kf)
        # store relative pose for offline-trajectory recovery (System.cpp:342)
        self.Tcp[kf] = self.kf_pose[kf] @ np.linalg.inv(self.kf_pose[parent])
        self.kf_valid.discard(kf)
        if self.on_keyframe_removed is not None:
            self.on_keyframe_removed(kf)

    # ------------------------------------------------------------------
    # bulk views for device kernels
    # ------------------------------------------------------------------

    def points_array(self, pids):
        """Assemble dense arrays for a list/array of point ids (one
        vectorized gather per field)."""
        ids = np.asarray(pids, np.int64)
        return (
            self.pt_pos[ids].astype(np.float32),
            self.pt_desc[ids],
            self.pt_normal[ids].astype(np.float32),
            self.pt_min_dist[ids].astype(np.float32),
            self.pt_max_dist[ids].astype(np.float32),
        )

    def clear(self):
        # keep the shared lock and the database's erase hook across resets
        # (the JAX package's clear drops the hook: a reset then leaves
        # culled keyframes in the database)
        lock, hook = self.lock, self.on_keyframe_removed
        self.__init__(self.n_kp, self.n_levels, self.scale_factor)
        self.lock, self.on_keyframe_removed = lock, hook
