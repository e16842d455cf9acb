"""Local mapping: keyframe processing, triangulation, fusion, local BA,
keyframe culling.

Port of orbslam2_tpu/slam/local_mapping.py (reference src/LocalMapping.cpp)
for the stereo and the monocular sensor (mono: culling by 2 observations,
20 neighbours for triangulation with the baseline / median scene depth
rule, every point counted in keyframe culling). `insert_keyframe` queues a
keyframe; processing it
runs the steps of the reference's mapping thread: map-point culling, new
points triangulated against the covisible keyframes, duplicate fusion,
local bundle adjustment, keyframe culling. Every stage assembles under the
map lock, runs its device work unlocked, and applies under the lock. The
reference's stop/interrupt protocol (LocalMapping.cpp:534-607) is a set of
host flags.

Device work: one `matchers.epipolar_match` (K3 `mask`) launch per
covisible neighbour, then the triangulation and its gates as stacked
[K, N, ...] tensors over all neighbours at once; one
`matchers.fuse_match` (K3 `fuse`) launch per forward-fusion target and
one for backward fusion; the point-major BA of `ops/ba.py`. The JAX
package's shape policy (`select_top`, `bucket_select`) is not ported: with
its default pow2 policy those calls select nothing, and the one cap that
binds there, 16 fusion targets, is kept.
"""

from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

from .. import convert
from ..config import SlamConfig
from ..ops import ba, matchers
from .ba_assembly import apply_pm_result, assemble_pm_problem
from .frontend import Frontend
from .map import SlamMap

#: forward-fusion targets (1st + 2nd covisibility ring; the JAX package's
#: `ShapePolicy.fuse_targets_cap`, the reference walks up to ~35)
FUSE_TARGETS_CAP = 16


class LocalMapper:
    def __init__(self, config: SlamConfig, frontend: Frontend, slam_map: SlamMap,
                 deferred: bool = False):
        #: deferred=True: keyframes queue and the tracker processes one per
        #: frame through pump(), spreading the mapping cost over frames
        self.deferred = deferred
        self.config = config
        self.frontend = frontend
        self.device = frontend.device
        self.map = slam_map
        self.lock = slam_map.lock  # the map-update lock (mMutexMapUpdate)
        self.cam = frontend.camera
        self.recent_points: List[int] = []  # (for MapPointCulling)
        self._stopped = False
        self._accept = True
        self._abort_ba = False
        self._queue: List[int] = []
        self.n_processed = 0
        self.n_created = 0  # points created by triangulation
        self.n_local_ba = 0  # local bundle adjustments solved
        self._kfs_since_ba = 0
        self._kfs_since_fuse = 0
        self.on_processed = None  # downstream stage hook (loop closing)
        self.timers = None  # StageTimers, wired by System
        #: MappingWorker when the pipeline runs threaded; None = inline
        self.worker = None
        self._sf = frontend.scale_factors
        self._sig2 = torch.tensor(frontend.level_sigma2, dtype=torch.float32, device=self.device)
        self._inv_sig2 = frontend.inv_level_sigma2

    # ------------------------------------------------------- tracker API
    def is_stopped(self) -> bool:
        return self._stopped

    def accept_keyframes(self) -> bool:
        return self._accept

    def interrupt_ba(self):
        self._abort_ba = True

    def queue_size(self) -> int:
        return len(self._queue)

    def request_stop(self):
        """Reference LocalMapping::RequestStop (LocalMapping.cpp:556-561):
        also aborts a running BA so the worker parks promptly."""
        self._stopped = True
        self._abort_ba = True

    def wait_stopped(self, timeout: float = 60.0):
        """Wait until no keyframe is mid-processing (reference CorrectLoop's
        isStopped() wait, LoopClosing.cpp:412-415): the mapping worker
        parks after its keyframe in flight. Inline, the caller is the
        mapper's own keyframe pass (its `on_processed`), which has finished
        every mapping stage, so there is nothing to wait for."""
        if self.worker is not None:
            self.worker.wait_parked(timeout)

    def release(self):
        self._stopped = False

    # -------------------------------------------------------------------

    def insert_keyframe(self, kf: int):
        """Queue one keyframe (reference LocalMapping::InsertKeyFrame,
        LocalMapping.cpp:109-114). Threaded: wakes the mapping worker.
        Inline: processes it now (deferred: one per frame via pump())."""
        self._queue.append(kf)
        if self.worker is not None:
            self.worker.notify()
            return
        if self._stopped or self.deferred:
            return
        while self._queue:
            self._process(self._queue.pop(0))

    def pump(self):
        """Process one queued keyframe (deferred mode: once per tracked
        frame; threaded mode: the worker loop)."""
        if self._stopped or not self._queue:
            return
        self._process(self._queue.pop(0))

    def _span(self, name):
        return self.timers.span(name) if self.timers else contextlib.nullcontext()

    def _process(self, kf: int):
        """The mapping thread's loop body (reference LocalMapping::Run,
        LocalMapping.cpp:22-107)."""
        self._accept = False  # reference SetAcceptKeyFrames(false)
        try:
            with self.lock:
                # a queued keyframe may have been culled by an earlier
                # keyframe's culling pass
                if kf not in self.map.kf_valid:
                    return
                with self._span("Keyframe insertion"):
                    self.map.update_connections(kf)
                with self._span("Map point culling"):
                    self._cull_map_points(kf)
            with self._span("Map point creation"):
                self._create_new_points(kf)  # manages the lock itself
            # The reference fuses only when the queue is empty
            # (LocalMapping.cpp:76-79). A backed-up queue that starves
            # fusion is a feedback loop here (fresh stereo points die at the
            # age-2 cull without a fused observation, and the tracker's
            # need_close emergency floods the queue further), so fusion is
            # forced after 2 consecutive skips (documented deviation).
            self._kfs_since_fuse += 1
            if not self._queue or self._kfs_since_fuse >= 2:
                self._kfs_since_fuse = 0
                with self._span("Map point fusion"):
                    self._fuse_neighbors(kf)  # manages the lock itself
            # Local BA and keyframe culling: per keyframe when the queue is
            # empty (LocalMapping.cpp:64-73), forced after 3 keyframes
            # without one (documented deviation); skipped after a stop
            # request (LocalMapping.cpp:68)
            self._kfs_since_ba += 1
            if (self.map.n_keyframes() > 2 and (not self._queue or self._kfs_since_ba >= 3)
                    and not self._stopped):
                self._kfs_since_ba = 0
                self._abort_ba = False
                with self._span("Local BA"):
                    self._local_ba(kf)
                with self.lock:
                    with self._span("Keyframe culling"):
                        self._cull_keyframes(kf)
            self.n_processed += 1
            if self.on_processed is not None:
                self.on_processed(kf)
        finally:
            self._accept = True

    # -------------------------------------------------------------------

    def _cull_map_points(self, kf: int):
        """Reference LocalMapping::MapPointCulling (LocalMapping.cpp:165-195)."""
        if not self.recent_points:
            return
        m = self.map
        pids = np.asarray(self.recent_points, np.int64)
        pids = pids[m.valid_mask(pids)]
        found = m.pt_found[pids]
        visible = np.maximum(m.pt_visible[pids], 1)
        age = kf - m.pt_first_kf_id[pids]
        th_obs = 2 if self.config.monocular else 3
        remove = (found / visible < 0.25) | ((age >= 2) & (m.pt_nobs[pids] <= th_obs))
        for pid in pids[remove]:
            m.remove_point(int(pid))
        # age >= 3 survives culling and leaves the probation list
        self.recent_points = pids[~remove & (age < 3)].tolist()

    # -------------------------------------------------------------------

    def _fundamental(self, kf1: int, kf2: int) -> np.ndarray:
        """Reference LocalMapping::ComputeF12 (LocalMapping.cpp:512-532)."""
        T1 = self.map.kf_pose[kf1].astype(np.float64)
        T2 = self.map.kf_pose[kf2].astype(np.float64)
        T12 = T1 @ np.linalg.inv(T2)
        R12, t12 = T12[:3, :3], T12[:3, 3]
        tx = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]])
        c = self.config.camera
        Kinv = np.linalg.inv(np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]]))
        return (Kinv.T @ tx @ R12 @ Kinv).astype(np.float32)

    def _epipolar_batch(self, uv1, d1, free1, a1, s1, dep1, ur1, o1,
                        uv2, o2, d2, free2, a2, s2, dep2, ur2,
                        F, ep, T1, T2, Twc1, Twc2, O1, O2):
        """Match keyframe 1 against K neighbours and triangulate every match
        (the JAX package's `_epi_tri_one` over its neighbour axis; reference
        CreateNewMapPoints, LocalMapping.cpp:202-407). Keyframe-1 inputs are
        [N, ...] tensors, neighbour inputs stacked [K, M, ...], F [K, 3, 3],
        ep [K, 2], T2/Twc2 [K, 4, 4], O2 [K, 3]. Returns (m12 [K, N] match
        index or -1, x3d [K, N, 3], valid [K, N])."""
        c = self.config.camera
        fx, fy, cx, cy, bfv = c.fx, c.fy, c.cx, c.cy, c.bf
        b_half = float(self.config.baseline) / 2
        rfac = 1.5 * float(self.config.orb.scale_factor)
        K, M = uv2.shape[0], uv2.shape[1]
        m12 = torch.stack([
            matchers.epipolar_match(uv1, d1, free1, a1, s1, uv2[k], o2[k], d2[k], free2[k], a2[k],
                                    s2[k], F[k], ep[k], self._sf, self._sig2)[0]
            for k in range(K)
        ])  # [K, N]
        hit = m12 >= 0
        j = torch.clamp(m12, 0, M - 1).long()
        kp2 = torch.gather(uv2, 1, j[..., None].expand(-1, -1, 2))
        dep2m, ur2m = torch.gather(dep2, 1, j), torch.gather(ur2, 1, j)
        o2m, s2m = torch.gather(o2, 1, j).long(), torch.gather(s2, 1, j)

        def normalized(uv):
            return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy, torch.ones_like(uv[..., 0])], -1)

        xn1, xn2 = normalized(uv1), normalized(kp2)  # [N, 3], [K, N, 3]
        ray1 = xn1 @ T1[:3, :3]
        ray2 = xn2 @ T2[:, :3, :3]
        cos_rays = torch.sum(ray1 * ray2, -1) / torch.clamp(
            torch.linalg.vector_norm(ray1, dim=-1) * torch.linalg.vector_norm(ray2, dim=-1), min=1e-12)
        cos_st1 = torch.where(s1, torch.cos(2 * torch.atan2(torch.full_like(dep1, b_half),
                                                            torch.clamp(dep1, min=1e-9))), 2.0)
        cos_st2 = torch.where(s2m, torch.cos(2 * torch.atan2(torch.full_like(dep2m, b_half),
                                                             torch.clamp(dep2m, min=1e-9))), 2.0)
        cos_stereo = torch.minimum(cos_st1, cos_st2)
        use_tri = (cos_rays < cos_stereo) & (cos_rays > 0) & (s1 | s2m | (cos_rays < 0.9998))
        use_s1 = ~use_tri & s1 & (cos_st1 < cos_st2)
        use_s2 = ~use_tri & ~use_s1 & s2m & (cos_st2 < cos_st1)

        # DLT rows (reference LocalMapping.cpp:292-320) solved as the 3x3
        # normal equations B^T B x = -B^T b by cofactors, as the JAX package
        # does; the parallax and chi2 gates reject ill-conditioned cases
        r1 = torch.stack([xn1[:, 0:1] * T1[2] - T1[0], xn1[:, 1:2] * T1[2] - T1[1]], 1)  # [N, 2, 4]
        T2r = T2[:, None]
        r2 = torch.stack([xn2[..., 0:1] * T2r[..., 2, :] - T2r[..., 0, :],
                          xn2[..., 1:2] * T2r[..., 2, :] - T2r[..., 1, :]], 2)  # [K, N, 2, 4]
        A = torch.cat([r1.expand(K, -1, -1, -1), r2], dim=2)  # [K, N, 4, 4]
        B, bb = A[..., :3], A[..., 3]
        mm = B.transpose(-1, -2) @ B
        Btb = (B.transpose(-1, -2) @ bb[..., None])[..., 0]
        m_ = lambda a, b: mm[..., a, b]  # noqa: E731
        c00 = m_(1, 1) * m_(2, 2) - m_(1, 2) * m_(2, 1)
        c10 = m_(1, 2) * m_(2, 0) - m_(1, 0) * m_(2, 2)
        c20 = m_(1, 0) * m_(2, 1) - m_(1, 1) * m_(2, 0)
        c01 = m_(0, 2) * m_(2, 1) - m_(0, 1) * m_(2, 2)
        c11 = m_(0, 0) * m_(2, 2) - m_(0, 2) * m_(2, 0)
        c21 = m_(0, 1) * m_(2, 0) - m_(0, 0) * m_(2, 1)
        c02 = m_(0, 1) * m_(1, 2) - m_(0, 2) * m_(1, 1)
        c12 = m_(0, 2) * m_(1, 0) - m_(0, 0) * m_(1, 2)
        c22 = m_(0, 0) * m_(1, 1) - m_(0, 1) * m_(1, 0)
        det = m_(0, 0) * c00 + m_(0, 1) * c10 + m_(0, 2) * c20
        h_ok = torch.abs(det) >= 1e-18
        inv = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1),
                           torch.stack([c20, c21, c22], -1)], -2) / torch.where(h_ok, det, 1.0)[..., None, None]
        x_tri = -(inv @ Btb[..., None])[..., 0]

        def unproject(uv, dep, Twc):
            pc = torch.stack([(uv[..., 0] - cx) * dep / fx, (uv[..., 1] - cy) * dep / fy, dep], -1)
            return pc @ Twc[..., :3, :3].transpose(-1, -2) + Twc[..., None, :3, 3]

        x3d = torch.where(use_tri[..., None], x_tri,
                          torch.where(use_s1[..., None], unproject(uv1, dep1, Twc1), unproject(kp2, dep2m, Twc2)))
        valid = hit & ((use_tri & h_ok) | use_s1 | use_s2)

        # reprojection gates in both keyframes (chi2 5.991 / 7.8)
        for T, uv, urm, octv, st in ((T1, uv1, ur1, o1.long(), s1), (T2, kp2, ur2m, o2m, s2m)):
            pc = x3d @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
            z = pc[..., 2]
            zs = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
            u = fx * pc[..., 0] / zs + cx
            v = fy * pc[..., 1] / zs + cy
            ex, ey = u - uv[..., 0], v - uv[..., 1]
            er = torch.where(st, (u - bfv / zs) - urm, 0.0)
            e2 = ex * ex + ey * ey + er * er
            th = torch.where(st, 7.8, 5.991) * self._sig2[octv]
            valid &= (z > 0) & (e2 <= th)

        # scale-consistency gate (LocalMapping.cpp:389-400)
        d1n = torch.linalg.vector_norm(x3d - O1, dim=-1)
        d2n = torch.linalg.vector_norm(x3d - O2[:, None], dim=-1)
        ratio_dist = d2n / torch.clamp(d1n, min=1e-12)
        ratio_oct = self._sf[o1.long()] / torch.clamp(self._sf[o2m], min=1e-12)
        valid &= (d1n > 0) & (d2n > 0)
        valid &= ~((ratio_dist * rfac < ratio_oct) | (ratio_dist > ratio_oct * rfac))
        return m12, x3d, valid

    def _create_new_points(self, kf1: int):
        """Reference LocalMapping::CreateNewMapPoints (LocalMapping.cpp:197-431).

        Snapshot keyframe 1 and its neighbours under the map lock, match
        and triangulate unlocked, then write the new points back under the
        lock, re-checking validity (the map may have changed meanwhile)."""
        c = self.config.camera
        with self.lock:
            if kf1 not in self.map.kf_valid:
                return
            f1 = self.map.kf_frame[kf1]
            T1 = self.map.kf_pose[kf1].astype(np.float64).copy()
            O1 = self.map.kf_center(kf1)
            free1 = f1.valid & (self.map.kf_point[kf1] < 0)
            stereo1 = f1.u_right >= 0
            active = []
            mono = self.config.monocular
            for kf2 in self.map.covisible_keyframes(kf1, 20 if mono else 10):
                O2 = self.map.kf_center(kf2)
                baseline = np.linalg.norm(O2 - O1)
                if mono:
                    # baseline / median scene depth: skip a neighbour with
                    # next to no parallax (upstream LocalMapping.cpp)
                    med = self._median_scene_depth(kf2)
                    if med <= 0 or baseline / med < 0.01:
                        continue
                elif baseline < self.config.baseline:  # LocalMapping.cpp:232-239
                    continue
                f2 = self.map.kf_frame[kf2]
                T2 = self.map.kf_pose[kf2].astype(np.float64).copy()
                free2 = f2.valid & (self.map.kf_point[kf2] < 0)
                C2 = T2[:3, :3] @ O1 + T2[:3, 3]  # epipole: kf1's centre in kf2
                ep = np.array([c.fx * C2[0] / C2[2] + c.cx, c.fy * C2[1] / C2[2] + c.cy], np.float32)
                active.append((kf2, T2, O2, f2, free2, f2.u_right >= 0, self._fundamental(kf1, kf2), ep))
        if not active:
            return

        # --- unlocked: match and triangulate against every neighbour
        def up(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        def stack(name):
            return torch.stack([getattr(a[3].dev, name) for a in active])

        kf2s, T2s, O2s, _, free2s, stereo2s, Fs, eps = zip(*active)
        d1 = f1.dev
        m12, x3d, valid = self._epipolar_batch(
            d1.uv, d1.desc, up(free1, bool), d1.angle, up(stereo1, bool), d1.depth, d1.u_right, d1.octave,
            stack("uv"), stack("octave"), stack("desc"), up(np.stack(free2s), bool), stack("angle"),
            up(np.stack(stereo2s), bool), stack("depth"), stack("u_right"), up(np.stack(Fs)), up(np.stack(eps)),
            up(T1), up(np.stack(T2s)), up(np.linalg.inv(T1)), up(np.linalg.inv(np.stack(T2s))), up(O1),
            up(np.stack(O2s)),
        )
        m12_all, x3d_all, valid_all = m12.cpu().numpy(), x3d.cpu().numpy(), valid.cpu().numpy()
        results = []
        for j, kf2 in enumerate(kf2s):
            i1 = np.nonzero(valid_all[j] & (m12_all[j] >= 0))[0]
            if i1.size:
                results.append((kf2, i1, m12_all[j][i1].astype(np.int64), x3d_all[j][i1].astype(np.float64)))

        # --- locked: claim and allocate; a keypoint claimed by an earlier
        # neighbour is skipped (the sequential reference excluded it from
        # matching, LocalMapping.cpp:274-280)
        created = []
        with self.lock:
            if kf1 not in self.map.kf_valid:
                return
            m = self.map
            for kf2, i1, i2, x in results:
                if kf2 not in m.kf_valid:
                    continue
                keep = (m.kf_point[kf1][i1] < 0) & (m.kf_point[kf2][i2] < 0)
                if keep.any():
                    created.extend(self._commit_triangulated(kf1, kf2, i1[keep], i2[keep], x[keep]))
            if created:
                self.recent_points.extend(created)
                m.update_normals_batch(created)
                self.n_created += len(created)

    def _median_scene_depth(self, kf: int) -> float:
        """KeyFrame::ComputeSceneMedianDepth: the median depth of the
        keyframe's points in its camera, -1 without points."""
        T = self.map.kf_pose[kf].astype(np.float64)
        pids = self.map.kf_point[kf]
        ok = self.map.valid_mask(pids)
        if not ok.any():
            return -1.0
        return float(np.median(self.map.pt_pos[pids[ok]] @ T[2, :3] + T[2, 3]))

    def _commit_triangulated(self, kf1, kf2, a_idx, b_idx, x3d):
        """Allocate and register new points (the caller holds the map lock
        and refreshes normals and the recent-point list)."""
        m = self.map
        f1, f2 = m.kf_frame[kf1], m.kf_frame[kf2]
        n = len(a_idx)
        if n == 0:
            return []
        base = m._alloc_points(n)
        new_ids = np.arange(base, base + n)
        m.pt_pos[new_ids] = x3d
        # distinctive descriptor of a fresh 2-observation point is the first
        # observation's (both medians tie; argmin picks row 0)
        m.pt_desc[new_ids] = f1.desc[a_idx].astype(np.uint32)
        m.pt_ref_kf[new_ids] = kf1
        m.pt_first_kf_id[new_ids] = kf1
        m.pt_nobs[new_ids] = np.where(f1.u_right[a_idx] >= 0, 2, 1) + np.where(f2.u_right[b_idx] >= 0, 2, 1)
        for j in range(n):
            m.pt_obs[base + j] = {kf1: int(a_idx[j]), kf2: int(b_idx[j])}
        # dense mirror (rows are freshly allocated, already -1)
        m.pt_obs_kf[new_ids, 0] = kf1
        m.pt_obs_idx[new_ids, 0] = a_idx
        m.pt_obs_kf[new_ids, 1] = kf2
        m.pt_obs_idx[new_ids, 1] = b_idx
        m.pt_obs_n[new_ids] = 2
        m.kf_point[kf1][a_idx] = new_ids
        m.kf_point[kf2][b_idx] = new_ids
        return new_ids.tolist()

    # -------------------------------------------------------------------

    def _fuse_neighbors(self, kf: int):
        """Reference LocalMapping::SearchInNeighbors (LocalMapping.cpp:433-510).

        Assemble under the map lock, project (host frustum gates) and match
        both directions unlocked, apply the merges under the lock;
        `_apply_fuse_matches` re-validates every point."""
        with self.lock:
            if kf not in self.map.kf_valid:
                return
            targets = []
            for nb in self.map.covisible_keyframes(kf, 10):
                targets.append(nb)
                for nb2 in self.map.covisible_keyframes(nb, 5):
                    if nb2 != kf and nb2 not in targets:
                        targets.append(nb2)
            targets = targets[:FUSE_TARGETS_CAP]
            kp = self.map.kf_point[kf]
            fwd = self._assemble_fuse_forward_locked(targets, kp[self.map.valid_mask(kp)])
            bwd = self._assemble_fuse_backward_locked(kf, targets)
        # --- unlocked: frustum/scale projections, then the matches
        fwd = self._project_fuse_forward(fwd)
        bwd = self._project_fuse_backward(bwd)
        if fwd is None and bwd is None:
            return
        best_f, best_b = self._fuse_match(fwd, bwd)
        with self.lock:
            if kf not in self.map.kf_valid:
                return
            if fwd is not None:
                for i, (t, *_rest) in enumerate(fwd["rows"]):
                    if t in self.map.kf_valid:
                        self._apply_fuse_matches(t, fwd["pids"], best_f[i])
            if bwd is not None:
                self._apply_fuse_matches(kf, bwd["pids"], best_b)
            # refresh point stats and connections of the current keyframe
            kp = self.map.kf_point[kf]
            pids = kp[kp >= 0]
            self.map.compute_distinctive_descriptors_batch(pids)
            self.map.update_normals_batch(pids)
            self.map.update_connections(kf)

    def _fuse_match(self, fwd, bwd):
        """K3 `fuse` launches: one per forward target (the current
        keyframe's points projected into it), one for backward fusion (the
        targets' points projected into the current keyframe). Returns the
        per-point keypoint indices as numpy ([targets, P] and [P'])."""
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        def match(f, uv, ur, level, desc, visible):
            return matchers.fuse_match(f.uv, f.octave, f.u_right, f.desc, f.valid, uv, ur, level, desc,
                                       visible, self._sf, self._inv_sig2)[0]

        best_f = best_b = None
        if fwd is not None:
            rows = fwd["rows"]
            uv, ur, level, visible = (up(np.stack([r[k] for r in rows])) for k in range(1, 5))
            desc = convert.desc_to_torch(fwd["desc"], self.device)
            best_f = torch.stack([
                match(fwd["frames"][t].dev, uv[i], ur[i], level[i], desc, visible[i])
                for i, (t, *_rest) in enumerate(rows)
            ]).cpu().numpy()
        if bwd is not None:
            best_b = match(bwd["frame"].dev, up(bwd["uv"]), up(bwd["ur"]), up(bwd["level"]),
                           convert.desc_to_torch(bwd["desc"], self.device), up(bwd["visible"])).cpu().numpy()
        return best_f, best_b

    def _project_for_fuse(self, pos, normal, dmin, dmax, T, Ow):
        """Host frustum/scale gates for fusing points into one keyframe of
        pose T and centre Ow (the numpy half of ORBmatcher::Fuse). Returns
        (uv [P,2] f32, ur [P] f32, level [P] i32, visible [P] bool)."""
        c = self.config.camera
        pc = pos.astype(np.float64) @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = c.fx * pc[:, 0] / zs + c.cx
        v = c.fy * pc[:, 1] / zs + c.cy
        ur = u - c.bf / zs
        po = pos.astype(np.float64) - Ow
        dist = np.linalg.norm(po, axis=1)
        viewcos = np.einsum("ij,ij->i", po, normal) / np.maximum(dist, 1e-9)
        visible = (
            (z > 0) & (u >= 0) & (u < c.width) & (v >= 0) & (v < c.height)
            & (dist >= dmin) & (dist <= dmax) & (viewcos > 0.5)
        )
        ratio = dmax / np.maximum(dist, 1e-9)
        level = np.clip(np.ceil(np.log(np.maximum(ratio, 1e-9)) / self.map.log_scale),
                        0, self.map.n_levels - 1).astype(np.int32)
        return np.stack([u, v], -1).astype(np.float32), ur.astype(np.float32), level, visible

    def _apply_fuse_matches(self, kf: int, pids, best_idx):
        """Merge protocol per matched (point, keypoint) pair (reference
        ORBmatcher.cpp:795-818): replace the weaker of the two points, or add
        the observation. Descriptor refreshes are batched at the end."""
        kf_pids = self.map.kf_point[kf]
        survivors = []
        for j in np.nonzero(np.asarray(best_idx) >= 0)[0]:
            fi = int(best_idx[j])
            pid = self.map.resolve_replaced(int(pids[j]))
            if pid not in self.map.pt_valid or kf in self.map.pt_obs[pid]:
                continue
            existing = int(kf_pids[fi])
            if existing >= 0 and existing in self.map.pt_valid:
                # keep the one with more observations (ORBmatcher.cpp:795-807)
                if self.map.n_observations(existing) > self.map.n_observations(pid):
                    self.map.replace_point(pid, existing, refresh_desc=False)
                    survivors.append(existing)
                else:
                    self.map.replace_point(existing, pid, refresh_desc=False)
                    survivors.append(pid)
            else:
                self.map.add_observation(pid, kf, fi)
        if survivors:
            self.map.compute_distinctive_descriptors_batch(survivors)

    def _assemble_fuse_forward_locked(self, targets, pids):
        """Forward-fusion snapshot (the caller holds the map lock): the
        source points and each target's pose, centre and points."""
        pids = np.asarray(pids, np.int64)
        if pids.size == 0 or not targets:
            return None
        pos, desc, normal, dmin, dmax = self.map.points_array(pids)
        snaps = []
        for t in targets:
            if t not in self.map.kf_valid:
                continue
            tp = self.map.kf_point[t]
            snaps.append((t, self.map.kf_pose[t].astype(np.float64).copy(), self.map.kf_center(t),
                          tp[tp >= 0].copy()))
        if not snaps:
            return None
        frames = {s[0]: self.map.kf_frame[s[0]] for s in snaps}
        return dict(pids=pids, pos=pos, desc=desc, normal=normal, dmin=dmin, dmax=dmax, snaps=snaps,
                    frames=frames)

    def _assemble_fuse_backward_locked(self, kf: int, targets):
        """Backward-fusion snapshot (the caller holds the map lock): the
        targets' points that kf does not observe, and kf's pose and frame."""
        out = dict(frame=self.map.kf_frame[kf], pids=np.zeros(0, np.int64))
        if not targets:
            return out
        cands = np.unique(np.concatenate(
            [self.map.kf_point[t] for t in targets if t in self.map.kf_valid] or [np.zeros(0, np.int64)]))
        pids = cands[self.map.valid_mask(cands)]
        tp = self.map.kf_point[kf]
        pids = pids[~np.isin(pids, tp[tp >= 0])]
        if pids.size == 0:
            return out
        pos, desc, normal, dmin, dmax = self.map.points_array(pids)
        out.update(pids=pids, pos=pos, desc=desc, normal=normal, dmin=dmin, dmax=dmax,
                   T=self.map.kf_pose[kf].astype(np.float64).copy(), Ow=self.map.kf_center(kf))
        return out

    def _project_fuse_forward(self, fwd):
        """Unlocked frustum/scale gates per forward target; a target that
        sees none of the points is dropped."""
        if fwd is None:
            return None
        rows = []
        for t, T, Ow, tp_pids in fwd["snaps"]:
            uv, ur, level, visible = self._project_for_fuse(fwd["pos"], fwd["normal"], fwd["dmin"],
                                                            fwd["dmax"], T, Ow)
            visible &= ~np.isin(fwd["pids"], tp_pids)  # skip points the target observes
            if visible.any():
                rows.append((t, uv, ur, level, visible))
        if not rows:
            return None
        fwd["rows"] = rows
        return fwd

    def _project_fuse_backward(self, bwd):
        """Unlocked frustum/scale gates for backward fusion; only the
        visible points go to the device."""
        if bwd is None or bwd["pids"].size == 0:
            return None
        uv, ur, level, visible = self._project_for_fuse(bwd["pos"], bwd["normal"], bwd["dmin"],
                                                        bwd["dmax"], bwd["T"], bwd["Ow"])
        sel = np.nonzero(visible)[0]
        if sel.size == 0:
            return None
        bwd.update(pids=bwd["pids"][sel], uv=uv[sel], ur=ur[sel], level=level[sel], desc=bwd["desc"][sel],
                   visible=visible[sel])
        return bwd

    # -------------------------------------------------------------------

    def _local_ba(self, kf: int):
        """Assemble and solve the local bundle (reference
        Optimizer::LocalBundleAdjustment, src/Optimizer.cpp:426-787).
        Assembly and write-back hold the map lock; the solve does not, and
        the tracker's interrupt_ba() (reference mbAbortBA) stops it between
        LM phases, after which the partial estimate is written back."""
        with self.lock:
            prob, meta = self._assemble_local_ba(kf)
        if prob is None:
            return
        res = ba.ba_solve_pm_interruptible(
            convert.ba_problem_pm_to_torch(prob, self.device), self.cam,
            should_abort=lambda: self._abort_ba, sync_every=32,
        )
        with self.lock:
            apply_pm_result(self.map, res, meta)
        self.n_local_ba += 1

    def _assemble_local_ba(self, kf: int):
        local_kfs = [kf] + self.map.covisible_keyframes(kf)
        local_set = set(local_kfs)
        cand = np.unique(np.concatenate([self.map.kf_point[k] for k in local_kfs]))
        pts = [int(p) for p in cand[self.map.valid_mask(cand)]]
        fixed: List[int] = []
        fixed_set = set()
        for p in pts:
            for k in self.map.pt_obs[p]:
                if k not in local_set and k in self.map.kf_valid and k not in fixed_set:
                    fixed_set.add(k)
                    fixed.append(k)
        all_kfs = local_kfs + fixed
        kf_index = {k: i for i, k in enumerate(all_kfs)}
        pt_index = {p: i for i, p in enumerate(pts)}
        return assemble_pm_problem(self.map, self.frontend, all_kfs, pts, kf_index, pt_index, local_kfs)

    # -------------------------------------------------------------------

    def _cull_keyframes(self, kf: int):
        """Reference LocalMapping::KeyFrameCulling (LocalMapping.cpp:609-670):
        a local keyframe is redundant if > 90% of its (stereo: close) points are seen
        by >= 3 other keyframes at the same or a finer scale. Queued
        keyframes are never culled (the tracker links a keyframe at
        creation, so culling one before its own pass would drop its
        triangulation)."""
        m = self.map
        queued = set(self._queue)
        for k in m.covisible_keyframes(kf):
            if k == 0 or k not in m.kf_valid or k in queued:
                continue
            f = m.kf_frame[k]
            pids = m.kf_point[k]
            counted = m.valid_mask(pids)
            if not self.config.monocular:
                # stereo rule: only close points count (LocalMapping.cpp:628-631)
                counted &= (f.depth <= self.config.depth_threshold) & (f.depth >= 0)
            n_pts = int(counted.sum())
            if n_pts == 0:
                continue
            # only points seen > 3 times can be redundant; the octave walk
            # runs over the dense observation mirror
            cand = counted.copy()
            cand[counted] = m.pt_nobs[pids[counted]] > 3
            cand_idx = np.nonzero(cand)[0]
            if cand_idx.size == 0:
                continue
            pids_c = pids[cand_idx]
            rows_kf = m.pt_obs_kf[pids_c]  # [M, D]
            rows_ix = m.pt_obs_idx[pids_c]
            ok_slot = (rows_kf != k) & m.kf_valid.mask_of(rows_kf)
            oct_obs = np.full(rows_kf.shape, 99, np.int32)
            for uk in np.unique(rows_kf[ok_slot]).tolist():
                sel = ok_slot & (rows_kf == uk)
                oct_obs[sel] = m.kf_frame[uk].octave[rows_ix[sel]]
            fine = ok_slot & (oct_obs <= (f.octave[cand_idx] + 1)[:, None])
            if int((fine.sum(axis=1) >= 3).sum()) > 0.9 * n_pts:
                m.remove_keyframe(k)
