"""Tracking front end: the per-frame state machine (stereo and monocular).

Port of orbslam2_tpu/slam/tracking.py (reference src/Tracking.cpp:248-524):
stereo initialization, the steady-state fused frame step (`_full_step`:
ORB + stereo matching, motion-model matching and pose optimization,
local-map matching and pose optimization), the motion-model, local-map
and reference-keyframe paths that frame 1 and every motion failure take,
the keyframe decision and creation (handing each keyframe to the local
mapper), relocalization of a lost frame (through the `relocalizer` that
`System` wires when it is given a vocabulary; None otherwise, and a lost
tracker then stays lost), localization mode (`only_tracking`: no
keyframes, visual-odometry points from the last frame's close stereo
features, never fused), the motion model's re-anchoring after a loop
correction (`apply_pose_jump`) and trajectory bookkeeping. Host code is
control flow and map admin in numpy; matching and optimization run on the
tracker's device.

Monocular (`track_mono`, the config's sensor "monocular"): the two-view
initialization (a reference frame with > 100 keypoints, then the first
frame with >= 100 initialization matches that `ops/initializer.py`
accepts; the initial map scaled to unit median depth, >= 50 points), then
the unfused motion-model, reference-keyframe and local-map paths with the
monocular thresholds (motion-model window 15, th_ref 0.9, no close-point
rule) and keyframes without stereo points: the mapper triangulates them.
The initialization matches go through K3 `mask` (caller `mono_init`).

Pipelined tracking (`config.pipelined_tracking`, JAX slam/tracking.py:
429-476): while the fused step applies and the last frame kept at least
`config.pipeline_min_inliers` inliers, frame i's fused step is enqueued on
the device with no host wait, its outputs and features copied to pinned
host buffers behind it (`_HostCopy`), and frame i-1's results applied
meanwhile; `track` then returns frame i's motion-model prediction, and the
trajectory records each solved pose when the next frame applies it. A
frame that leaves the state not OK re-tracks the frames behind it from
their features by the unfused paths (`flush_pipeline(legacy=True)`).
"""

from __future__ import annotations

import contextlib
import enum
from typing import List, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import hamming, initializer, matchers, pose_opt
from .frontend import FrameHost, Frontend, stack_images
from .map import SlamMap


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class TrajectoryEntry:
    __slots__ = ("Tcr", "ref_kf", "timestamp", "lost", "Tcw")

    def __init__(self, Tcr, ref_kf, timestamp, lost, Tcw):
        self.Tcr = Tcr
        self.ref_kf = ref_kf
        self.timestamp = timestamp
        self.lost = lost
        self.Tcw = Tcw  # online pose snapshot (reference System.cpp:134-135)


def _rows(idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """values[clip(idx)] as float32 rows (the JAX package's one-hot matmul)."""
    return values[torch.clamp(idx.long(), 0, values.shape[0] - 1)].to(torch.float32)


class _HostCopy:
    """The fused step's outputs (a dict of tensors) and, optionally, the
    frame's features copied to the host without a host wait (the JAX
    package's `copy_to_host_async`, then one `device_get`): on a card,
    pinned buffers filled by non-blocking copies on the current stream and
    an event recorded behind them. `wait()` waits on that event alone and
    returns (the outputs as numpy, the features as host tensors). CPU
    tensors are their own host copy."""

    def __init__(self, outputs: dict, features=()):
        self.names = list(outputs)
        tensors = [outputs[k] for k in self.names] + list(features)
        self.event = None
        if tensors[0].device.type != "cuda":
            self.host = tensors
            return
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        n = len(self.names)
        return {k: t.numpy() for k, t in zip(self.names, self.host[:n])}, self.host[n:]


def _u8(images):
    """Images as uint8, rounded and clipped where they are not (a tensor
    stays where it lies)."""
    if isinstance(images, torch.Tensor):
        return images if images.dtype == torch.uint8 else torch.round(images).clamp(0, 255).to(torch.uint8)
    return images if images.dtype == np.uint8 else np.clip(np.rint(images), 0, 255).astype(np.uint8)


class Tracker:
    def __init__(self, config: SlamConfig, frontend: Frontend, slam_map: SlamMap):
        self.config = config
        self.frontend = frontend
        self.device = frontend.device
        self.map = slam_map
        self.local_mapper = None  # LocalMapper, wired by System
        self.relocalizer = None  # Relocalizer, wired by System with a vocabulary
        #: the early-loss reset: System.reset, wired by System, which also
        #: clears the database, the mapper's queue and the loop state;
        #: None resets the tracker and the map alone
        self.on_reset = None
        #: localization mode: track against the map without mapping
        self.only_tracking = False
        self.cam = frontend.camera
        self.state = TrackingState.NO_IMAGES_YET
        self.velocity: Optional[np.ndarray] = None  # Tcl (cur <- last)
        #: the velocity before `velocity` (None after a loss): the pipelined
        #: prediction spans two frames with their product
        self.prev_velocity: Optional[np.ndarray] = None
        self.last_frame: Optional[FrameHost] = None
        #: the last stereo pair as given (a reference, not a copy), for
        #: `System.shutdown(measure_frontend_split=True)`
        self.last_images = None
        self.ref_kf: Optional[int] = None
        self.last_kf_id = 0  # frame id at last KF insertion
        self.last_reloc_frame_id = 0
        self.frame_id = 0
        self.min_frames = config.min_frames
        self.max_frames = config.max_frames
        self.trajectory: List[TrajectoryEntry] = []
        self.local_keyframes: List[int] = []
        self.local_points: List[int] = []
        self.n_inliers = 0
        self.timers = None  # StageTimers, wired by System
        #: tracking-failure breadcrumbs: which gate failed, with its count
        self.events: List[dict] = []

        self._N = config.orb.n_features
        self._sf = frontend.scale_factors
        self._lvl_sig2 = torch.tensor(
            frontend.level_sigma2, dtype=torch.float32, device=self.device
        )
        self._log_scale = float(np.log(config.orb.scale_factor))
        #: device-resident local-candidate cache: ids, device tensors, version
        self._cand_cache = None
        #: monocular: the reference frame of the two-view initialization
        self._init_ref: Optional[FrameHost] = None
        #: pipelined tracking (config.pipelined_tracking): the frames whose
        #: fused step was dispatched and not applied yet, oldest first, as
        #: (FrameHost, aux, _HostCopy of the step outputs and features)
        self.pipelined = bool(config.pipelined_tracking)
        self._pending: List[tuple] = []

    # ------------------------------------------------------------------
    # device steps

    def _frame_obs(self, fd):
        obs = torch.cat([fd.uv, fd.u_right[:, None]], dim=1).to(torch.float32)
        return obs, fd.u_right >= 0, 1.0 / self._lvl_sig2[fd.octave.long()]

    def _project(self, T, pw):
        """(u, v, z, zs) of world points under T with the config intrinsics."""
        c = self.config.camera
        pc = torch.einsum("ij,nj->ni", T[:3, :3], pw) + T[:3, 3]
        z = pc[:, 2]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        u = c.fx * pc[:, 0] / zs + c.cx
        v = c.fy * pc[:, 1] / zs + c.cy
        return u, v, z, zs

    def _in_image(self, u, v, z):
        c = self.config.camera
        return (z > 0) & (u >= 0) & (u < float(c.width)) & (v >= 0) & (v < float(c.height))

    def _motion_match(self, fd, src_pw, src_has, src_desc, oct_src, ang_src,
                      T_pred, th: float, fwd: bool, bwd: bool, no_wait: bool = False):
        """Project last-frame points under the predicted pose and match,
        with the reference's widen-on-few retry (Tracking.cpp:736-741).
        With `no_wait` both windows are matched and the retry's choice is
        made on the device, so the host never reads the match count (the
        pipelined dispatch); the result is the same."""
        u, v, z, _ = self._project(T_pred, src_pw)
        proj_valid = src_has & self._in_image(u, v, z)
        uvp = torch.stack([u, v], dim=-1).to(torch.float32)

        def match(t):
            pfk, _ = matchers.search_by_projection_frame(
                fd.uv, fd.octave, fd.desc, fd.valid, fd.angle,
                uvp, oct_src, src_desc, proj_valid, ang_src, self._sf, t, fwd, bwd,
            )
            return pfk

        pfk = match(th)
        if no_wait:
            return torch.where((pfk >= 0).sum() < 20, match(2.0 * th), pfk)
        if int((pfk >= 0).sum()) < 20:
            pfk = match(2.0 * th)
        return pfk

    def _motion_step(self, fd, pw_src, src_valid, oct_src, ang_src, desc_src,
                     T_pred, th: float, fwd: bool, bwd: bool):
        """TrackWithMotionModel device body: match, then pose-optimize."""
        pfk = self._motion_match(fd, pw_src, src_valid, desc_src, oct_src, ang_src,
                                 T_pred, th, fwd, bwd)
        obs, is_stereo, inv_sig = self._frame_obs(fd)
        res = pose_opt.pose_optimize(
            T_pred, _rows(pfk, pw_src), obs, inv_sig, is_stereo, pfk >= 0, self.cam
        )
        return pfk, res

    def _local_step(self, fd, kp_free, pw_exist, valid_exist, cand_uvp, cand_ur,
                    cand_level, cand_vcos, cand_desc, cand_visible, cand_pos, T0, th: float):
        """TrackLocalMap device body: match unmatched keypoints against the
        projected local points, merge with the existing associations,
        pose-optimize."""
        pfk, _ = matchers.search_by_projection_points(
            fd.uv, fd.octave, fd.u_right, fd.desc, kp_free,
            cand_uvp, cand_ur, cand_level, cand_vcos, cand_desc, cand_visible, self._sf, th,
        )
        valid_i = valid_exist | (pfk >= 0)
        pw_i = torch.where(valid_exist[:, None], pw_exist, _rows(pfk, cand_pos))
        obs, is_stereo, inv_sig = self._frame_obs(fd)
        res = pose_opt.pose_optimize(T0, pw_i, obs, inv_sig, is_stereo, valid_i, self.cam)
        return pfk, res

    def _full_step(self, images_u8, src_pw, src_has, src_desc, oct_src,
                   ang_src, src_cand_row, T_pred, th, fwd, bwd,
                   cand_pos, cand_desc, cand_normal, cand_dmin,
                   cand_dmax, cand_ok, th_local, no_wait: bool = False):
        """The steady-state stereo frame (orbslam2_tpu/slam/tracking.py
        `_full_step`): frontend, motion-model matching + pose optimization,
        local-map frustum culling + matching + pose optimization, and the
        keyframe-decision counts. Returns (FrameFeatures, dict of tensors).
        With `no_wait` (the pipelined dispatch) no step reads a device value
        on the host (`_motion_match`)."""
        fd = self.frontend.features_body(images_u8.to(torch.float32))

        # motion-model matching + first pose optimization
        # (reference TrackWithMotionModel, Tracking.cpp:714-772)
        pfk = self._motion_match(fd, src_pw, src_has, src_desc, oct_src, ang_src,
                                 T_pred, th, fwd, bwd, no_wait)
        hit1 = pfk >= 0
        pw1 = _rows(pfk, src_pw)
        obs, is_stereo, inv_sig = self._frame_obs(fd)
        res1 = pose_opt.pose_optimize(T_pred, pw1, obs, inv_sig, is_stereo, hit1, self.cam)
        keep1 = hit1 & res1.inlier

        # local candidates: project + frustum under the optimized pose
        # (reference SearchLocalPoints, Tracking.cpp:979-1038)
        T1 = res1.Tcw
        R1, t1 = T1[:3, :3], T1[:3, 3]
        u2, v2, z2, zs2 = self._project(T1, cand_pos)
        ur2 = u2 - self.config.camera.bf / zs2
        Ow = -torch.einsum("ji,j->i", R1, t1)
        po = cand_pos - Ow
        dist = torch.linalg.vector_norm(po, dim=1)
        viewcos = torch.sum(po * cand_normal, dim=1) / torch.clamp(dist, min=1e-9)
        visible = (
            self._in_image(u2, v2, z2)
            & (dist >= 0.8 * cand_dmin) & (dist <= 1.2 * cand_dmax)
            & (viewcos > 0.5) & cand_ok
        )
        ratio = cand_dmax / torch.clamp(dist, min=1e-9)
        level = torch.clamp(
            torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / self._log_scale),
            0, self.config.orb.n_levels - 1,
        ).to(torch.int32)

        # exclude candidates already matched by the motion step (reference
        # mnLastFrameSeen gate, Tracking.cpp:985-991)
        S, P = src_pw.shape[0], cand_pos.shape[0]
        src_matched = torch.zeros(S, dtype=torch.int32, device=pfk.device).index_add(
            0, torch.clamp(pfk.long(), 0, S - 1), keep1.to(torch.int32)
        ) > 0
        cand_matched = torch.zeros(P, dtype=torch.int32, device=pfk.device).index_add(
            0, torch.clamp(src_cand_row.long(), 0, P - 1),
            (src_matched & (src_cand_row >= 0)).to(torch.int32),
        ) > 0
        search = visible & ~cand_matched

        pfk2, _ = matchers.search_by_projection_points(
            fd.uv, fd.octave, fd.u_right, fd.desc, fd.valid & ~keep1,
            torch.stack([u2, v2], -1).to(torch.float32), ur2.to(torch.float32), level,
            viewcos.to(torch.float32), cand_desc, search, self._sf, th_local,
        )
        valid_i = keep1 | (pfk2 >= 0)
        pw_i = torch.where(keep1[:, None], pw1, _rows(pfk2, cand_pos))
        res2 = pose_opt.pose_optimize(T1, pw_i, obs, inv_sig, is_stereo, valid_i, self.cam)

        # keyframe-decision counts (reference Tracking.cpp:846-861)
        close = fd.valid & (fd.depth > 0) & (fd.depth < float(self.config.depth_threshold))
        assoc = valid_i & res2.inlier
        host = dict(
            pfk=pfk, keep1=keep1, pfk2=pfk2, valid_i=valid_i,
            inlier2=res2.inlier, Tcw=res2.Tcw, n_match1=hit1.sum(),
            visible=search,
            n_close_tracked=(close & assoc).sum(),
            n_close_free=(close & ~assoc).sum(),
        )
        return fd, host

    # ------------------------------------------------------------------

    def _span(self, name):
        return self.timers.span(name) if self.timers else contextlib.nullcontext()

    def _deferred_mapping(self) -> bool:
        return self.local_mapper is not None and self.local_mapper.deferred

    def _can_fuse(self) -> bool:
        """The fused step covers the steady-state stereo hot path; every
        other state, the monocular sensor, localization mode
        (visual-odometry points) and deferred mapping (which pumps the
        mapper between the steps) route through the motion-model /
        reference-keyframe paths."""
        return (
            self.state == TrackingState.OK
            and self.velocity is not None
            and not self.only_tracking
            and not self.config.monocular
            and self.frame_id >= self.last_reloc_frame_id + 2
            and not self._deferred_mapping()
            and len(self.local_points) > 0
        )

    def track(self, im_left, im_right, timestamp: float) -> Optional[np.ndarray]:
        """Process one stereo frame (numpy arrays, or tensors, which stay on
        the device); returns Tcw or None when lost."""
        self.last_images = (im_left, im_right)
        if self.local_mapper is not None:
            self.local_mapper.wait_for_room()
        images_u8 = _u8(stack_images(im_left, im_right))
        if self._can_fuse():
            # adaptive pipelining: hide the device round trip only while
            # support is comfortable (the one-frame lag costs matches)
            if self.pipelined and self.n_inliers >= self.config.pipeline_min_inliers:
                return self._track_pipelined(images_u8, timestamp)
            self.flush_pipeline()
            with self._span("Fused assemble"):
                with self.map.lock:
                    args, aux = self._assemble_fused(images_u8)
            with self._span("Fused frame step"):
                feats, host = self._full_step(*args)
                host = _HostCopy(host).wait()[0]
            frame = FrameHost(feats, timestamp, self.frame_id, eager=False)
            self.frame_id += 1
            with self._span("Fused apply"):
                with self.map.lock:
                    self._track(frame, fused=(host, aux))
            return frame.Tcw if self.state == TrackingState.OK else None
        self.flush_pipeline()
        with self._span("ORB extraction + stereo matching"):
            feats = self.frontend.process(images_u8[0], images_u8[1])
        frame = FrameHost(feats, timestamp, self.frame_id)
        self.frame_id += 1
        with self.map.lock:
            self._track(frame)
        return frame.Tcw if self.state == TrackingState.OK else None

    def _set_velocity(self, v: Optional[np.ndarray]):
        """The motion model's velocity, the previous one kept (dropped with
        it on a loss)."""
        self.prev_velocity = None if v is None else self.velocity
        self.velocity = v

    def _track_pipelined(self, images_u8, timestamp: float) -> np.ndarray:
        """Dispatch frame i's fused step, then apply the frames before it
        (their device work overlapped this frame's host work). Returns the
        motion-model PREDICTED pose of frame i; the trajectory records
        solved poses when they are applied, one frame later."""
        steps = 1 + len(self._pending)
        with self._span("Fused assemble"):
            with self.map.lock:
                args, aux = self._assemble_fused(images_u8, pred_steps=steps)
        with self._span("Fused dispatch"):
            feats, host = self._full_step(*args, no_wait=True)
            copy = _HostCopy(host, feats)
        frame = FrameHost(feats, timestamp, self.frame_id, eager=False)
        self.frame_id += 1
        self._pending.append((frame, aux, copy))
        while len(self._pending) > 1:
            self._apply_one()
        return aux["T_pred"]

    def _pop_pending(self):
        """The oldest dispatched frame with its host copy attached, and its
        (step outputs, aux)."""
        frame, aux, copy = self._pending.pop(0)
        with self._span("Fused frame step"):
            host, features = copy.wait()
        frame.attach_host(features)
        return frame, host, aux

    def _apply_one(self):
        """Apply the oldest dispatched frame's results (waits on its copy
        only if the device has not finished it)."""
        frame, host, aux = self._pop_pending()
        with self._span("Fused apply"):
            with self.map.lock:
                self._track(frame, fused=(host, aux))
        if self.state != TrackingState.OK:
            # the frames behind a failed one were predicted from a bad pose:
            # re-track them by the unfused paths
            self.flush_pipeline(legacy=True)

    def flush_pipeline(self, legacy: bool = False):
        """Apply every dispatched frame; legacy=True discards their fused
        results and re-tracks them from their features."""
        while self._pending:
            if not legacy:
                self._apply_one()
                continue
            frame = self._pop_pending()[0]
            with self.map.lock:
                self._track(frame)

    def track_mono(self, image, timestamp: float) -> Optional[np.ndarray]:
        """Process one monocular frame (upstream GrabImageMonocular); returns
        Tcw, or None when lost or not initialized yet."""
        if self.local_mapper is not None:
            self.local_mapper.wait_for_room()
        with self._span("ORB extraction"):
            feats = self.frontend.process_mono(image)
        frame = FrameHost(feats, timestamp, self.frame_id)
        self.frame_id += 1
        with self.map.lock:
            self._track(frame)
        return frame.Tcw if self.state == TrackingState.OK else None

    def _track(self, frame: FrameHost, fused=None):
        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            self.state = TrackingState.NOT_INITIALIZED
            if self.config.monocular:
                self._monocular_initialization(frame)
            else:
                self._stereo_initialization(frame)
            if self.state == TrackingState.OK:
                self._record_trajectory(frame)
            self.last_frame = frame
            return

        ok = False
        local_done = False
        if self.state == TrackingState.OK:
            if fused is not None:
                status = self._apply_fused(frame, *fused)
                if status == "motion_fail":
                    with self._span("Pose prediction"):
                        ok = self._track_reference_keyframe(frame)
                else:
                    ok = status == "ok"
                    local_done = True
            else:
                if self._deferred_mapping():
                    self.local_mapper.pump()
                self._check_replaced_in_last_frame()
                with self._span("Pose prediction"):
                    if self.velocity is None or frame.frame_id < self.last_reloc_frame_id + 2:
                        ok = self._track_reference_keyframe(frame)
                    else:
                        ok = self._track_with_motion_model(frame)
                        if not ok:
                            ok = self._track_reference_keyframe(frame)
        else:  # LOST
            with self._span("Relocalization"):
                ok = self._relocalize(frame)

        if ok and not local_done:
            with self._span("Local map tracking"):
                ok = self._track_local_map(frame)

        if ok:
            self.state = TrackingState.OK
            # motion model velocity: Tcl = Tcw_cur @ Twc_last
            if self.last_frame.Tcw is not None:
                self._set_velocity(frame.Tcw @ np.linalg.inv(self.last_frame.Tcw))
            else:
                self._set_velocity(None)
            with self._span("New keyframe decision"):
                need_kf = self._need_new_keyframe(frame)
            if need_kf:
                with self._span("New keyframe creation"):
                    self._create_new_keyframe(frame)
            frame.point_ids[frame.outlier] = -1
            frame.outlier[:] = False
        else:
            self.state = TrackingState.LOST
            self._set_velocity(None)
            if self.map.n_keyframes() <= 5:
                # early loss: reset (reference Tracking.cpp:485-492)
                (self.on_reset or self.reset)()
                return

        self._record_trajectory(frame)
        self.last_frame = frame

    # ------------------------------------------------------------------

    def _stereo_initialization(self, frame: FrameHost):
        """Reference Tracking::StereoInitialization (Tracking.cpp:527-581)."""
        if frame.n_keypoints <= 500:
            return
        frame.Tcw = np.eye(4, dtype=np.float32)
        kf = self.map.add_keyframe(frame, frame.Tcw)
        idxs = np.nonzero(frame.valid & (frame.depth > 0))[0]
        pids = self.map.add_stereo_points_batch(frame, kf, idxs, self.config.camera)
        frame.point_ids[idxs] = pids
        self.map.kf_point[kf] = frame.point_ids.copy()
        self.map.keyframe_origins.append(kf)
        self.ref_kf = kf
        self.last_kf_id = frame.frame_id
        self.local_keyframes = [kf]
        self.local_points = self.map.pt_ids()
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)
        self.state = TrackingState.OK

    def _monocular_initialization(self, frame: FrameHost):
        """Two-view bootstrap (upstream Tracking::MonocularInitialization):
        a reference frame with > 100 keypoints, then per frame the
        initialization matches against it (< 100 drops the reference) and
        the two-view initializer on 200 hypotheses drawn from a CPU generator
        seeded with the frame id (the JAX package's PRNGKey(frame id))."""
        ref = self._init_ref
        if ref is None:
            if frame.n_keypoints > 100:
                self._init_ref = frame
            return
        if frame.n_keypoints <= 100:
            self._init_ref = None
            return
        matches = self._match_for_initialization(ref, frame)
        if int((matches >= 0).sum()) < 100:
            self._init_ref = None
            return
        N = self._N
        valid = matches >= 0
        uv1 = np.zeros((N, 2), np.float32)
        uv2 = np.zeros((N, 2), np.float32)
        uv1[valid] = ref.uv[valid]
        uv2[valid] = frame.uv[matches[valid]]
        # drawn on the CPU: the card initializes as the CPU path does (a CUDA
        # generator draws other numbers from the same seed)
        generator = torch.Generator().manual_seed(frame.frame_id)
        res = initializer.initialize_two_view(self._tensor(uv1), self._tensor(uv2), self._tensor(valid),
                                              self.cam, generator)
        if not bool(res.success):
            return
        self._create_initial_map_monocular(ref, frame, matches, res)

    def _match_for_initialization(self, ref: FrameHost, cur: FrameHost) -> np.ndarray:
        """SearchForInitialization (ORBmatcher window 100, octave 0 on both
        sides, ratio 0.9, rotation check): the gate built here, the best and
        second best by K3 `mask` (caller `mono_init`), then the collisions
        resolved by distance (the JAX package walks the rows in order of
        distance; ties here go to the lowest row). Returns per reference
        keypoint its index in cur (-1 none)."""
        rd, cd = ref.dev, cur.dev
        du = torch.abs(rd.uv[:, 0, None] - cd.uv[None, :, 0])
        dv = torch.abs(rd.uv[:, 1, None] - cd.uv[None, :, 1])
        octave0 = (rd.octave == 0)[:, None] & (cd.octave == 0)[None, :]
        mask = (du <= 100) & (dv <= 100) & octave0 & rd.valid[:, None] & cd.valid[None, :]
        idx, best, _, second = hamming.best2(rd.desc, cd.desc, mask, caller="mono_init")
        ok = (best < hamming.TH_LOW) & (best < 0.9 * second)
        keep = matchers.rotation_consistency_mask(rd.angle, cd.angle[idx.long()], ok)
        # a current keypoint claimed twice goes to the best distance
        src, _ = matchers._resolve_collisions(idx, torch.where(keep, best, hamming.MAX_DIST), cd.valid.shape[0])
        src = src.cpu().numpy()
        out = np.full(self._N, -1, np.int64)
        out[src[src >= 0]] = np.nonzero(src >= 0)[0]
        return out

    def _create_initial_map_monocular(self, ref: FrameHost, frame: FrameHost, matches, res):
        """CreateInitialMapMonocular: two keyframes, the triangulated points,
        the map scaled to unit median depth; fewer than 50 points clear the
        map and drop the reference."""
        T21 = res.T21.cpu().numpy()
        point_ok = res.point_ok.cpu().numpy()
        X = res.points.cpu().numpy()
        ref.Tcw = np.eye(4, dtype=np.float32)
        frame.Tcw = T21.astype(np.float32)
        m = self.map
        kf1 = m.add_keyframe(ref, ref.Tcw)
        kf2 = m.add_keyframe(frame, frame.Tcw)
        created, depths = [], []
        for i in np.nonzero((matches >= 0) & point_ok)[0]:
            j = int(matches[i])
            pid = m.add_point(X[i], kf1, ref.desc[i])
            m.add_observation(pid, kf1, int(i))
            m.add_observation(pid, kf2, j)
            m.compute_distinctive_descriptor(pid)
            ref.point_ids[i] = pid
            frame.point_ids[j] = pid
            created.append(pid)
            depths.append(X[i][2])
        m.kf_point[kf1] = ref.point_ids.copy()
        m.kf_point[kf2] = frame.point_ids.copy()
        m.update_connections(kf1)
        m.update_connections(kf2)

        # scale: unit median depth of the points in frame 1
        med = float(np.median(depths)) if depths else 0.0
        if med <= 0 or len(created) < 50:
            m.clear()
            self._init_ref = None
            return
        inv_med = 1.0 / med
        frame.Tcw[:3, 3] *= inv_med
        m.kf_pose[kf2] = frame.Tcw.copy()
        for pid in created:
            m.pt_pos[pid] = m.pt_pos[pid] * inv_med
            m.update_normal_and_depth(pid)

        m.keyframe_origins.append(kf1)
        self.ref_kf = kf2
        self.last_kf_id = frame.frame_id
        self.local_keyframes = [kf1, kf2]
        self.local_points = list(created)
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf1)
            self.local_mapper.insert_keyframe(kf2)
        self._set_velocity(None)
        self._init_ref = None
        self.state = TrackingState.OK

    # ------------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        """A numpy array or a tensor on the tracker's device, uploaded
        without a host wait: to a card from pinned memory by a non-blocking
        copy (an upload from pageable memory waits for the stream's queued
        work, which would serialise the pipelined frames). Descriptor words
        (uint32) arrive as int32 holding the same bits."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, non_blocking=True)
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
        return t.pin_memory().to(self.device, non_blocking=True) if self.device.type == "cuda" else t

    def _check_replaced_in_last_frame(self):
        """Point the last frame's matches at the points that fusion merged
        theirs into (reference Tracking::CheckReplacedInLastFrame)."""
        lf = self.last_frame
        if not self.map.pt_replaced:
            return
        for i in np.nonzero(lf.point_ids >= 0)[0]:
            pid = int(lf.point_ids[i])
            r = self.map.resolve_replaced(pid)
            if r != pid:
                lf.point_ids[i] = r if r in self.map.pt_valid else -1

    def _unproject(self, frame: FrameHost, i: int) -> np.ndarray:
        """World position of keypoint i from its stereo depth."""
        z = frame.depth[i]
        u, v = frame.uv[i]
        cam = self.config.camera
        pc = np.array([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy, z, 1.0])
        return (np.linalg.inv(frame.Tcw) @ pc)[:3]

    def _pose_optimize(self, frame: FrameHost) -> int:
        """Pose optimization on the frame's current matches."""
        pw, valid = self._assemble_existing(frame)
        if valid.sum() < 3:
            return 0
        obs = np.concatenate([frame.uv, frame.u_right[:, None]], axis=1).astype(np.float32)
        inv_sig = (1.0 / self.frontend.level_sigma2[frame.octave]).astype(np.float32)
        res = pose_opt.pose_optimize(
            self._tensor(frame.Tcw.astype(np.float32)), self._tensor(pw), self._tensor(obs),
            self._tensor(inv_sig), self._tensor(frame.u_right >= 0), self._tensor(valid),
            self.cam,
        )
        frame.Tcw = res.Tcw.cpu().numpy()
        frame.outlier = valid & ~res.inlier.cpu().numpy()
        return int(res.n_inliers)

    def _discard_outliers(self, frame: FrameHost) -> int:
        """Post-optimization bookkeeping shared by both tracking modes."""
        has = frame.point_ids >= 0
        bad = has & frame.outlier
        frame.point_ids[bad] = -1
        frame.outlier[bad] = False
        good = has & ~bad
        return int((self.map.pt_nobs[frame.point_ids[good]] > 0).sum())

    def _refresh_candidate_cache(self):
        """Device-resident local-map candidate tables, re-uploaded only when
        the local-point set or the map version changed."""
        m = self.map
        ids = np.asarray(self.local_points, np.int64)
        if ids.size:
            ids = ids[m.valid_mask(ids)]
        c = self._cand_cache
        if c is not None and c["version"] == m.version and np.array_equal(c["ids"], ids):
            return c
        # true length; an empty set keeps one invalid row for the step's gathers
        P = max(len(ids), 1)
        pos, desc, normal, dmin, dmax = m.points_array(ids)

        def padto(a):
            out = np.zeros((P,) + a.shape[1:], a.dtype)
            out[: len(a)] = a
            return out

        dev = (
            self._tensor(padto(pos)), self._tensor(padto(desc)),
            self._tensor(padto(normal)), self._tensor(padto(dmin)),
            self._tensor(padto(dmax)), self._tensor(np.arange(P) < len(ids)),
        )
        c = {"ids": ids, "version": m.version, "dev": dev}
        self._cand_cache = c
        return c

    def _assemble_fused(self, images_u8, pred_steps: int = 1):
        """Inputs of the fused step (under the map lock), in the argument
        order of the JAX tracker's `_full_step`, uploaded without a host
        wait. pred_steps = 2 (pipelined tracking): the newest applied frame
        is one frame behind the one dispatched, so the prediction spans two
        frames, and the motion-match radius widens by 3 px.

        The two-frame prediction is the displacement over the last two
        frames, velocity x prev_velocity, applied to the newest applied
        pose (in float64). The JAX package applies the newest velocity
        twice (JAX slam/tracking.py:836-838). That extrapolates the solved
        poses' frame-to-frame jitter e as 3 e(i-2) - 2 e(i-3), a recursion
        with a root at -2: once a prediction leaves the match window the
        solved poses follow it and the error doubles with alternating sign
        each frame (both packages lose the 40-frame slice of
        tests/test_tracking.py's world from frame ~17-22 on the CPU). The
        two-frame displacement gives 2 e(i-2) - e(i-4), as stable as the
        synchronous 2 e(i-1) - e(i-2). Without a previous velocity (the
        first frame after a loss) the velocity is applied twice."""
        lf = self.last_frame
        N = self._N
        self._check_replaced_in_last_frame()
        pids = lf.point_ids.copy()
        has_pt = (pids >= 0) & self.map.valid_mask(pids)
        pids[~has_pt] = -1
        pw = np.zeros((N, 3), np.float32)
        desc = np.zeros((N, 8), np.uint32)
        pw[has_pt] = self.map.pt_pos[pids[has_pt]]
        desc[has_pt] = self.map.pt_desc[pids[has_pt]]
        v = self.velocity.astype(np.float64)
        step = v
        if pred_steps == 2:
            step = v @ (v if self.prev_velocity is None else self.prev_velocity.astype(np.float64))
        elif pred_steps != 1:
            raise ValueError(f"the fused step predicts 1 or 2 frames ahead, not {pred_steps}")
        T_pred = (step @ lf.Tcw.astype(np.float64)).astype(np.float32)
        Twc = np.linalg.inv(T_pred.astype(np.float64))
        tlc = (lf.Tcw.astype(np.float64) @ Twc)[:3, 3]
        b = self.config.baseline
        fwd, bwd = bool(tlc[2] > b), bool(-tlc[2] > b)
        cache = self._refresh_candidate_cache()
        ids = cache["ids"]
        src_cand_row = np.full(N, -1, np.int32)
        if ids.size:
            loc = np.searchsorted(ids, np.clip(pids, 0, None))
            locc = np.clip(loc, 0, len(ids) - 1)
            okm = has_pt & (ids[locc] == pids)
            src_cand_row[okm] = locc[okm]
        th_local = 5.0 if self.frame_id < self.last_reloc_frame_id + 2 else 1.0
        th_motion = 7.0 + 3.0 * (pred_steps - 1)
        args = (
            self._tensor(images_u8), self._tensor(pw), self._tensor(has_pt),
            self._tensor(desc), lf.dev.octave, lf.dev.angle,
            self._tensor(src_cand_row), self._tensor(T_pred),
            th_motion, fwd, bwd, *cache["dev"], th_local,
        )
        aux = {"src_pids": pids, "cand_ids": ids, "T_pred": T_pred}
        return args, aux

    def _apply_fused(self, frame: FrameHost, host, aux) -> str:
        """Host bookkeeping for the fused step's results. Returns "ok",
        "lost" (local-map support too thin, reference Tracking.cpp:808-819)
        or "motion_fail" (fall back to reference-KF tracking)."""
        m = self.map
        pfk, keep1, pfk2 = host["pfk"], host["keep1"], host["pfk2"]
        src_pids = aux["src_pids"]
        cand_ids = aux["cand_ids"]
        if int(host["n_match1"]) < 20:
            self.events.append(dict(frame=frame.frame_id, gate="fused_motion_matches",
                                    n=int(host["n_match1"])))
            return "motion_fail"

        frame.Tcw = host["Tcw"].copy()
        frame.point_ids[:] = -1
        k1 = keep1 & (pfk >= 0)
        frame.point_ids[k1] = src_pids[pfk[k1]]
        if cand_ids.size:
            k2 = ~k1 & (pfk2 >= 0)
            frame.point_ids[k2] = cand_ids[pfk2[k2]]
        hasp = frame.point_ids >= 0
        frame.point_ids[hasp & ~m.valid_mask(frame.point_ids)] = -1

        # motion-stage map support (reference TrackWithMotionModel >= 10)
        mk = k1 & (frame.point_ids >= 0)
        n_map1 = int((m.pt_nobs[frame.point_ids[mk]] > 0).sum())
        if n_map1 < 10:
            self.events.append(dict(frame=frame.frame_id, gate="fused_motion_map_support",
                                    n=n_map1))
            return "motion_fail"

        # visibility / found statistics (reference Tracking.cpp:790-806,985-1006)
        m.pt_visible[np.unique(frame.point_ids[mk])] += 1
        if cand_ids.size:
            m.pt_visible[cand_ids[host["visible"]]] += 1

        frame.outlier = host["valid_i"] & ~host["inlier2"]
        good = (frame.point_ids >= 0) & ~frame.outlier
        good_ids = frame.point_ids[good]
        m.pt_found[good_ids] += 1
        self.n_inliers = int((m.pt_nobs[good_ids] > 0).sum())
        # stereo mode drops outliers immediately (Tracking.cpp:806)
        bad = (frame.point_ids >= 0) & frame.outlier
        frame.point_ids[bad] = -1
        frame.outlier[bad] = False
        frame._close_counts = (int(host["n_close_tracked"]), int(host["n_close_free"]))
        # local map for the NEXT frame's candidate cache (one-frame lag,
        # the JAX package's documented deviation)
        self._update_local_map(frame)

        if frame.frame_id < self.last_reloc_frame_id + self.max_frames and self.n_inliers < 50:
            self.events.append(dict(frame=frame.frame_id, gate="fused_postreloc_50",
                                    n=self.n_inliers))
            return "lost"
        if self.n_inliers < 30:
            self.events.append(dict(frame=frame.frame_id, gate="fused_local_30",
                                    n=self.n_inliers))
            return "lost"
        return "ok"

    def _track_with_motion_model(self, frame: FrameHost) -> bool:
        """Reference Tracking::TrackWithMotionModel (Tracking.cpp:714-772)."""
        lf = self.last_frame
        N = self._N
        T_pred = (self.velocity @ lf.Tcw).astype(np.float32)
        frame.Tcw = T_pred
        th = 15.0 if self.config.monocular else 7.0  # reference Tracking.cpp:726-730
        pids = lf.point_ids.copy()
        has_pt = (pids >= 0) & self.map.valid_mask(pids)
        pw = np.zeros((N, 3), np.float64)
        desc = np.zeros((N, 8), np.uint32)
        is_temp = np.zeros(N, bool)
        pw[has_pt] = self.map.pt_pos[pids[has_pt]]
        desc[has_pt] = self.map.pt_desc[pids[has_pt]]
        if self.only_tracking:
            # visual-odometry points: unproject the last frame's close stereo
            # features that have no map point, closest first (reference
            # UpdateLastFrame, Tracking.cpp:648-712)
            close = lf.valid & (lf.depth > 0) & ~has_pt
            idxs = np.nonzero(close)[0]
            idxs = idxs[np.argsort(lf.depth[idxs])]
            n_vo = 0
            for i in idxs:
                if lf.depth[i] > self.config.depth_threshold and n_vo > 100:
                    break
                pw[i] = self._unproject(lf, int(i))
                desc[i] = lf.desc[i]
                has_pt[i] = True
                is_temp[i] = True
                n_vo += 1

        # forward/backward along the optical axis (reference ORBmatcher.cpp:1184-1194)
        tlc = (lf.Tcw @ np.linalg.inv(T_pred))[:3, 3]
        b = self.config.baseline
        fwd, bwd = bool(tlc[2] > b), bool(-tlc[2] > b)

        pfk, res = self._motion_step(
            frame.dev, self._tensor(pw.astype(np.float32)), self._tensor(has_pt), lf.dev.octave,
            lf.dev.angle, self._tensor(desc), self._tensor(T_pred), th, fwd, bwd,
        )
        pfk = pfk.cpu().numpy()
        frame.point_ids[:] = -1
        hit = pfk >= 0
        # a match to a visual-odometry point stays out of the map
        temp = np.zeros(N, bool)
        temp[hit] = is_temp[pfk[hit]]
        frame.temp_points = {int(i): pw[pfk[i]].copy() for i in np.nonzero(temp)[0]}
        mapped = hit & ~temp
        frame.point_ids[mapped] = pids[pfk[mapped]]
        if int(hit.sum()) < 20:
            self.events.append(dict(frame=frame.frame_id, gate="motion_matches_20",
                                    n=int(hit.sum())))
            return False
        frame.Tcw = res.Tcw.cpu().numpy()
        frame.outlier = hit & ~res.inlier.cpu().numpy()
        n_map = self._discard_outliers(frame)
        if n_map < 10:
            self.events.append(dict(frame=frame.frame_id, gate="motion_map_10", n=n_map))
        return n_map >= 10

    def _track_reference_keyframe(self, frame: FrameHost) -> bool:
        """Reference Tracking::TrackReferenceKeyFrame (Tracking.cpp:604-647)
        with BoW-free dense mutual-ratio matching."""
        kf = self.ref_kf
        if kf is None or kf not in self.map.kf_valid:
            return False
        kff = self.map.kf_frame[kf]
        kf_pids = self.map.kf_point[kf]
        has_pt = (kf_pids >= 0) & self.map.valid_mask(kf_pids)
        desc = np.zeros((self._N, 8), np.uint32)
        desc[has_pt] = self.map.pt_desc[kf_pids[has_pt]]
        n = self._match_descriptors(frame, kff, desc, has_pt, kf_pids)
        if n < 15:
            self.events.append(dict(frame=frame.frame_id, gate="refkf_bow_15", n=n))
            return False
        frame.Tcw = self.last_frame.Tcw.copy()
        self._pose_optimize(frame)
        n_map = self._discard_outliers(frame)
        if n_map < 10:
            self.events.append(dict(frame=frame.frame_id, gate="refkf_map_10", n=n_map))
        return n_map >= 10

    def _match_descriptors(self, frame, kff, desc, has_pt, kf_pids) -> int:
        """SearchByBoW(KF, Frame) equivalent: best match with 0.7 ratio and
        rotation consistency (reference ORBmatcher.cpp:110-239)."""
        out = matchers.search_by_bow(
            self._tensor(desc), self._tensor(has_pt), kff.dev.angle,
            frame.dev.desc, frame.dev.valid, frame.dev.angle, 0.7,
        )
        idx, best, keep = (t.cpu().numpy() for t in out)
        frame.point_ids[:] = -1
        # resolve collisions: best distance wins
        used = np.zeros(self._N, bool)
        cnt = 0
        for i in np.argsort(best):
            if keep[i] and not used[idx[i]]:
                frame.point_ids[idx[i]] = kf_pids[i]
                used[idx[i]] = True
                cnt += 1
        return cnt

    # ------------------------------------------------------------------

    def _track_local_map(self, frame: FrameHost) -> bool:
        """Reference Tracking::TrackLocalMap (Tracking.cpp:777-821)."""
        self._update_local_map(frame)
        self._search_local_points(frame)

        has = frame.point_ids >= 0
        good_ids = frame.point_ids[has & ~frame.outlier]
        self.map.pt_found[good_ids] += 1
        self.n_inliers = int((self.map.pt_nobs[good_ids] > 0).sum())
        bad = has & frame.outlier
        frame.point_ids[bad] = -1
        frame.outlier[bad] = False

        if frame.frame_id < self.last_reloc_frame_id + self.max_frames and self.n_inliers < 50:
            self.events.append(dict(frame=frame.frame_id, gate="local_postreloc_50",
                                    n=self.n_inliers))
            return False
        if self.n_inliers < 30:
            self.events.append(dict(frame=frame.frame_id, gate="local_30", n=self.n_inliers))
            return False
        return True

    def _update_local_map(self, frame: FrameHost):
        """UpdateLocalKeyFrames + UpdateLocalPoints (Tracking.cpp:1041-1137)."""
        has = frame.point_ids >= 0
        ok = has & self.map.valid_mask(frame.point_ids)
        frame.point_ids[has & ~ok] = -1
        ids = frame.point_ids[ok]
        if ids.size == 0:
            return
        rows = self.map.pt_obs_kf[ids]
        flat = rows[rows >= 0]
        flat = flat[self.map.kf_valid.mask_of(flat)]
        if flat.size == 0:
            return
        counts = np.bincount(flat)
        votes = {int(k): int(counts[k]) for k in np.nonzero(counts)[0]}
        local = list(votes)
        # add neighbors of the voters (cap 80, reference Tracking.cpp:1121)
        for kf in list(local):
            if len(local) > 80:
                break
            for nb in self.map.covisible_keyframes(kf, 10):
                if nb not in votes and nb not in local:
                    local.append(nb)
                    break
            for ch in self.map.children.get(kf, ()):
                if ch in self.map.kf_valid and ch not in local:
                    local.append(ch)
                    break
            par = self.map.parent.get(kf)
            if par is not None and par in self.map.kf_valid and par not in local:
                local.append(par)
        self.local_keyframes = local[:80]
        self.ref_kf = max(votes, key=votes.get)

        all_pids = np.unique(np.concatenate([self.map.kf_point[kf] for kf in self.local_keyframes]))
        pts = all_pids[self.map.valid_mask(all_pids)]
        self.local_points = pts
        self.map.reference_points = pts

    def _assemble_existing(self, frame: FrameHost):
        """Per-keypoint world positions of the frame's current matches: map
        points, and localization mode's visual-odometry points."""
        pw = np.zeros((self._N, 3), np.float32)
        pids = frame.point_ids
        has = pids >= 0
        valid = has & self.map.valid_mask(pids)
        frame.point_ids[has & ~valid] = -1
        pw[valid] = self.map.pt_pos[pids[valid]]
        for i, pos in frame.temp_points.items():
            if not valid[i]:
                pw[i] = pos
                valid[i] = True
        return pw, valid

    def _search_local_points(self, frame: FrameHost):
        """SearchLocalPoints (Tracking.cpp:979-1038) + PoseOptimization:
        frustum check on the host, projection matching of the unmatched
        local points and pose refinement on the device."""
        matched_ids = np.unique(frame.point_ids[frame.point_ids >= 0])
        self.map.pt_visible[matched_ids] += 1
        lp = np.asarray(self.local_points, np.int64)
        cand = lp[~np.isin(lp, matched_ids)]
        if cand.size == 0:
            self._pose_optimize(frame)
            return
        pos, desc, normal, dmin, dmax = self.map.points_array(cand)
        Rcw = frame.Tcw[:3, :3].astype(np.float64)
        tcw = frame.Tcw[:3, 3].astype(np.float64)
        Ow = -Rcw.T @ tcw
        pc = pos.astype(np.float64) @ Rcw.T + tcw
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        cam = self.config.camera
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        ur = u - cam.bf / zs
        po = pos.astype(np.float64) - Ow
        dist = np.linalg.norm(po, axis=1)
        viewcos = np.einsum("ij,ij->i", po, normal) / np.maximum(dist, 1e-9)
        visible = (
            (z > 0)
            & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
            & (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
            & (viewcos > 0.5)
        )
        self.map.pt_visible[cand[visible]] += 1
        if not visible.any():
            self._pose_optimize(frame)
            return
        # predicted scale level (MapPoint::PredictScale)
        ratio = dmax / np.maximum(dist, 1e-9)
        level = np.ceil(np.log(np.maximum(ratio, 1e-9)) / self.map.log_scale)
        level = np.clip(level, 0, self.map.n_levels - 1).astype(np.int32)
        th = 5.0 if frame.frame_id < self.last_reloc_frame_id + 2 else 1.0

        kp_free = frame.valid & (frame.point_ids < 0)
        pw_exist, valid_exist = self._assemble_existing(frame)
        t = self._tensor
        pfk, res = self._local_step(
            frame.dev, t(kp_free), t(pw_exist), t(valid_exist),
            t(np.stack([u, v], -1).astype(np.float32)),
            t(ur.astype(np.float32)), t(level), t(viewcos.astype(np.float32)),
            self._tensor(desc), t(visible),
            t(pos.astype(np.float32)), t(frame.Tcw.astype(np.float32)), th,
        )
        pfk = pfk.cpu().numpy()
        new_hit = (pfk >= 0) & (frame.point_ids < 0)
        frame.point_ids[new_hit] = cand[pfk[new_hit]]
        all_valid = valid_exist | new_hit
        if int(all_valid.sum()) >= 3:
            frame.Tcw = res.Tcw.cpu().numpy()
            frame.outlier = all_valid & ~res.inlier.cpu().numpy()

    # ------------------------------------------------------------------

    def _need_new_keyframe(self, frame: FrameHost) -> bool:
        """Reference Tracking::NeedNewKeyFrame (Tracking.cpp:824-897). The
        mapper is idle when it accepts keyframes (inline mapping always
        does); without a mapper the tracker counts it idle."""
        if self.only_tracking:
            return False
        lm = self.local_mapper
        if lm is not None and lm.is_stopped():
            return False
        n_kfs = self.map.n_keyframes()
        if frame.frame_id < self.last_reloc_frame_id + self.max_frames and n_kfs > self.max_frames:
            return False
        n_min_obs = 3 if n_kfs > 2 else 2
        n_ref_matches = self._tracked_in_keyframe(self.ref_kf, n_min_obs)
        idle = lm.accept_keyframes() if lm is not None else True

        if self.config.monocular:
            need_close = False
        else:
            cc = getattr(frame, "_close_counts", None)
            if cc is not None:  # computed on device by the fused step
                tracked_close, non_tracked_close = cc
            else:
                close = frame.valid & (frame.depth > 0) & (frame.depth < self.config.depth_threshold)
                tracked_close = int((close & (frame.point_ids >= 0) & ~frame.outlier).sum())
                non_tracked_close = int((close & ((frame.point_ids < 0) | frame.outlier)).sum())
            need_close = (tracked_close < 100) and (non_tracked_close > 70)

        if n_kfs < 2:
            th_ref = 0.4
        else:
            th_ref = 0.9 if self.config.monocular else 0.75
        c1a = frame.frame_id >= self.last_kf_id + self.max_frames
        c1b = frame.frame_id >= self.last_kf_id + self.min_frames and idle
        c1c = self.n_inliers < n_ref_matches * 0.25 or need_close
        # the JAX package's latency-adaptive trigger (documented deviation
        # from the reference): a busy mapper and half the reference support
        # lost force the insertion path, which still takes the reference's
        # InterruptBA + queue < 3 policy below (Tracking.cpp:884-894)
        c1d = not idle and self.n_inliers < n_ref_matches * 0.5 and frame.frame_id >= self.last_kf_id + 3
        c2 = (self.n_inliers < n_ref_matches * th_ref or need_close) and self.n_inliers > 15
        if not ((c1a or c1b or c1c or c1d) and c2):
            return False
        if idle:
            return True
        lm.interrupt_ba()
        return lm.has_room()

    def _tracked_in_keyframe(self, kf: Optional[int], min_obs: int) -> int:
        if kf is None or kf not in self.map.kf_valid:
            return 0
        pids = self.map.kf_point[kf]
        ok = self.map.valid_mask(pids)
        return int((self.map.pt_nobs[pids[ok]] >= min_obs).sum())

    def _create_new_keyframe(self, frame: FrameHost):
        """Reference Tracking::CreateNewKeyFrame (Tracking.cpp:899-977):
        close stereo points not yet mapped, depth-ascending, stopping past
        ThDepth once 100 points exist."""
        kf = self.map.add_keyframe(frame, frame.Tcw)
        self.ref_kf = kf
        if self.config.monocular:
            # no stereo points: the mapper triangulates the keyframe's
            # features (upstream CreateNewKeyFrame)
            self.map.update_connections(kf)
            if self.local_mapper is not None:
                self.local_mapper.insert_keyframe(kf)
            self.last_kf_id = frame.frame_id
            return
        depth_ok = frame.valid & (frame.depth > 0)
        order = np.argsort(frame.depth[depth_ok])
        idxs = np.nonzero(depth_ok)[0][order]
        stop = (frame.depth[idxs] > self.config.depth_threshold) & (
            np.arange(1, len(idxs) + 1) > 100
        )
        hits = np.nonzero(stop)[0]
        if hits.size:
            idxs = idxs[: hits[0] + 1]
        cur = frame.point_ids[idxs]
        keep = (cur >= 0) & self.map.valid_mask(cur)
        keep[keep] = self.map.pt_nobs[cur[keep]] >= 1
        create = idxs[~keep]
        pids = self.map.add_stereo_points_batch(
            frame, kf, np.asarray(create, np.int64), self.config.camera
        )
        frame.point_ids[create] = pids
        self.map.kf_point[kf] = frame.point_ids.copy()
        self.map.update_connections(kf)
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)
        self.last_kf_id = frame.frame_id

    # ------------------------------------------------------------------

    def apply_pose_jump(self, T_old: np.ndarray, T_new: np.ndarray):
        """Re-anchor the motion model after a loop correction, essential
        graph or global BA write-back moved the current region's poses
        (called under the map lock; JAX slam/tracking.py:707). The reference
        has no equivalent: its tracker risks one failed frame after
        CorrectLoop rewrites mpCurrentKeyFrame's neighbourhood
        (LoopClosing.cpp:429-501); here the last frame rides the same
        correction, so the motion model stays continuous across the jump."""
        lf = self.last_frame
        if lf is None or lf.Tcw is None:
            return
        D = np.linalg.inv(T_old.astype(np.float64)) @ T_new.astype(np.float64)
        lf.Tcw = (lf.Tcw.astype(np.float64) @ D).astype(np.float32)

    def _relocalize(self, frame: FrameHost) -> bool:
        if self.relocalizer is None:
            return False
        ok = self.relocalizer.relocalize(frame)
        if ok:
            self.last_reloc_frame_id = frame.frame_id
        return ok

    def _record_trajectory(self, frame: FrameHost):
        """Reference Tracking.cpp:503-520."""
        lost = self.state != TrackingState.OK
        if frame.Tcw is None:
            # lost before any estimate: repeat the last relative pose, lost
            if self.trajectory:
                last = self.trajectory[-1]
                self.trajectory.append(
                    TrajectoryEntry(last.Tcr, last.ref_kf, frame.timestamp, True, None)
                )
            return
        Tcr = frame.Tcw @ np.linalg.inv(self.map.kf_pose[self.ref_kf])
        self.trajectory.append(TrajectoryEntry(Tcr, self.ref_kf, frame.timestamp, lost,
                                               frame.Tcw.copy()))

    def reset(self):
        self._pending.clear()  # drop the dispatched frames
        self.map.clear()
        self._init_ref = None
        self.state = TrackingState.NO_IMAGES_YET
        self._set_velocity(None)
        self.last_frame = None
        self.ref_kf = None
        self.trajectory.clear()
        self.local_keyframes = []
        self.local_points = []
