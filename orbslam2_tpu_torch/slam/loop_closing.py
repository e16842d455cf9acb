"""Loop closing: detection, Sim3 computation, loop correction, global BA.

Port of orbslam2_tpu/slam/loop_closing.py (reference src/LoopClosing.cpp)
for the stereo and the monocular sensor (`fix_scale=False`: the Sim3
RANSAC, the Sim3 LM and the essential graph solve the scale too).
`insert_keyframe` runs on the thread that processed the keyframe (the
mapper, inline in `track_stereo`), or on a `pipeline.LoopWorker` thread
when the System is threaded. The global BA runs inline after each
correction, or with `threaded_gba` on a thread of its own (reference
LoopClosing.cpp:566-570), which a newer correction aborts and joins
first (:397-409); an aborted solve is discarded.

  * DetectLoop (:90-216): the keyframe database's loop candidates above
    the worst covisible BoW score, then 3-consecutive-keyframe group
    consistency;
  * ComputeSim3 (:218-385): per candidate one K3 `nodes` launch
    (`matchers.bow_node_matches`: FeatureVector-bucketed BoW matching and
    collision resolution), the batched Horn Sim3 RANSAC, the guided Sim3
    search (K3 `fuse`, counted under `sim3`), the Sim3 LM and the
    loop-point projection gate (>= 40);
  * CorrectLoop (:387-605): the mapper parks, the Sim3 propagates through
    the current keyframe's covisible group, the loop points fuse into it
    (K3 `fuse`, counted under `loop_fusion`), the essential graph is
    optimized (`ops/posegraph.py`), and a global BA
    (`ops/ba.py::ba_solve_pm_interruptible`) runs and is applied with
    spanning-tree propagation.

Host map admin is numpy under the map lock; matching and solving run on
the device without it, as in the JAX package. Not ported here: the device
mesh (`mesh`, `_dist_*`). The JAX package's fixed shapes go: tables are
uploaded at their true length, and every consistent candidate is matched
(its fixed-shape path keeps 8). Two faults of the JAX package are not
carried: loop fusion sizes its rows from the frustum selection (the JAX
package cuts them to 256 per corrected keyframe), and an empty loop-point
snapshot still refreshes the corrected group's connections (the JAX
package skips it).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import convert
from ..config import SlamConfig
from ..geometry import sim3 as sim3_mod
from ..ops import ba, matchers, pnp, posegraph, sim3solve
from .ba_assembly import apply_pm_result, assemble_pm_problem
from .frontend import Frontend
from .map import SlamMap
from .relocalization import Relocalizer

COVIS_CONSISTENCY_TH = 3  # reference mnCovisibilityConsistencyTh (LoopClosing.cpp:24)
MIN_LOOP_GAP = 10  # no loop search right after the last one (:97-103)
#: Sim3 RANSAC hypotheses per candidate, and the seed of their stream (the
#: JAX package's PRNGKey(7))
N_HYP = 128
SEED = 7

Sim3Np = Tuple[np.ndarray, np.ndarray, float]  # (R, t, s) float64 on the host


def _np_sim3(S) -> Sim3Np:
    """A Sim3 (tensors, or a host (R, t, s) tuple) as host float64 numpy."""
    R, t, s = S
    if isinstance(R, torch.Tensor):
        R, t, s = (x.detach().cpu().numpy() for x in (R, t, s))
    return np.asarray(R, np.float64), np.asarray(t, np.float64), float(s)


class LoopCloser:
    def __init__(self, config: SlamConfig, frontend: Frontend, slam_map: SlamMap,
                 relocalizer: Relocalizer, local_mapper=None, fix_scale: bool = True):
        self.config = config
        self.frontend = frontend
        self.device = frontend.device
        self.map = slam_map
        self.lock = slam_map.lock  # the map-update lock (mMutexMapUpdate)
        self.reloc = relocalizer  # owns the vocabulary and the database
        self.local_mapper = local_mapper
        self.fix_scale = fix_scale
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.last_loop_kf = -MIN_LOOP_GAP
        self.n_loops_closed = 0
        self.timers = None  # StageTimers, wired by System
        #: callback(T_old, T_new), fired under the map lock after each
        #: write-back that moves the current region's poses, so that the
        #: tracker re-anchors its motion model (Tracker.apply_pose_jump)
        self.on_pose_jump = None
        #: the Sim3 RANSAC hypotheses' random stream
        self.generator = torch.Generator(device=self.device).manual_seed(SEED)
        self._cam = frontend.camera
        self._sf = frontend.scale_factors
        self._isig2 = frontend.inv_level_sigma2

        # state produced by _detect_loop / _compute_sim3 for _correct_loop
        self._candidates: List[int] = []
        self._matched_kf: Optional[int] = None
        self._Scw: Optional[Sim3Np] = None  # corrected Sim3 world -> current
        self._loop_points: List[int] = []
        self._matched_points: Dict[int, int] = {}  # current feature idx -> loop point id
        #: one record per rejected Sim3 candidate: the gate that rejected it
        #: and the counts at each stage (n_bow / n_ransac / n_opt / n_total
        #: against the reference's 20/20/20/40, LoopClosing.cpp:218-385)
        self.rejections: List[Dict] = []
        #: one record per closed loop: the keyframe, its candidate, the
        #: counts at each gate, and the sizes of its correction's problems
        self.loops: List[Dict] = []
        #: (start, end) monotonic seconds of each correction, the global BA
        #: excluded (frames that complete inside one overlapped it)
        self.correction_windows: List[Tuple[float, float]] = []
        #: the global BA on a thread of its own (set by a threaded System;
        #: inline otherwise, so that a caller sees the settled map on return)
        self.threaded_gba = False
        self._gba_thread: Optional[threading.Thread] = None
        self._gba_stop = False
        #: global BAs discarded because a newer correction aborted them
        self.n_gba_aborted = 0

    # ------------------------------------------------------------------

    def _span(self, name):
        return self.timers.span(name) if self.timers else contextlib.nullcontext()

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _note(self, **sizes):
        """Add to the record of the loop being closed."""
        if self.loops:
            self.loops[-1].update(sizes)

    def reset(self):
        """Forget the loop state (reference LoopClosing::ResetIfRequested):
        keyframe ids restart with the map. A running global BA is aborted
        and joined first."""
        self._abort_gba_and_join()
        self.consistent_groups = []
        self.rejections = []
        self._candidates = []
        self.last_loop_kf = -MIN_LOOP_GAP

    def insert_keyframe(self, kf: int) -> bool:
        """Process one keyframe the mapper finished; True if a loop closed."""
        if kf in self.map.kf_frame and kf not in self.reloc.database.kf_words:
            # the BoW transform (K4) on the keyframe's immutable features,
            # the insertion re-checked under the lock
            self.reloc.add_keyframe(kf, lock=self.lock)
        closed = False
        if self.map.n_keyframes() > MIN_LOOP_GAP and kf >= self.last_loop_kf + MIN_LOOP_GAP:
            with self.lock, self._span("Loop detection"):
                detected = self._detect_loop(kf)
            if detected:
                with self._span("Sim3 detection"):
                    matched = self._compute_sim3(kf)
                if matched:
                    self._correct_loop(kf)
                    closed = True
        return closed

    # ------------------------------------------------------------------

    def _detect_loop(self, kf: int) -> bool:
        if kf not in self.map.kf_valid:  # culled while queued
            return False
        db = self.reloc.database
        if kf not in db.kf_words:
            self.reloc.add_keyframe(kf)
        bow = db.kf_bow[kf]
        min_score = 1.0
        for nb in self.map.covisible_keyframes(kf):
            if nb in db.kf_bow:
                min_score = min(min_score, db._l1_score(bow, db.kf_bow[nb]))
        candidates = db.detect_loop_candidates(kf, min_score, self.map)
        if not candidates:
            self.consistent_groups = []
            return False

        # 3-consecutive-keyframe group consistency (LoopClosing.cpp:139-198)
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for cand in candidates:
            group = set(self.map.covisible_keyframes(cand))
            group.add(cand)
            consistent_for_some = False
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    consistent_for_some = True
                    count = prev_count + 1
                    new_groups.append((group, count))
                    if count >= COVIS_CONSISTENCY_TH and cand not in enough:
                        enough.append(cand)
                    break
            if not consistent_for_some:
                new_groups.append((group, 0))
        self.consistent_groups = new_groups
        self._candidates = enough
        return bool(enough)

    # ------------------------------------------------------------------

    def _compute_sim3(self, kf: int) -> bool:
        """ComputeSim3 over every consistent candidate (reference
        LoopClosing.cpp:218-385): the candidates' features snapshot under
        the map lock, one K3 `nodes` launch per candidate without it, one
        fetch of all the matches; then each candidate through the Sim3
        RANSAC / guided search / LM / projection gates until one passes."""
        db = self.reloc.database
        with self.lock:
            if kf not in self.map.kf_valid:
                return False
            f1 = self.map.kf_frame[kf]
            p1 = self.map.kf_point[kf].copy()
            has1 = (p1 >= 0) & f1.valid
            node1 = db.kf_nodes.get(kf)
            if node1 is None:
                node1 = self.reloc.compute_bow_nodes(f1.dev.desc, f1.dev.valid)[1]
            snap = []
            for cand in self._candidates:
                if cand not in self.map.kf_valid:
                    continue
                f2 = self.map.kf_frame[cand]
                p2 = self.map.kf_point[cand].copy()
                node2 = db.kf_nodes.get(cand)
                if node2 is None:
                    node2 = self.reloc.compute_bow_nodes(f2.dev.desc, f2.dev.valid)[1]
                snap.append((cand, f2.dev, (p2 >= 0) & f2.valid, p2, node2))
        if not snap:
            return False
        has1_t, node1_t = self._tensor(has1), self._tensor(node1.astype(np.int32))
        found = [
            matchers.bow_node_matches(f1.dev.desc, has1_t, f1.dev.angle, node1_t, f2.desc,
                                      self._tensor(has2), f2.angle, self._tensor(node2.astype(np.int32)),
                                      0.75)
            for _, f2, has2, _, node2 in snap
        ]
        idxs = torch.stack([i for i, _ in found]).cpu().numpy()
        wins = torch.stack([w for _, w in found]).cpu().numpy()
        for c, (cand, _, _, p2, _) in enumerate(snap):
            matches = {}
            for i in np.nonzero(wins[c])[0]:
                pid = int(p2[idxs[c][i]])
                if pid in self.map.pt_valid:
                    matches[int(i)] = pid
            if self._try_sim3_candidate(kf, cand, matches):
                return True
        return False

    def _point_rows(self, T1, T2, f1, f2, pairs):
        """Rows (X1, X2, uv1, uv2, max_err1, max_err2) of the (feature in
        kf1, point id, feature in kf2) pairs (the caller holds the lock)."""
        sigma2 = self.frontend.level_sigma2
        rows = []
        for i1, pid1, pid2, i2 in pairs:
            w1 = self.map.pt_pos[pid1]
            w2 = self.map.pt_pos[pid2]
            rows.append((
                T1[:3, :3] @ w1 + T1[:3, 3], T2[:3, :3] @ w2 + T2[:3, 3], f1.uv[i1], f2.uv[i2],
                9.21 * sigma2[f1.octave[i1]], 9.21 * sigma2[f2.octave[i2]],
            ))
        return rows

    def _try_sim3_candidate(self, kf: int, cand: int, matches: Dict[int, int]) -> bool:
        """One candidate of the reference's ComputeSim3 loop (LoopClosing.
        cpp:218-385). Map reads hold the lock; the Sim3 RANSAC and LM run
        without it. The correspondence arrays have their true length."""
        m = self.map

        def reject(stage, **counts):
            self.rejections.append(dict(kf=kf, cand=cand, stage=stage, **counts))
            return False

        if len(matches) < 20:
            return reject("bow_matches", n_bow=len(matches))
        with self.lock:
            if cand not in m.kf_valid or kf not in m.kf_valid:
                return reject("kf_culled")
            f1, f2 = m.kf_frame[kf], m.kf_frame[cand]
            T1 = m.kf_pose[kf].astype(np.float64)
            T2 = m.kf_pose[cand].astype(np.float64)
            p1 = m.kf_point[kf]
            pairs = []
            for i in sorted(matches):
                pid1, pid2 = int(p1[i]), matches[i]
                # the matches came from an unlocked snapshot: re-validate
                if pid1 not in m.pt_valid or pid2 not in m.pt_valid:
                    continue
                i2 = m.pt_obs[pid2].get(cand)
                if i2 is not None:
                    pairs.append((i, pid1, pid2, i2))
            rows = self._point_rows(T1, T2, f1, f2, pairs)
        if len(rows) < 20:
            return reject("valid_pairs", n_bow=len(matches), n_valid=len(rows))

        cols = [np.asarray(c) for c in zip(*rows)]
        X1, X2, uv1, uv2, me1, me2 = (self._tensor(c.astype(np.float64)) for c in cols)
        valid = torch.ones(len(rows), dtype=torch.bool, device=self.device)
        hyp = pnp.sample_hypotheses(valid, N_HYP, self.generator, k=3)
        with self._span("Sim3 computation"):
            res = sim3solve.sim3_ransac(X1, X2, uv1, uv2, me1, me2, valid, self._cam,
                                        fix_scale=self.fix_scale, hypotheses=hyp)
            n_inl_ransac = int(res.n_inliers)
        if n_inl_ransac < 20:
            return reject("ransac", n_bow=len(matches), n_ransac=n_inl_ransac)

        # guided Sim3 matching (reference SearchBySim3, ORBmatcher.cpp:
        # 948-1171) extends the correspondences before the refinement
        with self._span("Sim3 guided search"):
            extra = self._search_by_sim3(kf, cand, _np_sim3(res.S12))
        with self.lock:
            if cand not in m.kf_valid or kf not in m.kf_valid:
                return reject("kf_culled")
            add = []
            for i1, pid2 in extra.items():
                if i1 in matches or pid2 not in m.pt_valid:
                    continue
                pid1 = int(p1[i1])
                if pid1 < 0 or pid1 not in m.pt_valid:
                    continue
                i2 = m.pt_obs[pid2].get(cand)
                if i2 is not None:
                    add.append((i1, pid1, pid2, i2))
            add_rows = self._point_rows(T1, T2, f1, f2, add)
        if add_rows:
            more = [self._tensor(np.asarray(c, np.float64)) for c in zip(*add_rows)]
            X1, X2, uv1, uv2, me1, me2 = (torch.cat([a, b]) for a, b in zip((X1, X2, uv1, uv2, me1, me2), more))
        inl0 = torch.cat([res.inliers, torch.ones(len(add_rows), dtype=torch.bool, device=self.device)])

        # each edge direction carries its own information (reference
        # OptimizeSim3, Optimizer.cpp:1100-1150): 9.21 / (9.21 sigma^2)
        with self._span("Sim3 refine"):
            S12, _, n_inl = sim3solve.optimize_sim3(res.S12, X1, X2, uv1, uv2, 9.21 / me1, 9.21 / me2, inl0,
                                                    self._cam, fix_scale=self.fix_scale)
            n_inl = int(n_inl)
        counts = dict(n_bow=len(matches), n_ransac=n_inl_ransac, n_opt=n_inl)
        if n_inl < 20:
            return reject("sim3_opt", **counts)

        # Scw = S12 o S2w (the corrected world -> current)
        R12, t12, s12 = _np_sim3(S12)
        Scw = (R12 @ T2[:3, :3], s12 * (R12 @ T2[:3, 3]) + t12, s12)

        # the loop region's points, verified by projection (>= 40)
        with self.lock:
            if cand not in m.kf_valid or kf not in m.kf_valid:
                return reject("kf_culled")
            group = [k for k in [cand] + m.covisible_keyframes(cand) if k in m.kf_valid]
            ids = np.unique(np.concatenate([m.kf_point[k] for k in group]))
            loop_pts = [int(p) for p in ids[m.valid_mask(ids)]]
        with self._span("Sim3 verify"):
            matched = self._search_by_sim3_projection(kf, Scw, loop_pts, th=10.0)
        total = len(matched) + sum(1 for i in matches if i not in matched)
        counts["n_total"] = total
        if total < 40:
            return reject("projection_total", **counts)
        self._matched_kf = cand
        self._Scw = Scw
        self._loop_points = loop_pts
        self._matched_points = dict(matched)
        for i, pid in matches.items():
            self._matched_points.setdefault(i, pid)
        self.loops.append(dict(kf=kf, cand=cand, s12=s12, **counts))
        return True

    def _search_by_sim3(self, kf1: int, kf2: int, S12: Sim3Np) -> Dict[int, int]:
        """Mutual Sim3 projection matching between two keyframes' points
        (reference ORBmatcher::SearchBySim3): kf2's points into kf1 under
        S12 and kf1's into kf2 under its inverse; pairs both directions
        agree on. Returns kf1 feature idx -> kf2 point id."""
        m = self.map
        with self.lock:
            if kf1 not in m.kf_valid or kf2 not in m.kf_valid:
                return {}
            T1 = m.kf_pose[kf1].astype(np.float64)
            T2 = m.kf_pose[kf2].astype(np.float64)
            kp2, kp1 = m.kf_point[kf2], m.kf_point[kf1]
            pids2 = kp2[m.valid_mask(kp2)]
            pids1 = kp1[m.valid_mask(kp1)]
        if pids1.size == 0 or pids2.size == 0:
            return {}
        R12, t12, s12 = S12
        # S1w = S12 o S2w ; S2w = S12^-1 o S1w
        S1w = (R12 @ T2[:3, :3], s12 * (R12 @ T2[:3, 3]) + t12, s12)
        R21, s21 = R12.T, 1.0 / s12
        S2w = (R21 @ T1[:3, :3], s21 * (R21 @ (T1[:3, 3] - t12)), s21)
        m12 = self._search_by_sim3_projection(kf1, S1w, pids2, th=7.5)  # kf1 feature -> kf2 point
        m21 = self._search_by_sim3_projection(kf2, S2w, pids1, th=7.5)  # kf2 feature -> kf1 point
        out = {}
        with self.lock:
            if kf1 not in m.kf_valid or kf2 not in m.kf_valid:
                return {}
            kf1_pts = m.kf_point[kf1]
            for i1, pid2 in m12.items():
                pid1 = int(kf1_pts[i1]) if i1 < len(kf1_pts) else -1
                if pid1 < 0:
                    continue
                i2 = m.pt_obs.get(pid2, {}).get(kf2)
                if i2 is not None and m21.get(int(i2)) == pid1:
                    out[int(i1)] = int(pid2)
        return out

    def _project_sim3_host(self, R, t, s, pos, normal, dmin, dmax):
        """Frustum and scale gates of points projected under a Sim3 (the
        host half of SearchByProjection with Scw, ORBmatcher.cpp:241-352).
        Returns (uv [P, 2] float64, level [P] int32, visible [P] bool)."""
        c = self._cam
        pc = (pos.astype(np.float64) @ R.T) * s + t
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = c.fx * pc[:, 0] / zs + c.cx
        v = c.fy * pc[:, 1] / zs + c.cy
        Ow = -(R.T @ t) / s
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
        return np.stack([u, v], -1), level, visible

    def _fuse_into(self, f, uv, level, desc, th: float, caller: str) -> torch.Tensor:
        """K3 `fuse` of projected points (uv [P, 2], level [P], desc [P, 8]
        uint32) into keyframe features f, with no stereo gate (the JAX
        package's -1 right coordinates): the keypoint index per point."""
        P, N = len(level), f.valid.shape[0]
        return matchers.fuse_match(
            f.uv, f.octave, torch.full((N,), -1.0, device=self.device), f.desc, f.valid,
            self._tensor(uv.astype(np.float32)), torch.full((P,), -1.0, device=self.device),
            self._tensor(level), convert.desc_to_torch(desc, self.device),
            torch.ones(P, dtype=torch.bool, device=self.device), self._sf, self._isig2, th=th,
            caller=caller,
        )[0]

    def _search_by_sim3_projection(self, kf: int, Scw: Sim3Np, pids, th: float) -> Dict[int, int]:
        """Reference SearchByProjection(KF, Scw, points, ...)
        (ORBmatcher.cpp:241-352): the points projected into the keyframe
        under the Sim3 and matched by K3 `fuse` (caller `sim3`). Returns
        feature idx -> point id, the first point to claim a feature."""
        pids = np.asarray(pids, np.int64)
        if pids.size == 0:
            return {}
        R, t, s = Scw
        with self.lock:
            if kf not in self.map.kf_valid:
                return {}
            f = self.map.kf_frame[kf]
            pids = pids[self.map.valid_mask(pids)]
            if pids.size == 0:
                return {}
            pos, desc, normal, dmin, dmax = self.map.points_array(pids)
        uv, level, visible = self._project_sim3_host(R, t, s, pos, normal, dmin, dmax)
        sel = np.nonzero(visible)[0]
        if sel.size == 0:
            return {}
        with self._span("Sim3 projection search"):
            best = self._fuse_into(f.dev, uv[sel], level[sel], desc[sel], th, "sim3").cpu().numpy()
        out: Dict[int, int] = {}
        for j, fi in enumerate(best):
            if fi >= 0 and int(fi) not in out:
                out[int(fi)] = int(pids[sel[j]])
        return out

    # ------------------------------------------------------------------

    def _correct_loop(self, kf: int):
        """Reference LoopClosing::CorrectLoop (LoopClosing.cpp:387-605),
        then the global BA inline. The mapper is parked throughout: its
        stop request is honoured between keyframes (a mapping worker
        finishes the keyframe in flight first)."""
        m = self.map
        t0 = time.monotonic()
        # a global BA of an earlier loop may still run: abort and join it
        # (reference LoopClosing.cpp:397-409, the mbStopGBA protocol)
        self._abort_gba_and_join()
        if self.local_mapper is not None:
            # reference RequestStop + isStopped wait (LoopClosing.cpp:394-415)
            self.local_mapper.request_stop()
            self.local_mapper.wait_stopped()
        try:
            with self._span("Loop propagate"), self.lock:
                pg_args, fuse_args = self._correct_loop_locked(kf)
            with self._span("Loop fusion"):
                loop_connections = self._search_and_fuse(kf, *fuse_args)
            with self._span("Essential graph"):
                self._optimize_essential_graph(kf, *pg_args, loop_connections)
        finally:
            # a failure mid-correction must not leave the mapper parked
            if self.local_mapper is not None:
                self.local_mapper.release()
        self.last_loop_kf = kf
        with self.lock:
            m.big_change_idx += 1  # MapChanged() (reference Map.cpp:42-52)
        self.correction_windows.append((t0, time.monotonic()))
        self.n_loops_closed += 1
        self._start_gba(kf)

    def _start_gba(self, kf: int):
        """The global BA: on a thread of its own with `threaded_gba`, so that
        the loop worker goes on with the next keyframes (reference
        LoopClosing.cpp:566-570); inline otherwise."""
        if self.threaded_gba:
            self._gba_stop = False
            self._gba_thread = threading.Thread(target=self._run_gba, args=(kf,), name="gba-thread",
                                                daemon=True)
            self._gba_thread.start()
        else:
            self._run_gba(kf)

    def _abort_gba_and_join(self, timeout: float = 300.0):
        """Stop a running global BA (its solve polls `_gba_stop` between
        chunks of iterations) and wait for its thread."""
        t = self._gba_thread
        if t is not None and t.is_alive():
            self._gba_stop = True
            t.join(timeout)
        self._gba_thread = None

    def gba_running(self) -> bool:
        t = self._gba_thread
        return t is not None and t.is_alive()

    def wait_gba(self, timeout: float = 600.0):
        """Block until a global BA on its own thread has been applied (or
        discarded)."""
        t = self._gba_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _run_gba(self, kf: int):
        with self._span("Global BA"):
            self._global_ba(kf)

    def _correct_loop_locked(self, kf: int):
        """The Sim3 propagation to the current keyframe's covisible group,
        its points corrected, the matched loop points attached (the caller
        holds the lock)."""
        m = self.map
        T_cur_old = m.kf_pose[kf].astype(np.float64).copy()
        current_group = [kf] + m.covisible_keyframes(kf)
        R, t, s = self._Scw

        corrected: Dict[int, Sim3Np] = {}
        non_corrected: Dict[int, np.ndarray] = {}
        Tkw = m.kf_pose[kf].astype(np.float64)
        for ki in current_group:
            Tiw = m.kf_pose[ki].astype(np.float64)
            non_corrected[ki] = Tiw.copy()
            if ki == kf:
                corrected[ki] = (R, t, s)
            else:
                Tic = Tiw @ np.linalg.inv(Tkw)
                Ric, tic = Tic[:3, :3], Tic[:3, 3]
                corrected[ki] = (Ric @ R, Ric @ t + tic, s)  # Siw = Sic o Scw (s_ic = 1)

        # each point of the group corrected once, through its first member
        done_mask = np.zeros(m._pt_capacity(), bool)
        for ki in current_group:
            Rc, tc, sc = corrected[ki]
            Tiw_old = non_corrected[ki]
            kp = m.kf_point[ki]
            ids = np.unique(kp[m.valid_mask(kp)])
            ids = ids[~done_mask[ids]]
            done_mask[ids] = True
            if ids.size:
                pc = m.pt_pos[ids] @ Tiw_old[:3, :3].T + Tiw_old[:3, 3]  # old camera coordinates
                m.pt_pos[ids] = ((pc - tc) / sc) @ Rc  # corrected world: Siw^-1 (pc)
            T_new = np.eye(4, dtype=np.float32)
            T_new[:3, :3] = Rc
            T_new[:3, 3] = (tc / sc).astype(np.float32)
            m.kf_pose[ki] = T_new

        # the matched loop points at the current keyframe (descriptor
        # refreshes deferred to one batched pass in _search_and_fuse)
        touched = []
        cur_pids = m.kf_point[kf]
        for fi, loop_pid in self._matched_points.items():
            loop_pid = m.resolve_replaced(loop_pid)
            if loop_pid not in m.pt_valid:
                continue
            cur_pid = int(cur_pids[fi])
            if cur_pid >= 0 and cur_pid in m.pt_valid and cur_pid != loop_pid:
                m.replace_point(cur_pid, loop_pid, refresh_desc=False)
                touched.append(loop_pid)
            elif cur_pid < 0:
                m.add_observation(loop_pid, kf, fi)
                touched.append(loop_pid)

        old_neighbors = {ki: set(m.covisible_keyframes(ki)) for ki in current_group}
        loop_pt_arr = np.asarray(self._loop_points, np.int64)
        loop_pt_list = loop_pt_arr[m.valid_mask(loop_pt_arr)]

        m.loop_edges[kf].add(self._matched_kf)
        m.loop_edges[self._matched_kf].add(kf)
        m.version += 1  # the tracker's device-resident candidate cache re-uploads
        if self.on_pose_jump is not None:
            self.on_pose_jump(T_cur_old, m.kf_pose[kf])
        return (corrected, non_corrected), (current_group, corrected, old_neighbors, loop_pt_list, touched)

    def _search_and_fuse(self, kf, current_group, corrected, old_neighbors, loop_pt_list,
                         touched) -> Dict[int, Set[int]]:
        """The loop points fused into every corrected keyframe (reference
        SearchAndFuse, LoopClosing.cpp:528-556): one K3 `fuse` launch per
        member with a visible point (caller `loop_fusion`), each member's
        merges under the lock, then every member's connections refreshed
        and the new links found."""
        m = self.map
        with self.lock:
            pids_all = loop_pt_list[m.valid_mask(loop_pt_list)]
            members = [ki for ki in current_group if ki in m.kf_valid]
            frames = {ki: m.kf_frame[ki] for ki in members}
            if pids_all.size:
                pos, desc, normal, dmin, dmax = m.points_array(pids_all)
        matched_by_ki: Dict[int, tuple] = {}
        with self._span("Loop fusion search"):
            found = []
            for ki in members if pids_all.size else ():
                uv, level, visible = self._project_sim3_host(*corrected[ki], pos, normal, dmin, dmax)
                sel = np.nonzero(visible)[0]
                if sel.size:
                    best = self._fuse_into(frames[ki].dev, uv[sel], level[sel], desc[sel], 4.0, "loop_fusion")
                    found.append((ki, pids_all[sel], best))
            if found:
                bests = torch.cat([b for *_, b in found]).cpu().numpy()
                at = 0
                for ki, spids, b in found:
                    matched_by_ki[ki] = (spids, bests[at:at + len(spids)])
                    at += len(spids)
        n_fused = 0
        for ki in members:
            spids, best = matched_by_ki.get(ki, (None, None))
            with self.lock, self._span("Loop fusion merge"):
                if ki not in m.kf_valid:
                    continue
                if spids is not None:
                    kf_pids = m.kf_point[ki]
                    for j in np.nonzero(best >= 0)[0]:
                        fi = int(best[j])
                        pid = m.resolve_replaced(int(spids[j]))
                        if pid not in m.pt_valid or ki in m.pt_obs[pid]:
                            continue
                        existing = int(kf_pids[fi])
                        if existing >= 0 and existing in m.pt_valid and existing != pid:
                            m.replace_point(existing, pid, refresh_desc=False)
                        else:
                            m.add_observation(pid, ki, fi)
                        touched.append(pid)
                        n_fused += 1
                # every member's covisibility refreshed: the new-link search
                # below diffs old against refreshed neighbours (reference
                # LoopClosing.cpp:537-552)
                m.update_connections(ki)
        self._note(fused=n_fused)

        loop_connections: Dict[int, Set[int]] = {}
        with self.lock:
            for ki in current_group:
                if ki not in m.kf_valid:
                    continue
                fresh = set(m.covisible_keyframes(ki)) - old_neighbors[ki] - set(current_group)
                if fresh:
                    loop_connections[ki] = fresh

        # one batched descriptor refresh for every point the fusion
        # touched, in chunks so that the lock is released between them
        with self._span("Loop fusion refresh"):
            tl = sorted(set(touched))
            for i in range(0, len(tl), 256):
                with self.lock:
                    m.compute_distinctive_descriptors_batch(tl[i : i + 256])
        with self.lock:
            m.version += 1
        return loop_connections

    # ------------------------------------------------------------------

    def _assemble_essential_graph(self, cur_kf, corrected, non_corrected, loop_connections):
        """The essential graph (reference Optimizer.cpp:790-1052; the caller
        holds the lock): vertices at their corrected or current poses,
        edges for the new loop connections (measured between corrected
        poses), the spanning tree, past loop edges and covisibility >= 100
        (measured between pre-correction poses), and the new loop edge."""
        m = self.map
        kfs = sorted(m.kf_valid)
        index = {k: i for i, k in enumerate(kfs)}
        K = len(kfs)
        Rv = np.zeros((K, 3, 3))
        tv = np.zeros((K, 3))
        sv = np.ones(K)
        T_old = np.zeros((K, 4, 4))
        for k, i in index.items():
            if k in corrected:
                Rv[i], tv[i], sv[i] = corrected[k]
            else:
                T = m.kf_pose[k].astype(np.float64)
                Rv[i], tv[i] = T[:3, :3], T[:3, 3]
            T_old[i] = non_corrected[k] if k in non_corrected else m.kf_pose[k].astype(np.float64)

        pairs_old: List[Tuple[int, int]] = []
        pairs_new: List[Tuple[int, int]] = []
        added = set()

        def add_edge(ka, kb, new=False):
            if ka not in index or kb not in index:
                return
            pair = (min(ka, kb), max(ka, kb))
            if pair in added:
                return
            added.add(pair)
            (pairs_new if new else pairs_old).append((index[ka], index[kb]))

        for ka, fresh in loop_connections.items():
            for kb in fresh:
                add_edge(ka, kb, new=True)
        for k in kfs:
            par = m.parent.get(k)
            if par is not None and par in index:
                add_edge(k, par)
            for le in m.loop_edges.get(k, ()):
                if le < k:
                    add_edge(k, le)
            for nb, w in m.covis.get(k, {}).items():
                if w >= 100 and nb < k and nb not in m.children.get(k, set()):
                    add_edge(k, nb)
        add_edge(cur_kf, self._matched_kf)

        def meas(pairs, R_src, t_src):
            # Sji = Sj o Si^-1 (scale 1): Rji = Rj Ri^T, tji = tj - Rji ti
            ia = np.asarray([p[0] for p in pairs], np.int64)
            ib = np.asarray([p[1] for p in pairs], np.int64)
            Rji = np.einsum("ebc,edc->ebd", R_src[ib], R_src[ia])
            return ia, ib, Rji, t_src[ib] - np.einsum("ebc,ec->eb", Rji, t_src[ia])

        parts = [meas(pairs_old, T_old[:, :3, :3], T_old[:, :3, 3]), meas(pairs_new, Rv, tv)]
        ei, ej, mR, mt = (np.concatenate([p[c] for p in parts]) for c in range(4))
        old_poses = {k: T_old[i] for k, i in index.items()}
        return kfs, index, (Rv, tv, sv), (ei, ej, mR, mt), old_poses

    def _optimize_essential_graph(self, cur_kf, corrected, non_corrected, loop_connections):
        """Assemble the essential graph under the lock, solve it on the
        device without it (`ops/posegraph.py`, float64), write back under
        the lock: poses, and every point through its reference keyframe,
        p' = S_corr^-1 (S_old p)."""
        m = self.map
        with self.lock:
            kfs, index, (Rv, tv, sv), (ei, ej, mR, mt), old_poses = self._assemble_essential_graph(
                cur_kf, corrected, non_corrected, loop_connections)
        if len(ei) == 0:
            return
        K, E = len(kfs), len(ei)
        self._note(eg_vertices=K, eg_edges=E)
        t = lambda a, dtype=torch.float64: torch.as_tensor(a, dtype=dtype, device=self.device)  # noqa: E731
        prob = posegraph.PoseGraphProblem(
            vertices=sim3_mod.Sim3(t(Rv), t(tv), t(sv)),
            edge_i=t(ei, torch.int64), edge_j=t(ej, torch.int64),
            meas=sim3_mod.Sim3(t(mR), t(mt), torch.ones(E, dtype=torch.float64, device=self.device)),
            edge_valid=torch.ones(E, dtype=torch.bool, device=self.device),
            fixed=t(np.array([k == self._matched_kf for k in kfs]), torch.bool),
        )
        V_opt, _ = posegraph.optimize_essential_graph(prob, fix_scale=self.fix_scale)
        R_opt, t_opt, s_opt = (x.cpu().numpy() for x in V_opt)

        with self.lock:
            old_T = np.stack([old_poses[k] for k in kfs])
            kf_lut = np.full(max(kfs) + 2, -1, np.int64)  # kf id -> vertex
            kf_lut[np.asarray(kfs)] = np.arange(K)
            pids = m.pt_ids()
            refs = m.pt_ref_kf[pids]
            ok = (refs >= 0) & (refs < len(kf_lut))
            ok[ok] = kf_lut[refs[ok]] >= 0
            pids = pids[ok]
            vi = kf_lut[m.pt_ref_kf[pids]]
            To = old_T[vi]
            pc = np.einsum("nij,nj->ni", To[:, :3, :3], m.pt_pos[pids]) + To[:, :3, 3]
            v = (pc - t_opt[vi]) / s_opt[vi][:, None]
            m.pt_pos[pids] = np.einsum("nji,nj->ni", R_opt[vi], v)  # R^T v per row
            anchor = max((k for k in kfs if k in m.kf_valid), default=None)
            T_anchor_old = m.kf_pose[anchor].astype(np.float64).copy() if anchor is not None else None
            for k, i in index.items():
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = R_opt[i]
                T[:3, 3] = t_opt[i] / s_opt[i]
                m.kf_pose[k] = T
            m.update_normals_batch(m.pt_ids())
            if self.on_pose_jump is not None and anchor is not None:
                self.on_pose_jump(T_anchor_old, m.kf_pose[anchor])

    # ------------------------------------------------------------------

    def _global_ba(self, kf: int):
        """Full-map BA (reference RunGlobalBundleAdjustment, LoopClosing.
        cpp:607-758): the problem assembled from the map under the lock,
        solved on the device without it (10 + 15 LM iterations, 40 PCG
        steps: the JAX package's schedule; the solve polls `_gba_stop`),
        applied under the lock with spanning-tree propagation to whatever
        the tracker added meanwhile, or discarded if it was aborted."""
        m = self.map
        if not self._lock_unless_stopped():
            return
        try:
            kfs = sorted(m.kf_valid)
            pts = [int(p) for p in m.pt_ids()]
            if len(kfs) < 2 or len(pts) < 10:
                return
            kf_index = {k: i for i, k in enumerate(kfs)}
            pt_index = {p: i for i, p in enumerate(pts)}
            prob, meta = assemble_pm_problem(m, self.frontend, kfs, pts, kf_index, pt_index, kfs)
        finally:
            self.lock.release()
        if prob is None:
            return
        self._note(gba_keyframes=len(kfs), gba_points=len(pts), gba_edges=int(prob.edge_valid.sum()))
        res = ba.ba_solve_pm_interruptible(convert.ba_problem_pm_to_torch(prob, self.device), self._cam,
                                           n_iters_first=10, n_iters_second=15, sync_every=5, n_cg=40,
                                           should_abort=lambda: self._gba_stop)
        if self._gba_stop or not self._lock_unless_stopped():
            # aborted by a newer correction or a reset: discarded (the
            # reference returns without updating, LoopClosing.cpp:641-654)
            self.n_gba_aborted += 1
            return
        try:
            with self._span("Graph update"):
                self._apply_gba_staged(res, meta, kfs, pts)
        finally:
            self.lock.release()

    def _lock_unless_stopped(self) -> bool:
        """Take the map lock, unless the global BA is stopped while it waits
        (then False): the tracker's early-loss reset stops and joins the
        global BA's thread while it holds the lock."""
        while not self.lock.acquire(timeout=0.01):
            if self._gba_stop:
                return False
        return True

    def _apply_gba_staged(self, res, meta, solved_kfs, solved_pts):
        """Apply the global BA and propagate it to the state created during
        the solve (reference LoopClosing.cpp:673-733): a new keyframe moves
        with its spanning-tree parent, a new point with its reference
        keyframe. Inline, nothing was created meanwhile; on its own thread
        the tracker and the mapper went on during the solve."""
        m = self.map
        solved_set = set(solved_kfs)
        pre = {k: m.kf_pose[k].astype(np.float64).copy() for k in m.kf_pose}
        apply_pm_result(m, res, meta)
        for k in sorted(k for k in m.kf_valid if k not in solved_set):  # parents first
            par = m.parent.get(k)
            if par is None or par not in pre:
                continue
            T_rel = pre[k] @ np.linalg.inv(pre[par])
            m.kf_pose[k] = (T_rel @ m.kf_pose[par].astype(np.float64)).astype(np.float32)
        solved_pt_mask = np.zeros(m._pt_capacity(), bool)
        solved_pt_mask[np.asarray(solved_pts, np.int64)] = True
        all_ids = m.pt_ids()
        new_pts = all_ids[~solved_pt_mask[all_ids]]
        if new_pts.size:
            refs = m.pt_ref_kf[new_pts]
            ref_ids = np.array(sorted({int(r) for r in refs if int(r) in m.kf_valid}), np.int64)
            if ref_ids.size:
                lut = np.full(int(ref_ids.max()) + 2, -1, np.int64)
                lut[ref_ids] = np.arange(len(ref_ids))
                sel = (refs >= 0) & (refs <= ref_ids.max())
                sel[sel] = lut[refs[sel]] >= 0
                ids = new_pts[sel]
                vi = lut[m.pt_ref_kf[ids]]
                pre_T = np.stack([pre[int(k)] for k in ref_ids])
                new_Twc = np.linalg.inv(np.stack([m.kf_pose[int(k)].astype(np.float64) for k in ref_ids]))
                pc = np.einsum("nij,nj->ni", pre_T[vi][:, :3, :3], m.pt_pos[ids]) + pre_T[vi][:, :3, 3]
                m.pt_pos[ids] = np.einsum("nij,nj->ni", new_Twc[vi][:, :3, :3], pc) + new_Twc[vi][:, :3, 3]
        m.update_normals_batch(new_pts)
        anchor = max((k for k in m.kf_valid if k in pre), default=None)
        if self.on_pose_jump is not None and anchor is not None:
            self.on_pose_jump(pre[anchor], m.kf_pose[anchor])
