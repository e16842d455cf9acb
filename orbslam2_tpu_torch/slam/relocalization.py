"""Relocalization: BoW candidate retrieval + hypothesis-parallel EPnP.

Port of orbslam2_tpu/slam/relocalization.py (reference
Tracking::Relocalization, src/Tracking.cpp:1177-1346): query the keyframe
database with the lost frame's BoW vector, match each candidate keyframe's
map points to the frame by descriptor, solve EPnP RANSAC for every
candidate at once, refine the best-supported pose with motion-only
optimization, widen with projection search if needed, accept at >= 50
inliers.

Device work per attempt: one K4 launch (the frame's words), one K3 `mask`
launch per candidate (`matchers.search_by_bow`, counted under the caller
`relocalization`), one batched `ops.pnp.pnp_ransac` over candidates x 256
hypotheses, `pose_opt.pose_optimize` per refinement and K3 `frame` per
widening pass. Keyframes are indexed as the mapper finishes them: one K4
launch each.

With `solver="mlpnp"` (BASELINE config 4) an attempt takes the JAX
package's sequential path instead: the first 5 candidates one by one, BoW
matching (K3 `mask`, caller `relocalization`), collisions resolved by
distance on the host, then `ops.mlpnp.mlpnp_ransac` (128 hypotheses of 6
points) on the bearings with the angular gate sqrt(5.991 sigma^2) / fx,
>= 10 inliers, and the same optimize-and-widen passes. The JAX package's
padded shapes (`padto`, `ShapePolicy.bucket`) are not ported: every array
has its true length; the candidate count stays 5 (`CANDIDATES`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..config import SlamConfig
from ..ops import hamming, matchers, mlpnp, pnp, pose_opt
from ..vocab import bow as bow_mod
from ..vocab.database import KeyFrameDatabase
from .frontend import FrameHost, Frontend
from .map import SlamMap

#: candidate keyframes solved per attempt (the JAX package's
#: ShapePolicy.reloc_cands; the reference tries up to all of them)
CANDIDATES = 5
#: seed of the RANSAC hypotheses' random stream (the JAX package's PRNGKey(42))
SEED = 42


class Relocalizer:
    def __init__(
        self,
        config: SlamConfig,
        frontend: Frontend,
        slam_map: SlamMap,
        vocab: bow_mod.Vocabulary,
        solver: str = "epnp",
    ):
        if solver not in ("epnp", "mlpnp"):
            raise ValueError(f"unknown relocalization solver {solver!r}")
        self.config = config
        self.frontend = frontend
        self.device = frontend.device
        self.map = slam_map
        self.vocab = vocab
        self.solver = solver
        self.database = KeyFrameDatabase(vocab.n_words)
        #: the RANSAC hypotheses' random stream
        self.generator = torch.Generator(device=self.device).manual_seed(SEED)
        self._word_weight_np = vocab.word_weight.cpu().numpy()
        #: per-attempt gate trace: which of the reference's gates (DB
        #: candidates -> BoW matches -> EPnP inliers -> pose optimization ->
        #: widening, Tracking.cpp:1177-1346) ended each attempt
        self.trace: list = []

    # ------------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def compute_bow(self, desc, valid):
        """Returns (per-descriptor word ids [N], sparse (wid, weight))."""
        words, _ = self.compute_bow_nodes(desc, valid)
        return words, bow_mod.bow_sparse(words, self._word_weight_np)

    def compute_bow_nodes(self, desc, valid):
        """(word ids [N], FeatureVector node ids [N]) as numpy, from int32
        descriptor tensors (or uint32 numpy words) and their valid mask."""
        if not isinstance(desc, torch.Tensor):
            desc = convert.desc_to_torch(desc, self.device)
        if not isinstance(valid, torch.Tensor):
            valid = self._tensor(valid)
        words, nodes = bow_mod.transform_words_nodes(self.vocab, desc, valid)
        return words.cpu().numpy(), nodes.cpu().numpy()

    def add_keyframe(self, kf: int, lock=None):
        """Register a keyframe in the BoW database. The transform runs on
        the frame's immutable features (safe without the map lock); with
        `lock` given, the insertion re-checks under it that the keyframe is
        still alive, since a mapping worker may cull it in between."""
        f = self.map.kf_frame.get(kf)
        if f is None:
            return
        words, nodes = self.compute_bow_nodes(f.dev.desc, f.dev.valid)
        vec = bow_mod.bow_sparse(words, self._word_weight_np)
        if lock is None:
            self.database.add(kf, words, vec, nodes=nodes)
            return
        with lock:
            if kf in self.map.kf_valid:
                self.database.add(kf, words, vec, nodes=nodes)

    def remove_keyframe(self, kf: int):
        self.database.erase(kf)

    # ------------------------------------------------------------------

    def relocalize(self, frame: FrameHost) -> bool:
        """One attempt for a lost frame; on success the frame carries its
        pose and matches. Appends the attempt's record to `trace`."""
        words, vec = self.compute_bow(frame.dev.desc, frame.dev.valid)
        candidates = self.database.detect_relocalization_candidates(words, vec, self.map)
        rec = {"frame": int(frame.frame_id), "n_db_cands": len(candidates), "cands": [], "ok": False}
        self.trace.append(rec)
        if not candidates:
            rec["stage"] = "db_candidates"
            return False
        if self.solver == "mlpnp":
            ok = self._relocalize_sequential(frame, candidates, rec)
        else:
            ok = self._relocalize_batched(frame, candidates, rec)
        rec["ok"] = bool(ok)
        return ok

    def _relocalize_batched(self, frame: FrameHost, candidates, rec) -> bool:
        """Every candidate's BoW matching and EPnP RANSAC in one batch, then
        the candidates by RANSAC support through pose optimization and the
        reference's two widening passes (Tracking.cpp:1239-1334)."""
        cands = [kf for kf in candidates[:CANDIDATES] if kf in self.map.kf_valid]
        if not cands:
            return False
        cam = self.config.camera
        sigma2 = self.frontend.level_sigma2
        N = len(frame.valid)
        fd = frame.dev
        pw_rows, hit_rows, src_rows, pids_rows = [], [], [], []
        for kf in cands:
            kff = self.map.kf_frame[kf]
            kf_pids = self.map.kf_point[kf]
            has_pt = (kf_pids >= 0) & self.map.valid_mask(kf_pids)
            desc = np.zeros((N, 8), np.uint32)
            pw = np.zeros((N, 3), np.float32)
            desc[has_pt] = self.map.pt_desc[kf_pids[has_pt]]
            pw[has_pt] = self.map.pt_pos[kf_pids[has_pt]]
            idx, best, keep = matchers.search_by_bow(
                convert.desc_to_torch(desc, self.device), self._tensor(has_pt), kff.dev.angle,
                fd.desc, fd.valid, fd.angle, 0.75, caller="relocalization",
            )
            # frame-keypoint collisions: the best distance wins
            src, _ = matchers._resolve_collisions(idx, torch.where(keep, best, hamming.MAX_DIST), N)
            src_rows.append(src)
            hit_rows.append(src >= 0)
            pw_rows.append(self._tensor(pw)[torch.clamp(src.long(), 0, N - 1)])
            pids_rows.append(np.where(has_pt, kf_pids, -1))
        obs_n = np.stack([(frame.uv[:, 0] - cam.cx) / cam.fx, (frame.uv[:, 1] - cam.cy) / cam.fy],
                         axis=1).astype(np.float32)
        max_err2 = (5.991 * sigma2[frame.octave] / (cam.fx * cam.fx)).astype(np.float32)
        hit = torch.stack(hit_rows)
        res = pnp.pnp_ransac(torch.stack(pw_rows), self._tensor(obs_n), hit, self._tensor(max_err2),
                             self.generator)
        src, hit, n_bow = torch.stack(src_rows).cpu().numpy(), hit.cpu().numpy(), hit.sum(-1).cpu().numpy()
        Rs, ts = res.R.cpu().numpy(), res.t.cpu().numpy()
        inls, n_inls = res.inliers.cpu().numpy(), res.n_inliers.cpu().numpy()
        # best candidate first (the reference tries candidates round-robin
        # until one reaches 50 inliers; the order by RANSAC support is the
        # batched equivalent)
        for c in np.argsort(-n_inls):
            c = int(c)
            crec = {"kf": int(cands[c]), "n_bow": int(n_bow[c]), "n_pnp": int(n_inls[c])}
            rec["cands"].append(crec)
            if n_bow[c] < 15 or n_inls[c] < 10:
                crec["stage"] = "bow" if n_bow[c] < 15 else "pnp"
                continue
            Tcw = np.eye(4, dtype=np.float32)
            Tcw[:3, :3] = Rs[c]
            Tcw[:3, 3] = ts[c]
            frame.Tcw = Tcw
            sel = hit[c] & inls[c]
            frame.point_ids[:] = np.where(sel, pids_rows[c][np.clip(src[c], 0, N - 1)], -1)
            n_good = self._optimize(frame)
            crec["n_opt"] = int(n_good)
            if n_good < 10:
                crec["stage"] = "pose_opt"
                continue
            if n_good < 50:
                n_good = self._widen(frame, cands[c], th=10.0, orb_dist=100)
                if 30 <= n_good < 50:
                    n_good = self._widen(frame, cands[c], th=3.0, orb_dist=64)
            crec["n_widen"] = int(n_good)
            if n_good >= 50:
                crec["stage"] = "accepted"
                return True
            crec["stage"] = "widen"
        return False

    def _relocalize_sequential(self, frame: FrameHost, candidates, rec) -> bool:
        """The MLPnP path (the JAX package's `_relocalize_sequential`): the
        first CANDIDATES candidates in turn, each through BoW matching (>=
        15), MLPnP RANSAC on the bearings (>= 10 inliers), pose
        optimization and the widening passes (>= 50 accepts)."""
        cam = self.config.camera
        sigma2 = self.frontend.level_sigma2
        t = self._tensor
        bearings = mlpnp.bearings_from_pixels(frame.dev.uv, cam.fx, cam.fy, cam.cx, cam.cy)
        # the angular gate equivalent to the pixel chi2 gate
        cos_th = t(np.cos(np.sqrt(5.991 * sigma2[frame.octave]) / cam.fx).astype(np.float32))
        for kf in candidates[:CANDIDATES]:
            if kf not in self.map.kf_valid:
                continue
            pids = self._bow_match_keyframe(frame, kf)
            n_matches = int((pids >= 0).sum())
            crec = {"kf": int(kf), "n_bow": n_matches}
            rec["cands"].append(crec)
            if n_matches < 15:
                crec["stage"] = "bow"
                continue
            N = len(pids)
            pw = np.zeros((N, 3), np.float32)
            valid = (pids >= 0) & self.map.valid_mask(pids)
            pw[valid] = self.map.pt_pos[pids[valid]]
            res = mlpnp.mlpnp_ransac(t(pw), bearings, t(valid), cos_th, self.generator)
            crec["n_pnp"] = int(res.n_inliers)
            if crec["n_pnp"] < 10:
                crec["stage"] = "pnp"
                continue
            frame.Tcw = res.Tcw.cpu().numpy().astype(np.float32)
            frame.point_ids[:] = np.where(res.inliers.cpu().numpy() & valid, pids, -1)
            n_good = self._optimize(frame)
            crec["n_opt"] = int(n_good)
            if n_good < 10:
                crec["stage"] = "pose_opt"
                continue
            if n_good < 50:
                n_good = self._widen(frame, kf, th=10.0, orb_dist=100)
                if 30 <= n_good < 50:
                    n_good = self._widen(frame, kf, th=3.0, orb_dist=64)
            crec["n_widen"] = int(n_good)
            if n_good >= 50:
                crec["stage"] = "accepted"
                return True
            crec["stage"] = "widen"
        return False

    def _bow_match_keyframe(self, frame: FrameHost, kf: int) -> np.ndarray:
        """SearchByBoW(KF, Frame) (ratio 0.75, rotation check), K3 `mask`
        under the caller `relocalization`; frame-keypoint collisions go to
        the best distance, as in the batched path. Returns the matched map
        point per keypoint (-1 none)."""
        kff = self.map.kf_frame[kf]
        kf_pids = self.map.kf_point[kf]
        has_pt = (kf_pids >= 0) & self.map.valid_mask(kf_pids)
        desc = np.zeros((len(kf_pids), 8), np.uint32)
        desc[has_pt] = self.map.pt_desc[kf_pids[has_pt]]
        fd = frame.dev
        idx, best, keep = matchers.search_by_bow(convert.desc_to_torch(desc, self.device), self._tensor(has_pt),
                                                 kff.dev.angle, fd.desc, fd.valid, fd.angle, 0.75,
                                                 caller="relocalization")
        src, _ = matchers._resolve_collisions(idx, torch.where(keep, best, hamming.MAX_DIST), len(frame.valid))
        src = src.cpu().numpy()
        return np.where(src >= 0, kf_pids[np.clip(src, 0, None)], -1)

    # ------------------------------------------------------------------

    def _optimize(self, frame: FrameHost) -> int:
        """Motion-only pose optimization on the frame's matches; drops the
        outliers' matches. Returns the inlier count."""
        N = len(frame.valid)
        pw = np.zeros((N, 3), np.float32)
        pids = frame.point_ids
        valid = (pids >= 0) & self.map.valid_mask(pids)
        pw[valid] = self.map.pt_pos[pids[valid]]
        if valid.sum() < 3:
            return 0
        obs = np.concatenate([frame.uv, frame.u_right[:, None]], axis=1).astype(np.float32)
        inv_sig = (1.0 / self.frontend.level_sigma2[frame.octave]).astype(np.float32)
        t = self._tensor
        res = pose_opt.pose_optimize(
            t(frame.Tcw.astype(np.float32)), t(pw), t(obs), t(inv_sig), t(frame.u_right >= 0), t(valid),
            self.frontend.camera,
        )
        frame.Tcw = res.Tcw.cpu().numpy()
        frame.point_ids[valid & ~res.inlier.cpu().numpy()] = -1
        return int(res.n_inliers)

    def _widen(self, frame: FrameHost, kf: int, th: float, orb_dist: int) -> int:
        """SearchByProjection of the candidate keyframe's unmatched points
        into the frame (reference ORBmatcher.cpp:1317-1444, without the
        rotation check), then pose optimization again."""
        cam = self.config.camera
        kf_pids = self.map.kf_point[kf]
        already = np.unique(frame.point_ids[frame.point_ids >= 0])
        kff = self.map.kf_frame[kf]
        sel = (kf_pids >= 0) & self.map.valid_mask(kf_pids)
        sel &= ~np.isin(kf_pids, already)
        cand = kf_pids[sel]
        if cand.size == 0:
            return self._optimize(frame)
        pos = self.map.pt_pos[cand].astype(np.float64)
        Rcw = frame.Tcw[:3, :3].astype(np.float64)
        tcw = frame.Tcw[:3, 3].astype(np.float64)
        pc = pos @ Rcw.T + tcw
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        proj_ok = (z > 0) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        kp_free = frame.valid & (frame.point_ids < 0)
        fd = frame.dev
        t = self._tensor
        pfk, d = matchers.search_by_projection_frame(
            fd.uv, fd.octave, fd.desc, t(kp_free), fd.angle,
            t(np.stack([u, v], -1).astype(np.float32)), t(kff.octave[sel].astype(np.int32)),
            convert.desc_to_torch(self.map.pt_desc[cand], self.device), t(proj_ok),
            torch.zeros(len(cand), dtype=torch.float32, device=self.device),  # rotation check off
            self.frontend.scale_factors, th, False, False, check_rotation=False,
        )
        pfk, d = pfk.cpu().numpy(), d.cpu().numpy()
        new = (pfk >= 0) & (frame.point_ids < 0) & (d <= orb_dist)
        frame.point_ids[new] = cand[pfk[new]]
        return self._optimize(frame)
