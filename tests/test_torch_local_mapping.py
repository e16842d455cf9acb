"""The port's tracker with its local mapper against the JAX package's pair,
built as in tests/test_local_mapping.py (same world, seed 11, 1200
features), on the CPU; then the port alone over the 45 frames with that
file's bars; then relocalization and localization mode on those maps.

Stated tolerances: through frame 28, which runs the second local BA, the
same tracking state and keyframe count every frame and camera centres
within 1 cm (measured on this sequence: <= 0.23 mm over all 45 frames);
the port alone: all 45 frames tracked, ATE RMSE < 0.05 m, > 200 points
with two or more keyframe observations, every keyframe but the first
connected in the covisibility graph with a spanning-tree parent.

Relocalization: on the map of frame 28 each package gets a Relocalizer
with the same vocabulary (the JAX package's `vocab/train.py`, k = 8,
depth 3, as tests/test_relocalization.py trains it, carried across with
`convert.vocabulary_to_torch`) and every keyframe indexed; both
relocalize the kidnapped view of frame 16: the same database candidates,
camera centres within 1 cm of each other and within 0.1 m of the ground
truth. `relocalize` changes only the frame it is given, so the trackers
run on undisturbed. Localization mode: after frame 44 the port tracks 6
more frames with mapping stopped: every frame tracked, no keyframe added,
the map's points unchanged, visual-odometry points matched.
"""

import numpy as np
import pytest
from _torch_parity import slam_config

from orbslam2_tpu import config as jax_config
from orbslam2_tpu.slam.frontend import Frontend as JaxFrontend
from orbslam2_tpu.slam.local_mapping import LocalMapper as JaxMapper
from orbslam2_tpu.slam.frontend import FrameHost as JaxFrameHost
from orbslam2_tpu.slam.map import SlamMap as JaxMap
from orbslam2_tpu.slam.relocalization import Relocalizer as JaxRelocalizer
from orbslam2_tpu.slam.tracking import Tracker as JaxTracker
from orbslam2_tpu.vocab import train
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.slam.frontend import FrameHost, Frontend
from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
from orbslam2_tpu_torch.slam.map import SlamMap
from orbslam2_tpu_torch.slam.relocalization import Relocalizer
from orbslam2_tpu_torch.slam.tracking import Tracker, TrackingState

N_FRAMES = 45
N_PARITY = 29  # frames 0..28: the second local BA runs on frame 28
KIDNAPPED = 16  # the view shown to both relocalizers on frame 28's map
N_LOCALIZATION = 6  # frames tracked in localization mode after frame 44


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


def _pair(cfg_module, frontend_cls, map_cls, tracker_cls, mapper_cls, world, **kw):
    cfg = slam_config(world, cfg_module)
    frontend = frontend_cls(cfg, **kw)
    slam_map = map_cls(cfg.orb.n_features)
    tracker = tracker_cls(cfg, frontend, slam_map)
    tracker.local_mapper = mapper_cls(cfg, frontend, slam_map)
    return tracker


def _train_vocabulary(slam_map):
    """tests/test_relocalization.py's vocabulary: k = 8, depth 3, from the
    first 400 valid descriptors of every keyframe."""
    descs, docs = [], []
    for kf in sorted(slam_map.kf_valid):
        f = slam_map.kf_frame[kf]
        d = f.desc[f.valid][:400]
        descs.append(np.ascontiguousarray(d).view(np.uint8))
        docs.append(np.full(len(d), kf))
    return train.train_vocabulary(np.concatenate(descs), k=8, depth=3, doc_ids=np.concatenate(docs))


def _relocalize(reloc_cls, frame_cls, tracker, vocab, frame_images, frame_id):
    """Index every keyframe of the tracker's map, then relocalize the view:
    (database candidates, relocalized Tcw or None, the relocalizer)."""
    reloc = reloc_cls(tracker.config, tracker.frontend, tracker.map, vocab)
    for kf in sorted(tracker.map.kf_valid):
        reloc.add_keyframe(kf)
    frame = frame_cls(tracker.frontend.process(*frame_images), 99.0, frame_id)
    words, vec = reloc.compute_bow(frame.desc, frame.valid)
    cands = reloc.database.detect_relocalization_candidates(words, vec, tracker.map)
    ok = reloc.relocalize(frame)
    return cands, (np.asarray(frame.Tcw) if ok else None), reloc


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(n_points=900, seed=11, baseline=0.2)
    poses_gt, frames = world.render_sequence(N_FRAMES + N_LOCALIZATION, step=0.06)
    jt = _pair(jax_config, JaxFrontend, JaxMap, JaxTracker, JaxMapper, world)
    jax_out = []
    for i, (imL, imR) in enumerate(frames[:N_PARITY]):
        T = jt.track(imL, imR, i / 20.0)
        jax_out.append((jt.state.name, T, jt.map.n_keyframes()))
    voc = _train_vocabulary(jt.map)
    jax_reloc = _relocalize(JaxRelocalizer, JaxFrameHost, jt, voc, frames[KIDNAPPED], N_PARITY)
    tt = _pair(torch_config, Frontend, SlamMap, Tracker, LocalMapper, world, device="cpu")
    port_out, n_ba = [], []
    for i, (imL, imR) in enumerate(frames[:N_FRAMES]):
        T = tt.track(imL, imR, i / 20.0)
        port_out.append((tt.state.name, T, tt.map.n_keyframes()))
        n_ba.append(tt.local_mapper.n_local_ba)
        if i == N_PARITY - 1:
            port_reloc = _relocalize(Relocalizer, FrameHost, tt, convert.vocabulary_to_torch(voc, "cpu"),
                                     frames[KIDNAPPED], N_PARITY)
    # localization mode: mapping stopped, visual-odometry points
    n_kf, n_pts = tt.map.n_keyframes(), len(tt.map.pt_valid)
    tt.only_tracking = True
    tt.local_mapper.request_stop()
    loc_out = []
    for i in range(N_FRAMES, N_FRAMES + N_LOCALIZATION):
        T = tt.track(*frames[i], i / 20.0)
        loc_out.append((tt.state.name, T, len(tt.last_frame.temp_points), tt._can_fuse()))
    localization = dict(out=loc_out, n_kf=(n_kf, tt.map.n_keyframes()), n_pts=(n_pts, len(tt.map.pt_valid)))
    return dict(jax_out=jax_out, port_out=port_out, n_ba=n_ba, tracker=tt, poses_gt=poses_gt[:N_FRAMES],
                poses_loc=poses_gt[N_FRAMES:], reloc=(jax_reloc, port_reloc), localization=localization)


def test_matches_jax_through_second_local_ba(runs):
    assert runs["n_ba"][N_PARITY - 1] >= 2
    for i, ((sj, Tj, kj), (st, Tt, kt)) in enumerate(zip(runs["jax_out"], runs["port_out"])):
        assert (sj, kj) == (st, kt), i
        assert (Tj is None) == (Tt is None), i
        if Tj is not None:
            assert np.linalg.norm(_center(np.asarray(Tj)) - _center(Tt)) < 0.01, i


def test_tracks_with_mapping(runs):
    tracker, est = runs["tracker"], [T for _, T, _ in runs["port_out"]]
    assert tracker.state == TrackingState.OK
    assert all(T is not None for T in est)
    rmse = ate_rmse(np.stack([_center(T) for T in est]), np.stack([_center(T) for T in runs["poses_gt"]]))
    assert rmse < 0.05, rmse


def test_triangulation_grows_map(runs):
    tracker = runs["tracker"]
    assert tracker.local_mapper.n_processed >= 2 and tracker.local_mapper.n_created > 0
    multi_obs = sum(1 for p in tracker.map.pt_valid if len(tracker.map.pt_obs[p]) >= 2)
    assert multi_obs > 200, multi_obs


def test_covisibility_graph_connected(runs):
    m = runs["tracker"].map
    for kf in m.kf_valid:
        if kf == 0:
            continue
        assert m.covis.get(kf), f"kf {kf} isolated in covisibility graph"
        assert kf in m.parent, f"kf {kf} missing spanning-tree parent"


def test_relocalization_matches_jax(runs):
    (jc, jT, _), (tc, tT, reloc) = runs["reloc"]
    assert len(jc) > 0 and tc == jc
    assert jT is not None and tT is not None
    assert reloc.trace[-1]["ok"] and reloc.trace[-1]["cands"][-1]["stage"] == "accepted"
    assert np.linalg.norm(_center(tT) - _center(jT)) < 0.01
    gt = _center(runs["poses_gt"][KIDNAPPED])
    assert np.linalg.norm(_center(tT) - gt) < 0.1 and np.linalg.norm(_center(jT) - gt) < 0.1


def test_localization_mode(runs):
    loc = runs["localization"]
    assert all(state == "OK" and T is not None for state, T, _, _ in loc["out"])
    assert not any(fused for *_, fused in loc["out"])
    assert loc["n_kf"][0] == loc["n_kf"][1]
    assert loc["n_pts"][0] == loc["n_pts"][1]
    assert sum(n_temp for _, _, n_temp, _ in loc["out"]) > 0
    for i, (_, T, _, _) in enumerate(loc["out"]):
        assert np.linalg.norm(_center(T) - _center(runs["poses_loc"][i])) < 0.1, i
