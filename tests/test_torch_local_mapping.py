"""The port's tracker with its local mapper against the JAX package's pair,
built as in tests/test_local_mapping.py (same world, seed 11, 1200
features), on the CPU; then the port alone over the 45 frames with that
file's bars.

Stated tolerances: through frame 28, which runs the second local BA, the
same tracking state and keyframe count every frame and camera centres
within 1 cm (measured on this sequence: <= 0.23 mm over all 45 frames);
the port alone: all 45 frames tracked, ATE RMSE < 0.05 m, > 200 points
with two or more keyframe observations, every keyframe but the first
connected in the covisibility graph with a spanning-tree parent.
"""

import numpy as np
import pytest
from _torch_parity import slam_config

from orbslam2_tpu import config as jax_config
from orbslam2_tpu.slam.frontend import Frontend as JaxFrontend
from orbslam2_tpu.slam.local_mapping import LocalMapper as JaxMapper
from orbslam2_tpu.slam.map import SlamMap as JaxMap
from orbslam2_tpu.slam.tracking import Tracker as JaxTracker
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.slam.frontend import Frontend
from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
from orbslam2_tpu_torch.slam.map import SlamMap
from orbslam2_tpu_torch.slam.tracking import Tracker, TrackingState

N_FRAMES = 45
N_PARITY = 29  # frames 0..28: the second local BA runs on frame 28


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


def _pair(cfg_module, frontend_cls, map_cls, tracker_cls, mapper_cls, world, **kw):
    cfg = slam_config(world, cfg_module)
    frontend = frontend_cls(cfg, **kw)
    slam_map = map_cls(cfg.orb.n_features)
    tracker = tracker_cls(cfg, frontend, slam_map)
    tracker.local_mapper = mapper_cls(cfg, frontend, slam_map)
    return tracker


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(n_points=900, seed=11, baseline=0.2)
    poses_gt, frames = world.render_sequence(N_FRAMES, step=0.06)
    jt = _pair(jax_config, JaxFrontend, JaxMap, JaxTracker, JaxMapper, world)
    jax_out = []
    for i, (imL, imR) in enumerate(frames[:N_PARITY]):
        T = jt.track(imL, imR, i / 20.0)
        jax_out.append((jt.state.name, T, jt.map.n_keyframes()))
    tt = _pair(torch_config, Frontend, SlamMap, Tracker, LocalMapper, world, device="cpu")
    port_out, n_ba = [], []
    for i, (imL, imR) in enumerate(frames):
        T = tt.track(imL, imR, i / 20.0)
        port_out.append((tt.state.name, T, tt.map.n_keyframes()))
        n_ba.append(tt.local_mapper.n_local_ba)
    return dict(jax_out=jax_out, port_out=port_out, n_ba=n_ba, tracker=tt, poses_gt=poses_gt)


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
