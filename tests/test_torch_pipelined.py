"""The PyTorch port's pipelined tracking (`config.pipelined_tracking`) and
`System.precompile`, on the CPU (the kernels' plain versions). The
comparison of the pipelined tracker with the JAX package's, side by side,
is in tests/test_torch_tracking.py (it shares that file's JAX compiles).

Stated bars:
  * tests/test_pipelined_tracking.py's world (seed 11, 2400 points, 1000
    features, 24 frames, a k = 6 depth-3 vocabulary, mapping inline): its
    bars, tracking OK, nothing pending after shutdown, >= 22 solved
    trajectory entries of 24, ATE RMSE < 0.10 m; the pipeline engaged;
  * tests/test_system.py's return contract on its 12-frame world (seed 5,
    900 points): the synchronous mode returns the recorded (solved) pose
    bit for bit; the pipelined mode returns, on each frame it dispatched,
    the two-frame prediction, velocity x prev_velocity x the last applied
    pose (within 1e-5, float32 of a float64 product), and records >= 10
    solved poses of 12;
  * `System.precompile` on the first System leaves its map, keyframe
    database, trajectory, tracker, random streams, launch counters and
    stage timers as they were, and raises when a program it runs raises.
"""

import copy
import functools
import pickle

import numpy as np
import pytest
import torch

from orbslam2_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.ops import matchers
from orbslam2_tpu_torch.slam import precompile
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.slam.tracking import TrackingState
from orbslam2_tpu_torch.vocab import train

# six xdist workers share the machine: one intra-op thread each
torch.set_num_threads(1)


def _config(world, pipelined):
    return SlamConfig(
        camera=CameraConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf, width=world.width,
                            height=world.height, fps=20.0),
        orb=OrbConfig(n_features=1000), pipelined_tracking=pipelined)


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


def track(system, frames):
    """Track `frames`; returns (what track_stereo returned, per dispatched
    frame (index, the prediction from the tracker's state at dispatch))."""
    tracker, dispatched = system.tracker, []
    dispatch = tracker._track_pipelined

    def recording(images_u8, timestamp):
        # 1 + len(_pending) frames ahead; over two, the displacement over
        # the last two frames (the velocity twice without a previous one)
        v, prev = tracker.velocity.astype(np.float64), tracker.prev_velocity
        step = v @ (v if prev is None else prev.astype(np.float64)) if tracker._pending else v
        dispatched.append((tracker.frame_id, step @ tracker.last_frame.Tcw.astype(np.float64)))
        return dispatch(images_u8, timestamp)

    tracker._track_pipelined = recording
    rets = [system.track_stereo(imL, imR, i / 20.0) for i, (imL, imR) in enumerate(frames)]
    del tracker._track_pipelined
    return rets, dispatched


@pytest.fixture(scope="module")
def pipelined_run():
    world = SyntheticWorld(n_points=2400, seed=11, baseline=0.2)
    rng = np.random.default_rng(0)
    voc = train.train_vocabulary(rng.integers(0, 256, (2000, 32), dtype=np.uint8), k=6, depth=3,
                                 doc_ids=np.repeat(np.arange(20), 100), device="cpu")
    system = System(voc, _config(world, True), device="cpu")
    poses_gt, frames = world.render_sequence(24, step=0.04)
    _, dispatched = track(system, frames)
    system.wait_idle()
    system.shutdown()
    return system, poses_gt, dispatched


def test_pipelined_slice_meets_the_jax_bars(pipelined_run):
    system, poses_gt, dispatched = pipelined_run
    assert system.get_tracking_state() == TrackingState.OK
    assert system.tracker._pending == []
    assert len(dispatched) >= 10
    traj = system.tracker.trajectory
    assert len(traj) == len(poses_gt)
    pairs = [(g, e.Tcw) for g, e in zip(poses_gt, traj) if e.Tcw is not None and not e.lost]
    assert len(pairs) >= len(poses_gt) - 2
    rmse = ate_rmse(np.stack([_center(e) for _, e in pairs]), np.stack([_center(g) for g, _ in pairs]))
    assert rmse < 0.10, rmse


def _snapshot(system):
    """Everything `precompile` must leave as it was, as comparable values."""
    m, t = system.map, system.tracker
    skip = ("lock", "on_keyframe_removed", "kf_frame")
    return dict(
        map=pickle.dumps({k: v for k, v in vars(m).items() if k not in skip}),
        kf_frames={kf: f.frame_id for kf, f in m.kf_frame.items()},
        database=pickle.dumps(vars(system.relocalizer.database)),
        trajectory=pickle.dumps([(e.Tcr, e.ref_kf, e.timestamp, e.lost, e.Tcw) for e in t.trajectory]),
        tracker=pickle.dumps((t.state, t.frame_id, t.n_inliers, t.ref_kf, t.velocity, t.last_frame.frame_id,
                              t.last_frame.Tcw, t.last_frame.point_ids, t.last_reloc_frame_id, t.last_kf_id,
                              list(t.local_keyframes), np.asarray(t.local_points), len(t._pending),
                              t.only_tracking, len(t.events))),
        streams=[g.get_state() for g in (system.relocalizer.generator, system.loop_closer.generator)],
        counters=[c[2] for c in precompile.launch_counts()],
        timers=copy.deepcopy(system.timers.samples),
    )


def test_precompile_leaves_no_trace_and_raises(pipelined_run, monkeypatch):
    system = pipelined_run[0]
    # emulate a card's launch counts: a launch the warm-up makes counts
    for owner, name in precompile.COUNTED:
        counts = getattr(owner, name).launches
        if isinstance(counts, dict):
            monkeypatch.setitem(counts, next(iter(counts)), 7)
        else:
            monkeypatch.setattr(getattr(owner, name), "launches", 7)
    optimize = precompile.pose_opt.pose_optimize

    def counting(*a, **k):
        counting.launches += 1
        return optimize(*a, **k)

    counting.launches = 7
    monkeypatch.setattr(precompile.pose_opt, "pose_optimize", counting)
    before = _snapshot(system)
    assert system.precompile() > 0
    assert counting.launches == 7
    after = _snapshot(system)
    for key in before:
        if key == "streams":
            assert all(torch.equal(a, b) for a, b in zip(before[key], after[key]))
        else:
            assert before[key] == after[key], key

    def failing(*a, **k):
        raise RuntimeError("frame matching failed")

    # the first program after the front end (a later one fails the same way)
    monkeypatch.setattr(matchers, "search_by_projection_frame", failing)
    with pytest.raises(RuntimeError, match="frame matching failed"):
        system.precompile()
    assert [c[2] for c in precompile.launch_counts()] == before["counters"]


@functools.lru_cache(maxsize=None)
def _contract_world():
    """tests/test_system.py's 12-frame world (seed 5, 900 points), rendered
    once for both modes."""
    world = SyntheticWorld(n_points=900, seed=5, baseline=0.2)
    return world, world.render_sequence(12, step=0.06)[1]


@pytest.mark.parametrize("pipelined", [False, True])
def test_track_stereo_return_contract(pipelined):
    world, frames = _contract_world()
    system = System(None, _config(world, pipelined), device="cpu")
    rets, dispatched = track(system, frames)
    if not pipelined:
        traj = system.tracker.trajectory
        assert len(traj) == len(rets) and not dispatched
        for r, e in zip(rets[1:], traj[1:]):
            if r is not None and e.Tcw is not None:
                np.testing.assert_array_equal(r, e.Tcw)
        return
    system.tracker.flush_pipeline()
    traj = system.tracker.trajectory
    assert len(traj) == len(rets)
    assert len([e for e in traj if e.Tcw is not None and not e.lost]) >= len(rets) - 2
    assert len(dispatched) >= 6
    for i, want in dispatched:
        assert rets[i].shape == (4, 4) and np.all(np.isfinite(rets[i]))
        np.testing.assert_allclose(rets[i], want, atol=1e-5)
        # the prediction, not the solved pose recorded one frame later
        assert not np.array_equal(rets[i], traj[i].Tcw)
