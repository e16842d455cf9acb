"""Parity of the PyTorch port's stereo tracking against the JAX package, on
the synthetic world of tests/test_tracking.py (the port alone over the
whole 40-frame sequence is tests/test_torch_system.py).

Stated tolerances:
  * one fused frame step (`_full_step`) on the JAX tracker's own assembled
    arguments: motion and local-map matches (pfk, pfk2) equal on >= 99% of
    keypoints, Tcw within 1e-3 m / 1e-3 rad;
  * the port's tracker against the JAX tracker over the first 12 frames,
    both without a local mapper: the same state every frame, camera poses
    within 1 cm;
  * the same, both with `pipelined_tracking` on: the same frames dispatched
    by the pipeline; every prediction returned on a dispatched frame within
    1e-5 of its two-frame motion model applied to the last applied pose,
    from that tracker's own state at dispatch (float32 of a float64
    product): the JAX package's velocity twice, the port's displacement
    over the last two frames (a deliberate divergence, `Tracker.
    _assemble_fused`); the solved poses of the trajectories within 1 cm, as
    in the synchronous run (the solve does not depend on the prediction
    while the matches stay in their window). The JAX pipelined tracker
    reuses the synchronous one's compiled programs: each tracker is reset
    and run again.
"""

import jax
import numpy as np
import pytest
from _torch_parity import rot_err, slam_config

from orbslam2_tpu import config as jax_config
from orbslam2_tpu.slam.frontend import Frontend as JaxFrontend
from orbslam2_tpu.slam.map import SlamMap as JaxMap
from orbslam2_tpu.slam.tracking import Tracker as JaxTracker
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.slam.frontend import Frontend
from orbslam2_tpu_torch.slam.map import SlamMap
from orbslam2_tpu_torch.slam.tracking import Tracker

N_PARITY = 12


def _u8(im):
    return np.clip(np.rint(im), 0, 255).astype(np.uint8)


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


def _restart_pipelined(tracker):
    """The tracker as a new one, with pipelining on, keeping its compiled
    programs (the JAX tracker's jit closures belong to the instance, and a
    new one would trace and compile them again)."""
    tracker.reset()
    tracker.frame_id = tracker.last_kf_id = 0
    tracker._cand_cache = None
    tracker.pipelined = True


def _pipelined(tracker, frames):
    """Track `frames` with the tracker's pipeline on and drain it; returns
    (what track returned, per dispatched frame (index, the prediction from
    the tracker's state at dispatch)). Either package's tracker."""
    dispatched = []
    dispatch = tracker._track_pipelined

    def recording(images_u8, timestamp):
        # the prediction spans 1 + len(_pending) frames; over two, the JAX
        # package applies the velocity twice, the port applies the
        # displacement over the last two frames (velocity x prev_velocity;
        # the velocity twice while it has no previous one)
        v = np.asarray(tracker.velocity, np.float64)
        prev = getattr(tracker, "prev_velocity", None)
        step = v @ (v if prev is None else np.asarray(prev, np.float64)) if tracker._pending else v
        dispatched.append((tracker.frame_id, step @ np.asarray(tracker.last_frame.Tcw, np.float64)))
        return dispatch(images_u8, timestamp)

    tracker._track_pipelined = recording
    rets = [tracker.track(imL, imR, timestamp=i / 20.0) for i, (imL, imR) in enumerate(frames)]
    tracker.flush_pipeline()
    return rets, dispatched


@pytest.fixture(scope="module")
def runs():
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    _, frames = world.render_sequence(N_PARITY + 1, step=0.06)
    cfg = slam_config(world, jax_config)

    jt = JaxTracker(cfg, JaxFrontend(cfg), JaxMap(cfg.orb.n_features))
    jax_out = []
    for i in range(N_PARITY):
        T = jt.track(*frames[i], timestamp=i / 20.0)
        jax_out.append((jt.state.name, T))
    # one fused step on the JAX tracker's assembled arguments (next frame)
    assert jt._can_fuse()
    images_u8 = np.stack([_u8(im) for im in frames[N_PARITY]])
    args, _ = jt._assemble_fused(images_u8)
    jax_step = jax.device_get(jt._jit_full_step(*args))

    # tracker-only parity: the port's Tracker without a mapper, as the JAX one
    tcfg = slam_config(world, torch_config)
    tt = Tracker(tcfg, Frontend(tcfg, "cpu"), SlamMap(tcfg.orb.n_features))
    port_out = []
    for i, (imL, imR) in enumerate(frames[:N_PARITY]):
        T = tt.track(imL, imR, timestamp=i / 20.0)
        port_out.append((tt.state.name, T))
    port_step = tt._full_step(*convert.full_step_args_to_torch(args, "cpu"))

    # both trackers again from the start, pipelined
    pipelined = {}
    for name, t in (("jax", jt), ("port", tt)):
        _restart_pipelined(t)
        pipelined[name] = (t, *_pipelined(t, frames[:N_PARITY]))
    return dict(jax_out=jax_out, port_out=port_out, jax_step=jax_step, port_step=port_step, pipelined=pipelined)


def test_full_step_on_jax_arguments(runs):
    (_, jhost), (_, thost) = runs["jax_step"], runs["port_step"]
    for name in ("pfk", "pfk2"):
        a, b = np.asarray(jhost[name]), thost[name].numpy()
        assert (a == b).mean() >= 0.99, (name, (a == b).mean())
        assert (a >= 0).sum() > 50
    Tj, Tt = np.asarray(jhost["Tcw"]), thost["Tcw"].numpy()
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-3
    assert rot_err(Tt[:3, :3], Tj[:3, :3]) <= 1e-3


def test_tracker_matches_jax(runs):
    for i, ((sj, Tj), (st, Tt)) in enumerate(zip(runs["jax_out"], runs["port_out"])):
        assert sj == st, (i, sj, st)
        assert (Tj is None) == (Tt is None), i
        if Tj is not None:
            assert np.linalg.norm(_center(np.asarray(Tj)) - _center(Tt)) < 0.01, i


def test_pipelined_tracker_matches_jax(runs):
    (jt, jrets, jdisp), (tt, trets, tdisp) = runs["pipelined"]["jax"], runs["pipelined"]["port"]
    assert [i for i, _ in tdisp] == [i for i, _ in jdisp] and len(tdisp) >= 6
    for rets, disp in ((jrets, jdisp), (trets, tdisp)):
        for i, want in disp:
            np.testing.assert_allclose(np.asarray(rets[i]), want, atol=1e-5)
    assert len(jt.trajectory) == len(tt.trajectory) == N_PARITY and not tt._pending
    for i, (a, b) in enumerate(zip(jt.trajectory, tt.trajectory)):
        assert a.lost == b.lost, i
        assert np.linalg.norm(_center(np.asarray(a.Tcw)) - _center(b.Tcw)) < 0.01, i
