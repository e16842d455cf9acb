"""Parity of the PyTorch port's stereo tracking against the JAX package, on
the synthetic world of tests/test_tracking.py (the port alone over the
whole 40-frame sequence is tests/test_torch_system.py).

Stated tolerances:
  * one fused frame step (`_full_step`) on the JAX tracker's own assembled
    arguments: motion and local-map matches (pfk, pfk2) equal on >= 99% of
    keypoints, Tcw within 1e-3 m / 1e-3 rad;
  * the port's tracker against the JAX tracker over the first 12 frames,
    both without a local mapper: the same state every frame, camera poses
    within 1 cm.
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
    return dict(jax_out=jax_out, port_out=port_out, jax_step=jax_step, port_step=port_step)


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
