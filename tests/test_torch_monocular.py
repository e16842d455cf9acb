"""Parity of the port's monocular slice (`Tracker.track_mono`: the
initialization matching through K3 `mask`, the two-view initializer, the
initial map, then the unfused motion-model and local-map paths) against
the JAX tracker, on the first frames of tests/test_monocular.py's world.

Both trackers run without a local mapper (as tests/test_torch_tracking.py
does) over N_PARITY frames, on the same features (the port's front end's,
converted for the JAX tracker: the ORB parity is tests/test_torch_ops.py's
and tests/test_torch_frontend.py's, and compiling the JAX front end alone
would take a third of this file's budget), the port's initializer fed the
JAX tracker's own hypotheses (its Gumbel-top-8 draw from PRNGKey(frame
id), on the port's matches). Stated tolerances: the same state and
keyframe count every frame, the same initialization frame, the initial
points within 2 of JAX's count, the initial map's median depth 1 in both,
and the camera centres of the tracked frames within 1e-3 m (in the map's
unit-median-depth scale). N_PARITY = 3: frame 0 is the reference, frame 1
initializes, frame 2 is tracked through the reference-keyframe and
local-map paths and makes a keyframe. Frame 3 would take the motion-model
path (window 15), whose JAX compile (3-9 s on this CPU) passes the file's
20 s budget on one thread; the port takes it in `test_monocular_bars`.

The port alone over the 35 frames with its local mapper and the bars of
tests/test_monocular.py is `test_monocular_bars` (`slow`; on the card it
is chip_smoke.py's monocular phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import slam_config

from orbslam2_tpu import config as jax_config
from orbslam2_tpu.slam.frontend import FrameFeatures as JaxFeatures
from orbslam2_tpu.slam.frontend import Frontend as JaxFrontend
from orbslam2_tpu.slam.map import SlamMap as JaxMap
from orbslam2_tpu.slam.tracking import Tracker as JaxTracker
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.ops import hamming, initializer
from orbslam2_tpu_torch.slam.frontend import Frontend
from orbslam2_tpu_torch.slam.map import SlamMap
from orbslam2_tpu_torch.slam.system import Sensor, System
from orbslam2_tpu_torch.slam.tracking import Tracker, TrackingState

N_PARITY = 3


def _world():
    return SyntheticWorld(n_points=1200, seed=31, depth_range=(4.0, 10.0))


def _poses(n):
    """tests/test_monocular.py's trajectory."""
    out = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = -np.array([0.06 * i, 0.01 * np.sin(0.3 * i), 0.015 * i])
        out.append(T)
    return out


def _mono_config(world, module):
    cfg = slam_config(world, module)
    cfg.sensor = "monocular"
    return cfg


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


def _jax_hypotheses(uv1, uv2, valid, cam, generator, n_hyp=200, **kw):
    """`initializer.initialize_two_view` with the JAX tracker's draw in place
    of the port's: PRNGKey(frame id), the seed of the port's generator."""
    key = jax.random.PRNGKey(generator.initial_seed())
    v = jnp.asarray(valid.numpy())
    g = jax.random.gumbel(key, (n_hyp, v.shape[0])) + jnp.where(v, 0.0, -1e9)[None]
    idx = torch.from_numpy(np.asarray(jax.lax.top_k(g, 8)[1]).copy())
    return initializer.initialize_two_view_from_hypotheses(idx, uv1, uv2, valid, cam, **kw)


def _median_depth(m, kf, pids):
    T = m.kf_pose[kf].astype(np.float64)
    return float(np.median(m.pt_pos[pids] @ T[2, :3] + T[2, 3]))


def test_monocular_tracker_matches_jax(monkeypatch):
    world = _world()
    images = [world.render_stereo(T)[0] for T in _poses(N_PARITY)]
    tcfg = _mono_config(world, torch_config)
    tfe = Frontend(tcfg, "cpu")

    def features_for_jax(image):
        f = tfe.process_mono(image)
        return JaxFeatures(**{k: jnp.asarray(convert.desc_to_numpy(v) if k == "desc" else v.numpy())
                              for k, v in f._asdict().items()})

    jcfg = _mono_config(world, jax_config)
    jm = JaxMap(jcfg.orb.n_features)
    jfe = JaxFrontend(jcfg)
    jfe.process_mono = features_for_jax
    jt = JaxTracker(jcfg, jfe, jm)
    jax_out = []
    for i, im in enumerate(images):
        T = jt.track_mono(im, i / 20.0)
        jax_out.append((jt.state.name, T, jm.n_keyframes(), len(jm.pt_valid)))
        if i == 1:
            j_init = (bool(jt.state == jt.state.OK), sorted(int(p) for p in jm.pt_valid))

    monkeypatch.setattr(initializer, "initialize_two_view", _jax_hypotheses)
    tm = SlamMap(tcfg.orb.n_features)
    tt = Tracker(tcfg, tfe, tm)
    mono_init = hamming.best2.launches["mono_init"]
    out = []
    for i, im in enumerate(images):
        T = tt.track_mono(im, i / 20.0)
        out.append((tt.state.name, T, tm.n_keyframes(), len(tm.pt_valid)))
        if i == 1:
            pids = tm.pt_ids()
            assert abs(len(pids) - len(j_init[1])) <= 2
            assert _median_depth(tm, 0, pids) == pytest.approx(1.0, abs=1e-6)
            assert _median_depth(jm, 0, np.asarray(j_init[1])) == pytest.approx(1.0, abs=1e-5)
    assert hamming.best2.launches["mono_init"] == mono_init  # CPU tensors: the plain version

    assert [o[0] for o in out] == [o[0] for o in jax_out] == ["NOT_INITIALIZED"] + ["OK"] * (N_PARITY - 1)
    assert [o[2] for o in out] == [o[2] for o in jax_out] == [0, 2, 3]  # 2 at init, frame 2 adds one
    for i, ((_, Tt, _, _), (_, Tj, _, _)) in enumerate(zip(out, jax_out)):
        if Tt is not None:
            gap = np.linalg.norm(_center(Tt) - _center(np.asarray(Tj)))
            assert gap < 1e-3, (i, gap)
    # no keyframe carries a stereo observation
    assert all(np.all(tm.kf_frame[k].u_right < 0) for k in tm.kf_valid)


@pytest.mark.slow
def test_monocular_bars():
    """tests/test_monocular.py's bars on the port: System(sensor=MONOCULAR)
    with its inline local mapper over the 35 frames."""
    world = _world()
    poses = _poses(35)
    s = System(None, _mono_config(world, torch_config), sensor=Sensor.MONOCULAR, device="cpu")
    est = [s.track_monocular(world.render_stereo(T)[0], i / 20.0) for i, T in enumerate(poses)]
    m = s.map
    assert s.get_tracking_state() == TrackingState.OK
    assert sum(e is not None for e in est) >= len(est) - 5
    assert all(np.all(m.kf_frame[k].u_right < 0) for k in m.kf_valid)
    assert len(m.pt_valid) > 400
    pairs = [(g, e) for g, e in zip(poses, est) if e is not None]
    rmse = ate_rmse(np.stack([_center(e) for _, e in pairs]), np.stack([_center(g) for g, _ in pairs]),
                    with_scale=True)
    assert rmse < 0.06, rmse
    k0 = min(m.kf_pose)
    assert 0.2 < _median_depth(m, k0, np.asarray(list(m.pt_valid)[:200])) < 5.0
