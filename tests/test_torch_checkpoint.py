"""Map checkpoints cross between the packages: a map made by the port on the
CPU (6 frames of the synthetic world at 600 features, 3 keyframes) is
saved by the port and loaded by the JAX package's `checkpoint.load_map`;
the JAX package saves that map again and the port loads the result.

Stated bars: both directions give equal keyframe and point sets, poses and
positions (exact), observations and covisibility weights (equal), and
equal npz key sets, dtypes and shapes; a System's `save_map` / `load_map`
round trip gives each keyframe's device features `torch.equal` to the
original's, and `search_by_bow` equal results on them.
"""

import numpy as np
import pytest
import torch

from orbslam2_tpu.slam import checkpoint as jcheckpoint
from orbslam2_tpu.slam.map import SlamMap as JaxMap
from orbslam2_tpu_torch import config as C
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.ops import matchers
from orbslam2_tpu_torch.slam import checkpoint
from orbslam2_tpu_torch.slam.map import SlamMap
from orbslam2_tpu_torch.slam.system import System


@pytest.fixture(scope="module")
def system():
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    cfg = C.SlamConfig(camera=C.CameraConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf,
                                             width=world.width, height=world.height, fps=20.0),
                       orb=C.OrbConfig(n_features=600))
    s = System(None, cfg, device="cpu")
    _, frames = world.render_sequence(6, step=0.25)
    for i, (imL, imR) in enumerate(frames):
        s.track_stereo(imL, imR, i / 20.0)
    assert s.map.n_keyframes() >= 3
    # the covisibility weights as a loader derives them from the observations
    for k in sorted(s.map.kf_valid):
        s.map.update_connections(k)
    return s


def _same_map(a, b):
    """a, b: maps of either package."""
    assert set(a.kf_valid) == set(b.kf_valid)
    assert set(int(p) for p in a.pt_ids()) == set(int(p) for p in b.pt_ids())
    for k in a.kf_valid:
        np.testing.assert_array_equal(a.kf_pose[k], b.kf_pose[k])
        np.testing.assert_array_equal(a.kf_point[k], b.kf_point[k])
        assert a.covis[k] == b.covis[k], k
        assert a.parent.get(k) == b.parent.get(k)
        for name in ("uv", "octave", "angle", "response", "desc", "valid", "u_right", "depth"):
            np.testing.assert_array_equal(getattr(a.kf_frame[k], name), getattr(b.kf_frame[k], name), err_msg=name)
    pts = a.pt_ids()
    for name in ("pt_pos", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_ref_kf", "pt_nobs"):
        np.testing.assert_array_equal(getattr(a, name)[pts], getattr(b, name)[pts], err_msg=name)
    live = set(a.kf_valid)
    for p in pts:
        assert {k: i for k, i in a.pt_obs[int(p)].items() if k in live} == b.pt_obs[int(p)]
    assert a.keyframe_origins == b.keyframe_origins


def _layout(path):
    z = np.load(path)
    return {k: (z[k].dtype, z[k].shape) for k in z.files}


def test_files_cross_both_ways(system, tmp_path):
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save_map(system.map, port_file)
    jmap = JaxMap(system.map.n_kp, system.map.n_levels, system.map.scale_factor)
    jcheckpoint.load_map(jmap, port_file)
    _same_map(system.map, jmap)
    jcheckpoint.save_map(jmap, jax_file)
    assert _layout(port_file) == _layout(jax_file)
    back = SlamMap(system.map.n_kp, system.map.n_levels, system.map.scale_factor)
    checkpoint.load_map(back, jax_file, "cpu")
    _same_map(system.map, back)
    _same_map(jmap, back)


def test_system_round_trip(system, tmp_path):
    path = str(tmp_path / "map.npz")
    system.save_map(path)
    fresh = System(None, system.config, device="cpu")
    fresh.load_map(path)
    m, m2 = system.map, fresh.map
    _same_map(m, m2)
    for k in m.kf_valid:
        for a, b in zip(m.kf_frame[k].dev, m2.kf_frame[k].dev):
            assert torch.equal(a, b) and a.dtype == b.dtype
    lf = system.tracker.last_frame.dev
    k = max(m.kf_valid)
    got = [matchers.search_by_bow(mm.kf_frame[k].dev.desc, mm.kf_frame[k].dev.valid, mm.kf_frame[k].dev.angle,
                                  lf.desc, lf.valid, lf.angle, 0.7) for mm in (m, m2)]
    assert all(torch.equal(a, b) for a, b in zip(*got))
    assert int(got[0][2].sum()) > 50
    # the map is loaded under its lock, which it keeps
    assert m2.lock is fresh.tracker.map.lock
