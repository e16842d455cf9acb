"""Two faults of the JAX package's map that the port repairs (deliberate
divergences, ROADMAP queue 3), on the CPU.

- A culled keyframe leaves no observation behind, also where its point
  slot went stale (`SlamMap.remove_keyframe`; the reference's SetBadFlag,
  KeyFrame.cpp:443-536, erases every observation the keyframe holds).
- `System.load_map` indexes the loaded keyframes in the keyframe database,
  so the loaded map relocalizes a view of one of its keyframes.

Stated bars: no point observed by the dead keyframe, observation counts
and mirror rows equal to a recount, points left with <= 1 observation
culled; the loaded System relocalizes frame 2's view within 0.1 m of the
ground truth, as the System that made the map does.
"""

import os

import numpy as np
from _torch_parity import slam_config

from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.slam.frontend import FrameHost
from orbslam2_tpu_torch.slam.map import SlamMap
from orbslam2_tpu_torch.slam.system import System

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "vocab_generic.npz")


class _Frame:
    def __init__(self, n, stereo):
        self.u_right = np.where(stereo, 100.0, -1.0).astype(np.float32)
        self.point_ids = np.full(n, -1, np.int64)
        self.frame_id = 0
        self.timestamp = 0.0


def test_culled_keyframe_leaves_no_observation():
    rng = np.random.default_rng(0)
    n_kp = 8
    m = SlamMap(n_kp)
    kfs = [m.add_keyframe(_Frame(n_kp, rng.random(n_kp) < 0.5), np.eye(4)) for _ in range(3)]
    victim = kfs[1]
    p_stale = m.add_point(np.zeros(3), victim, np.zeros(8))
    p_two = m.add_point(np.ones(3), kfs[0], np.zeros(8))
    p_new = m.add_point(np.full(3, 2.0), kfs[0], np.zeros(8))
    for k in kfs:
        m.add_observation(p_stale, k, 5)
    m.add_observation(p_two, kfs[0], 1)
    m.add_observation(p_two, victim, 2)
    m.add_observation(p_new, kfs[0], 3)
    m.add_observation(p_new, kfs[2], 3)
    # the victim's slot 5 now names p_new: p_stale's observation by the
    # victim is stale, no slot of the victim names p_stale any more
    m.add_observation(p_new, victim, 5)
    assert m.kf_point[victim][5] == p_new and m.pt_obs[p_stale][victim] == 5

    m.remove_keyframe(victim)
    assert victim not in m.kf_valid
    for p in m.pt_ids().tolist():
        assert victim not in m.pt_obs[p], p
        n = int(m.pt_obs_n[p])
        assert sorted(m.pt_obs_kf[p, :n].tolist()) == sorted(m.pt_obs[p]), p
        assert victim not in m.pt_obs_kf[p].tolist(), p
        assert m.pt_nobs[p] == sum(m._obs_weight(k, i) for k, i in m.pt_obs[p].items()), p
        assert m.pt_ref_kf[p] != victim, p
    # p_two kept one observation and went, like the reference's SetBadFlag
    assert p_two not in m.pt_valid and m.kf_point[kfs[0]][1] == -1
    assert sorted(m.pt_obs[p_stale]) == [kfs[0], kfs[2]]
    assert sorted(m.pt_obs[p_new]) == [kfs[0], kfs[2]]


def test_loaded_map_relocalizes(tmp_path):
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    cfg = slam_config(world, torch_config)
    poses_gt, frames = world.render_sequence(3, step=0.06)
    s = System(VOCAB, cfg, enable_loop_closing=False, device="cpu")
    s.track_stereo(*frames[0], 0.0)
    path = str(tmp_path / "map.npz")
    s.save_map(path)

    fresh = System(VOCAB, cfg, enable_loop_closing=False, device="cpu")
    fresh.relocalizer.database.add(99, np.zeros(1, np.int64), {})  # emptied by the load
    fresh.load_map(path)
    assert sorted(fresh.relocalizer.database.kf_words) == sorted(s.map.kf_valid) == [0]
    for r in (s.relocalizer, fresh.relocalizer):
        frame = FrameHost(r.frontend.process(*frames[2]), 9.0, 101)
        assert r.relocalize(frame), r.trace[-1]
        centre = -frame.Tcw[:3, :3].T.astype(np.float64) @ frame.Tcw[:3, 3]
        gt = -poses_gt[2][:3, :3].T.astype(np.float64) @ poses_gt[2][:3, 3]
        assert np.linalg.norm(centre - gt) < 0.1
