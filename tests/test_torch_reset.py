"""The tracker's early-loss reset on the port's `System`, on the CPU.

With <= 5 keyframes a lost tracker resets itself (reference
Tracking.cpp:485-492). In the port that reset is `System.reset`: the map,
the tracker, the keyframe database, the mapper's queue and recent points,
the loop closer's state, with the database's erase hook kept. The JAX
package resets the tracker and the map alone there, and its map reset
drops the hook (ROADMAP queue 3). Stated bars: exact (empty containers,
the hook the same bound method).
"""

import os

import numpy as np
from _torch_parity import slam_config

from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.slam.system import System

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "vocab_generic.npz")


def test_early_loss_reset_is_the_full_reset():
    """A black frame after stereo initialization loses the tracker with one
    keyframe: the reset that follows empties the database and the loop
    state and keeps the erase hook."""
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    cfg = slam_config(world, torch_config)
    _, frames = world.render_sequence(1, step=0.06)
    s = System(VOCAB, cfg, device="cpu")
    s.track_stereo(*frames[0], 0.0)
    assert sorted(s.relocalizer.database.kf_words) == [0] and s.map.n_keyframes() == 1
    s.local_mapper.recent_points = [1, 2]
    s.loop_closer.consistent_groups = [({0}, 1)]
    s.loop_closer.last_loop_kf = 40
    black = np.zeros_like(frames[0][0])
    assert s.track_stereo(black, black, 0.05) is None
    assert s.map.n_keyframes() == 0 and s.tracker.state.name == "NO_IMAGES_YET"
    assert not s.relocalizer.database.kf_words and not s.relocalizer.database.kf_bow
    assert not s.local_mapper.recent_points and not s.local_mapper._queue
    assert not s.loop_closer.consistent_groups and s.loop_closer.last_loop_kf < 0
    assert s.map.on_keyframe_removed == s.relocalizer.remove_keyframe
