"""The port's relocalization wiring on the CPU: vocabulary files against the
JAX package's loaders, `System` with a vocabulary, attempts that must not
raise, `System.reset` keeping the database's erase hook, and the calls
that stay unported. The tracker's early-loss reset is in
tests/test_torch_reset.py.

The relocalizer's parity with the JAX package's on one tracked map, and
localization mode over tracked frames, are in
tests/test_torch_local_mapping.py, which reuses that file's tracked maps.

Stated tolerances: the DBoW2 text and .npz loaders give the JAX package's
arrays exactly; a relocalization attempt on a black frame, or against a
keyframe left with 3 map points, returns False without raising and ends
at its gate (`db_candidates`, `bow`); the view of a tracked frame
relocalizes within 0.1 m of the ground truth.
"""

import os

import numpy as np
import pytest
import torch
from _torch_parity import slam_config

from orbslam2_tpu.vocab import bow as jax_bow
from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.kernels import cases
from orbslam2_tpu_torch.slam.frontend import FrameHost
from orbslam2_tpu_torch.slam.relocalization import Relocalizer
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.vocab import bow

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "vocab_generic.npz")


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


def _write_dbow2_text(path, children_idx, node_desc, word_weight, node_word, k, depth):
    """A DBoW2 text vocabulary (TemplatedVocabulary.h:1382-1416) of a tree
    given as its children table."""
    lines = [f"{k} {depth} 0 0"]
    parent = np.full(len(node_word), -1)
    for node, row in enumerate(children_idx):
        parent[row[row >= 0]] = node
    for node in range(1, len(node_word)):
        leaf = node_word[node] >= 0
        w = word_weight[node_word[node]] if leaf else 0.0
        d = " ".join(str(b) for b in np.ascontiguousarray(node_desc[node]).view(np.uint8))
        lines.append(f"{parent[node]} {int(leaf)} {d} {w:.6f}")
    path.write_text("\n".join(lines) + "\n")


def test_vocabulary_files_match_jax(tmp_path):
    (cd, ci, nw, ww, k, depth), node_desc = cases.ragged_tree(np.random.default_rng(0))
    txt = tmp_path / "voc.txt"
    _write_dbow2_text(txt, ci, node_desc, ww, nw, k, depth)
    jv, tv = jax_bow.load_dbow2_text(str(txt)), bow.load_dbow2_text(str(txt), "cpu")
    for name in ("children_desc", "children_idx", "node_word", "word_weight"):
        want = np.asarray(getattr(jv, name))
        got = getattr(tv, name).numpy()
        np.testing.assert_array_equal(got.view(want.dtype) if name == "children_desc" else got, want)
    assert (tv.k, tv.depth) == (jv.k, jv.depth)
    # .npz: the JAX package's file loads to the same tables, and the port
    # writes the JAX package's layout back
    jg = jax_bow.load_npz(VOCAB)
    tg = bow.load_npz(VOCAB, "cpu")
    cg = convert.vocabulary_to_torch(jg, "cpu")
    for name in ("children_desc", "children_idx", "node_word", "word_weight"):
        assert torch.equal(getattr(tg, name), getattr(cg, name)), name
    bow.save_npz(tv, str(tmp_path / "voc.npz"))
    back = jax_bow.load_npz(str(tmp_path / "voc.npz"))
    np.testing.assert_array_equal(np.asarray(back.children_desc), np.asarray(jv.children_desc))
    np.testing.assert_array_equal(np.asarray(back.word_weight), np.asarray(jv.word_weight))
    # System takes a path (npz or text) or a Vocabulary
    world = SyntheticWorld(n_points=50, seed=1, baseline=0.2)
    cfg = slam_config(world, torch_config)
    for voc in (VOCAB, str(txt), tv):
        s = System(voc, cfg, enable_loop_closing=False, device="cpu")
        assert s.relocalizer is not None and s.tracker.relocalizer is s.relocalizer
        assert s.relocalizer.vocab.n_words == (tg.n_words if voc == VOCAB else tv.n_words)


def test_unported_calls_raise():
    world = SyntheticWorld(n_points=50, seed=1, baseline=0.2)
    cfg = slam_config(world, torch_config)
    # loop closing runs inline, or with threaded=True on a LoopWorker with
    # the global BA on its own thread; a viewer runs on a thread of its own
    # until shutdown
    s = System(VOCAB, cfg, use_viewer=True, device="cpu")
    assert s.viewer is not None and s.viewer._live_thread.is_alive()
    s.shutdown()
    assert s.viewer._live_thread is None and s.viewer.live_error is None
    s = System(VOCAB, cfg, device="cpu")
    assert s.loop_closer is not None and s.local_mapper.on_processed == s.loop_closer.insert_keyframe
    assert s.loop_closer.on_pose_jump == s.tracker.apply_pose_jump
    assert not s.loop_closer.threaded_gba and s.loop_closer.fix_scale
    s = System(VOCAB, cfg, threaded=True, device="cpu")
    assert s.loop_worker is not None and s.local_mapper.on_processed == s.loop_worker.submit
    assert s.loop_closer.threaded_gba
    s.shutdown()
    s = System(VOCAB, cfg, enable_loop_closing=False, device="cpu")
    assert s.loop_closer is None
    r = Relocalizer(s.config, s.frontend, s.map, s.vocabulary, solver="mlpnp")
    assert r.solver == "mlpnp"
    with pytest.raises(ValueError):
        Relocalizer(s.config, s.frontend, s.map, s.vocabulary, solver="p3p")


def test_system_relocalizes_and_never_raises():
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    cfg = slam_config(world, torch_config)
    poses_gt, frames = world.render_sequence(3, step=0.06)
    s = System(VOCAB, cfg, enable_loop_closing=False, device="cpu")
    s.track_stereo(*frames[0], 0.0)
    # the mapper processed keyframe 0 inline and indexed it
    assert sorted(s.relocalizer.database.kf_words) == [0]
    assert s.map.on_keyframe_removed == s.relocalizer.remove_keyframe
    reloc = s.relocalizer

    def attempt(images, frame_id):
        frame = FrameHost(s.frontend.process(*images), 9.0, frame_id)
        return reloc.relocalize(frame), frame

    black = np.zeros_like(frames[0][0])
    ok, _ = attempt((black, black), 100)
    assert not ok and reloc.trace[-1]["stage"] == "db_candidates"
    ok, frame = attempt(frames[2], 101)
    assert ok and reloc.trace[-1]["cands"][0]["stage"] == "accepted"
    assert np.linalg.norm(_center(frame.Tcw) - _center(poses_gt[2])) < 0.1
    # keyframe 0 keeps 3 map points: the RANSAC's hypotheses all take
    # invalid points, and the attempt ends at the BoW gate
    pids = s.map.kf_point[0]
    for pid in pids[pids >= 0][3:]:
        s.map.remove_point(int(pid))
    ok, _ = attempt(frames[2], 102)
    assert not ok and reloc.trace[-1]["cands"][0]["stage"] == "bow"
    # localization mode switches, and reset empties the database
    s.activate_localization_mode()
    assert s.tracker.only_tracking and s.local_mapper.is_stopped()
    s.deactivate_localization_mode()
    assert not s.tracker.only_tracking and not s.local_mapper.is_stopped()
    s.reset()
    assert not reloc.database.kf_words
    # the reset keeps the database's erase hook
    assert s.map.on_keyframe_removed == s.relocalizer.remove_keyframe

