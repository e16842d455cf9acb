"""The port's tracker with its local mapper alone over the 45 frames of
tests/test_local_mapping.py (same world, seed 11, 1200 features), on the
CPU, with that file's bars; then localization mode on its map. The
parity with the JAX package's pair through frame 28, and relocalization
on the map of frame 28, are in tests/test_torch_local_mapping_jax.py; both
files read one run of the port's sequence (the "port" part of
tests/_torch_local_mapping_run.py).

Stated bars: all 45 frames tracked, ATE RMSE < 0.05 m, > 200 points with
two or more keyframe observations, every keyframe but the first
connected in the covisibility graph with a spanning-tree parent.
Localization mode: after frame 44 the port tracks 6 more frames with
mapping stopped: every frame tracked, no keyframe added, the map's points
unchanged, visual-odometry points matched.
"""

import numpy as np
import pytest
from _torch_local_mapping_run import center, shared_part

from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.slam.tracking import TrackingState


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_part(tmp_path_factory, "port")


def test_tracks_with_mapping(runs):
    est = [T for _, T, _ in runs["port_out"]]
    assert runs["mapping"]["state"] == TrackingState.OK.name
    assert all(T is not None for T in est)
    rmse = ate_rmse(np.stack([center(T) for T in est]), np.stack([center(T) for T in runs["poses_gt"]]))
    assert rmse < 0.05, rmse


def test_triangulation_grows_map(runs):
    mapping = runs["mapping"]
    assert mapping["n_processed"] >= 2 and mapping["n_created"] > 0
    assert mapping["multi_obs"] > 200, mapping["multi_obs"]


def test_covisibility_graph_connected(runs):
    for kf, (has_covis, has_parent) in runs["mapping"]["covis"].items():
        if kf == 0:
            continue
        assert has_covis, f"kf {kf} isolated in covisibility graph"
        assert has_parent, f"kf {kf} missing spanning-tree parent"


def test_localization_mode(runs):
    loc = runs["localization"]
    assert all(state == "OK" and T is not None for state, T, _, _ in loc["out"])
    assert not any(fused for *_, fused in loc["out"])
    assert loc["n_kf"][0] == loc["n_kf"][1]
    assert loc["n_pts"][0] == loc["n_pts"][1]
    assert sum(n_temp for _, _, n_temp, _ in loc["out"]) > 0
    for i, (_, T, _, _) in enumerate(loc["out"]):
        assert np.linalg.norm(center(T) - center(runs["poses_loc"][i])) < 0.1, i
