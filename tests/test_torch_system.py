"""The options of the PyTorch port's `System` on the CPU: each constructs
and wires its stage. The System's run over the 40-frame sequence is in
tests/test_torch_system_run.py."""

import os

import pytest
from _torch_parity import slam_config

from orbslam2_tpu_torch import config as torch_config
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.parallel.mesh import Mesh
from orbslam2_tpu_torch.slam.system import System

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "vocab_generic.npz")


@pytest.mark.parametrize("kw", [
    dict(vocabulary=VOCAB, threaded=True), dict(vocabulary=VOCAB, mesh=Mesh(["cpu"] * 2)), dict(sensor="monocular"),
    dict(use_viewer=True), dict(settings=torch_config.SlamConfig(camera=torch_config.CameraConfig(k1=0.1))),
    dict(settings=torch_config.SlamConfig(pipelined_tracking=True)),
])
def test_refuses_unported_options(kw):
    """The options that were refused until loop closing on its own thread,
    a device mesh (routed to the loop closer), the monocular sensor,
    undistortion, the viewer and pipelined tracking were ported construct
    (the viewer's live thread runs until `shutdown` joins it)."""
    args = dict(vocabulary=None, settings=slam_config(SyntheticWorld(n_points=10, seed=0), torch_config),
                device="cpu")
    args.update(kw)
    s = System(**args)
    if "mesh" in kw:
        assert s.loop_closer.mesh is kw["mesh"] and s.loop_closer._dist_pg is None
    elif "threaded" in kw:
        assert s.loop_worker is not None and s.loop_closer.threaded_gba
    elif "sensor" in kw:
        assert s.config.monocular and s.tracker.config.monocular
    elif "use_viewer" in kw:
        assert s.viewer is not None and s.viewer._live_thread.is_alive()
    elif kw["settings"].pipelined_tracking:
        assert s.tracker.pipelined and s.tracker._pending == []
    else:
        assert s.frontend.has_distortion
    s.shutdown()
    assert "use_viewer" not in kw or (s.viewer._live_thread is None and s.viewer.live_error is None)
