"""The port imports without JAX and without the JAX package, its copies of
the JAX package's JAX-free modules equal their originals, and its kernel
wrappers choose their path by the device of the tensor they are given."""

import ast
import concurrent.futures
import dataclasses
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from orbslam2_tpu import config as jconfig
from orbslam2_tpu.evaluation import analyze as janalyze
from orbslam2_tpu.evaluation import ate as jate
from orbslam2_tpu.slam import timing as jtiming
from orbslam2_tpu_torch import config as tconfig
from orbslam2_tpu_torch.evaluation import analyze as tanalyze
from orbslam2_tpu_torch.evaluation import ate as tate
from orbslam2_tpu_torch.geometry.camera import make_camera
from orbslam2_tpu_torch.kernels import build
from orbslam2_tpu_torch.ops import fast, hamming, orb, patches, pose_opt
from orbslam2_tpu_torch.slam import timing as ttiming
from orbslam2_tpu_torch.vocab import bow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: the module groups checked by `test_imports_without_jax`
IMPORT_GROUPS = [
    "orbslam2_tpu_torch.slam.system",
    "orbslam2_tpu_torch.slam.local_mapping",
    "orbslam2_tpu_torch.datasets.synthetic",
    "orbslam2_tpu_torch.evaluation.ate",
    "orbslam2_tpu_torch.convert",
    "orbslam2_tpu_torch.vocab.bow, orbslam2_tpu_torch.vocab.database, orbslam2_tpu_torch.ops.pnp, "
    "orbslam2_tpu_torch.slam.relocalization",
    "orbslam2_tpu_torch.geometry.sim3, orbslam2_tpu_torch.ops.sim3solve, orbslam2_tpu_torch.ops.posegraph, "
    "orbslam2_tpu_torch.slam.loop_closing",
    "orbslam2_tpu_torch.ops.initializer, orbslam2_tpu_torch.ops.undistort, orbslam2_tpu_torch.ops.mlpnp, "
    "orbslam2_tpu_torch.geometry.triangulation",
    "orbslam2_tpu_torch.slam.checkpoint, orbslam2_tpu_torch.slam.viewer, orbslam2_tpu_torch.datasets.png, "
    "orbslam2_tpu_torch.datasets.euroc, orbslam2_tpu_torch.datasets.kitti",
    "orbslam2_tpu_torch.drivers.run_euroc, orbslam2_tpu_torch.drivers.run_kitti, "
    "orbslam2_tpu_torch.drivers.run_synthetic, orbslam2_tpu_torch.evaluation.associate, "
    "orbslam2_tpu_torch.evaluation.analyze, orbslam2_tpu_torch.vocab.train",
    "orbslam2_tpu_torch.parallel.mesh, orbslam2_tpu_torch.parallel.dist_ba, "
    "orbslam2_tpu_torch.parallel.dist_posegraph, orbslam2_tpu_torch.parallel.multihost",
]
BLOCKED = ("jax", "orbslam2_tpu", "cv2", "matplotlib", "PIL")


def _import_blocked(module):
    code = (
        f"import sys; blocked = {BLOCKED!r}; sys.modules.update(dict.fromkeys(blocked)); "
        f"import {module}; "
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m in blocked or m.startswith(tuple(b + '.' for b in blocked)))]; "
        "print('ok' if not bad else bad)"
    )
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def blocked_imports():
    """Every group imported in a fresh interpreter of its own, 4 at a time."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        return dict(zip(IMPORT_GROUPS, pool.map(_import_blocked, IMPORT_GROUPS)))


@pytest.mark.parametrize("module", IMPORT_GROUPS)
def test_imports_without_jax(module, blocked_imports):
    """Each module imports with JAX, the JAX package, OpenCV, matplotlib and
    PIL blocked, and loads none of them."""
    out = blocked_imports[module]
    assert out.returncode == 0 and out.stdout.strip() == "ok", (out.stdout, out.stderr)


def _code_below_docstring(path):
    tree = ast.parse(open(path).read())
    tree.body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    return ast.dump(tree)


@pytest.mark.parametrize("part", ["config", "timing", "ate", "pattern", "pipeline", "associate", "analyze"])
def test_copies_equal_jax_package(part, tmp_path, capsys):
    if part == "config":
        for name in ("CameraConfig", "OrbConfig", "RectifyConfig"):
            assert dataclasses.asdict(getattr(tconfig, name)()) == dataclasses.asdict(
                getattr(jconfig, name)())
        t, j = tconfig.SlamConfig(), jconfig.SlamConfig()
        jax_only = {"shapes"}
        assert [f.name for f in dataclasses.fields(t)] == [
            f.name for f in dataclasses.fields(j) if f.name not in jax_only]
        for f in dataclasses.fields(t):  # every default equal to JAX's
            a, b = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert (t.baseline, t.depth_threshold, t.max_frames) == (j.baseline, j.depth_threshold, j.max_frames)
    elif part == "timing":
        t, j = ttiming.StageTimers(), jtiming.StageTimers()
        for timers in (t, j):
            for us in (10.0, 30.0):
                timers.samples.setdefault("Total tracking", []).append(us)
        assert t.report() == j.report()
        for name in ("TRACKING_STAGES", "LOCAL_MAPPING_STAGES", "LOOP_CLOSING_STAGES"):
            assert getattr(ttiming, name) == getattr(jtiming, name)
    elif part == "ate":
        rng = np.random.default_rng(1)
        gt = rng.normal(size=(40, 3))
        est = gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(0, 0.01, (40, 3))
        for with_scale in (False, True):
            assert tate.ate_rmse(est, gt, with_scale=with_scale) == jate.ate_rmse(
                est, gt, with_scale=with_scale)
        for align in (False, True):
            assert tate.ate_mean_abs(est, gt, align) == jate.ate_mean_abs(est, gt, align)
        t_a, t_b = np.sort(rng.uniform(0, 10, 50)), np.sort(rng.uniform(0, 10, 70))
        for got, want in zip(tate.associate_by_time(t_a, t_b, 0.05), jate.associate_by_time(t_a, t_b, 0.05)):
            np.testing.assert_array_equal(got, want)
        path = _tum_file(tmp_path / "traj.txt", rng, 30)
        np.testing.assert_array_equal(tate.load_tum_trajectory(path), jate.load_tum_trajectory(path))
    elif part == "associate":
        assert _code_below_docstring(os.path.join(ROOT, "orbslam2_tpu", "evaluation", "associate.py")) == \
            _code_below_docstring(os.path.join(ROOT, "orbslam2_tpu_torch", "evaluation", "associate.py"))
    elif part == "analyze":
        # the same report on the same files; the port has no --plot
        rng = np.random.default_rng(2)
        est, gt = _tum_file(tmp_path / "est.txt", rng, 40), _tum_file(tmp_path / "gt.txt", rng, 40)
        outputs = []
        for module in (tanalyze, janalyze):
            assert module.main([est, gt]) == 0
            outputs.append(capsys.readouterr().out)
        assert outputs[0] == outputs[1] and "ATE RMSE" in outputs[0]
    elif part == "pipeline":
        assert _code_below_docstring(os.path.join(ROOT, "orbslam2_tpu", "slam", "pipeline.py")) == \
            _code_below_docstring(os.path.join(ROOT, "orbslam2_tpu_torch", "slam", "pipeline.py"))
    else:
        with open(os.path.join(ROOT, "orbslam2_tpu", "ops", "orb_pattern.npy"), "rb") as a, \
                open(os.path.join(ROOT, "orbslam2_tpu_torch", "ops", "orb_pattern.npy"), "rb") as b:
            assert a.read() == b.read()


def _tum_file(path, rng, n):
    t = np.arange(n) * 0.05 + rng.uniform(0, 0.004, n)
    q = rng.normal(size=(n, 4))
    rows = np.column_stack([t, rng.normal(size=(n, 3)), q / np.linalg.norm(q, axis=1, keepdims=True)])
    np.savetxt(path, rows, header="t x y z qx qy qz qw")
    return str(path)


def test_no_jax_import_in_port_sources():
    """No JAX, JAX package, OpenCV, matplotlib or PIL import anywhere in the
    port or its card scripts, not even behind a `try`."""
    pattern = re.compile(r"^\s*(import jax|from jax|import orbslam2_tpu\b(?!_)|from orbslam2_tpu\b(?!_)"
                         r"|(import|from) (cv2|matplotlib|PIL)\b)", re.M)
    files = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "kernel_device_ab.py", "threaded_pace_probe.py",
                                             "threaded_slice_probe.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "orbslam2_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = [f for f in files if pattern.search(open(f).read())]
    assert not hits, hits


def test_wrappers_refuse_other_devices():
    img = torch.zeros((2, 40, 40), device="meta")
    with pytest.raises(ValueError):
        fast.fast_nms(img)
    xs = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        patches.orb_patch_desc(img, xs, xs)
    d = torch.zeros((3, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hamming.best2(d, d, torch.zeros((3, 3), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        hamming.best2_gated(d, d, _gate("meta"))
    with pytest.raises(ValueError):
        hamming.best2_gated(d, d, _nodes_gate("meta"), "loop")
    with pytest.raises(ValueError):
        bow.transform_words_nodes(_vocabulary("meta"), d, torch.ones(3, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        orb.select_keypoints_levels([img], [10], 20.0, 7.0)
    p = torch.zeros((3, 3), device="meta")
    flags = torch.ones(3, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        pose_opt.pose_optimize(torch.eye(4, device="meta"), p, p, p[:, 0], flags, flags,
                               make_camera(458.0, 457.0, 376.0, 240.0, 47.9))


def _vocabulary(device):
    """A root with two leaf children."""
    cd = np.zeros((3, 2, 8), np.uint32)
    cd[0, 1] = 0xFFFFFFFF
    ci = np.array([[1, 2], [-1, -1], [-1, -1]], np.int32)
    voc = bow.from_arrays(cd, ci, np.array([-1, 0, 1], np.int32), np.ones(2, np.float32), 2, 1, "cpu")
    return bow.to_device(voc, device)


def _gate(device):
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    return hamming.Gate("points", z(3, 2), z(3), z(3, dtype=torch.int32), z(3, dtype=torch.bool),
                        z(3, 2), z(3, dtype=torch.int32), z(3, dtype=torch.bool), row_ur=z(3), col_ur=z(3))


def _nodes_gate(device):
    flags = torch.ones(3, dtype=torch.bool, device=device)
    nodes = torch.zeros(3, dtype=torch.int32, device=device)
    return hamming.Gate("nodes", row_valid=flags, col_valid=flags, row_node=nodes, col_node=nodes)


def test_cpu_tensors_take_the_plain_version():
    before = (fast.fast_nms_levels.launches, patches.orb_patch_desc_levels.launches, dict(hamming.best2.launches))
    gated_before = dict(hamming.best2_gated.launches)
    img = torch.rand((2, 48, 64)) * 255
    fast.fast_nms(img)
    xs = torch.full((2, 3), 20, dtype=torch.int32)
    patches.orb_patch_desc(img, xs, xs)
    d = torch.zeros((3, 8), dtype=torch.int32)
    hamming.best2(d, d, torch.ones((3, 3), dtype=torch.bool))
    hamming.best2(d, d, torch.ones((3, 3), dtype=torch.bool), caller="epipolar_match")
    hamming.best2_gated(d, d, _gate("cpu"))
    hamming.best2_gated(d, d, _gate("cpu")._replace(mode="fuse", col_isig=torch.ones(3)))
    hamming.best2_gated(d, d, _gate("cpu")._replace(mode="fuse", col_isig=torch.ones(3)), "loop_fusion")
    assert [t.tolist() for t in hamming.best2_gated(d, d, _nodes_gate("cpu"), "loop")] == [[0] * 3, [0] * 3,
                                                                                             [1] * 3, [0] * 3]
    k4_before = bow.transform_words_nodes.launches
    words, nodes = bow.transform_words_nodes(_vocabulary("cpu"), d, torch.tensor([True, False, True]))
    assert words.tolist() == [0, -1, 0] and nodes.tolist() == [1, -1, 1]
    after = (fast.fast_nms_levels.launches, patches.orb_patch_desc_levels.launches, dict(hamming.best2.launches))
    assert after == before
    assert hamming.best2_gated.launches == gated_before
    assert bow.transform_words_nodes.launches == k4_before


def test_launch_counters_do_not_lose_updates():
    """The mapping worker thread counts K3 launches beside the tracker: 16
    threads adding to one counter, with the interpreter switching threads
    every microsecond, lose no update."""
    counts, n_threads, n_adds = {"k": 0}, 16, 2000

    def add():
        for _ in range(n_adds):
            hamming._count(counts, "k", True)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counts["k"] == n_threads * n_adds


def test_kernel_library_key_tracks_sources():
    path = build.library_path()
    assert path == build.library_path()
    assert os.path.basename(os.path.dirname(path)) == "kernels"
    assert {os.path.basename(s) for s in build._sources()} >= {
        "orb_patch_desc.cu", "fast_nms.cu", "hamming_best2.cu", "bow_transform.cu"}


def test_failed_build_raises(monkeypatch):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_nvcc", lambda: "/bin/false")
    monkeypatch.setattr(build, "library_path", lambda: os.path.join(ROOT, "build", "kernels", "never.so"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.load()
