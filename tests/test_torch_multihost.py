"""The port's sharded solvers over a real process group: two spawned
processes joined over a localhost TCP store (`parallel/multihost.py`,
gloo on the CPU), each holding one shard of `multihost.global_mesh()`,
run the sharded point-major BA and essential graph on the problems of
tests/torch_mp_worker.py (203 point rows: uneven row blocks). Both ranks'
results must equal the in-process 2-shard mesh's bit for bit: with two
shards each cross-shard sum adds the same two partials, and an addition
of two floats has the same bits in either order. The counterpart of the
JAX package's tests/test_multihost.py (`slow` there: its workers compile
XLA programs; these run eagerly in a few seconds)."""

import os
import socket
import subprocess
import sys

import numpy as np
import torch
from torch_mp_worker import build_problems, solve

from orbslam2_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_equal_the_in_process_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               CUDA_VISIBLE_DEVICES="")
    out, port = str(tmp_path / "rank"), str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-u", os.path.join(HERE, "torch_mp_worker.py"), str(r), "2", port,
                               out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        # the in-process reference while the ranks run
        torch.set_num_threads(1)
        want = solve(mesh.Mesh(["cpu"] * 2), *build_problems())
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    assert np.isfinite(want["chi2"]) and want["points"].shape == (203, 3)
    for r in range(2):
        got = np.load(f"{out}{r}.npz")
        assert sorted(got.files) == sorted(want)
        for name, a in want.items():
            assert got[name].dtype == a.dtype and np.array_equal(got[name], a), (r, name)
