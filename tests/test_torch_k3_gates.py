"""Kernel K3's gated modes on the CPU: the local-map matcher
(`search_by_projection_points`, whose gate has the stereo agreement)
against the JAX package's, and the rule by which the kernel prunes its
candidates, where the kernel cannot run.

Inputs: as tests/test_torch_matchers.py (one rendered SyntheticWorld pair,
600 keypoints per eye, rows placed exactly on a gate's edge and one
float32 ulp beyond), and the edge cases of `orbslam2_tpu_torch/kernels/
cases.py`.

Stated tolerances: the int32 indices and distances exact; the candidate
rule keeps every pair the gate keeps.
"""

import numpy as np
import pytest
import torch
from _torch_parity import jax_and_torch, matcher_pair, np_of, on_boundary, projected

from orbslam2_tpu.ops import matchers as jmatch
from orbslam2_tpu_torch.kernels import build, cases
from orbslam2_tpu_torch.ops import hamming
from orbslam2_tpu_torch.ops import matchers as tmatch

SF = (1.2 ** np.arange(8)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return matcher_pair()


def test_search_by_projection_points(pair):
    world, (cur, right) = pair
    rng = np.random.default_rng(22)
    P, th, k = 500, 1.0, 40
    sm = tmatch.stereo_match(*[torch.from_numpy(a) for a in (
        cur["uv"], cur["oct"], cur["desc"].view(np.int32), cur["valid"], right["uv"], right["oct"],
        right["desc"].view(np.int32), right["valid"], SF)], world.bf, world.baseline)
    ur_cur = sm.u_right.numpy()
    pick, uv, level, desc = projected(rng, cur, P)
    level = np.clip(cur["oct"][pick] + rng.integers(0, 2, P), 0, 7).astype(np.int32)
    ur_pt = np.where(ur_cur[pick] >= 0, ur_cur[pick], uv[:, 0] - 10.0).astype(np.float32)
    ur_pt = (ur_pt + rng.normal(0, 1.0, P)).astype(np.float32)
    vcos = rng.uniform(0.99, 1.0, P).astype(np.float32)
    # level-0 rows facing the camera (radius 2.5) at an octave-0 keypoint:
    # on the window's edge in v (first k), on the stereo agreement's edge
    # in right u (next k); half of each one ulp beyond
    cols0 = np.nonzero(cur["valid"] & (cur["oct"] == 0) & (ur_cur >= 0))[0]
    cols, v = on_boundary(rng, cur["uv"][:, 1], cols0, 2.5, k)
    uv[:k] = np.stack([cur["uv"][cols, 0], v], axis=1)
    ur_pt[:k] = ur_cur[cols]
    cols2, ur = on_boundary(rng, ur_cur, cols0, 2.5, k)
    uv[k:2 * k] = cur["uv"][cols2]
    ur_pt[k:2 * k] = ur
    both_cols = np.concatenate([cols, cols2])
    desc[:2 * k] = cur["desc"][both_cols]
    level[:2 * k] = 0
    vcos[:2 * k] = 1.0
    valid = rng.uniform(size=P) < 0.9
    args = (cur["uv"], cur["oct"], ur_cur, cur["desc"], cur["valid"], uv, ur_pt, level, vcos, desc, valid, SF)
    (pj, dj), (pt, dt) = jax_and_torch(jmatch.search_by_projection_points, tmatch.search_by_projection_points,
                              args, (3, 9), th)
    np.testing.assert_array_equal(np_of(pt), np_of(pj))
    np.testing.assert_array_equal(np_of(dt), np_of(dj))
    assert (np_of(pt) >= 0).sum() > 100


# ---------------------------------------------------------------------------
# K3's pruning, where the kernel cannot run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gated_cases():
    # the v-band modes (nodes mode prunes by node: tests/test_torch_loop_closing.py)
    return [(n, A, B, g) for n, A, B, g in cases.k3_cases("cpu")
            if isinstance(g, hamming.Gate) and g.mode != "nodes"]


def _candidates(g):
    """[N, M] bool: the columns each row's kernel scan visits."""
    col_bucket, first, last = hamming.candidate_buckets(g)
    b = col_bucket[None, :]
    return (b >= 0) & (b >= first[:, None]) & (b <= last[:, None])


def test_candidate_rule_contains_every_gated_pair(gated_cases):
    """The kernel's candidate rule (the valid columns counting-sorted into
    v buckets, each row scanning the buckets of v +- (r + slack)) keeps
    every pair the full gate keeps, on random, boundary and non-finite
    inputs."""
    kept = 0
    for name, _, _, g in gated_cases:
        gate = hamming.gate_mask(g)
        assert not bool((gate & ~_candidates(g)).any()), name
        kept += int(gate.sum())
    assert kept > 30000


def test_pruned_scan_equals_plain(gated_cases):
    """The kernel's algorithm in plain PyTorch: per row, only its candidate
    columns, the exact gate, (d << 32 | j) keys, and index 0 wherever a
    best or second distance is 256; equal to the plain version."""
    for name, A, B, g in gated_cases:
        scan = _candidates(g) & hamming.gate_mask(g)
        want = torch.stack(hamming.best2_gated_plain(A, B, g))
        got = torch.tensor([[0, 256, 0, 256]] * A.shape[0], dtype=torch.int32).T.contiguous()
        for i in range(A.shape[0]):
            j = scan[i].nonzero()[:, 0]
            if j.numel() == 0:
                continue
            keys = torch.sort(hamming.hamming_pair(A[i], B[j]).long() * 2**32 + j).values[:2]
            for slot, key in enumerate(keys.tolist()):
                d, idx = key >> 32, key & 0xFFFFFFFF
                if d < hamming.MAX_DIST:
                    got[2 * slot:2 * slot + 2, i] = torch.tensor([idx, d])
        assert torch.equal(got, want), name


def test_best2_answers_m0_on_every_path(monkeypatch):
    """M == 0: the plain versions answer (0, 256, 0, 256) per row, and the
    CUDA wrappers' launch logic passes M == 0 to the launcher instead of
    raising (run here on CPU tensors, with the launch recorded)."""
    A = torch.zeros((5, 8), dtype=torch.int32)
    B = torch.zeros((0, 8), dtype=torch.int32)
    mask = torch.zeros((5, 0), dtype=torch.bool)
    z = torch.zeros
    g = hamming.Gate("points", z((5, 2)), z(5), z(5, dtype=torch.int32), z(5, dtype=torch.bool),
                     z((0, 2)), z(0, dtype=torch.int32), z(0, dtype=torch.bool), row_ur=z(5), col_ur=z(0))
    for out in (hamming.best2(A, B, mask), hamming.best2_gated(A, B, g)):
        assert [t.tolist() for t in out] == [[0] * 5, [256] * 5, [0] * 5, [256] * 5]
    seen = []
    monkeypatch.setattr(build, "launch", lambda name, args: seen.append((name, args.n, args.m, args.mode)))
    for out, _ in (hamming._launch("mask", A, B, {"mask": mask}), hamming._launch_gated(A, B, g)):
        assert [tuple(t.shape) for t in out] == [(5,)] * 4
    assert seen == [("hamming_best2_launch", 5, 0, 0), ("hamming_best2_launch", 5, 0, 3)]
