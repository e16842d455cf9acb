"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It

  1. prints the card (`nvidia-smi` name and power limit) and the versions;
  2. builds the port's CUDA kernels from `orbslam2_tpu_torch/csrc/`
     (into `build/kernels/`) and prints the build time;
  3. holds K1 and K2 against their plain PyTorch versions on the card at
     the main path's shapes (a rendered 752x480 stereo pair: one K2 launch
     over its 8 levels x 2 images, one K1 launch over its 2400 keypoints),
     K1 against the per-level plain calls, which read each window from a
     reflect-padded copy of the level; holds every mode of the Hamming
     kernel K3 against its plain version (gate + `best2_plain`) on the
     edge cases of `kernels/cases.py` and, in mask mode, on random and
     tie-heavy 1200x1200 masks; holds the BoW tree-descent kernel K4
     against its plain version on its edge cases (trees numbered
     depth-first, deeper and shallower than its staged levels, leaves
     inside them) and prints the levels it stages; times the wrapper and
     the plain version with CUDA events around back-to-back calls; and
     computes each kernel's bound (bytes or operations at the published
     peaks) from the inputs;
  4. drives the main path, `System("assets/vocab_generic.npz", cfg,
     enable_loop_closing=False).track_stereo` on the card, over the
     40-frame synthetic sequence of tests/test_tracking.py, with the
     local mapper inline on every keyframe and every processed keyframe
     indexed in the BoW database (one K4 launch each), recording the
     arguments of
     every K3 call of frame 1 (mask mode, search_by_bow), of a steady
     fused frame (stereo, frame and points modes) and of the first
     keyframe's mapping pass that launched both mapper modes (mask mode
     for epipolar_match, one call per neighbour; fuse mode, one call per
     fusion target and one backward); checks that every kernel and K3
     mode was launched there (K1, K2 and K3's stereo mode exactly once
     per frame; on every fused frame one points launch and no
     search_by_bow mask launch: the mapper's epipolar mask launches are
     counted apart), that the mapper processed >= 2 keyframes, created
     points by triangulation and ran >= 1 local BA on CUDA tensors, that
     >= 39 frames tracked with ATE RMSE < 0.06 m, and that the first
     frames agree with the port's plain CPU path (mapping included), that
     the database holds every live keyframe and K4 launched once per
     processed keyframe; holds each K3 mode, and K4 on one indexed
     keyframe's descriptors, exactly against its plain version on the
     recorded arguments and times it there;
  5. relocalization, on the same system: 3 black frames (the tracker goes
     LOST without a reset, each attempt ends at `db_candidates`), then
     frame 16's view (relocalized within 0.1 m of the ground truth), then
     frames 17-24 tracked; K4 launched once per attempt (plus once per
     keyframe processed meanwhile), K3's mask mode under the caller
     `relocalization`; the accepting attempt's trace record and host ms,
     its device kernels (a replay of the attempt under `torch.profiler`),
     its K3 call and its K4 call held exactly against the plain versions,
     its EPnP RANSAC
     against the plain CPU path on the recorded arguments and hypotheses
     (pose within 1e-3 m and 1e-3 rad, inlier counts within 2);
  6. loop closing (its own phase, on a System of its own):
     `System("assets/vocab_generic.npz", cfg)` with loop closing on (the
     default), on the card, over the whole 591-frame figure-8 of the
     bench's loop world (bench.py:171-175), rendered ahead by
     RENDER_WORKERS spawned processes; launch counts set to 0 just before
     and read just after; checks 591/591 tracked, 2 loops closed, ATE
     RMSE < 0.30 m (the bar of tests/test_loop_closing.py; the JAX
     package's TPU record, 0.264 m, is printed beside it for comparison
     only) and that K3 `nodes:loop`, `fuse:sim3` and `fuse:loop_fusion`
     launched; prints each loop's keyframe, candidate and gate counts,
     the rejected Sim3 attempts by gate, the loop stages' host ms (the
     shutdown report) and the global BA's size; holds those K3 rows
     exactly against their plain versions on recorded calls and times
     them; holds the card's Sim3 RANSAC against the CPU on a recorded
     call's hypotheses (the same inliers, S12 within 1e-6) and a recorded
     essential graph against the CPU (camera centres within 1e-4 m), and
     replays that graph under `torch.profiler` (host ms, device ms,
     device kernels); prints a digest of the rendered frames, of the
     per-frame poses and of the final keyframe poses, so that two runs
     compare line by line;
  6b. reproducibility: replays one recorded local BA (the slice's first),
     one recorded global BA and one recorded essential graph (the loop
     phase's first) twice each on the card and requires the replays
     bit-identical (`torch.equal`) to each other and to the recorded
     result; the fixed-order segment sum under them likewise on a
     collision-heavy input;
  7. localization mode: 8 frames after `activate_localization_mode()`,
     all tracked, no keyframe, no new map point, no fused step,
     visual-odometry points matched; then `deactivate_localization_mode()`
     and frames 33-39;
  8. times each kernel alone by its `torch.profiler` durations, K4 also
     with 2 and 3 staged levels (between
     phases 6 and 7: after the slice, so that no profiler session
     precedes the slice's frames, and before the long profile phase);
     profiles 10 more frames (per traced stage: host and device ms and
     device kernels, per frame for the tracker's stages and per call for
     the mapper's), in which mapping has resumed; prints each kernel's
     launches per frame, times, bound and roofline share;
  9. runs `System(vocabulary, cfg, enable_loop_closing=False,
     threaded=True)` over the 40 frames: the
     mapper and the keyframe indexing (K4) on the worker thread, >= 39
     frames tracked, ATE RMSE < 0.06 m, every live keyframe indexed,
     `wait_idle` without a worker error;
  10. prints one JSON line describing the kernels (one row per K3 mode and
     caller, and K4), then the result line.

It exits non-zero, and prints no result, when any phase fails, when no
CUDA card is visible, or when the port cannot be imported.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.kernels import build, cases
from orbslam2_tpu_torch.geometry import sim3
from orbslam2_tpu_torch.ops import ba, fast, hamming, orb, patches, pnp, posegraph, sim3solve
from orbslam2_tpu_torch.slam.frontend import FrameHost
from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.slam.tracking import TrackingState
from orbslam2_tpu_torch.vocab import bow

N_FRAMES = 40
VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "vocab_generic.npz")
# relocalization: black frames, the kidnapped view, the frames tracked after
# it; then the frames of localization mode, then mapping again
N_BLACK = 3
KIDNAPPED = 16
RESUMED = range(17, 25)
LOCALIZATION = range(25, 33)
MAPPING_AGAIN = range(33, N_FRAMES)
# the first two mapped keyframes and a local BA fall in the first 20 frames
N_CPU_FRAMES = 20
N_PROFILE_FRAMES = 10
# frames whose K3 calls are recorded: frame 1 takes the reference-keyframe
# path (mask mode), REC_FRAME is a steady fused frame
REC_FRAMES = (1, 20)
REC_FRAME = 20
# published H100 SXM peaks (NVIDIA data sheet): HBM3 and fp32 outside the
# tensor cores; the integer and min/max operations of the kernels are
# counted against the fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K2, per pixel: 16 ring differences, 64 min and 64 max for the 16 arcs of
# 9 by log-doubling, 32 max for the score, 8 max and 2 compares for the NMS
K2_OPS_PER_PX = 16 + 128 + 32 + 10
# K1, per keypoint: row and column blur multiply-adds, the two moments over
# the radius-15 disc, 256 comparisons
K1_FLOP_PER_KP = 2 * (48 * 42 * 7 + 42 * 42 * 7) + 4 * int(convert.IC_MASK.sum()) + 256
# K3, per gated pair: xor, popcount and add for each of 8 words
K3_OPS_PER_PAIR = 24
K3_SOURCE = "orbslam2_tpu_torch/csrc/hamming_best2.cu"
# K4, per descriptor and visited child: xor, popcount and add for each of 8
# words; per visited node its k child rows (32 B) and ids (4 B)
K4_OPS_PER_CHILD = 24
K4_BYTES_PER_CHILD = 36
# name -> the kernel's name in the profiler's trace (a K3 mode is the
# instantiation over its gate functor) and the TPU-side function it replaces
KERNELS = {
    "fast_nms": dict(kernel="fast_nms_kernel", source="orbslam2_tpu_torch/csrc/fast_nms.cu",
                     replaces="orbslam2_tpu/ops/fast.py:25"),
    "orb_patch_desc": dict(kernel="orb_patch_desc_kernel", source="orbslam2_tpu_torch/csrc/orb_patch_desc.cu",
                           replaces="orbslam2_tpu/ops/patches.py:103"),
    "hamming_best2:mask": dict(kernel="GateMask", source=K3_SOURCE, replaces="orbslam2_tpu/ops/hamming.py:27"),
    "hamming_best2:stereo": dict(kernel="GateStereo", source=K3_SOURCE,
                                 replaces="orbslam2_tpu/ops/matchers.py:189"),
    "hamming_best2:frame": dict(kernel="GateFrame", source=K3_SOURCE,
                                replaces="orbslam2_tpu/ops/matchers.py:256"),
    "hamming_best2:points": dict(kernel="GatePoints", source=K3_SOURCE,
                                 replaces="orbslam2_tpu/ops/matchers.py:440"),
    "hamming_best2:fuse": dict(kernel="GateFuse", source=K3_SOURCE, replaces="orbslam2_tpu/ops/matchers.py:384"),
    "hamming_best2:mask:epipolar": dict(kernel="GateMask", source=K3_SOURCE,
                                        replaces="orbslam2_tpu/ops/matchers.py:343"),
    "hamming_best2:mask:relocalization": dict(kernel="GateMask", source=K3_SOURCE,
                                              replaces="orbslam2_tpu/slam/relocalization.py:85", path="relocalization"),
    "bow_transform": dict(kernel="bow_transform_kernel", source="orbslam2_tpu_torch/csrc/bow_transform.cu",
                          replaces="orbslam2_tpu/vocab/bow.py:57"),
    "hamming_best2:nodes:loop": dict(kernel="GateNodes", source=K3_SOURCE,
                                     replaces="orbslam2_tpu/ops/matchers.py:127", path="loop"),
    "hamming_best2:fuse:sim3": dict(kernel="GateFuse", source=K3_SOURCE,
                                    replaces="orbslam2_tpu/slam/loop_closing.py:680", path="loop"),
    "hamming_best2:fuse:loop_fusion": dict(kernel="GateFuse", source=K3_SOURCE,
                                           replaces="orbslam2_tpu/slam/loop_closing.py:922", path="loop"),
}
# K3's rows: the tracker's modes, then the mapper's (mask mode under its
# caller epipolar_match); the relocalizer's mask row is recorded on its path
K3_ROWS = ("mask", "stereo", "frame", "points", "fuse", "mask:epipolar")
# a mask-mode call's row by its caller
MASK_ROWS = {"search_by_bow": "mask", "epipolar_match": "mask:epipolar", "relocalization": "mask:relocalization"}
MAPPER_ROWS = ("fuse", "mask:epipolar")
# the mapper's stages (its shutdown-report spans), reported per call
MAPPING_STAGES = ("Keyframe insertion", "Map point culling", "Map point creation", "Map point fusion",
                  "Local BA", "Keyframe culling")
# the loop phase: the bench's loop world (bench.py:171-175) over its whole
# figure-8 (two distinct loops), System(VOCAB, cfg) with loop closing on
LOOP_WORLD = dict(n_points=2000, seed=21, baseline=0.2, vertical_extent=6.0, cylinder_radius=11.0,
                  near_fraction=0.15, noise_sigma=1.5, exposure_drift=0.05)
LOOP_ATE_BAR = 0.30  # the bar of tests/test_loop_closing.py
LOOP_TPU_ATE = 0.264  # BENCH_r05.json: a TPU run of the JAX package, shown for comparison only
LOOP_STAGES = ("Loop detection", "Sim3 detection", "Loop propagate", "Loop fusion", "Essential graph",
               "Global BA")
LOOP_ROWS = ("nodes:loop", "fuse:sim3", "fuse:loop_fusion")
# processes rendering the figure-8 ahead of the tracker (the sprite
# renderer takes ~2 s of host time per frame)
RENDER_WORKERS = 6


def launch_counts() -> dict:
    """Every kernel's launch counter, by KERNELS name."""
    c = {"fast_nms": fast.fast_nms_levels.launches, "orb_patch_desc": patches.orb_patch_desc_levels.launches,
         "bow_transform": bow.transform_words_nodes.launches}
    c.update({f"hamming_best2:{row}": hamming.best2.launches[caller] for caller, row in MASK_ROWS.items()})
    c.update({f"hamming_best2:{m}": n for m, n in hamming.best2_gated.launches.items()})
    return c


def reset_launch_counts():
    fast.fast_nms_levels.launches = 0
    patches.orb_patch_desc_levels.launches = 0
    bow.transform_words_nodes.launches = 0
    for counts in (hamming.best2.launches, hamming.best2_gated.launches):
        for k in counts:
            counts[k] = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


#: failed checks whose phase's later diagnostics still run; main() fails on
#: them before it prints any result
DEFERRED = []


def check_later(cond, msg):
    if not cond:
        print(f"chip_smoke check failed (reported at the end): {msg}")
        DEFERRED.append(msg)


def cuda_ms(fn, reps=20, batch=10, warmup=3) -> float:
    """Milliseconds per call of fn(): CUDA events around `batch` back-to-back
    calls, divided by `batch`; the median of `reps` such batches. A call's
    host-side launch cost is included wherever it exceeds the device time,
    as it is on the main path."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def slam_config(world) -> SlamConfig:
    return SlamConfig(
        camera=CameraConfig(
            fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
            bf=world.bf, width=world.width, height=world.height, fps=20.0,
        ),
        orb=OrbConfig(n_features=1200),
    )


def level_inputs(images: torch.Tensor, params: orb.OrbParams):
    """The main path's K2 and K1 inputs, as orb.extract builds them: the
    pyramid levels [2, h, w] and per level the keypoints xs, ys."""
    levels = [images]
    for size in orb.level_sizes(*images.shape[1:], params)[1:]:
        levels.append(orb.pyramid_level(levels[-1], size))
    xs_l, ys_l = [], []
    for img, n_t, s in zip(levels, orb.features_per_level(params), fast.fast_nms_levels_plain(levels)):
        xs, ys, _, valid = orb._select_level_keypoints(s, n_t, params.ini_th, params.min_th)
        xs_l.append(torch.where(valid, xs, orb.KP_BORDER))
        ys_l.append(torch.where(valid, ys, orb.KP_BORDER))
    return levels, xs_l, ys_l


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `nbytes` and do `ops` operations, at the published H100 SXM peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device-only milliseconds of one launch of `kernel` made by fn(): the
    median of its `torch.profiler` durations over `reps` calls, one
    profiler session per call. A session whose trace lost the launch is
    skipped; at least half of them must show it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    durs = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and kernel in e.name]
        check(len(seen) <= 1, f"one call launched {kernel} {len(seen)} times")
        durs += seen
    check(2 * len(durs) >= reps, f"profiler saw {len(durs)} of {reps} launches of {kernel}")
    return statistics.median(durs) / 1e3


# Each check_* holds a kernel against its plain version and returns
# (max_abs_err, wrapper and plain times, bound, the timed wrapper call).


def check_fast_nms(levels):
    got, want = fast.fast_nms_levels(levels), fast.fast_nms_levels_plain(levels)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(torch.equal(g, w), f"fast_nms_levels differs from plain at {tuple(g.shape)}")
        err = max(err, float((g - w).abs().max()))
    px = sum(img.numel() for img in levels)
    call = lambda: fast.fast_nms_levels(levels)
    timing = dict(ms=cuda_ms(call), plain_ms=cuda_ms(lambda: fast.fast_nms_levels_plain(levels)))
    print(f"K2 fast_nms_levels: one launch, exact on all {len(levels)} levels x "
          f"{levels[0].shape[0]} images ({px} px)")
    # read and write each pixel once; K2_OPS_PER_PX operations per pixel
    return err, timing, bound(8.0 * px, K2_OPS_PER_PX * px), call


def check_orb_patch_desc(levels, xs_l, ys_l):
    a, d = patches.orb_patch_desc_levels(levels, xs_l, ys_l)
    # the per-level plain calls: windows from a reflect-padded copy of each
    # level, not the kernel's own reflect indexing
    per_level = [patches.orb_patch_desc_plain(img, xs, ys) for img, xs, ys in zip(levels, xs_l, ys_l)]
    a0, d0 = torch.cat([p[0] for p in per_level], dim=1), torch.cat([p[1] for p in per_level], dim=1)
    torch.cuda.synchronize()
    dang = torch.remainder(a.double() - a0.double() + np.pi, 2 * np.pi) - np.pi
    ang_err = float(dang.abs().max())
    flips = (d ^ d0).cpu().numpy().view(np.uint8)
    ber = float(np.unpackbits(flips).mean())
    n_kp = a.numel()
    print(f"K1 orb_patch_desc_levels: one launch, {n_kp} keypoints over {len(levels)} levels, "
          f"max angle error {ang_err:.3e} rad, bit error rate {ber:.3e}")
    check(n_kp == 2400, f"K1 keypoint count {n_kp} != 2400")
    check(ang_err <= 1e-4, f"K1 angle error {ang_err} > 1e-4 rad")
    check(ber < 0.01, f"K1 bit error rate {ber} >= 1%")
    call = lambda: patches.orb_patch_desc_levels(levels, xs_l, ys_l)
    timing = dict(ms=cuda_ms(call),
                  plain_ms=cuda_ms(lambda: patches.orb_patch_desc_levels_plain(levels, xs_l, ys_l)))
    # bytes: the level pixels under this frame's windows (each read once),
    # the coordinates, angle and descriptor of every keypoint, the tables
    window_px = sum(int(torch.unique(patches.window_index(img.shape, xs, ys)).numel())
                    for img, xs, ys in zip(levels, xs_l, ys_l))
    nbytes = 4 * window_px + (8 + 4 + 32) * n_kp + 2 * 32 * 512 + 4 * (7 + 16)
    return ang_err, timing, bound(nbytes, K1_FLOP_PER_KP * n_kp), call


def check_k3_edge_cases():
    """Every K3 mode against its plain version on `kernels/cases.py`, and
    mask mode on random and tie-heavy 1200x1200 masks."""
    n = 0
    for name, A, B, gate in cases.k3_cases("cuda"):
        got, want = cases.k3(A, B, gate), cases.k3_plain(A, B, gate)
        for g, w, label in zip(got, want, ("idx1", "d1", "idx2", "d2")):
            check(torch.equal(g, w), f"hamming_best2 {label} differs from plain ({name})")
        n += 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    N = M = 1200
    words = {
        "random": torch.randint(-2**31, 2**31 - 1, (N + M, 8), generator=gen, device="cuda",
                                dtype=torch.int64).to(torch.int32),
        "ties": torch.tensor(cases.TIE_WORDS, device="cuda")[
            torch.randint(0, 5, (N + M, 8), generator=gen, device="cuda")],
    }
    for name, w in words.items():
        mask = torch.rand((N, M), generator=gen, device="cuda") < 0.05
        mask[:16] = False  # rows with no candidate
        mask[16, :] = False
        mask[16, 7] = True
        for g, p in zip(hamming.best2(w[:N], w[N:], mask), hamming.best2_plain(w[:N], w[N:], mask)):
            check(torch.equal(g, p), f"hamming_best2 (mask) differs from plain ({name} 1200x1200)")
    torch.cuda.synchronize()
    print(f"K3 hamming_best2: every mode exact on {n} edge cases (boundaries, complement, no candidate, "
          f"M == 0, N == 1, inf/NaN rows, ties) and mask mode on random and tie-heavy 1200x1200")


def k3_record(mode, A, B, tensors, oct_mode):
    """(A, B, gate) of one K3 call from the arguments of `hamming._launch`."""
    if mode == "mask":
        return A, B, tensors["mask"]
    fields = {k: tensors[k] for k in hamming.Gate._fields if k in tensors}
    return A, B, hamming.Gate(mode=mode, oct_mode=oct_mode, **fields)


def k3_bound(A, B, gate):
    """Bound of one K3 call: bytes of the descriptors, the row and column
    vectors and the outputs (or of the mask in mask mode; the gated modes'
    sort stays in shared memory; nodes mode's sorted ids, which its wrapper
    makes, are not inputs of the function); K3_OPS_PER_PAIR operations per
    gated pair."""
    N, M = A.shape[0], B.shape[0]
    if isinstance(gate, hamming.Gate):
        nbytes = sum(t.numel() * t.element_size() for t in gate if isinstance(t, torch.Tensor))
        pairs = int(hamming.gate_mask(gate).sum())
    else:
        nbytes, pairs = N * M, int(gate.sum())
    return bound(nbytes + 32 * (N + M) + 16 * N, K3_OPS_PER_PAIR * pairs), pairs


def check_k3_main_path(calls, rows=K3_ROWS, path="main-path"):
    """Each K3 row exactly against its plain version on the arguments the
    main path gave it (recorded during the slice); times each row there,
    on its first recorded call. Returns {KERNELS name: (max_abs_err,
    times, bound, timed call)}."""
    out = {}
    for frame in sorted(calls, key=lambda f: f != REC_FRAME):  # time the steady frame's calls
        for row, A, B, gate in calls[frame]:
            got, want = cases.k3(A, B, gate), cases.k3_plain(A, B, gate)
            torch.cuda.synchronize()
            for g, w, label in zip(got, want, ("idx1", "d1", "idx2", "d2")):
                check(torch.equal(g, w), f"hamming_best2 ({row}) {label} differs from plain on frame {frame}")
            name = f"hamming_best2:{row}"
            if name in out:  # a retry, another neighbour or target: checked, timed once
                continue
            (b_ms, b_by), pairs = k3_bound(A, B, gate)
            call = functools.partial(cases.k3, A, B, gate)
            timing = dict(ms=cuda_ms(call), plain_ms=cuda_ms(functools.partial(cases.k3_plain, A, B, gate)))
            n_calls = sum(r == row for r, *_ in calls[frame])
            print(f"K3 {row}: exact on frame {frame}'s {n_calls} {path} call(s), timed on the first: "
                  f"{A.shape[0]}x{B.shape[0]}, {pairs} gated pairs")
            out[name] = (0.0, timing, (b_ms, b_by), call)
    for row in rows:
        check(f"hamming_best2:{row}" in out, f"no K3 {row} call was recorded")
    return out


def check_k4_edge_cases():
    """K4 against its plain version on the edge cases of `kernels/cases.py`,
    with every staging that fits a block (the default's included)."""
    names = []
    for name, voc, desc, valid, level in cases.k4_cases("cuda"):
        want = bow.transform_words_nodes_plain(voc, desc, valid, level)
        for levels in range(bow.stage_levels(voc.k, voc.depth, bow.MAX_STAGE_BYTES) + 1):
            got = bow.transform_words_nodes(bow.with_stage_levels(voc, levels), desc, valid, level)
            torch.cuda.synchronize()
            for g, w, label in zip(got, want, ("words", "nodes")):
                check(torch.equal(g, w), f"bow_transform {label} differ from plain ({name}, {levels} staged levels)")
        names.append(f"{name}: k {voc.k}, depth {voc.depth}, {voc.stage_levels} staged levels by default")
    print(f"K4 bow_transform: exact on {len(names)} edge cases at every staging ({'; '.join(names)})")


def check_k4_call(voc, desc, valid, what):
    """K4 exactly against its plain version on one recorded call."""
    got = bow.transform_words_nodes(voc, desc, valid)
    want = bow.transform_words_nodes_plain(voc, desc, valid)
    torch.cuda.synchronize()
    for g, w, label in zip(got, want, ("words", "nodes")):
        check(torch.equal(g, w), f"bow_transform {label} differ from plain on {what}")
    print(f"K4 bow_transform: exact on {what} ({int(valid.sum())} of {desc.shape[0]} descriptors valid), "
          f"{voc.stage_levels} staged levels ({voc.stage.numel() * 4} bytes of shared memory per block)")
    return got


def k4_bound(voc, desc, valid):
    """Bound of one K4 call from the nodes this call's descriptors visit:
    each visited node with children read once (its k child rows and ids),
    each reached word id once, the descriptors, flags and outputs;
    K4_OPS_PER_CHILD operations per descriptor and child of each step."""
    node = torch.zeros(int(valid.sum()), dtype=torch.int64, device=desc.device)
    d = desc[valid]
    seen, pairs = set(), 0
    for _ in range(voc.depth):
        ci = voc.children_idx[node]
        has = (ci >= 0).any(dim=1)
        seen.update(node[has].tolist())
        pairs += int(has.sum()) * voc.k
        dist = hamming.popcount32(torch.bitwise_xor(voc.children_desc[node], d[:, None, :])).sum(-1)
        j = torch.argmin(torch.where(ci >= 0, dist, bow.MISSING), dim=1, keepdim=True)
        node = torch.where(has, ci.gather(1, j)[:, 0].long(), node)
    n = desc.shape[0]
    nbytes = K4_BYTES_PER_CHILD * voc.k * len(seen) + 4 * int(torch.unique(node).numel()) + (32 + 1 + 8) * n
    return bound(nbytes, K4_OPS_PER_CHILD * pairs)


def check_k4_main_path(system):
    """K4 exactly against its plain version on the descriptors of one
    keyframe the main path indexed (the inputs of its launch), timed
    there. Returns (max_abs_err, times, bound, timed call)."""
    voc, m = system.vocabulary, system.map
    kf = max(m.kf_valid)
    f = m.kf_frame[kf].dev
    got = check_k4_call(voc, f.desc, f.valid, f"keyframe {kf}'s descriptors")
    db = system.relocalizer.database
    check(np.array_equal(db.kf_words[kf], np.unique(got[0].cpu().numpy()[got[0].cpu().numpy() >= 0])),
          f"keyframe {kf}: the database's words are not K4's")
    call = functools.partial(bow.transform_words_nodes, voc, f.desc, f.valid)
    timing = dict(ms=cuda_ms(call), plain_ms=cuda_ms(functools.partial(
        bow.transform_words_nodes_plain, voc, f.desc, f.valid)))
    print(f"K4 bow_transform: keyframe {kf} against the {voc.n_words}-word vocabulary (k {voc.k}, depth "
          f"{voc.depth}, {voc.node_word.shape[0]} nodes)")
    return 0.0, timing, k4_bound(voc, f.desc, f.valid), call


def k4_stagings(voc, call, levels=(2, 3)):
    """Device-only ms per launch of K4 on the timed call's inputs with each
    number of staged levels ({levels: ms}, the default's included)."""
    desc, valid = call.args[1:]
    return {L: device_ms(functools.partial(bow.transform_words_nodes, bow.with_stage_levels(voc, L), desc, valid),
                         KERNELS["bow_transform"]["kernel"]) for L in levels}


@contextlib.contextmanager
def k3_recorder(sink, keep=lambda row: True):
    """Records every K3 call made inside whose row `keep` accepts, as (row,
    A, B, gate) appended to `sink`, by wrapping `hamming._launch`, the one
    launch path below the counted wrappers; `hamming.best2` and
    `hamming.best2_gated` are wrapped to know a call's caller."""
    launch, best2, best2_gated = hamming._launch, hamming.best2, hamming.best2_gated
    rows = []

    def best2_tagged(A, B, mask, caller="search_by_bow"):
        rows.append(MASK_ROWS[caller])
        try:
            return best2(A, B, mask, caller)
        finally:
            rows.pop()

    def best2_gated_tagged(A, B, g, caller=None):
        rows.append(g.mode if caller is None else f"{g.mode}:{caller}")
        try:
            return best2_gated(A, B, g, caller)
        finally:
            rows.pop()

    best2_tagged.launches = best2.launches
    best2_gated_tagged.launches = best2_gated.launches

    def recording(mode, A, B, tensors, oct_mode="both"):
        if keep(rows[-1]):
            sink.append((rows[-1], *k3_record(mode, A, B, tensors, oct_mode)))
        return launch(mode, A, B, tensors, oct_mode)

    hamming._launch, hamming.best2, hamming.best2_gated = recording, best2_tagged, best2_gated_tagged
    try:
        yield sink
    finally:
        hamming._launch, hamming.best2, hamming.best2_gated = launch, best2, best2_gated


def run_slice(world, cfg, frames, device, record=()):
    """Track `frames`; returns (system, poses, ms per frame, launch counts
    per frame, fused flag per frame, recorded K3 calls, devices of the
    local BA problems, the first local BA's (args, kwargs, result)). The K3
    calls of the frames in `record`, and those of the mapper on the first
    frame whose mapping pass launched both mapper rows, are recorded
    ({frame: [(row, A, B, gate)]}); nothing is recorded when `record` is
    empty."""
    system = System(VOCAB, cfg, enable_loop_closing=False, device=device)
    est, ms, per_frame, fused, calls, ba_devices, ba_calls = [], [], [], [], {}, [], []
    solve = ba.ba_solve_pm_interruptible
    at = {"frame": 0, "mapping": None}
    sink = []

    def solve_seen(prob, *a, **k):
        ba_devices.append(prob.poses.device)
        res = solve(prob, *a, **k)
        if not ba_calls:
            ba_calls.append(((prob, *a), k, res))
        return res

    def keep(row):
        return at["frame"] in record or (row in MAPPER_ROWS and at["mapping"] is None)

    ba.ba_solve_pm_interruptible = solve_seen
    try:
        with k3_recorder(sink, keep) if record else contextlib.nullcontext():
            for i, (imL, imR) in enumerate(frames):
                at["frame"] = i
                fused.append(system.tracker._can_fuse())
                before = launch_counts()
                t0 = time.perf_counter()
                est.append(system.track_stereo(imL, imR, timestamp=i / 20.0))
                ms.append((time.perf_counter() - t0) * 1e3)
                per_frame.append({k: v - before[k] for k, v in launch_counts().items()})
                frame_calls, sink[:] = sink[:], []
                if at["mapping"] is None and set(MAPPER_ROWS) <= {r for r, *_ in frame_calls}:
                    at["mapping"] = i
                    calls[i] = frame_calls
                elif i in record:
                    calls[i] = frame_calls
    finally:
        ba.ba_solve_pm_interruptible = solve
    return system, est, ms, per_frame, fused, calls, ba_devices, ba_calls[0] if ba_calls else None


def rot_err(Ra, Rb) -> float:
    """Angle (rad) of Ra^T Rb, from its skew part and trace."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s_ = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arctan2(s_, (np.trace(M) - 1.0) / 2.0))


def run_relocalization(system, frames, poses_gt):
    """Relocalization on the slice's system: black frames, the kidnapped
    view (its K3 calls, its EPnP RANSAC call and its relocalize call
    recorded), the frames after it. Launch counts are set to 0 just before
    and read just after. Returns a result dict, the recorded K3 calls and
    the recorded (RANSAC arguments, card result), and the accepting
    attempt's frame."""
    reloc, m, lm = system.relocalizer, system.map, system.local_mapper
    n_kf, n_trace, processed0 = m.n_keyframes(), len(reloc.trace), lm.n_processed
    black = np.zeros_like(frames[0][0])
    reset_launch_counts()
    for j in range(N_BLACK):
        T = system.track_stereo(black, black, timestamp=100.0 + j / 20.0)
        check(T is None and system.tracker.state == TrackingState.LOST,
              f"black frame {j}: tracking state {system.tracker.state}")
        check(m.n_keyframes() == n_kf, f"black frame {j}: the map was reset ({m.n_keyframes()} keyframes)")
    blackout = reloc.trace[n_trace:]
    check(len(blackout) == N_BLACK - 1 and all(a["stage"] == "db_candidates" for a in blackout),
          f"blackout attempts: {blackout}")

    k3_calls, ransac, attempts, k4_calls = [], [], [], []
    ransac_fn, relocalize, bow_nodes = pnp.pnp_ransac_from_hypotheses, reloc.relocalize, reloc.compute_bow_nodes

    def ransac_recorded(*args):
        res = ransac_fn(*args)
        ransac.append((args, res))
        return res

    def bow_nodes_recorded(desc, valid):
        k4_calls.append((desc, valid))
        return bow_nodes(desc, valid)

    def relocalize_timed(frame):
        t0 = time.perf_counter()
        ok = relocalize(frame)
        torch.cuda.synchronize()
        attempts.append(((time.perf_counter() - t0) * 1e3, frame))
        return ok

    pnp.pnp_ransac_from_hypotheses, reloc.relocalize = ransac_recorded, relocalize_timed
    reloc.compute_bow_nodes = bow_nodes_recorded
    try:
        with k3_recorder(k3_calls):
            T = system.track_stereo(*frames[KIDNAPPED], timestamp=101.0)
    finally:
        pnp.pnp_ransac_from_hypotheses = ransac_fn
        del reloc.relocalize, reloc.compute_bow_nodes
    rec = reloc.trace[-1]
    check(T is not None and rec["ok"] and len(attempts) == 1 and len(ransac) == 1 and k4_calls,
          f"the kidnapped view did not relocalize: {rec}")
    err = float(np.linalg.norm(center(T) - center(poses_gt[KIDNAPPED])))
    check(err < 0.1, f"relocalized camera centre {err} m from the ground truth")
    resumed = []
    for i in RESUMED:
        T = system.track_stereo(*frames[i], timestamp=101.0 + i / 20.0)
        check(T is not None, f"frame {i} after the relocalization was not tracked")
        resumed.append(float(np.linalg.norm(center(T) - center(poses_gt[i]))))
    launches = launch_counts()
    n_attempts, processed = len(reloc.trace) - n_trace, lm.n_processed - processed0
    check(launches["bow_transform"] == n_attempts + processed,
          f"K4: {launches['bow_transform']} launches for {n_attempts} attempts and {processed} keyframes")
    check(launches["hamming_best2:mask:relocalization"] >= 1, "K3 was not launched for the relocalizer")
    host_ms, frame = attempts[0]
    print(f"relocalization: {N_BLACK} black frames LOST without a reset ({n_kf} keyframes), "
          f"{len(blackout)} attempts at db_candidates; frame {KIDNAPPED}'s view relocalized {err:.4f} m from "
          f"the ground truth in {host_ms:.2f} ms host (the attempt: {rec}); frames {RESUMED.start}-"
          f"{RESUMED.stop - 1} tracked, centre error max {max(resumed):.4f} m; launches {launches}")
    out = dict(relocalized_err_m=err, attempt=rec, attempt_host_ms=host_ms, attempts=n_attempts,
               resumed_err_max_m=max(resumed), launches=launches)
    return out, k3_calls, ransac[0], frame, k4_calls[0]


def check_ransac_cpu(recorded):
    """The card's EPnP RANSAC against the plain CPU path on the recorded
    arguments and hypotheses: per candidate, pose within 1e-3 m (camera
    centre) and 1e-3 rad, inlier counts within 2. Returns the card's
    times of the call."""
    args, res = recorded
    cpu = pnp.pnp_ransac_from_hypotheses(*(a.cpu() for a in args))
    worst = (0.0, 0.0, 0)
    for c in range(args[0].shape[0]):
        Rg, tg, Rc, tc = res.R[c].cpu().numpy(), res.t[c].cpu().numpy(), cpu.R[c].numpy(), cpu.t[c].numpy()
        n_g, n_c = int(res.n_inliers[c]), int(cpu.n_inliers[c])
        if n_g == 0 and n_c == 0:
            continue
        dc = float(np.linalg.norm(-Rg.T @ tg + Rc.T @ tc))
        dr = rot_err(Rg, Rc)
        worst = (max(worst[0], dc), max(worst[1], dr), max(worst[2], abs(n_g - n_c)))
        check(dc < 1e-3 and dr < 1e-3 and abs(n_g - n_c) <= 2,
              f"EPnP RANSAC candidate {c}: card vs cpu centre {dc} m, rotation {dr} rad, inliers {n_g} vs {n_c}")
    C, B, _ = args[0].shape
    call = functools.partial(pnp.pnp_ransac_from_hypotheses, *args)
    times = dict(ms=cuda_ms(call, reps=5, batch=2), plain_ms=cuda_ms(functools.partial(
        pnp.pnp_ransac_from_hypotheses, *(a.cpu() for a in args)), reps=3, batch=1, warmup=1))
    print(f"EPnP RANSAC ({C} candidates x {B} hypotheses x {args[1].shape[1]} points): card vs cpu on the "
          f"recorded hypotheses, max centre gap {worst[0]:.2e} m, rotation {worst[1]:.2e} rad, inlier "
          f"counts {worst[2]}; card {times['ms']:.2f} ms/call, cpu {times['plain_ms']:.2f} ms/call")
    return times


def profile_relocalize(system, frame):
    """Replays of the accepting attempt (a fresh frame on the same
    features; new hypotheses from the relocalizer's generator): one
    unprofiled for its warm host ms, then one under `torch.profiler` for
    its device ms and device kernels, the port's kernels among them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    ok = system.relocalizer.relocalize(FrameHost(frame.dev, frame.timestamp, frame.frame_id))
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(ok, f"the replayed relocalization failed: {system.relocalizer.trace[-1]}")
    replay = FrameHost(frame.dev, frame.timestamp, frame.frame_id)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ok = system.relocalizer.relocalize(replay)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    check(ok, f"the replayed relocalization failed: {system.relocalizer.trace[-1]}")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours = {k: sum(v["kernel"] in e.name for e in kernels) for k, v in KERNELS.items()
            if k in ("bow_transform", "hamming_best2:mask:relocalization")}
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"relocalization attempt replayed: host {warm_ms:.2f} ms unprofiled; under the profiler host "
          f"{host_ms:.2f} ms, device {dev_ms:.3f} ms, "
          f"{len(kernels)} device kernels (K4 {ours['bow_transform']}, K3 mask "
          f"{ours['hamming_best2:mask:relocalization']}); {system.relocalizer.trace[-1]}")
    return dict(host_ms_warm=warm_ms, host_ms_profiled=host_ms, device_ms=dev_ms, device_kernels=len(kernels))


def run_localization(system, frames, poses_gt):
    """Localization mode on the slice's system over LOCALIZATION, counts
    set to 0 just before and read just after; then mapping again over
    MAPPING_AGAIN."""
    m, tracker = system.map, system.tracker
    n_kf, n_pts = m.n_keyframes(), len(m.pt_valid)
    system.activate_localization_mode()
    reset_launch_counts()
    errs, n_temp = [], 0
    for i in LOCALIZATION:
        check(not tracker._can_fuse(), f"localization frame {i} would take the fused step")
        T = system.track_stereo(*frames[i], timestamp=102.0 + i / 20.0)
        check(T is not None, f"localization frame {i} was not tracked")
        errs.append(float(np.linalg.norm(center(T) - center(poses_gt[i]))))
        n_temp += len(tracker.last_frame.temp_points)
    launches = launch_counts()
    check(m.n_keyframes() == n_kf and len(m.pt_valid) == n_pts,
          f"localization mode changed the map: {n_kf} -> {m.n_keyframes()} keyframes, {n_pts} -> "
          f"{len(m.pt_valid)} points")
    check(n_temp > 0, "no visual-odometry point was matched in localization mode")
    check(launches["bow_transform"] == 0, f"K4 launched {launches['bow_transform']} times in localization mode")
    for name in ("fast_nms", "orb_patch_desc", "hamming_best2:stereo"):
        check(launches[name] == len(LOCALIZATION), f"localization mode: {name} {launches[name]} launches")
    system.deactivate_localization_mode()
    check(not tracker.only_tracking and not system.local_mapper.is_stopped(), "localization mode still on")
    for i in MAPPING_AGAIN:
        T = system.track_stereo(*frames[i], timestamp=102.0 + i / 20.0)
        check(T is not None, f"frame {i} after localization mode was not tracked")
    print(f"localization mode: {len(LOCALIZATION)} frames tracked, centre error max {max(errs):.4f} m, "
          f"{n_kf} keyframes and {n_pts} map points unchanged, {n_temp} visual-odometry matches, no fused "
          f"step; launches {launches}; then frames {MAPPING_AGAIN.start}-{MAPPING_AGAIN.stop - 1} tracked "
          f"with mapping")
    return dict(frames=len(LOCALIZATION), err_max_m=max(errs), vo_matches=n_temp, launches=launches)


def profile_frames(system, frames, first):
    """Track more frames under torch.profiler: host/device times of the
    tracker's stages per frame and of the mapper's stages per call (one
    call per keyframe), the device's busy share of the wall time, the top
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from orbslam2_tpu_torch.ops import matchers, pose_opt
    from orbslam2_tpu_torch.slam.frontend import Frontend

    stages = [(Frontend, "features_body"), (pose_opt, "pose_optimize"),
              (matchers, "search_by_projection_frame"), (matchers, "search_by_projection_points")]
    originals = [getattr(owner, name) for owner, name in stages]

    def traced(fn, label):
        def run(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return run

    span = LocalMapper._span

    def traced_span(self, name):
        stack = contextlib.ExitStack()
        stack.enter_context(span(self, name))
        stack.enter_context(record_function(f"stage:{name}"))
        return stack

    for (owner, name), fn in zip(stages, originals):
        setattr(owner, name, traced(fn, f"stage:{name}"))
    LocalMapper._span = traced_span
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i, (imL, imR) in enumerate(frames):
                system.track_stereo(imL, imR, timestamp=(first + i) / 20.0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (owner, name), fn in zip(stages, originals):
            setattr(owner, name, fn)
        LocalMapper._span = span
    n = len(frames)
    # device-side events, without the ranges' own GPU annotations
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.name.startswith("stage:")]
    check(len(kernels) > 0, "the profile phase traced no device kernels")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profile over {n} frames (profiler on): wall {wall_ms / n:.2f} ms/frame, "
          f"{len(kernels) / n:.0f} device kernels/frame, device busy {busy_ms / n:.3f} ms/frame "
          f"= {100 * busy_ms / wall_ms:.1f}% of wall (idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    per_stage = stage_kernels(prof)
    n_in_stages = sum(len(st["kernels"]) for st in per_stage.values())
    print(f"  device kernels launched inside a traced stage: {n_in_stages / n:.1f}/frame")
    for name, st in per_stage.items():
        ks = st["kernels"]
        ours = sum(any(k["kernel"] in e.name for k in KERNELS.values()) for e in ks)
        per, unit = (st["calls"], "call") if name in MAPPING_STAGES else (n, "frame")
        print(f"  {name}: {st['calls'] / n:.1f} calls/frame, host {st['host_us'] / per / 1e3:.2f} ms/{unit}, "
              f"device {sum(e.time_range.elapsed_us() for e in ks) / per / 1e3:.3f} ms/{unit}, "
              f"{len(ks) / per:.1f} device kernels/{unit} ({ours / per:.1f} of the port's kernels)")
    check(any(name in per_stage for name in MAPPING_STAGES), "the profile phase traced no mapping stage")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  kernel {name[:90]}: {t / n / 1e3:.3f} ms/frame, {c / n:.0f} launches/frame")
    return wall_ms / n, busy_ms / wall_ms


def stage_kernels(prof):
    """{stage: calls, host time and device events} of the `stage:` ranges of
    a profile. A device event (kernel or copy) belongs to the stage whose
    host time range holds the CUDA runtime call that launched it, matched
    by correlation id: this covers the kernels launched through ctypes,
    which the profiler attaches to no PyTorch operator."""
    from torch.autograd import DeviceType

    evs = prof.events()
    device = {e.id: e for e in evs if e.device_type == DeviceType.CUDA and not e.name.startswith("stage:")}
    calls = sorted((e.time_range.start, e.id) for e in evs
                   if e.device_type == DeviceType.CPU and e.name.startswith("cu") and e.id in device)
    starts = [t for t, _ in calls]
    out = {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name.startswith("stage:"):
            st = out.setdefault(e.name[6:], dict(calls=0, host_us=0.0, kernels=[]))
            st["calls"] += 1
            st["host_us"] += e.cpu_time_total
            lo = bisect.bisect_left(starts, e.time_range.start)
            hi = bisect.bisect_right(starts, e.time_range.end)
            st["kernels"] += [device[c] for _, c in calls[lo:hi]]
    return out


def center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


def run_threaded(cfg, frames, poses_gt) -> dict:
    """`System(VOCAB, cfg, threaded=True)` on the card over `frames`: the
    mapper and the keyframe indexing (K4) on its worker thread; >= all but
    one frame tracked, ATE RMSE < 0.06 m, every live keyframe indexed,
    `wait_idle` without a worker error."""
    system = System(VOCAB, cfg, enable_loop_closing=False, threaded=True)
    reset_launch_counts()
    est, ms = [], []
    for i, (imL, imR) in enumerate(frames):
        t0 = time.perf_counter()
        est.append(system.track_stereo(imL, imR, timestamp=i / 20.0))
        ms.append((time.perf_counter() - t0) * 1e3)
    system.wait_idle()
    lm = system.local_mapper
    system.shutdown()
    k4 = bow.transform_words_nodes.launches
    indexed = sorted(system.relocalizer.database.kf_words)
    check(indexed == sorted(system.map.kf_valid), f"threaded: database {indexed}, keyframes {system.map.kf_valid}")
    check(k4 == lm.n_processed, f"threaded: K4 {k4} launches for {lm.n_processed} processed keyframes")
    n_tracked = sum(T is not None for T in est)
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]))
    out = dict(tracked=n_tracked, ate_rmse_m=rmse, ms_per_frame_p50=statistics.median(ms[2:]),
               ms_per_frame_max=max(ms[2:]), keyframes_mapped=lm.n_processed, local_ba=lm.n_local_ba)
    print(f"threaded: {n_tracked}/{len(frames)} frames tracked, ATE RMSE {rmse:.4f} m, ms/frame p50 "
          f"{out['ms_per_frame_p50']:.2f} max {out['ms_per_frame_max']:.2f}, {lm.n_processed} keyframes mapped, "
          f"{lm.n_local_ba} local BAs and {k4} K4 launches on the worker thread")
    check(n_tracked >= len(frames) - 1, f"threaded: only {n_tracked}/{len(frames)} frames tracked")
    check(rmse < 0.06, f"threaded: ATE RMSE {rmse} >= 0.06 m")
    check(lm.n_processed >= 2, f"threaded: the worker processed {lm.n_processed} keyframes")
    return out


_render_state = {}


def _render_init(poses):
    _render_state.update(world=SyntheticWorld(**LOOP_WORLD), poses=poses)


def _render(i):
    """Frame i of the loop world's figure-8 as uint8 images (as the tracker
    takes them). The renderer's noise and gain follow how many frames it
    rendered before: set to i, as if it had rendered the sequence in order."""
    world = _render_state["world"]
    world._n_rendered = i
    return tuple(np.clip(np.rint(im), 0, 255).astype(np.uint8)
                 for im in world.render_stereo(_render_state["poses"][i]))


class _Recorder:
    """Wraps a module function for the loop phase: keeps the arguments and
    result of the first `keep` calls whose arguments `when` accepts and
    whose result `want` accepts."""

    def __init__(self, owner, name, keep=1, want=lambda out: True, when=lambda args, kwargs: True):
        self.owner, self.name, self.keep, self.want, self.when, self.calls = owner, name, keep, want, when, []
        self.fn = getattr(owner, name)

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if len(self.calls) < self.keep and self.when(args, kwargs) and self.want(out):
            self.calls.append((args, kwargs, out))
        return out

    def __enter__(self):
        setattr(self.owner, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def run_loop():
    """The loop phase: `System(VOCAB, cfg)` with loop closing on (the
    default), on the card, over the loop world's whole figure-8, rendered
    ahead by RENDER_WORKERS processes. Launch counts are set to 0 just
    before and read just after. Records the K3 calls of the loop rows, the
    accepted Sim3 attempts' RANSAC calls and the essential-graph problems.
    Checks every frame tracked, 2 loops closed, ATE RMSE < LOOP_ATE_BAR."""
    world = SyntheticWorld(**LOOP_WORLD)
    cfg = slam_config(world)
    poses_gt, meta = world.trajectory_figure8()
    n = len(poses_gt)
    system = System(VOCAB, cfg)
    closer = system.loop_closer
    check(closer is not None and system.device.type == "cuda", "System(VOCAB, cfg) has no loop closer on the card")
    k3_calls, est, ms = [], [], []
    seen = {row: 0 for row in LOOP_ROWS}

    def keep(row):
        if row not in seen or seen[row] >= 4:
            return False
        seen[row] += 1
        return True

    ctx = multiprocessing.get_context("spawn")
    frames_digest = hashlib.sha256()
    t_start = time.perf_counter()
    with ctx.Pool(RENDER_WORKERS, initializer=_render_init, initargs=(poses_gt,)) as pool, \
            _Recorder(sim3solve, "sim3_ransac", keep=2, want=lambda r: int(r.n_inliers) >= 20) as ransac, \
            _Recorder(posegraph, "optimize_essential_graph", keep=2) as graphs, \
            _Recorder(ba, "ba_solve_pm_interruptible", when=lambda a, kw: kw.get("n_iters_first") == 10) as gba, \
            k3_recorder(k3_calls, keep):
        reset_launch_counts()
        for i, (imL, imR) in enumerate(pool.imap(_render, range(n), chunksize=1)):
            frames_digest.update(imL.tobytes())
            frames_digest.update(imR.tobytes())
            t0 = time.perf_counter()
            est.append(system.track_stereo(imL, imR, timestamp=i / 20.0))
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        launches = launch_counts()
    wall_s = time.perf_counter() - t_start
    report = system.shutdown()
    n_tracked = sum(T is not None for T in est)
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]))
    accuracy = loop_accuracy(system, poses_gt, est, meta["handover"])
    stages = {name: dict(calls=len(v), mean_ms=statistics.mean(v) / 1e3, max_ms=max(v) / 1e3)
              for name in LOOP_STAGES if (v := system.timers.samples.get(name))}
    gates = {}
    for r in closer.rejections:
        gates[r["stage"]] = gates.get(r["stage"], 0) + 1
    poses_digest, kf_digest = hashlib.sha256(), hashlib.sha256()
    for T in est:
        poses_digest.update(b"lost" if T is None else np.ascontiguousarray(T, np.float32).tobytes())
    for k in sorted(system.map.kf_valid):
        kf_digest.update(np.int64(k).tobytes() + np.ascontiguousarray(system.map.kf_pose[k], np.float32).tobytes())
    digests = dict(frames=frames_digest.hexdigest()[:16], poses=poses_digest.hexdigest()[:16],
                   keyframe_poses=kf_digest.hexdigest()[:16])
    print(f"loop phase: the figure-8 of the loop world ({n} frames, handover at {meta['handover']}), "
          f"{n_tracked}/{n} tracked, {closer.n_loops_closed} loops closed, ATE RMSE {rmse:.4f} m (bar "
          f"{LOOP_ATE_BAR} m; the TPU record of the JAX package, for comparison only: {LOOP_TPU_ATE} m), "
          f"{system.map.n_keyframes()} keyframes, {len(system.map.pt_valid)} points; ms/frame p50 "
          f"{statistics.median(ms[2:]):.2f} max {max(ms):.2f}; {wall_s:.1f} s wall (rendering overlapped)")
    print(f"  ATE RMSE (m): {accuracy}")
    print(f"  loop digests: rendered frames {digests['frames']}, per-frame poses {digests['poses']}, final "
          f"keyframe poses {digests['keyframe_poses']} ({system.map.n_keyframes()} keyframes)")
    for rec in closer.loops:
        print(f"  loop: keyframe {rec['kf']} (frame {system.map.kf_frame_id.get(rec['kf'])}) with candidate "
              f"{rec['cand']}: {rec}")
    print(f"  camera-centre error (m) every 25 frames, online poses aligned as the ATE aligns them: "
          f"{drift_curve(poses_gt, est)}")
    print(f"  Sim3 attempts that a gate rejected, by gate: {gates}; accepted: "
          f"{[(r['kf'], r['cand']) for r in closer.loops]}")
    for name, st in stages.items():
        print(f"  {name}: {st['calls']} calls, host {st['mean_ms']:.2f} ms mean, {st['max_ms']:.2f} ms max")
    print(f"  launches on the loop path: {launches}")
    print(report)
    check(n_tracked == n, f"loop phase: {n_tracked}/{n} frames tracked")
    check(closer.n_loops_closed == 2, f"loop phase: {closer.n_loops_closed} loops closed, not 2")
    check_later(rmse < LOOP_ATE_BAR, f"loop phase: ATE RMSE {rmse} >= {LOOP_ATE_BAR} m")
    for row in LOOP_ROWS:
        check(launches[f"hamming_best2:{row}"] > 0, f"loop phase: K3 {row} never launched")
    check(ransac.calls and graphs.calls and gba.calls,
          "loop phase: no Sim3 RANSAC past its gate, essential graph or global BA recorded")
    out = dict(frames=n, tracked=n_tracked, loops=closer.n_loops_closed, ate_rmse_m=rmse, ate=accuracy,
               digests=digests,
               loop_records=closer.loops, rejected_by_gate=gates, stages=stages,
               ms_per_frame_p50=statistics.median(ms[2:]), ms_per_frame_max=max(ms), wall_s=wall_s,
               keyframes=system.map.n_keyframes(), points=len(system.map.pt_valid))
    return out, launches, k3_calls, ransac.calls[0], graphs.calls[0], gba.calls[0]


def drift_curve(poses_gt, est, every=25):
    """The online camera-centre errors (m) at every `every`-th frame after
    the alignment `ate_rmse` makes (lost frames: None)."""
    from orbslam2_tpu_torch.evaluation.ate import umeyama_alignment

    got = [(i, center(e), center(g)) for i, (g, e) in enumerate(zip(poses_gt, est)) if e is not None]
    R, t, s = umeyama_alignment(np.stack([c for _, c, _ in got]), np.stack([c for _, _, c in got]))
    err = {i: float(np.linalg.norm(s * R @ c + t - g)) for i, c, g in got}
    return [None if err.get(i) is None else round(err[i], 4) for i in range(0, len(poses_gt), every)]


def loop_accuracy(system, poses_gt, est, handover):
    """ATE RMSE (m) of the loop phase beyond the online one the bar holds
    (bench.py's breakdown): the online poses of circle A's frames and of
    circle B's apart, the offline trajectory (each frame's pose relative
    to its reference keyframe, resolved against the final, corrected
    keyframe poses), and the final keyframe poses."""
    from orbslam2_tpu_torch.slam import trajectory as traj_mod

    m, traj = system.map, system.tracker.trajectory

    def ate(pairs):
        return ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]))

    online = [(i, g, e) for i, (g, e) in enumerate(zip(poses_gt, est)) if e is not None]
    offline = [(g, (e.Tcr.astype(np.float64) @ traj_mod._resolve_reference(m, e.ref_kf)).astype(np.float32))
               for g, e in zip(poses_gt, traj) if e.Tcw is not None and not e.lost]
    keyframes = [(poses_gt[m.kf_frame_id[k]], m.kf_pose[k]) for k in sorted(m.kf_valid)]
    return dict(circle_a=ate([(g, e) for i, g, e in online if i < handover]),
                circle_b=ate([(g, e) for i, g, e in online if i >= handover]),
                offline=ate(offline), keyframes=ate(keyframes))


def check_sim3_ransac_cpu(recorded):
    """The card's Sim3 RANSAC against the plain CPU path on a recorded
    call's arguments and hypotheses: the same inliers, S12 within 1e-6."""
    args, kwargs, res = recorded
    to_cpu = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a  # noqa: E731
    cpu = sim3solve.sim3_ransac(*(to_cpu(a) for a in args), **{k: to_cpu(v) for k, v in kwargs.items()})
    gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(res.S12, cpu.S12))
    same = torch.equal(res.inliers.cpu(), cpu.inliers)
    print(f"Sim3 RANSAC ({kwargs['hypotheses'].shape[0]} hypotheses x {args[0].shape[0]} points): card vs cpu "
          f"on the recorded hypotheses: inliers {int(res.n_inliers)} vs {int(cpu.n_inliers)} "
          f"({'the same' if same else 'different'}), max S12 gap {gap:.2e}")
    check(same and gap < 1e-6, f"Sim3 RANSAC card vs cpu: inliers equal {same}, S12 gap {gap}")
    return dict(n_inliers=int(res.n_inliers), s12_gap=gap)


def check_reproducible(local_ba, global_ba, graph):
    """Replays of one recorded local BA, one global BA and one essential
    graph, twice each on the card: bit-identical (`torch.equal`) to each
    other and to the recorded result (the local BA is replayed without the
    mapper's abort poll, which inline mapping never sets). Then the
    fixed-order segment sum on a collision-heavy input, 10 calls, beside
    the float `index_add_` it replaced (shown, not checked)."""

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    out = {}
    for name, (args, kwargs, res) in (("local BA", local_ba), ("global BA", global_ba)):
        kw = {k: v for k, v in kwargs.items() if k != "should_abort"}
        t0 = time.perf_counter()
        r1 = ba.ba_solve_pm_interruptible(*args, **kw)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        r2 = ba.ba_solve_pm_interruptible(*args, **kw)
        torch.cuda.synchronize()
        prob = args[0]
        out[name] = dict(keyframes=prob.poses.shape[0], points=prob.points.shape[0],
                         edges=int(prob.edge_valid.sum()), host_ms=host_ms, replays_equal=same(r1, r2),
                         equal_to_run=same(r1, res))
    args, kwargs, res = graph
    g1 = posegraph.optimize_essential_graph(*args, **kwargs)
    g2 = posegraph.optimize_essential_graph(*args, **kwargs)
    torch.cuda.synchronize()
    out["essential graph"] = dict(vertices=args[0].vertices.s.shape[0], edges=args[0].edge_i.shape[0],
                                  replays_equal=same(g1[0], g2[0]) and torch.equal(g1[1], g2[1]),
                                  equal_to_run=same(g1[0], res[0]) and torch.equal(g1[1], res[1]))
    dev = args[0].vertices.t.device
    gen = torch.Generator(device=dev).manual_seed(1)
    K, E = 64, 200000
    idx = torch.randint(0, K, (E,), generator=gen, device=dev)
    x = torch.randn((E, 36), generator=gen, device=dev)
    seg = ba.segments(idx, K, torch.ones_like(idx, dtype=torch.bool))
    sums = [ba.segment_sum(seg, x) for _ in range(10)]
    adds = [torch.zeros((K, 36), device=dev).index_add_(0, idx, x) for _ in range(10)]
    torch.cuda.synchronize()
    out["segment sum"] = dict(calls_equal=all(torch.equal(sums[0], t) for t in sums[1:]),
                              index_add_calls_equal=all(torch.equal(adds[0], t) for t in adds[1:]),
                              max_gap_to_index_add=float((sums[0] - adds[0]).abs().max()))
    print(f"reproducibility: replays on the card, twice each: {out}")
    for name, r in out.items():
        if name == "segment sum":
            check(r["calls_equal"], "segment sum: 10 calls on one input differ")
        else:
            check(r["replays_equal"] and r["equal_to_run"], f"{name}: replays differ ({r})")
    return out


def check_essential_graph(recorded):
    """The recorded essential-graph problem: card against CPU (camera
    centres within 1e-4 m), then replayed under torch.profiler for its
    host ms, device ms and device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args, kwargs, (V, _) = recorded
    prob = args[0]
    cpu_prob = posegraph.PoseGraphProblem(*(
        sim3.Sim3(*(x.cpu() for x in f)) if isinstance(f, sim3.Sim3) else f.cpu() for f in prob))
    Vc, _ = posegraph.optimize_essential_graph(cpu_prob, *args[1:], **kwargs)

    def centres(S):
        R, t, s = (x.cpu().double() for x in S)
        return -torch.einsum("kji,kj->ki", R, t / s[:, None])

    gap = float((centres(V) - centres(Vc)).abs().max())
    K, E = prob.vertices.s.shape[0], prob.edge_i.shape[0]
    t0 = time.perf_counter()
    posegraph.optimize_essential_graph(prob, *args[1:], **kwargs)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        posegraph.optimize_essential_graph(prob, *args[1:], **kwargs)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"essential graph ({K} vertices, {E} edges, float64): card vs cpu max camera-centre gap {gap:.2e} m; "
          f"replayed: host {warm_ms:.2f} ms unprofiled, under the profiler host {host_ms:.2f} ms, device "
          f"{dev_ms:.3f} ms, {len(kernels)} device kernels")
    check(gap < 1e-4, f"essential graph card vs cpu: {gap} m")
    return dict(vertices=K, edges=E, centre_gap_m=gap, host_ms_warm=warm_ms, host_ms_profiled=host_ms,
                device_ms=dev_ms, device_kernels=len(kernels))


def main():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    build.load()
    print(f"kernel build: {build.build_seconds:.2f} s ({build.library_path()})")

    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    cfg = slam_config(world)
    poses_gt, frames = world.render_sequence(N_FRAMES + N_PROFILE_FRAMES, step=0.06)
    poses_gt, frames, profile_set = poses_gt[:N_FRAMES], frames[:N_FRAMES], frames[N_FRAMES:]
    images = torch.from_numpy(np.stack(frames[2])).round().clamp(0, 255).to("cuda")
    params = orb.OrbParams()
    levels, xs_l, ys_l = level_inputs(images, params)
    results = {
        "fast_nms": check_fast_nms(levels),
        "orb_patch_desc": check_orb_patch_desc(levels, xs_l, ys_l),
    }
    check_k3_edge_cases()
    check_k4_edge_cases()

    reset_launch_counts()
    system, est, ms, per_frame, fused, calls, ba_devices, local_ba = run_slice(world, cfg, frames, "cuda",
                                                                               record=REC_FRAMES)
    torch.cuda.synchronize()
    launches = launch_counts()
    lm = system.local_mapper
    mapping = dict(keyframes_mapped=lm.n_processed, local_ba=lm.n_local_ba, points_triangulated=lm.n_created)
    print(f"local mapping: {lm.n_processed} keyframes processed, {lm.n_created} points triangulated, "
          f"{lm.n_local_ba} local BAs on {sorted({str(d) for d in ba_devices})}")
    check(lm.n_processed >= 2, f"the mapper processed {lm.n_processed} keyframes")
    check(lm.n_created > 0, "triangulation created no point")
    check(lm.n_local_ba >= 1 and ba_devices and all(d.type == "cuda" for d in ba_devices),
          f"local BA: {lm.n_local_ba} solves on {ba_devices}")
    indexed = sorted(system.relocalizer.database.kf_words)
    check(indexed == sorted(system.map.kf_valid), f"database {indexed}, live keyframes {system.map.kf_valid}")
    n_attempts = len(system.relocalizer.trace)
    check(launches["bow_transform"] == lm.n_processed + n_attempts,
          f"K4: {launches['bow_transform']} launches for {lm.n_processed} keyframes and {n_attempts} attempts")
    print(f"keyframe database: every live keyframe indexed ({indexed}), K4 {launches['bow_transform']} launches "
          f"for {lm.n_processed} processed keyframes and {n_attempts} relocalization attempts")
    n_tracked = sum(T is not None for T in est)
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]))
    steady = ms[2:]
    print(f"slice: {n_tracked}/{N_FRAMES} frames tracked, ATE RMSE {rmse:.4f} m, "
          f"{system.map.n_keyframes()} keyframes, {sum(fused)} fused frames; ms/frame p50 "
          f"{statistics.median(steady):.2f} max {max(steady):.2f} (frames 2..{N_FRAMES - 1}; first two "
          f"{ms[0]:.1f}, {ms[1]:.1f}); launches {launches}")
    print(system.shutdown())
    check(fused[REC_FRAME], f"frame {REC_FRAME} was not a fused frame")
    check(n_tracked >= N_FRAMES - 1, f"only {n_tracked}/{N_FRAMES} frames tracked")
    check(rmse < 0.06, f"ATE RMSE {rmse} >= 0.06 m")
    results.update(check_k3_main_path(calls))
    results["bow_transform"] = check_k4_main_path(system)

    # relocalization and localization mode on the same system, each path
    # with its own counts
    reloc, reloc_calls, ransac, reloc_frame, reloc_k4 = run_relocalization(system, frames, poses_gt)
    check_k4_call(system.vocabulary, *reloc_k4, "the relocalizer's call")
    results.update(check_k3_main_path({"kidnapped": [c for c in reloc_calls if c[0] == "mask:relocalization"]},
                                      rows=("mask:relocalization",), path="relocalization"))
    reloc["ransac"] = check_ransac_cpu(ransac)
    # loop closing: a System of its own on the loop world's figure-8
    loop, loop_launches, loop_calls, loop_ransac, loop_graph, loop_gba = run_loop()
    results.update(check_k3_main_path({"loop": loop_calls}, rows=LOOP_ROWS, path="loop"))
    loop["sim3_ransac"] = check_sim3_ransac_cpu(loop_ransac)
    check(local_ba is not None, "no local BA was recorded on the slice")
    loop["reproducibility"] = check_reproducible(local_ba, loop_gba, loop_graph)
    # kernel profiling after the slice, so that no profiler session runs
    # before the slice's frames, and before the profile phase: profiler
    # sessions after that long one have traced no kernels on the H100
    for name, k in KERNELS.items():
        results[name][1]["device_ms"] = device_ms(results[name][3], k["kernel"])
    stagings = k4_stagings(system.vocabulary, results["bow_transform"][3])
    results["bow_transform"][1]["staged_levels"] = system.vocabulary.stage_levels
    results["bow_transform"][1]["device_ms_by_staged_levels"] = stagings
    print(f"K4 bow_transform device-only ms per launch by staged levels: {stagings} (default "
          f"{system.vocabulary.stage_levels})")
    loop["essential_graph"] = check_essential_graph(loop_graph)
    reloc["profiled"] = profile_relocalize(system, reloc_frame)
    localization = run_localization(system, frames, poses_gt)
    processed = lm.n_processed
    profile_frames(system, profile_set, N_FRAMES)
    check(lm.n_processed > processed, "mapping did not resume after localization mode")
    print(f"mapping resumed: {lm.n_processed - processed} keyframes processed in the profile phase")

    path_launches = {"main": launches, "relocalization": reloc["launches"], "loop": loop_launches}
    path_frames = {"main": N_FRAMES, "relocalization": N_BLACK + 1 + len(RESUMED), "loop": loop["frames"]}
    for name, k in KERNELS.items():
        path = k.get("path", "main")
        check(path_launches[path][name] > 0, f"kernel {name} was not launched on the {path} path")
    # one launch per frame: K1 and K2 over every level, K3's stereo mode
    for name in ("fast_nms", "orb_patch_desc", "hamming_best2:stereo"):
        check(launches[name] == N_FRAMES, f"{name}: {launches[name]} launches over {N_FRAMES} frames")
    for i, (f, c) in enumerate(zip(fused, per_frame)):
        # a fused frame: the tracker's one points launch, one or two (the
        # retry) frame launches, no search_by_bow mask launch; the mapper's
        # epipolar mask launches are counted apart
        if f:
            check(c["hamming_best2:points"] == 1 and c["hamming_best2:mask"] == 0
                  and c["hamming_best2:frame"] in (1, 2), f"fused frame {i}: K3 launches {c}")
    on_fused = {r: sum(c[f"hamming_best2:{r}"] for c, f in zip(per_frame, fused) if f) for r in K3_ROWS}
    print(f"K3 launches on the {sum(fused)} fused frames: {on_fused}")
    rows = []
    for name, k in KERNELS.items():
        err, t, (bound_ms, bound_by), _ = results[name]
        path = k.get("path", "main")
        n_launches = path_launches[path][name]
        per_frame_n = n_launches / path_frames[path]
        print(f"{name}: {per_frame_n:.3f} launches/frame ({path} path); per launch: wrapper {t['ms']:.4f} ms, "
              f"device {t['device_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}), roofline share {bound_ms / t['device_ms']:.2%}; per frame: wrapper "
              f"{t['ms'] * per_frame_n:.4f} ms, device {t['device_ms'] * per_frame_n:.4f} ms; {smi}")
        rows.append({
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": n_launches, "path": path, "launches_per_frame": per_frame_n, "max_abs_err": err,
            **t, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })

    # the plain CPU path on the first frames, mapping included: same
    # states, poses within 1 cm
    est_cpu = run_slice(world, cfg, frames[:N_CPU_FRAMES], "cpu")[1]
    worst = 0.0
    for i, (a, b) in enumerate(zip(est[:N_CPU_FRAMES], est_cpu)):
        check((a is None) == (b is None), f"frame {i}: cuda/cpu tracking state differs")
        if a is not None:
            worst = max(worst, float(np.linalg.norm(center(a) - center(b))))
    print(f"cuda vs cpu plain path, first {N_CPU_FRAMES} frames (mapping included): max camera-centre gap "
          f"{worst:.2e} m")
    check(worst < 0.01, f"cuda and cpu poses differ by {worst} m")
    threaded = run_threaded(cfg, frames, poses_gt)

    check(not DEFERRED, f"{len(DEFERRED)} deferred check(s) failed: {DEFERRED}")
    print(json.dumps({"slice": {
        "frames": N_FRAMES, "tracked": n_tracked, "ate_rmse_m": rmse,
        "ms_per_frame_p50": statistics.median(steady), "ms_per_frame_max": max(steady),
        **mapping, "threaded": threaded, "card": smi,
    }, "relocalization": {k: v for k, v in reloc.items() if k != "launches"},
        "localization": {k: v for k, v in localization.items() if k != "launches"}, "loop": loop}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
