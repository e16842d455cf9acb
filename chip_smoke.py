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
     tie-heavy 1200x1200 masks; times the wrapper and the plain version
     with CUDA events around back-to-back calls; and computes each
     kernel's bound (bytes or operations at the published peaks) from the
     inputs;
  4. drives the main path, `System(..., device="cuda").track_stereo`, over
     the 40-frame synthetic sequence of tests/test_tracking.py, with the
     local mapper inline on every keyframe, recording the arguments of
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
     frames agree with the port's plain CPU path (mapping included);
     holds each K3 mode exactly against its plain version on the recorded
     arguments and times it there; times each kernel alone by its
     `torch.profiler` durations (after the slice, so that no profiler
     session precedes the slice's frames); profiles 10 more frames (per
     traced stage: host and device ms and device kernels, per frame for
     the tracker's stages and per call for the mapper's); prints each
     kernel's launches per frame, times, bound and roofline share;
  5. runs `System(None, cfg, threaded=True)` over the 40 frames: the
     mapper on its worker thread, >= 39 frames tracked, ATE RMSE < 0.06
     m, `wait_idle` without a worker error;
  6. prints one JSON line describing the kernels (one row per K3 mode and
     caller), then the result line.

It exits non-zero, and prints no result, when any phase fails, when no
CUDA card is visible, or when the port cannot be imported.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
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
from orbslam2_tpu_torch.ops import ba, fast, hamming, orb, patches
from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
from orbslam2_tpu_torch.slam.system import System

N_FRAMES = 40
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
}
# K3's rows: the tracker's modes, then the mapper's (mask mode under its
# caller epipolar_match)
K3_ROWS = ("mask", "stereo", "frame", "points", "fuse", "mask:epipolar")
MAPPER_ROWS = ("fuse", "mask:epipolar")
# the mapper's stages (its shutdown-report spans), reported per call
MAPPING_STAGES = ("Keyframe insertion", "Map point culling", "Map point creation", "Map point fusion",
                  "Local BA", "Keyframe culling")


def launch_counts() -> dict:
    """Every kernel's launch counter, by KERNELS name."""
    c = {"fast_nms": fast.fast_nms_levels.launches, "orb_patch_desc": patches.orb_patch_desc_levels.launches,
         "hamming_best2:mask": hamming.best2.launches["search_by_bow"],
         "hamming_best2:mask:epipolar": hamming.best2.launches["epipolar_match"]}
    c.update({f"hamming_best2:{m}": n for m, n in hamming.best2_gated.launches.items()})
    return c


def reset_launch_counts():
    fast.fast_nms_levels.launches = 0
    patches.orb_patch_desc_levels.launches = 0
    for counts in (hamming.best2.launches, hamming.best2_gated.launches):
        for k in counts:
            counts[k] = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


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
    sort stays in shared memory); K3_OPS_PER_PAIR operations per gated
    pair."""
    N, M = A.shape[0], B.shape[0]
    if isinstance(gate, hamming.Gate):
        vec = [gate.row_uv, gate.row_r, gate.row_oct, gate.row_valid, gate.col_uv, gate.col_oct,
               gate.col_valid, gate.row_umin, gate.row_ur, gate.col_ur, gate.col_isig]
        nbytes = sum(t.numel() * t.element_size() for t in vec if t is not None)
        pairs = int(hamming.gate_mask(gate).sum())
    else:
        nbytes, pairs = N * M, int(gate.sum())
    return bound(nbytes + 32 * (N + M) + 16 * N, K3_OPS_PER_PAIR * pairs), pairs


def check_k3_main_path(calls):
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
            print(f"K3 {row}: exact on frame {frame}'s {n_calls} main-path call(s), timed on the first: "
                  f"{A.shape[0]}x{B.shape[0]}, {pairs} gated pairs")
            out[name] = (0.0, timing, (b_ms, b_by), call)
    for row in K3_ROWS:
        check(f"hamming_best2:{row}" in out, f"no K3 {row} call was recorded")
    return out


def run_slice(world, cfg, frames, device, record=()):
    """Track `frames`; returns (system, poses, ms per frame, launch counts
    per frame, fused flag per frame, recorded K3 calls, devices of the
    local BA problems). The K3 calls of the frames in `record`, and those
    of the mapper on the first frame whose mapping pass launched both
    mapper rows, are recorded by wrapping `hamming._launch`, the one
    launch path below the counted wrappers: {frame: [(row, A, B, gate)]}.
    Nothing is recorded when `record` is empty."""
    system = System(None, cfg, device=device)
    est, ms, per_frame, fused, calls, ba_devices = [], [], [], [], {}, []
    launch, best2, solve = hamming._launch, hamming.best2, ba.ba_solve_pm_interruptible
    callers = []

    def best2_tagged(A, B, mask, caller="search_by_bow"):
        callers.append(caller)
        try:
            return best2(A, B, mask, caller)
        finally:
            callers.pop()

    best2_tagged.launches = best2.launches

    def recording(mode, A, B, tensors, oct_mode="both"):
        row = "mask:epipolar" if mode == "mask" and callers[-1] == "epipolar_match" else mode
        if i in record or (row in MAPPER_ROWS and mapping_frame is None):
            calls.setdefault(i, []).append((row, *k3_record(mode, A, B, tensors, oct_mode)))
        return launch(mode, A, B, tensors, oct_mode)

    def solve_seen(prob, *a, **k):
        ba_devices.append(prob.poses.device)
        return solve(prob, *a, **k)

    mapping_frame = None
    ba.ba_solve_pm_interruptible = solve_seen
    if record:
        hamming._launch, hamming.best2 = recording, best2_tagged
    try:
        for i, (imL, imR) in enumerate(frames):
            fused.append(system.tracker._can_fuse())
            before = launch_counts()
            t0 = time.perf_counter()
            est.append(system.track_stereo(imL, imR, timestamp=i / 20.0))
            ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append({k: v - before[k] for k, v in launch_counts().items()})
            rows = {r for r, *_ in calls.get(i, [])}
            if mapping_frame is None and set(MAPPER_ROWS) <= rows:
                mapping_frame = i
            elif i not in record:
                calls.pop(i, None)
    finally:
        hamming._launch, hamming.best2, ba.ba_solve_pm_interruptible = launch, best2, solve
    return system, est, ms, per_frame, fused, calls, ba_devices


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
    """`System(None, cfg, threaded=True)` on the card over `frames`: the
    mapper on its worker thread; >= all but one frame tracked, ATE RMSE <
    0.06 m, `wait_idle` without a worker error."""
    system = System(None, cfg, threaded=True)
    est, ms = [], []
    for i, (imL, imR) in enumerate(frames):
        t0 = time.perf_counter()
        est.append(system.track_stereo(imL, imR, timestamp=i / 20.0))
        ms.append((time.perf_counter() - t0) * 1e3)
    system.wait_idle()
    lm = system.local_mapper
    system.shutdown()
    n_tracked = sum(T is not None for T in est)
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]))
    out = dict(tracked=n_tracked, ate_rmse_m=rmse, ms_per_frame_p50=statistics.median(ms[2:]),
               ms_per_frame_max=max(ms[2:]), keyframes_mapped=lm.n_processed, local_ba=lm.n_local_ba)
    print(f"threaded: {n_tracked}/{len(frames)} frames tracked, ATE RMSE {rmse:.4f} m, ms/frame p50 "
          f"{out['ms_per_frame_p50']:.2f} max {out['ms_per_frame_max']:.2f}, {lm.n_processed} keyframes mapped, "
          f"{lm.n_local_ba} local BAs on the worker thread")
    check(n_tracked >= len(frames) - 1, f"threaded: only {n_tracked}/{len(frames)} frames tracked")
    check(rmse < 0.06, f"threaded: ATE RMSE {rmse} >= 0.06 m")
    check(lm.n_processed >= 2, f"threaded: the worker processed {lm.n_processed} keyframes")
    return out


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

    reset_launch_counts()
    system, est, ms, per_frame, fused, calls, ba_devices = run_slice(world, cfg, frames, "cuda",
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
    results.update(check_k3_main_path(calls))
    # kernel profiling after the slice, so that no profiler session runs
    # before the slice's frames, and before the profile phase: profiler
    # sessions after that long one have traced no kernels on the H100
    for name, k in KERNELS.items():
        results[name][1]["device_ms"] = device_ms(results[name][3], k["kernel"])
    profile_frames(system, profile_set, N_FRAMES)
    check(n_tracked >= N_FRAMES - 1, f"only {n_tracked}/{N_FRAMES} frames tracked")
    check(rmse < 0.06, f"ATE RMSE {rmse} >= 0.06 m")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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
        per_frame_n = launches[name] / N_FRAMES
        print(f"{name}: {per_frame_n:.3f} launches/frame; per launch: wrapper {t['ms']:.4f} ms, "
              f"device {t['device_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}), roofline share {bound_ms / t['device_ms']:.2%}; per frame: wrapper "
              f"{t['ms'] * per_frame_n:.4f} ms, device {t['device_ms'] * per_frame_n:.4f} ms; {smi}")
        rows.append({
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": launches[name], "launches_per_frame": per_frame_n, "max_abs_err": err,
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

    print(json.dumps({"slice": {
        "frames": N_FRAMES, "tracked": n_tracked, "ate_rmse_m": rmse,
        "ms_per_frame_p50": statistics.median(steady), "ms_per_frame_max": max(steady),
        **mapping, "threaded": threaded, "card": smi,
    }}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
