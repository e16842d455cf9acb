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
     against its plain version on its edge cases; times the wrapper and
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
     its K3 call held exactly against the plain version, its EPnP RANSAC
     against the plain CPU path on the recorded arguments and hypotheses
     (pose within 1e-3 m and 1e-3 rad, inlier counts within 2);
  6. localization mode: 8 frames after `activate_localization_mode()`,
     all tracked, no keyframe, no new map point, no fused step,
     visual-odometry points matched; then `deactivate_localization_mode()`
     and frames 33-39;
  7. times each kernel alone by its `torch.profiler` durations (between
     phases 5 and 6: after the slice, so that no profiler session
     precedes the slice's frames, and before the long profile phase);
     profiles 10 more frames (per traced stage: host and device ms and
     device kernels, per frame for the tracker's stages and per call for
     the mapper's), in which mapping has resumed; prints each kernel's
     launches per frame, times, bound and roofline share;
  8. runs `System(vocabulary, cfg, threaded=True)` over the 40 frames: the
     mapper and the keyframe indexing (K4) on the worker thread, >= 39
     frames tracked, ATE RMSE < 0.06 m, every live keyframe indexed,
     `wait_idle` without a worker error;
  9. prints one JSON line describing the kernels (one row per K3 mode and
     caller, and K4), then the result line.

It exits non-zero, and prints no result, when any phase fails, when no
CUDA card is visible, or when the port cannot be imported.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
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
from orbslam2_tpu_torch.ops import ba, fast, hamming, orb, patches, pnp
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
    """K4 against its plain version on the edge cases of `kernels/cases.py`."""
    names = []
    for name, voc, desc, valid, level in cases.k4_cases("cuda"):
        got = bow.transform_words_nodes(voc, desc, valid, level)
        want = bow.transform_words_nodes_plain(voc, desc, valid, level)
        torch.cuda.synchronize()
        for g, w, label in zip(got, want, ("words", "nodes")):
            check(torch.equal(g, w), f"bow_transform {label} differ from plain ({name})")
        names.append(name)
    print(f"K4 bow_transform: exact on {len(names)} edge cases ({'; '.join(names)})")


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
    got = bow.transform_words_nodes(voc, f.desc, f.valid)
    want = bow.transform_words_nodes_plain(voc, f.desc, f.valid)
    torch.cuda.synchronize()
    for g, w, label in zip(got, want, ("words", "nodes")):
        check(torch.equal(g, w), f"bow_transform {label} differ from plain on keyframe {kf}")
    db = system.relocalizer.database
    check(np.array_equal(db.kf_words[kf], np.unique(got[0].cpu().numpy()[got[0].cpu().numpy() >= 0])),
          f"keyframe {kf}: the database's words are not K4's")
    call = functools.partial(bow.transform_words_nodes, voc, f.desc, f.valid)
    timing = dict(ms=cuda_ms(call), plain_ms=cuda_ms(functools.partial(
        bow.transform_words_nodes_plain, voc, f.desc, f.valid)))
    print(f"K4 bow_transform: exact on keyframe {kf}'s {int(f.valid.sum())} descriptors against the "
          f"{voc.n_words}-word vocabulary (k {voc.k}, depth {voc.depth}, {voc.node_word.shape[0]} nodes)")
    return 0.0, timing, k4_bound(voc, f.desc, f.valid), call


@contextlib.contextmanager
def k3_recorder(sink, keep=lambda row: True):
    """Records every K3 call made inside whose row `keep` accepts, as (row,
    A, B, gate) appended to `sink`, by wrapping `hamming._launch`, the one
    launch path below the counted wrappers; `hamming.best2` is wrapped to
    know the caller of a mask-mode call."""
    launch, best2 = hamming._launch, hamming.best2
    callers = []

    def best2_tagged(A, B, mask, caller="search_by_bow"):
        callers.append(caller)
        try:
            return best2(A, B, mask, caller)
        finally:
            callers.pop()

    best2_tagged.launches = best2.launches

    def recording(mode, A, B, tensors, oct_mode="both"):
        row = MASK_ROWS[callers[-1]] if mode == "mask" else mode
        if keep(row):
            sink.append((row, *k3_record(mode, A, B, tensors, oct_mode)))
        return launch(mode, A, B, tensors, oct_mode)

    hamming._launch, hamming.best2 = recording, best2_tagged
    try:
        yield sink
    finally:
        hamming._launch, hamming.best2 = launch, best2


def run_slice(world, cfg, frames, device, record=()):
    """Track `frames`; returns (system, poses, ms per frame, launch counts
    per frame, fused flag per frame, recorded K3 calls, devices of the
    local BA problems). The K3 calls of the frames in `record`, and those
    of the mapper on the first frame whose mapping pass launched both
    mapper rows, are recorded ({frame: [(row, A, B, gate)]}); nothing is
    recorded when `record` is empty."""
    system = System(VOCAB, cfg, enable_loop_closing=False, device=device)
    est, ms, per_frame, fused, calls, ba_devices = [], [], [], [], {}, []
    solve = ba.ba_solve_pm_interruptible
    at = {"frame": 0, "mapping": None}
    sink = []

    def solve_seen(prob, *a, **k):
        ba_devices.append(prob.poses.device)
        return solve(prob, *a, **k)

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
    return system, est, ms, per_frame, fused, calls, ba_devices


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

    k3_calls, ransac, attempts = [], [], []
    ransac_fn, relocalize = pnp.pnp_ransac_from_hypotheses, reloc.relocalize

    def ransac_recorded(*args):
        res = ransac_fn(*args)
        ransac.append((args, res))
        return res

    def relocalize_timed(frame):
        t0 = time.perf_counter()
        ok = relocalize(frame)
        torch.cuda.synchronize()
        attempts.append(((time.perf_counter() - t0) * 1e3, frame))
        return ok

    pnp.pnp_ransac_from_hypotheses, reloc.relocalize = ransac_recorded, relocalize_timed
    try:
        with k3_recorder(k3_calls):
            T = system.track_stereo(*frames[KIDNAPPED], timestamp=101.0)
    finally:
        pnp.pnp_ransac_from_hypotheses = ransac_fn
        del reloc.relocalize
    rec = reloc.trace[-1]
    check(T is not None and rec["ok"] and len(attempts) == 1 and len(ransac) == 1,
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
    return out, k3_calls, ransac[0], frame


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
    reloc, reloc_calls, ransac, reloc_frame = run_relocalization(system, frames, poses_gt)
    results.update(check_k3_main_path({"kidnapped": [c for c in reloc_calls if c[0] == "mask:relocalization"]},
                                      rows=("mask:relocalization",), path="relocalization"))
    reloc["ransac"] = check_ransac_cpu(ransac)
    # kernel profiling after the slice, so that no profiler session runs
    # before the slice's frames, and before the profile phase: profiler
    # sessions after that long one have traced no kernels on the H100
    for name, k in KERNELS.items():
        results[name][1]["device_ms"] = device_ms(results[name][3], k["kernel"])
    reloc["profiled"] = profile_relocalize(system, reloc_frame)
    localization = run_localization(system, frames, poses_gt)
    processed = lm.n_processed
    profile_frames(system, profile_set, N_FRAMES)
    check(lm.n_processed > processed, "mapping did not resume after localization mode")
    print(f"mapping resumed: {lm.n_processed - processed} keyframes processed in the profile phase")

    path_launches = {"main": launches, "relocalization": reloc["launches"]}
    path_frames = {"main": N_FRAMES, "relocalization": N_BLACK + 1 + len(RESUMED)}
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

    print(json.dumps({"slice": {
        "frames": N_FRAMES, "tracked": n_tracked, "ate_rmse_m": rmse,
        "ms_per_frame_p50": statistics.median(steady), "ms_per_frame_max": max(steady),
        **mapping, "threaded": threaded, "card": smi,
    }, "relocalization": {k: v for k, v in reloc.items() if k != "launches"},
        "localization": {k: v for k, v in localization.items() if k != "launches"}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
