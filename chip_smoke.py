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
     inside them) and prints the levels it stages; holds the pose LM
     kernel K5 against its plain version on its edge cases and those of
     its cluster layout (inlier masks and counts equal, the pose within
     1e-6, a second launch equal to the first bit for bit) and the
     keypoint selection kernel K6 exactly on its edge cases and those of
     its block layout; prints ptxas's registers, stack and spills of
     every kernel built; times the wrapper and
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
     frames agree with the port's plain CPU path (mapping included; run in
     a spawned process of its own while the card runs phases 9 and 9d), that
     the database holds every live keyframe and K4 launched once per
     processed keyframe; holds each K3 mode, and K4 on one indexed
     keyframe's descriptors, exactly against its plain version on the
     recorded arguments and times it there; records every
     pose_optimize and select_keypoints_levels call of the slice, checks
     that K5 launched twice on every fused frame and K6 twice (its cell
     pass and its top-k pass) on every frame, holds K6 exactly against its
     plain version on every level of every frame and K5 as on its edge
     cases on every call (and a replay of each K5 call equal to its
     main-path launch bit for bit), and times both there;
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
  5b. MLPnP relocalization: a `Relocalizer(..., solver="mlpnp")` over the
     slice's map and keyframe database relocalizes frame 16's view (within
     0.1 m); its MLPnP RANSAC calls against the CPU on the recorded
     hypotheses (pose within 1e-3 m and 1e-3 rad, inliers within 2);
  5c. undistortion: a `Frontend` with EuRoC cam0's k1, k2, p1 and p2 gives
     stereo and mono keypoints equal, within 1e-3 px, to the undistortion
     on the CPU path of the raw keypoints of a `Frontend` without them;
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
  6c. the monocular slice (a System of its own): K1 and K2 with one image,
     exact against their plain versions; `System(VOCAB, cfg,
     sensor=Sensor.MONOCULAR)` over tests/test_monocular.py's 35 frames,
     launch counts set to 0 just before and read just after; the bars of
     that test (>= 30/35 tracked, scale-aligned ATE < 0.06 m, > 400
     points, no stereo observation in a keyframe, initial median depth in
     (0.2, 5)); K1 and K2 one launch per frame; K3 `mask:mono_init`,
     `frame` and `points` exact on recorded calls; the two-view
     initializer against the CPU on the recorded matches and hypotheses;
  7. localization mode: 8 frames after `activate_localization_mode()`,
     all tracked, no keyframe, no new map point, no fused step,
     visual-odometry points matched; then `deactivate_localization_mode()`
     and frames 33-39;
  8. times each kernel alone by its `torch.profiler` durations, K4 also
     with 2 and 3 staged levels (between
     phases 6 and 7: after the slice, so that no profiler session
     precedes the slice's frames, and before the long profile phase);
     profiles 5 more frames, and on to at most 10 until the mapper has
     processed a keyframe (per traced stage: host and device ms and
     device kernels, per frame for the tracker's stages and per call for
     the mapper's), in which mapping has resumed; prints each kernel's
     launches per frame, times, bound and roofline share;
  9. runs `System(vocabulary, cfg, enable_loop_closing=False,
     threaded=True)` over the 40 frames: the
     mapper and the keyframe indexing (K4) on the worker thread, >= 39
     frames tracked, ATE RMSE < 0.06 m, every live keyframe indexed,
     `wait_idle` without a worker error;
  9b. the monocular loop: tests/test_mono_loop.py on the card (the circuit
     world, 1.16 laps rendered ahead once, a 1.3x scale drift injected
     after frame 85, loop closing inline with a free scale): tracking OK,
     >= 1 loop, the injected factor > 1.2, the scale error shrunk > 5x;
     prints each loop's Sim3 scale;
  9c. the threaded loop: `System(vocab_circuit, cfg, threaded=True)` over
     the same lap, then on until its first loop (at most 450 frames):
     tests/test_pipeline.py's bars (<= 2 lost, >= 1 loop, >= 1 frame
     inside a correction window, steady max latency < max(4 x median,
     2.5 s), ATE < 0.45 m), `wait_idle` and `shutdown` without an error,
     no global BA thread alive after; prints the global BA's host ms and
     its aborts;
  9d. the checkpoint, the disk drivers, the rectifier and the viewer: the
     slice's System (its last use) saved by `save_map` and loaded into a
     fresh System on the card (keyframe and point sets, poses, positions,
     observations and covisibility weights equal, each reloaded keyframe's
     device features `torch.equal` to the original's, one K3 `mask` call
     through `search_by_bow` between frame 39 and a reloaded keyframe equal
     to the call on the original); the slice's 40 frames written as PNGs
     in the EuRoC layout with identity LEFT/RIGHT blocks and run through
     `drivers.run_euroc.main` on the card (counts set to 0 just before
     and read just after: K1 and K2 one launch per frame, K3's stereo,
     frame, points and mask modes and K4 launched; >= 39/40 tracked, ATE
     < 0.06 m, timestamps within 5e-4 s, the three TUM files, every
     decoded and rectified frame equal to the frame written), then 10
     frames in the KITTI layout through `drivers.run_kitti.main` (a
     12-column line per frame); the rectifier on the card against the CPU
     on real blocks (maps within 1e-4 px, images within 1 gray level);
     `System(None, cfg, use_viewer=True)` over 10 frames (>= 2 live
     renders, no live error, > 50 green feature pixels, a saved map PNG
     equal to `render_array`, the localization toggle and the reset
     applied by the live loop) and its `shutdown(measure_frontend_split=
     True)` (the report names "ORB extraction" and "Stereo matching");
  9e. the mesh phase (a mesh of MESH_SHARDS shards: one card each where as
     many cards are visible, else all on card 0): the loop phase's first
     recorded global BA and essential graph solved sharded
     (`parallel/dist_ba.py`, `dist_posegraph.py`) and on one device, with
     the bars of tests/test_dist_ba.py (BA poses within 5e-4 and median
     point within 1e-3, the graph's R and t within 1e-3 and its cost
     within 1e-3 relative) and the host ms of each; the same BA over a
     process group of MESH_SHARDS spawned processes (`parallel/
     multihost.py`: NCCL on a card each, gloo when they share one), every
     rank's result equal bit for bit to the in-process mesh's (the ranks
     solve while the System below tracks); `System(vocab_circuit, cfg,
     mesh=mesh)`, stereo, loop closing inline, over the circuit until its
     first loop (at most 200 frames past the lap, tests/test_mesh_loop.py's
     margin), launch counts set to 0 just
     before and read just after: >= 1 loop, both sharded solvers built and
     run on every shard, ATE RMSE < 0.45 m (that test's bar), K1-K4
     launched;
  9f. cold starts (run right after the kernels' checks): `System(VOCAB,
     cfg)` in a fresh spawned process, without and then with
     `System.precompile()`: the slice's 40 frames, 3 black frames, frame
     16's view relocalized, one Sim3 detection between the newest and the
     oldest keyframe; the host ms of frame 0, frame 1, the relocalizing
     attempt and the Sim3 detection, and the precompile's seconds;
  9g. the pipelined slice (after phase 5c): the 40 frames on `System(VOCAB,
     cfg, enable_loop_closing=False)` synchronous, then with
     `pipelined_tracking` on, launch counts set to 0 just before and read
     after each; the pipelined dispatch (assembly, fused step, host copy)
     under `torch.cuda.set_sync_debug_mode("error")`; p50 and max ms/frame
     of each (frames 2..29) and the device's busy share over frames 30-39
     under the profiler; bars: 40 entries, >= 38 solved, ATE < 0.10 m,
     nothing pending after shutdown, K1, K2, K3 `stereo` once and K6 twice a
     frame, K5 and K3 `frame` twice a dispatched frame;
  9h. the COO bundle adjustment (after phase 6b): the slice's first local
     BA as a COO problem, `ba.ba_solve` twice (bit-identical), against
     `ba_solve_pm` on the same problem and on 2 shards of the card
     (`dist_ba.make_distributed_ba`) against one device
     (tests/test_dist_ba.py's bars), with the host ms of each;
  10. prints each phase's wall time, the script's total, one JSON line of
     the phases' results,
     one JSON line describing the kernels (K1, K2, one row per K3 mode
     and caller, K4, K5 and K6; each with its launches on its path and on
     the pipelined slice), then the result line.

It exits non-zero, and prints no result, when any phase fails, when no
CUDA card is visible, or when the port cannot be imported.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.kernels import build, cases
from orbslam2_tpu_torch.geometry import sim3, triangulation
from orbslam2_tpu_torch.geometry.camera import Camera
from orbslam2_tpu_torch.ops import (ba, fast, hamming, initializer, mlpnp, orb, patches, pnp, pose_opt, posegraph,
                                    sim3solve, undistort)
from orbslam2_tpu_torch.parallel import dist_ba, dist_posegraph, multihost
from orbslam2_tpu_torch.parallel.mesh import Mesh, make_mesh
from orbslam2_tpu_torch.slam.frontend import FrameHost, Frontend
from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
from orbslam2_tpu_torch.slam.relocalization import CANDIDATES, Relocalizer
from orbslam2_tpu_torch.slam.system import Sensor, System
from orbslam2_tpu_torch.slam import tracking
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
# the CPU path's threads, in its own process beside the card's phases
CPU_PATH_THREADS = 2
N_PROFILE_FRAMES = 10
# profiled frames: at least this many, then until a keyframe was mapped
# (the mapper's stages are part of the profile)
N_PROFILE_MIN = 5
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
# K5, per edge, counted from csrc/pose_lm.cu (a multiply-add counts 2): an
# LM pass (`accumulate`: `project`'s pose, 1/z, residual and chi2, 40; the
# Huber weight and F, 12; the Jacobian rows, 10; per component its weight,
# the cross product, -r, and the 21 + 6 products into H and g, 71) and a
# reclassification (`project` and the test, 45); float64, at the data
# sheet's float64 rate outside the tensor cores
K5_OPS_PER_EDGE_PASS = 40 + 12 + 10 + 3 * 71
K5_OPS_PER_EDGE_CLASSIFY = 45
FP64_OPS_PER_S = 34e12
# K6, per pixel: the threshold, fallback and border tests, the key's
# quantization, clamp and packing, the cell maximum
K6_OPS_PER_PX = 15
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
    "hamming_best2:mask:mono_init": dict(kernel="GateMask", source=K3_SOURCE,
                                         replaces="orbslam2_tpu/slam/tracking.py:630", path="mono"),
    "pose_lm": dict(kernel="pose_lm_kernel", source="orbslam2_tpu_torch/csrc/pose_lm.cu",
                    replaces="orbslam2_tpu/ops/pose_opt.py:193"),
    # two kernels a call: the cell pass and the top-k pass
    "select_keypoints": dict(kernel="select_keypoints_", source="orbslam2_tpu_torch/csrc/select_keypoints.cu",
                             replaces="orbslam2_tpu/ops/orb.py:206", per_call=2),
}
# K3's rows: the tracker's modes, then the mapper's (mask mode under its
# caller epipolar_match); the relocalizer's mask row is recorded on its path
K3_ROWS = ("mask", "stereo", "frame", "points", "fuse", "mask:epipolar")
# a mask-mode call's row by its caller
MASK_ROWS = {"search_by_bow": "mask", "epipolar_match": "mask:epipolar", "relocalization": "mask:relocalization",
             "mono_init": "mask:mono_init"}
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
# the monocular slice: tests/test_monocular.py's world and 35 frames, the
# rows it checks, the bars of that test
MONO_WORLD = dict(n_points=1200, seed=31, depth_range=(4.0, 10.0))
N_MONO = 35
MONO_ROWS = ("mask:mono_init", "frame", "points")
# the circuit of tests/test_mono_loop.py and tests/test_pipeline.py (one
# lap of 150 frames), rendered once for both phases, and its vocabulary
CIRCUIT_WORLD = dict(n_points=2000, seed=21, baseline=0.2, vertical_extent=6.0, cylinder_radius=11.0,
                     near_fraction=0.15)
VOCAB_CIRCUIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "vocab_circuit.npz")
N_CIRCUIT = 150
# the monocular loop: 1.16 laps, the drift injected after frame 85
MONO_LOOP_EXTRA = 24
INJECT_AT = 85
DRIFT_SCALE = 1.3
# the threaded loop: frames past the first lap until the loop closes
THREADED_MAX_EXTRA = 300
# the mesh phase: shards (one card each where as many are visible, else all
# on card 0), and frames past the first lap until the mesh System's loop
# closes (tests/test_mesh_loop.py's 200)
MESH_SHARDS = 2
MESH_MAX_EXTRA = 200
# the pipelined phase: the slice's frames on a System with pipelined
# tracking on and, for the same measurements, off; its last frames under
# the profiler (the device's busy share); tests/test_pipelined_tracking.py's
# ATE bar
N_PIPE_PROFILED = 10
PIPE_ATE_BAR = 0.10
# the device of the monocular, MLPnP, undistortion and circuit phases (a
# rehearsal of them on the CPU sets "cpu")
DEVICE = "cuda"
# EuRoC cam0's distortion (the 752x480 camera of the synthetic worlds)
DISTORTION = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)


def launch_counts() -> dict:
    """Every kernel's launch counter, by KERNELS name."""
    c = {"fast_nms": fast.fast_nms_levels.launches, "orb_patch_desc": patches.orb_patch_desc_levels.launches,
         "bow_transform": bow.transform_words_nodes.launches, "pose_lm": pose_opt.pose_optimize.launches,
         "select_keypoints": orb.select_keypoints_levels.launches}
    c.update({f"hamming_best2:{row}": hamming.best2.launches[caller] for caller, row in MASK_ROWS.items()})
    c.update({f"hamming_best2:{m}": n for m, n in hamming.best2_gated.launches.items()})
    return c


def reset_launch_counts():
    fast.fast_nms_levels.launches = 0
    patches.orb_patch_desc_levels.launches = 0
    bow.transform_words_nodes.launches = 0
    pose_opt.pose_optimize.launches = 0
    orb.select_keypoints_levels.launches = 0
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


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `nbytes` and do `ops` operations, at the published H100 SXM peaks
    (the operations at `ops_per_s`, float32's unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, kernel: str, reps: int = 20, per_call: int = 1) -> float:
    """Device-only milliseconds of one call fn(), which launches `per_call`
    kernels whose names hold `kernel`: the median over `reps` calls, one
    profiler session per call, of the sum of their `torch.profiler`
    durations. A session whose trace lost a launch is skipped; at least
    half of them must show every one."""
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
        check(len(seen) <= per_call, f"one call launched {kernel} {len(seen)} times, not {per_call}")
        if len(seen) == per_call:
            durs.append(sum(seen))
    check(2 * len(durs) >= reps, f"profiler saw all {per_call} launches of {kernel} in {len(durs)} of {reps} calls")
    return statistics.median(durs) / 1e3


@contextlib.contextmanager
def patched(owner, name: str, wrap):
    """Replaces owner.<name> by wrap(original) inside. A kernel wrapper
    counts its launches through its module's global name, which is the
    replacement while patched, so its `launches` counter carries over both
    ways."""
    orig = getattr(owner, name)
    new = wrap(orig)
    counted = hasattr(orig, "launches")
    if counted:
        new.launches = orig.launches
    setattr(owner, name, new)
    try:
        yield new
    finally:
        setattr(owner, name, orig)
        if counted:
            orig.launches = new.launches


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


def check_orb_patch_desc(levels, xs_l, ys_l, n_kp_want=2400):
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
    check(n_kp == n_kp_want, f"K1 keypoint count {n_kp} != {n_kp_want}")
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


def check_k5_pair(got, want, what):
    """K5's result against the plain version's on one call: the same inlier
    mask and count, the pose within 1e-6. Returns (pose gap, bit-identical)."""
    torch.cuda.synchronize()
    check(torch.equal(got.inlier, want.inlier), f"pose_lm inlier mask differs from plain on {what}")
    check(int(got.n_inliers) == int(want.n_inliers),
          f"pose_lm n_inliers {int(got.n_inliers)} != plain {int(want.n_inliers)} on {what}")
    gap = float((got.Tcw - want.Tcw).abs().max())
    check(gap <= 1e-6, f"pose_lm pose differs from plain by {gap} on {what}")
    return gap, torch.equal(got.Tcw, want.Tcw)


def check_k5_edge_cases():
    """K5 against its plain version on the edge cases of `kernels/cases.py`
    (its cluster cases included), and a second launch on each equal to the
    first bit for bit."""
    out = []
    for name, args, cam in cases.k5_cases("cuda") + cases.k5_cluster_cases("cuda"):
        got = pose_opt.pose_optimize(*args, cam)
        gap, same = check_k5_pair(got, pose_opt.pose_optimize_plain(*args, cam), name)
        again = pose_opt.pose_optimize(*args, cam)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"pose_lm: a second launch differs on {name}")
        out.append(f"{name}: {'bit-identical' if same else f'gap {gap:.2e}'}")
    print(f"K5 pose_lm (clusters of {pose_opt.K5_CLUSTER} CTAs): inliers equal and pose within 1e-6 of plain on "
          f"{len(out)} edge cases, a second launch equal bit for bit on each ({'; '.join(out)})")


def k5_bound(args):
    """Bound of one K5 call: its inputs read once and its outputs written
    once; K5_OPS_PER_EDGE_PASS float64 operations per edge for each of the
    4 x (1 + 10) LM passes and K5_OPS_PER_EDGE_CLASSIFY for each of the 4
    reclassifications (the schedule's length is fixed)."""
    n = args[1].shape[0]
    nbytes = 64 + n * (12 + 12 + 4 + 1 + 1) + 64 + n + 4
    ops = n * (4 * 11 * K5_OPS_PER_EDGE_PASS + 4 * K5_OPS_PER_EDGE_CLASSIFY)
    return bound(nbytes, ops, FP64_OPS_PER_S)


def check_k5_main_path(calls):
    """K5 against its plain version on every recorded pose_optimize call of
    the slice ((args, kwargs, result)): the same inlier masks and counts,
    the pose within 1e-6; a replay of the kernel equals the main path's
    launch bit for bit (fixed-order sums). Timed on the last call. Returns
    (max_abs_err, times, bound, timed call)."""
    check(len(calls) > 0, "no pose_optimize call was recorded on the slice")
    worst, n_same = 0.0, 0
    for i, (args, kwargs, res) in enumerate(calls):
        got = pose_opt.pose_optimize(*args, **kwargs)
        gap, same = check_k5_pair(got, pose_opt.pose_optimize_plain(*args, **kwargs), f"slice call {i}")
        check(torch.equal(got.Tcw, res.Tcw) and torch.equal(got.inlier, res.inlier),
              f"pose_lm: a replay of slice call {i} differs from its main-path launch")
        worst, n_same = max(worst, gap), n_same + same
    args, kwargs, _ = calls[-1]
    call = functools.partial(pose_opt.pose_optimize, *args, **kwargs)
    timing = dict(ms=cuda_ms(call), plain_ms=cuda_ms(functools.partial(pose_opt.pose_optimize_plain, *args, **kwargs),
                                                     reps=5, batch=2))
    print(f"K5 pose_lm: inliers equal and pose within 1e-6 of plain on all {len(calls)} pose_optimize calls of the "
          f"slice, {n_same} bit-identical, max gap {worst:.3e}; replays equal the main path's launches; timed on "
          f"the last ({int(args[5].sum())} of {args[1].shape[0]} edges valid)")
    return worst, timing, k5_bound(args), call


def check_k6_edge_cases():
    """K6 exactly against its plain version on the edge cases of
    `kernels/cases.py` (its block cases included)."""
    names = []
    for name, scores, budgets in cases.k6_cases("cuda") + cases.k6_block_cases("cuda"):
        got = orb.select_keypoints_levels(scores, budgets, 20.0, 7.0)
        want = orb.select_keypoints_levels_plain(scores, budgets, 20.0, 7.0)
        torch.cuda.synchronize()
        for g, w, label in zip(got, want, ("xs", "ys", "resp", "valid")):
            check(all(torch.equal(a, b) for a, b in zip(g, w)), f"select_keypoints {label} differ from plain ({name})")
        names.append(name)
    print(f"K6 select_keypoints: exact on {len(names)} edge cases ({'; '.join(names)})")


def check_k6_main_path(calls):
    """K6 exactly against its plain version on every level of every frame
    of the slice (the recorded K2 scores of each extract call); timed on
    REC_FRAME's. Returns (max_abs_err, times, bound, timed call)."""
    check(len(calls) >= N_FRAMES, f"{len(calls)} select_keypoints calls recorded over {N_FRAMES} frames")
    for i, (args, kwargs, _) in enumerate(calls):
        got = orb.select_keypoints_levels(*args, **kwargs)
        want = orb.select_keypoints_levels_plain(*args, **kwargs)
        torch.cuda.synchronize()
        for g, w, label in zip(got, want, ("xs", "ys", "resp", "valid")):
            check(all(torch.equal(a, b) for a, b in zip(g, w)), f"select_keypoints {label} differ from plain on "
                                                                f"call {i}")
    args, kwargs, _ = calls[REC_FRAME]
    scores, budgets = args[0], args[1]
    call = functools.partial(orb.select_keypoints_levels, *args, **kwargs)
    timing = dict(ms=cuda_ms(call), plain_ms=cuda_ms(functools.partial(orb.select_keypoints_levels_plain, *args,
                                                                       **kwargs)))
    px = sum(t.numel() for t in scores)
    nbytes = 4 * px + scores[0].shape[0] * sum(budgets) * (4 + 4 + 4 + 1)
    print(f"K6 select_keypoints: exact on every level of all {len(calls)} calls of the slice ({len(scores)} levels x "
          f"{scores[0].shape[0]} images, {px} px each)")
    return 0.0, timing, bound(nbytes, K6_OPS_PER_PX * px), call


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(a) for a in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(a) for a in x)
    return x


def call_recorder(owner, name: str, sink: list):
    """Records (args, kwargs, result) of every call of owner.<name> made
    inside, cloned, into `sink` (see `patched`)."""
    def wrap(fn):
        def recording(*args, **kwargs):
            out = fn(*args, **kwargs)
            sink.append((_clone(args), dict(kwargs), _clone(out)))
            return out
        return recording
    return patched(owner, name, wrap)


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
    local BA problems, the first local BA's (args, kwargs, result), the
    recorded K5 and K6 calls). The K3 calls of the frames in `record`, and
    those of the mapper on the first frame whose mapping pass launched both
    mapper rows, are recorded ({frame: [(row, A, B, gate)]}), and every
    pose_optimize and select_keypoints_levels call ({"pose_lm": [(args,
    kwargs, result)], "select_keypoints": [...]}); nothing is recorded when
    `record` is empty."""
    system = System(VOCAB, cfg, enable_loop_closing=False, device=device)
    est, ms, per_frame, fused, calls, ba_devices, ba_calls = [], [], [], [], {}, [], []
    recorded = {"pose_lm": [], "select_keypoints": []}
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
        with contextlib.ExitStack() as recorders:
            if record:
                recorders.enter_context(k3_recorder(sink, keep))
                recorders.enter_context(call_recorder(pose_opt, "pose_optimize", recorded["pose_lm"]))
                recorders.enter_context(call_recorder(orb, "select_keypoints_levels", recorded["select_keypoints"]))
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
    return system, est, ms, per_frame, fused, calls, ba_devices, ba_calls[0] if ba_calls else None, recorded


def cpu_path(cfg, frames):
    """The plain CPU path of the slice over `frames`, in a process of its
    own (CPU_PATH_THREADS threads): (poses, its wall seconds)."""
    torch.set_num_threads(CPU_PATH_THREADS)
    t0 = time.perf_counter()
    est = run_slice(None, cfg, frames, "cpu")[1]
    return est, time.perf_counter() - t0


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
    """Track more frames under torch.profiler, N_PROFILE_MIN of them and
    then on until the mapper processed a keyframe: host/device times of the
    tracker's stages per frame and of the mapper's stages per call (one
    call per keyframe), the device's busy share of the wall time, the top
    kernels. Returns (wall ms per frame, busy share, frames profiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from orbslam2_tpu_torch.ops import matchers, pose_opt
    from orbslam2_tpu_torch.slam.frontend import Frontend

    stages = [(Frontend, "features_body"), (pose_opt, "pose_optimize"),
              (matchers, "search_by_projection_frame"), (matchers, "search_by_projection_points")]

    def traced(label):
        def wrap(fn):
            def run(*a, **k):
                with record_function(label):
                    return fn(*a, **k)
            return run
        return wrap

    span = LocalMapper._span

    def traced_span(self, name):
        stack = contextlib.ExitStack()
        stack.enter_context(span(self, name))
        stack.enter_context(record_function(f"stage:{name}"))
        return stack

    with contextlib.ExitStack() as stack:
        for owner, name in stages:
            stack.enter_context(patched(owner, name, traced(f"stage:{name}")))
        stack.enter_context(patched(LocalMapper, "_span", lambda orig: traced_span))
        mapped = system.local_mapper.n_processed
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n = 0
            for i, (imL, imR) in enumerate(frames):
                system.track_stereo(imL, imR, timestamp=(first + i) / 20.0)
                n += 1
                if n >= N_PROFILE_MIN and system.local_mapper.n_processed > mapped:
                    break
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
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
    return wall_ms / n, busy_ms / wall_ms, n


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


def _render_init(poses, world=LOOP_WORLD, as_uint8=True):
    _render_state.update(world=SyntheticWorld(**world), poses=poses, as_uint8=as_uint8)


def _render(i):
    """Frame i of `poses` in the worker's world: uint8 images (as the stereo
    tracker takes them), or the renderer's float32 images. The renderer's
    noise and gain follow how many frames it rendered before: set to i, as
    if it had rendered the sequence in order."""
    world = _render_state["world"]
    world._n_rendered = i
    ims = world.render_stereo(_render_state["poses"][i])
    if not _render_state["as_uint8"]:
        return ims
    return tuple(np.clip(np.rint(im), 0, 255).astype(np.uint8) for im in ims)


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


def phase_done(name, t0, times):
    """Print and keep a phase's own wall time."""
    times[name] = time.perf_counter() - t0
    print(f"phase {name}: {times[name]:.1f} s")


def mono_poses(n):
    """tests/test_monocular.py's trajectory: forward and right with a small
    vertical wave, no rotation."""
    out = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = -np.array([0.06 * i, 0.01 * np.sin(0.3 * i), 0.015 * i])
        out.append(T)
    return out


def init_near_gate(args, T21, eps=1e-3):
    """Matches of a two-view initializer call (its recorded arguments) whose
    CheckRT quantities under T21 lie within `eps` (relative) of a gate: the
    depth in either view, the parallax angle against acos(0.99998), the
    squared reprojection error in either view against 4."""
    _, uv1, uv2, _, cam = args[:5]
    uv1, uv2, T = uv1.cpu().double(), uv2.cpu().double(), T21.cpu().double()
    xn1 = torch.stack([(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy], -1)
    xn2 = torch.stack([(uv2[:, 0] - cam.cx) / cam.fx, (uv2[:, 1] - cam.cy) / cam.fy], -1)
    X, _ = triangulation.triangulate_dlt(torch.eye(4, dtype=T.dtype)[:3], T[:3], xn1, xn2)
    Xc2 = X @ T[:3, :3].T + T[:3, 3]
    R, t = T[:3, :3], T[:3, 3]
    ang = torch.arccos(torch.clamp(triangulation.rays_parallax_cos(torch.zeros(3, dtype=T.dtype), -R.T @ t, X), -1, 1))
    near = (torch.abs(X[:, 2]) < eps) | (torch.abs(Xc2[:, 2]) < eps)
    near |= torch.abs(ang - float(np.arccos(0.99998))) <= eps * float(np.arccos(0.99998))
    for Xc, uv in ((X, uv1), (Xc2, uv2)):
        z = torch.where(torch.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        e2 = (cam.fx * Xc[:, 0] / z + cam.cx - uv[:, 0]) ** 2 + (cam.fy * Xc[:, 1] / z + cam.cy - uv[:, 1]) ** 2
        near |= torch.abs(e2 - 4.0) <= 4.0 * eps
    return near.numpy()


def check_initializer_cpu(calls):
    """The card's two-view initializer against the CPU on every recorded
    call's matches and hypotheses: the same success and model, T21 within
    1e-4 where it succeeded, the same point mask except matches within 1e-3
    of a gate or of a model-inlier difference (at most 2 of those)."""
    worst = dict(t21_gap=0.0, point_ok_diff=0, inlier_diff=0)
    for args, kwargs, res in calls:
        cpu = initializer.initialize_two_view_from_hypotheses(
            *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args), **kwargs)
        check(bool(res.success) == bool(cpu.success) and bool(res.used_homography) == bool(cpu.used_homography),
              f"two-view initializer card vs cpu: success {bool(res.success)}/{bool(cpu.success)}, homography "
              f"{bool(res.used_homography)}/{bool(cpu.used_homography)}")
        inl_diff = np.nonzero(res.inliers.cpu().numpy() != cpu.inliers.numpy())[0]
        check(len(inl_diff) <= 2, f"two-view initializer: {len(inl_diff)} model inliers differ card vs cpu")
        worst["inlier_diff"] = max(worst["inlier_diff"], len(inl_diff))
        if not bool(cpu.success):
            continue
        gap = float((res.T21.cpu() - cpu.T21).abs().max())
        check(gap < 1e-4, f"two-view initializer card vs cpu: T21 gap {gap}")
        diff = np.nonzero(res.point_ok.cpu().numpy() != cpu.point_ok.numpy())[0]
        allowed = init_near_gate(args, cpu.T21)
        allowed[inl_diff] = True
        check(bool(allowed[diff].all()), f"two-view initializer: point_ok differs away from a gate at {diff}")
        worst.update(t21_gap=max(worst["t21_gap"], gap), point_ok_diff=max(worst["point_ok_diff"], len(diff)))
    print(f"two-view initializer: card vs cpu on {len(calls)} recorded calls (matches and hypotheses): {worst}")
    return worst


def run_mono(times):
    """The monocular slice: `System(VOCAB, cfg, sensor=Sensor.MONOCULAR)` on
    the card over tests/test_monocular.py's 35 frames (loop closing on, with
    a free scale). K1 and K2 on one image, exact against their plain
    versions on a mono frame; launch counts set to 0 just before the frames
    and read just after; the K3 rows `mask:mono_init`, `frame` and `points`
    and the two-view initializer recorded. Bars: initialized, >= 30/35
    tracked, no keyframe with a stereo observation, > 400 points,
    scale-aligned ATE RMSE < 0.06 m, initial map median depth in (0.2, 5)."""
    t0 = time.perf_counter()
    world = SyntheticWorld(**MONO_WORLD)
    cfg = slam_config(world)
    poses = mono_poses(N_MONO)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(RENDER_WORKERS, initializer=_render_init, initargs=(poses, MONO_WORLD, False)) as pool:
        images = [ims[0] for ims in pool.map(_render, range(N_MONO), chunksize=1)]
    # K1 and K2 launched with one image, as features_mono launches them
    levels, xs_l, ys_l = level_inputs(torch.from_numpy(images[2][None]).to(DEVICE), orb.OrbParams())
    check_fast_nms(levels)
    check_orb_patch_desc(levels, xs_l, ys_l, n_kp_want=1200)

    system = System(VOCAB, cfg, sensor=Sensor.MONOCULAR, device=DEVICE)
    check(system.config.monocular and not system.loop_closer.fix_scale, "the monocular System's wiring")
    k3_calls, est, per_frame, ms = [], [], [], []
    seen = {row: 0 for row in MONO_ROWS}

    def keep(row):
        if row not in seen or seen[row] >= 3:
            return False
        seen[row] += 1
        return True

    with _Recorder(initializer, "initialize_two_view_from_hypotheses", keep=16) as inits, \
            k3_recorder(k3_calls, keep):
        reset_launch_counts()
        for i, im in enumerate(images):
            before = launch_counts()
            t1 = time.perf_counter()
            est.append(system.track_monocular(im, i / 20.0))
            ms.append((time.perf_counter() - t1) * 1e3)
            per_frame.append({k: v - before[k] for k, v in launch_counts().items()})
        torch.cuda.synchronize()
        launches = launch_counts()
    system.shutdown()
    m = system.map
    n_tracked = sum(T is not None for T in est)
    pairs = [(g, e) for g, e in zip(poses, est) if e is not None]
    rmse = ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]),
                    with_scale=True) if pairs else float("inf")
    k0 = min(m.kf_pose) if m.kf_pose else None
    med = float("nan")
    if k0 is not None:
        T = m.kf_pose[k0].astype(np.float64)
        ids = np.asarray(list(m.pt_valid)[:200], np.int64)
        med = float(np.median(m.pt_pos[ids] @ T[2, :3] + T[2, 3]))
    init_frame = next((i for i, e in enumerate(est) if e is not None), None)
    stereo_obs = sum(int((m.kf_frame[k].u_right >= 0).sum()) for k in m.kf_valid)
    out = dict(frames=N_MONO, tracked=n_tracked, init_frame=init_frame, ate_rmse_scale_aligned_m=rmse,
               keyframes=m.n_keyframes(), points=len(m.pt_valid), initial_median_depth=med,
               stereo_observations=stereo_obs, init_calls=len(inits.calls),
               keyframes_mapped=system.local_mapper.n_processed, ms_per_frame_p50=statistics.median(ms[2:]),
               ms_per_frame_max=max(ms[2:]))
    print(f"monocular: {n_tracked}/{N_MONO} tracked (initialized on frame {init_frame} after "
          f"{len(inits.calls)} initializer call(s)), scale-aligned ATE RMSE {rmse:.4f} m, {m.n_keyframes()} "
          f"keyframes, {len(m.pt_valid)} points, initial median depth {med:.3f}, {stereo_obs} stereo "
          f"observations in keyframes; ms/frame p50 {out['ms_per_frame_p50']:.2f} max {out['ms_per_frame_max']:.2f} "
          f"(frames 2..{N_MONO - 1}); launches {launches}")
    check(init_frame is not None and n_tracked >= 30, f"monocular: {n_tracked}/{N_MONO} frames tracked")
    check(stereo_obs == 0, f"monocular: {stereo_obs} stereo observations in keyframes")
    check(len(m.pt_valid) > 400, f"monocular: {len(m.pt_valid)} map points")
    check(rmse < 0.06, f"monocular: scale-aligned ATE RMSE {rmse} >= 0.06 m")
    check(0.2 < med < 5.0, f"monocular: initial map median depth {med}")
    for name in ("fast_nms", "orb_patch_desc"):
        check(all(c[name] == 1 for c in per_frame), f"monocular: {name} launches per frame "
              f"{[c[name] for c in per_frame]}")
    for row in MONO_ROWS:
        check(launches[f"hamming_best2:{row}"] > 0, f"monocular: K3 {row} never launched")
    out["initializer"] = check_initializer_cpu(inits.calls)
    rows = check_k3_main_path({"mono": k3_calls}, rows=MONO_ROWS, path="mono")
    phase_done("monocular", t0, times)
    return out, launches, {"hamming_best2:mask:mono_init": rows["hamming_best2:mask:mono_init"]}


def run_mlpnp_relocalization(system, frames, poses_gt, times):
    """A Relocalizer with solver="mlpnp" over the slice's map and keyframe
    database relocalizes frame KIDNAPPED's view (within 0.1 m); its MLPnP
    RANSAC calls, on the card, against the CPU on the recorded hypotheses:
    pose within 1e-3 m and 1e-3 rad, inlier counts within 2."""
    t0 = time.perf_counter()
    r = Relocalizer(system.config, system.frontend, system.map, system.vocabulary, solver="mlpnp")
    r.database = system.relocalizer.database
    u8 = [np.clip(np.rint(im), 0, 255).astype(np.uint8) for im in frames[KIDNAPPED]]
    frame = FrameHost(system.frontend.process(*u8), 200.0, 10_000)
    with _Recorder(mlpnp, "mlpnp_ransac_from_hypotheses", keep=CANDIDATES) as rec, system.map.lock:
        t1 = time.perf_counter()
        ok = r.relocalize(frame)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t1) * 1e3
    check(ok, f"MLPnP relocalization failed: {r.trace[-1]}")
    err = float(np.linalg.norm(center(frame.Tcw) - center(poses_gt[KIDNAPPED])))
    check(err < 0.1, f"MLPnP relocalized camera centre {err} m from the ground truth")
    worst = (0.0, 0.0, 0)
    for args, kwargs, res in rec.calls:
        cpu = mlpnp.mlpnp_ransac_from_hypotheses(*(a.cpu() for a in args))
        Tg, Tc = res.Tcw.cpu().numpy(), cpu.Tcw.numpy()
        dc, dr = float(np.linalg.norm(center(Tg) - center(Tc))), rot_err(Tg[:3, :3], Tc[:3, :3])
        dn = abs(int(res.n_inliers) - int(cpu.n_inliers))
        worst = (max(worst[0], dc), max(worst[1], dr), max(worst[2], dn))
        check(dc < 1e-3 and dr < 1e-3 and dn <= 2,
              f"MLPnP RANSAC card vs cpu: centre {dc} m, rotation {dr} rad, inliers {int(res.n_inliers)} vs "
              f"{int(cpu.n_inliers)}")
    out = dict(relocalized_err_m=err, host_ms=host_ms, attempt=r.trace[-1], ransac_calls=len(rec.calls),
               card_vs_cpu=dict(centre_m=worst[0], rotation_rad=worst[1], inliers=worst[2]))
    print(f"MLPnP relocalization: frame {KIDNAPPED}'s view relocalized {err:.4f} m from the ground truth in "
          f"{host_ms:.2f} ms host ({r.trace[-1]}); {len(rec.calls)} MLPnP RANSAC call(s) card vs cpu on the "
          f"recorded hypotheses: centre {worst[0]:.2e} m, rotation {worst[1]:.2e} rad, inliers {worst[2]}")
    phase_done("MLPnP relocalization", t0, times)
    return out


def check_undistortion(cfg, frames, times):
    """A Frontend with k1, k2, p1 and p2 on the card: its stereo and mono
    keypoints equal the undistortion, on the CPU path, of the raw keypoints
    of a Frontend without distortion (within 1e-3 px); everything else
    unchanged."""
    t0 = time.perf_counter()
    cfg_d = SlamConfig(camera=CameraConfig(**{**cfg.camera.__dict__, **DISTORTION}), orb=cfg.orb)
    fe_d, fe = Frontend(cfg_d, DEVICE), Frontend(cfg, DEVICE)
    check(fe_d.has_distortion and not fe.has_distortion, "undistortion: the frontends' distortion flags")
    c = cfg_d.camera
    u8 = [np.clip(np.rint(im), 0, 255).astype(np.uint8) for im in frames[5]]
    out = {}
    for name, got, raw in (("stereo", fe_d.process(*u8), fe.process(*u8)),
                           ("mono", fe_d.process_mono(u8[0]), fe.process_mono(u8[0]))):
        want = undistort.undistort_points(raw.uv.cpu(), c.fx, c.fy, c.cx, c.cy, c.k1, c.k2, c.p1, c.p2, c.k3)
        gap = float((got.uv.cpu() - want).abs().max())
        moved = float((got.uv - raw.uv).abs().max())
        same = all(torch.equal(getattr(got, k), getattr(raw, k)) for k in ("octave", "desc", "valid", "u_right"))
        out[name] = dict(max_gap_px=gap, max_shift_px=moved)
        check(gap < 1e-3 and same and moved > 1.0,
              f"undistortion ({name}): card vs cpu {gap} px, shift {moved} px, other fields equal {same}")
    print(f"undistortion (k1 {c.k1}, k2 {c.k2}, p1 {c.p1}, p2 {c.p2}): card vs the cpu path on the raw keypoints "
          f"{out}")
    phase_done("undistortion", t0, times)
    return out


# tests/test_mono_loop.py's scale-drift helpers (numpy over the map)


def inject_scale_drift(m, tracker, s):
    """A similarity of scale s applied to the recent submap (keyframes and
    points from the oldest local keyframe on) and the tracker's motion
    state, anchored at that keyframe's centre. Returns its id."""
    kc = min(tracker.local_keyframes)
    anchor = m.kf_center(kc)
    for k in [k for k in m.kf_valid if k >= kc]:
        T = m.kf_pose[k].astype(np.float64)
        c2 = s * ((-T[:3, :3].T @ T[:3, 3]) - anchor) + anchor
        T2 = T.copy()
        T2[:3, 3] = -T[:3, :3] @ c2
        m.kf_pose[k] = T2.astype(np.float32)
    pids = m.pt_ids()
    sel = pids[m.pt_first_kf_id[pids] >= kc]
    m.pt_pos[sel] = s * (m.pt_pos[sel] - anchor) + anchor
    m.pt_min_dist[sel] *= s
    m.pt_max_dist[sel] *= s
    lf = tracker.last_frame
    T = lf.Tcw.astype(np.float64)
    c2 = s * ((-T[:3, :3].T @ T[:3, 3]) - anchor) + anchor
    T2 = T.copy()
    T2[:3, 3] = -T[:3, :3] @ c2
    lf.Tcw = T2.astype(np.float32)
    if tracker.velocity is not None:
        V = tracker.velocity.copy()
        V[:3, 3] *= s
        tracker.velocity = V
    return kc


def map_snapshot(m):
    kf_ids = sorted(m.kf_valid)
    return kf_ids, {k: m.kf_center(k) for k in kf_ids}, {k: m.kf_timestamp[k] for k in kf_ids}


def segment_scale_ratio(snapshot, kc, poses_gt):
    """The median estimated / true inter-keyframe chord of the drifted
    segment (ids >= kc) over that of the clean one."""
    kf_ids, centers, stamps = snapshot

    def med_ratio(ids):
        r = []
        for a, b in zip(ids[:-1], ids[1:]):
            g = np.linalg.norm(center(poses_gt[int(round(stamps[b] * 20.0))]) -
                               center(poses_gt[int(round(stamps[a] * 20.0))]))
            if g > 1e-6:
                r.append(np.linalg.norm(centers[b] - centers[a]) / g)
        return float(np.median(r))

    clean, drift = [k for k in kf_ids if k < kc], [k for k in kf_ids if k >= kc]
    check(len(clean) >= 3 and len(drift) >= 3, f"mono loop: segments of {len(clean)} and {len(drift)} keyframes")
    return med_ratio(drift) / med_ratio(clean)


def run_mono_loop(times):
    """tests/test_mono_loop.py on the card: `System(VOCAB_CIRCUIT, cfg,
    sensor=Sensor.MONOCULAR)` (loop closing inline, free scale) over 1.16
    laps of the circuit, the recent submap scaled by DRIFT_SCALE after frame
    INJECT_AT. The lap is rendered once, ahead of the tracker, by
    RENDER_WORKERS processes, and returned for the threaded loop phase.
    Bars: tracking OK at the injection and at the end, >= 1 loop closed, the
    injected factor > 1.2 before closure, err_post < err_pre / 5."""
    t0 = time.perf_counter()
    world = SyntheticWorld(**CIRCUIT_WORLD)
    cfg = slam_config(world)
    lap = world.trajectory_circuit(N_CIRCUIT)
    poses_gt = lap + lap[:MONO_LOOP_EXTRA]
    system = System(VOCAB_CIRCUIT, cfg, sensor=Sensor.MONOCULAR, device=DEVICE)
    closer, tracker, m = system.loop_closer, system.tracker, system.map
    check(not closer.fix_scale and not closer.threaded_gba, "mono loop: the loop closer's wiring")
    frames, est, ms = [], [], []
    state_at_injection = None
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(RENDER_WORKERS, initializer=_render_init, initargs=(lap, CIRCUIT_WORLD, False)) as pool:
        rendered = pool.imap(_render, range(N_CIRCUIT), chunksize=1)
        reset_launch_counts()
        for i in range(len(poses_gt)):
            if i < N_CIRCUIT:
                frames.append(next(rendered))
            t1 = time.perf_counter()
            est.append(system.track_monocular(frames[i % N_CIRCUIT][0], i / 20.0))
            ms.append((time.perf_counter() - t1) * 1e3)
            if i == INJECT_AT:
                state_at_injection = tracker.state
                before = map_snapshot(m)
                kc = inject_scale_drift(m, tracker, DRIFT_SCALE)
                pre = map_snapshot(m)
        torch.cuda.synchronize()
        launches = launch_counts()
    post = map_snapshot(m)
    system.shutdown()
    r_before = segment_scale_ratio(before, kc, poses_gt)
    factor = segment_scale_ratio(pre, kc, poses_gt) / r_before
    err_pre = abs(np.log(factor))
    err_post = abs(np.log(segment_scale_ratio(post, kc, poses_gt)))
    n_tracked = sum(T is not None for T in est)
    init_frame = next((i for i, T in enumerate(est) if T is not None), None)
    lost = [i for i, T in enumerate(est) if T is None and init_frame is not None and i > init_frame]
    out = dict(frames=len(poses_gt), tracked=n_tracked, init_frame=init_frame, lost_after_init=lost,
               tracker_events=tracker.events[:8], ms_per_frame_p50=statistics.median(ms[2:]),
               ms_per_frame_max=max(ms[2:]), loops=closer.n_loops_closed, kc=kc,
               drift_factor=factor, err_pre=err_pre, err_post=err_post,
               sim3_scales=[r.get("s12") for r in closer.loops], loop_records=closer.loops,
               keyframes=m.n_keyframes(), points=len(m.pt_valid))
    print(f"mono loop: {n_tracked}/{len(poses_gt)} tracked (initialized on frame {init_frame}; lost after it: "
          f"{lost}; the tracker's first failures: {tracker.events[:8]}; ms/frame p50 {out['ms_per_frame_p50']:.2f} "
          f"max {out['ms_per_frame_max']:.2f}), {closer.n_loops_closed} loop(s) closed with free "
          f"scale, Sim3 scale(s) {out['sim3_scales']}; drift injected at frame {INJECT_AT} from keyframe {kc}: "
          f"factor {factor:.4f}, scale error {err_pre:.4f} -> {err_post:.4f}; loops {closer.loops}; launches "
          f"{launches}")
    check(state_at_injection == TrackingState.OK and tracker.state == TrackingState.OK and kc > 5,
          f"mono loop: state {state_at_injection} at the injection, {tracker.state} at the end, kc {kc}")
    check(closer.n_loops_closed >= 1, "mono loop: no loop closed")
    check(factor > 1.2, f"mono loop: injected factor {factor} not visible")
    check(err_post < err_pre / 5.0, f"mono loop: scale error {err_pre} -> {err_post}, not a 5x shrink")
    phase_done("mono loop", t0, times)
    return out, frames, lap


def run_threaded_loop(frames, lap, times):
    """tests/test_pipeline.py's threaded run on the card: `System(VOCAB_CIRCUIT,
    cfg, threaded=True)` (mapping and loop closing on worker threads, each
    global BA on its own) over one lap of the circuit, then on around it
    until the loop closes (at most THREADED_MAX_EXTRA more frames). Bars:
    <= 2 frames lost and OK at the end, >= 1 loop, >= 1 frame completed
    inside a correction window, steady max latency < max(4 x median, 2.5 s),
    ATE RMSE < 0.45 m, wait_idle and shutdown without a worker error and no
    global BA thread alive after."""
    t0 = time.perf_counter()
    cfg = slam_config(SyntheticWorld(**CIRCUIT_WORLD))
    system = System(VOCAB_CIRCUIT, cfg, threaded=True, device=DEVICE)
    closer = system.loop_closer
    check(system.loop_worker is not None and closer.threaded_gba, "threaded loop: the System's wiring")
    poses_gt, est, lat, stamps = [], [], [], []

    def feed(i):
        imL, imR = frames[i % N_CIRCUIT]
        poses_gt.append(lap[i % N_CIRCUIT])
        t1 = time.monotonic()
        est.append(system.track_stereo(imL, imR, i / 20.0))
        t2 = time.monotonic()
        lat.append(t2 - t1)
        stamps.append((t1, t2))

    for i in range(N_CIRCUIT):
        feed(i)
    i = N_CIRCUIT
    while closer.n_loops_closed == 0 and i < N_CIRCUIT + THREADED_MAX_EXTRA:
        feed(i)
        i += 1
    system.wait_idle(600.0)
    system.shutdown()
    gba_alive = any(t.name == "gba-thread" and t.is_alive() for t in threading.enumerate())
    n_lost = sum(e is None for e in est)
    overlapped = sum(t1 >= w0 and t2 <= w1 for w0, w1 in closer.correction_windows for t1, t2 in stamps)
    steady = np.sort(np.asarray(lat[20:]))[:-4]
    med, worst = float(np.median(steady)), float(steady.max())
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]))
    gba_ms = [v / 1e3 for v in system.timers.samples.get("Global BA", [])]
    out = dict(frames=len(est), lost=n_lost, loops=closer.n_loops_closed, frames_in_correction=overlapped,
               correction_windows_s=[w1 - w0 for w0, w1 in closer.correction_windows],
               latency_median_s=med, latency_max_steady_s=worst, ate_rmse_m=rmse, gba_host_ms=gba_ms,
               gba_aborted=closer.n_gba_aborted, loop_records=closer.loops)
    print(f"threaded loop: {len(est)} frames, {n_lost} lost, state {system.tracker.state.name}, "
          f"{closer.n_loops_closed} loop(s), {overlapped} frame(s) completed inside the correction window(s) "
          f"{out['correction_windows_s']} s; latency median {med:.3f} s, steady max {worst:.3f} s; ATE RMSE "
          f"{rmse:.4f} m; global BA host ms {gba_ms}, aborted {closer.n_gba_aborted}")
    check(n_lost <= 2 and system.tracker.state == TrackingState.OK,
          f"threaded loop: {n_lost} frames lost, state {system.tracker.state}")
    check(closer.n_loops_closed >= 1, "threaded loop: no loop closed")
    check(overlapped >= 1, "threaded loop: no frame completed inside a correction window")
    check(worst < max(4.0 * med, 2.5), f"threaded loop: steady max latency {worst} s, median {med} s")
    check(rmse < 0.45, f"threaded loop: ATE RMSE {rmse} >= 0.45 m")
    check(not gba_alive, "threaded loop: a global BA thread is alive after shutdown")
    phase_done("threaded loop", t0, times)
    return out


def card_mesh() -> Mesh:
    """MESH_SHARDS shards: one card each where as many cards are visible,
    else all on card 0."""
    if torch.cuda.device_count() >= MESH_SHARDS:
        return make_mesh(MESH_SHARDS)
    return Mesh([torch.device("cuda", 0)] * MESH_SHARDS)


def timed_ms(fn):
    """(fn(), host ms), the call ending synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_sharded_solves(mesh, recorded_gba, recorded_graph):
    """The loop phase's first recorded global BA and essential graph, each
    solved on `mesh` and on one device, with the bars of
    tests/test_dist_ba.py: BA poses within 5e-4 and the median point within
    1e-3 (both with the sharded solver's schedule, 5 + 10 iterations and 20
    PCG steps), the graph's R and t within 1e-3 and its cost within 1e-3
    relative; the host ms of each solve. Returns the results and the
    sharded BA's result (the two-process check's reference)."""
    args, _, _ = recorded_gba
    prob, cam = args[0], args[1]
    single, single_ms = timed_ms(lambda: ba.ba_solve_pm(prob, cam, n_iters_first=5, n_iters_second=10, n_cg=20))
    solve = dist_ba.make_distributed_ba_pm(mesh, cam)
    sharded, sharded_ms = timed_ms(lambda: solve(prob))
    pose_gap = float((sharded.poses - single.poses).abs().max())
    pt_median = float(torch.linalg.norm(sharded.points - single.points, dim=1).median())
    chi2 = (float(single.final_chi2), float(sharded.final_chi2))
    gargs, gkwargs, _ = recorded_graph
    fix_scale = gkwargs.get("fix_scale", True)
    (V1, F1), pg_single_ms = timed_ms(lambda: posegraph.optimize_essential_graph(*gargs, **gkwargs))
    pg = dist_posegraph.make_distributed_posegraph(mesh, fix_scale=fix_scale)
    (V2, F2), pg_sharded_ms = timed_ms(lambda: pg(gargs[0]))
    pg_R, pg_t = float((V1.R - V2.R).abs().max()), float((V1.t - V2.t).abs().max())
    pg_cost = abs(float(F1) - float(F2)) / max(1.0, abs(float(F1)))
    out = dict(mesh=repr(mesh), ba=dict(keyframes=prob.poses.shape[0], points=prob.points.shape[0],
                                        edges=int(prob.edge_valid.sum()), pose_gap=pose_gap,
                                        point_gap_median=pt_median, chi2_single_sharded=chi2,
                                        host_ms_single=single_ms, host_ms_sharded=sharded_ms),
               essential_graph=dict(vertices=gargs[0].vertices.s.shape[0], edges=gargs[0].edge_i.shape[0],
                                    fix_scale=fix_scale, R_gap=pg_R, t_gap=pg_t, cost_gap_rel=pg_cost,
                                    host_ms_single=pg_single_ms, host_ms_sharded=pg_sharded_ms))
    print(f"mesh: the loop phase's recorded global BA and essential graph on {mesh} against one device: {out}")
    check(pose_gap < 5e-4 and pt_median < 1e-3, f"sharded global BA: poses {pose_gap}, median point {pt_median}")
    check(pg_R < 1e-3 and pg_t < 1e-3 and pg_cost < 1e-3, f"sharded essential graph: R {pg_R}, t {pg_t}, "
          f"cost {pg_cost}")
    return out, sharded


def _mesh_rank(rank, port, path, out):
    """One rank of the two-process check, in a spawned process: join the
    process group (`multihost.initialize`), solve the saved BA problem on
    `multihost.global_mesh()`, save what this rank got and its seconds from
    here to the result."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = multihost.initialize(f"localhost:{port}", MESH_SHARDS, rank)
    mesh = multihost.global_mesh()
    saved = torch.load(path)
    prob = ba.BAProblemPM(**{k: v.to(device) for k, v in saved["prob"].items()})
    cam = Camera(*saved["cam"])
    res = dist_ba.make_distributed_ba_pm(mesh, cam)(multihost.put_global(prob, dist_ba.PM_SPECS, mesh))
    torch.save({k: v.cpu() for k, v in res._asdict().items()}
               | {"backend": torch.distributed.get_backend(), "mesh": repr(mesh),
                  "seconds": time.perf_counter() - t0}, f"{out}{rank}.pt")
    torch.distributed.destroy_process_group()


def start_ranks(recorded_gba, tmp):
    """MESH_SHARDS spawned processes, one rank each of a process group (NCCL
    on a card each, gloo when they share card 0), that solve the recorded
    global BA: (processes, result prefix). Daemons: stopped with this
    process if it fails before `join_ranks`."""
    import socket

    args, _, _ = recorded_gba
    prob, cam = args[0], args[1]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    path, out = os.path.join(tmp, "prob.pt"), os.path.join(tmp, "rank")
    torch.save({"prob": {k: v.cpu() for k, v in prob._asdict().items()}, "cam": tuple(cam)}, path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, port, path, out), daemon=True) for r in range(MESH_SHARDS)]
    for p in procs:
        p.start()
    return procs, out


def join_ranks(ranks, in_process):
    """Waits for the ranks (stopping any left): every rank's result equals
    the in-process mesh's bit for bit."""
    procs, out = ranks
    try:
        for p in procs:
            p.join(300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs), f"two processes: exit codes {[p.exitcode for p in procs]}")
    got = [torch.load(f"{out}{r}.pt") for r in range(MESH_SHARDS)]
    equal = [all(torch.equal(g[k], v.cpu()) for k, v in in_process._asdict().items()) for g in got]
    res = dict(ranks=MESH_SHARDS, backend=got[0]["backend"], mesh=got[0]["mesh"], equal_to_in_process=equal,
               rank_seconds=[g["seconds"] for g in got])
    print(f"mesh: the recorded global BA over a {MESH_SHARDS}-process group: {res}")
    check(all(equal), f"two processes: results differ from the in-process mesh ({equal})")
    return res


def run_mesh_system(mesh, frames, lap):
    """`System(VOCAB_CIRCUIT, cfg, mesh=mesh)`, stereo, loop closing inline,
    over the circuit until its first loop (at most MESH_MAX_EXTRA frames
    past the lap, tests/test_mesh_loop.py's margin), launch
    counts set to 0 just before and read just after. Bars: >= 1 loop,
    both sharded solvers built and run on every shard, ATE RMSE < 0.45 m
    (that test's bar), K1-K4 launched."""
    cfg = slam_config(SyntheticWorld(**CIRCUIT_WORLD))
    system = System(VOCAB_CIRCUIT, cfg, mesh=mesh, device=DEVICE)
    closer = system.loop_closer
    check(closer.mesh is mesh and not closer.threaded_gba, "mesh System: the loop closer's wiring")
    sharded = lambda a, kw: kw.get("reducer") is not None  # noqa: E731
    est, poses_gt, ms = [], [], []
    t_run = time.perf_counter()
    with _Recorder(posegraph, "optimize_essential_graph", keep=64, when=sharded) as pg_shards, \
            _Recorder(ba, "ba_solve_pm", keep=64, when=sharded) as ba_shards:
        reset_launch_counts()
        i = 0
        while closer.n_loops_closed == 0 and i < N_CIRCUIT + MESH_MAX_EXTRA:
            imL, imR = frames[i % N_CIRCUIT]
            poses_gt.append(lap[i % N_CIRCUIT])
            t0 = time.perf_counter()
            est.append(system.track_stereo(imL, imR, i / 20.0))
            ms.append((time.perf_counter() - t0) * 1e3)
            i += 1
        torch.cuda.synchronize()
        launches = launch_counts()
    wall_s = time.perf_counter() - t_run
    print(system.shutdown())
    # where the frames' time went: each stage's seconds over the run
    stage_s = {name: sum(v) / 1e6 for name, v in system.timers.samples.items()}
    n_lost = sum(T is None for T in est)
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]))
    stages = {name: [v / 1e3 for v in system.timers.samples.get(name, [])] for name in ("Essential graph",
                                                                                        "Global BA")}
    out = dict(frames=len(est), lost=n_lost, loops=closer.n_loops_closed, ate_rmse_m=rmse,
               sharded_graph_shard_solves=len(pg_shards.calls), sharded_gba_shard_solves=len(ba_shards.calls),
               stage_host_ms=stages, ms_per_frame_p50=statistics.median(ms[2:]), loop_records=closer.loops,
               launches=launches, wall_s=wall_s, stage_seconds=stage_s)
    print(f"mesh System: {len(est)} frames, {n_lost} lost, {closer.n_loops_closed} loop(s), ATE RMSE {rmse:.4f} m; "
          f"shard solves: essential graph {len(pg_shards.calls)}, global BA {len(ba_shards.calls)}; host ms "
          f"{stages}; ms/frame p50 {out['ms_per_frame_p50']:.2f}; loops {closer.loops}; launches {launches}; "
          f"seconds by stage over its {wall_s:.2f} s: {stage_s}")
    check(closer.n_loops_closed >= 1, "mesh System: no loop closed")
    check(closer._dist_pg is not None and closer._dist_gba is not None
          and len(pg_shards.calls) >= MESH_SHARDS and len(ba_shards.calls) >= MESH_SHARDS,
          "mesh System: the sharded solvers were not built and run on every shard")
    check(rmse < 0.45, f"mesh System: ATE RMSE {rmse} >= 0.45 m")
    for name in ("fast_nms", "orb_patch_desc", "hamming_best2:stereo", "hamming_best2:frame",
                 "hamming_best2:points", "hamming_best2:nodes:loop", "bow_transform"):
        check(launches[name] > 0, f"mesh System: {name} never launched")
    return out


def run_mesh(frames, lap, recorded_gba, recorded_graph, ranks, times):
    """The mesh phase: the recorded whole-map solves sharded against one
    device, the process group's solve of the same BA (started earlier by
    `start_ranks`) held against it, then a System on the mesh."""
    t0 = time.perf_counter()
    mesh = card_mesh()
    solves, sharded = check_sharded_solves(mesh, recorded_gba, recorded_graph)
    solves["two_processes"] = join_ranks(ranks, sharded)
    solves["system"] = run_mesh_system(mesh, frames, lap)
    phase_done("mesh", t0, times)
    return solves


# the checkpoint, the disk drivers, the rectifier and the viewer: N_KITTI
# of the slice's frames in the KITTI layout, N_VIEWER under the viewer
N_KITTI = 10
N_VIEWER = 10
EUROC_T0_NS = 1403636579763555584  # EuRoC-style epoch-ns stamps
EUROC_FILES = ("CameraTrajectory.txt", "OfflineCameraTrajectory.txt", "KeyFrameTrajectory.txt")


def run_checkpoint(system, frame39, tmp) -> dict:
    """(a) `save_map`, then `load_map` into a fresh System on the card: the
    keyframe and point sets, poses, positions, observations and
    covisibility weights equal, each reloaded keyframe's device features
    `torch.equal` to the original's, and one K3 `mask` call through
    `search_by_bow` between frame 39 and a reloaded keyframe equal to the
    call on the original keyframe; no observation by a culled keyframe in
    the original. The original's covisibility weights are
    first refreshed from its observations under the map lock, as the
    loader derives them (the live map's weights date from each keyframe's
    last refresh); the slice's System is not used after this phase."""
    from orbslam2_tpu_torch.ops import matchers

    m = system.map
    with m.lock:
        for k in sorted(m.kf_valid):
            m.update_connections(k)
    path = os.path.join(tmp, "map.npz")
    t0 = time.perf_counter()
    system.save_map(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = System(None, system.config, device=DEVICE)
    t0 = time.perf_counter()
    fresh.load_map(path)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    m2 = fresh.map
    check(m2.kf_valid == m.kf_valid and m2.pt_valid == m.pt_valid, "checkpoint: keyframe or point sets differ")
    for k in m.kf_valid:
        check(np.array_equal(m2.kf_pose[k], m.kf_pose[k]), f"checkpoint: keyframe {k}'s pose differs")
        check(m2.covis[k] == m.covis[k], f"checkpoint: keyframe {k}'s covisibility {m2.covis[k]} != {m.covis[k]}")
        check(all(torch.equal(a, b) and a.device == b.device for a, b in
                  zip(m2.kf_frame[k].dev, m.kf_frame[k].dev)), f"checkpoint: keyframe {k}'s device features")
    pts = m.pt_ids()
    check(np.array_equal(m2.pt_pos[pts], m.pt_pos[pts]), "checkpoint: point positions differ")
    # a culled keyframe leaves no observation behind (SlamMap.remove_keyframe)
    stale = sum(k not in m.kf_valid for p in pts for k in m.pt_obs[int(p)])
    check(stale == 0, f"checkpoint: {stale} observations by culled keyframes")
    check(all(m2.pt_obs[int(p)] == m.pt_obs[int(p)] for p in pts), "checkpoint: observations differ")
    k = max(m.kf_valid)
    f = frame39.dev
    calls = [matchers.search_by_bow(mm.kf_frame[k].dev.desc, mm.kf_frame[k].dev.valid, mm.kf_frame[k].dev.angle,
                                    f.desc, f.valid, f.angle, 0.7) for mm in (m, m2)]
    check(all(torch.equal(a, b) for a, b in zip(*calls)), "checkpoint: search_by_bow on the reloaded keyframe")
    out = dict(keyframes=m.n_keyframes(), points=len(pts), save_ms=save_ms, load_ms=load_ms,
               bytes=os.path.getsize(path), bow_matches=int(calls[0][2].sum()), stale_observations=stale)
    print(f"checkpoint: {out['keyframes']} keyframes, {out['points']} points ({stale} observations by culled "
          f"keyframes), save {save_ms:.1f} ms, load {load_ms:.1f} ms, {out['bytes']} bytes; keyframe {k} "
          f"vs frame 39 by search_by_bow: {out['bow_matches']} matches on both")
    return out


def _driver(main_fn, argv):
    """Run a driver's main(argv), print its output, return (rc, output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    print(buf.getvalue(), end="")
    return rc, buf.getvalue()


def _medians(text):
    """(median tracking ms, median image load ms) from a driver's output."""
    track = re.search(r"mean tracking time: [\d.]+ms  median: ([\d.]+)ms", text)
    load = re.search(r"mean image load time: [\d.]+ms  median: ([\d.]+)ms", text)
    return float(track.group(1)), float(load.group(1))


def run_disk(cfg, frames, poses_gt, tmp) -> dict:
    """(b) The slice's frames as uint8 PNGs in the EuRoC layout, with a
    settings YAML whose LEFT and RIGHT blocks are the identity, through
    `drivers.run_euroc.main` on the card: >= 39/40 tracked, ATE < 0.06 m,
    timestamps within 5e-4 s, the three TUM files written, K1 and K2 one
    launch per frame and K3's stereo, frame, points and mask modes and K4
    launched (counts set to 0 just before the run, read just after), every
    decoded and rectified frame equal to the frame written. Then N_KITTI
    frames in the KITTI layout through `drivers.run_kitti.main`: a
    12-column trajectory line per frame."""
    from orbslam2_tpu_torch.config import RectifyConfig, load_config
    from orbslam2_tpu_torch.datasets import euroc, kitti
    from orbslam2_tpu_torch.drivers import run_euroc, run_kitti

    u8 = [tuple(np.clip(np.rint(im), 0, 255).astype(np.uint8) for im in pair) for pair in frames]
    stamps = [EUROC_T0_NS + int(round(i * 0.05e9)) for i in range(len(u8))]
    root = os.path.join(tmp, "euroc")
    t0 = time.perf_counter()
    left, right, times_file = euroc.write_sequence(root, u8, stamps)
    write_ms = (time.perf_counter() - t0) * 1e3 / len(u8)
    c = cfg.camera
    K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1.0]])
    eye = RectifyConfig(K=K, D=np.zeros((1, 5)), R=np.eye(3), P=np.concatenate([K, np.zeros((3, 1))], 1),
                        width=c.width, height=c.height)
    settings = os.path.join(tmp, "euroc.yaml")
    euroc.write_settings(settings, SlamConfig(camera=cfg.camera, orb=cfg.orb, rectify_left=eye, rectify_right=eye))
    seq = euroc.EurocSequence(left, right, times_file, load_config(settings), DEVICE)
    for i in range(len(seq)):
        imL, imR, _ = seq[i]
        check(all(torch.equal(a.cpu(), torch.from_numpy(b).float()) for a, b in zip((imL, imR), u8[i])),
              f"disk: frame {i} decoded and rectified differs from the frame written")
    reset_launch_counts()
    cpu = ["--cpu"] if DEVICE == "cpu" else []
    rc, text = _driver(run_euroc.main, ["run_euroc", VOCAB, settings, left, right, times_file, root + "/", *cpu])
    launches = launch_counts()
    check(rc == 0, f"run_euroc returned {rc}")
    for name in EUROC_FILES:
        check(os.path.getsize(os.path.join(root, name)) > 0, f"run_euroc wrote no {name}")
    traj = np.loadtxt(os.path.join(root, "CameraTrajectory.txt"), ndmin=2)
    secs = np.asarray(stamps, np.float64) / 1e9
    idx = np.abs(traj[:, :1] - secs[None]).argmin(axis=1)
    dt = float(np.abs(traj[:, 0] - secs[idx]).max())
    rmse = ate_rmse(traj[:, 1:4], np.stack([center(poses_gt[i]) for i in idx]))
    track_ms, load_ms = _medians(text)
    n = len(u8)
    out = dict(tracked=len(traj), ate_rmse_m=rmse, max_stamp_err_s=dt, ms_per_frame_p50=track_ms,
               load_ms_per_pair_p50=load_ms, png_write_ms=write_ms,
               launches={k: v for k, v in launches.items() if v})
    print(f"disk (EuRoC layout): {len(traj)}/{n} tracked, ATE RMSE {rmse:.4f} m, stamps within {dt:.2e} s, "
          f"p50 {track_ms:.1f} ms tracking + {load_ms:.1f} ms PNG decode and rectification per pair; "
          f"launches {out['launches']}")
    check(len(traj) >= n - 1, f"disk: only {len(traj)}/{n} frames tracked")
    check(rmse < 0.06, f"disk: ATE RMSE {rmse} >= 0.06 m")
    check(dt <= 5e-4, f"disk: timestamps off by {dt} s")
    for name in ("fast_nms", "orb_patch_desc"):
        check(launches[name] == n, f"disk: {name} {launches[name]} launches over {n} frames")
    for name in ("hamming_best2:stereo", "hamming_best2:frame", "hamming_best2:points", "hamming_best2:mask",
                 "bow_transform"):
        check(launches[name] > 0, f"disk: kernel {name} was not launched")
    kroot = os.path.join(tmp, "kitti")
    kitti.write_sequence(kroot, u8[:N_KITTI], [i * 0.05 for i in range(N_KITTI)])
    ksettings = os.path.join(tmp, "kitti.yaml")
    euroc.write_settings(ksettings, SlamConfig(camera=cfg.camera, orb=cfg.orb))
    reset_launch_counts()
    rc, text = _driver(run_kitti.main, ["run_kitti", VOCAB, ksettings, kroot, kroot + "/", *cpu])
    launches = launch_counts()
    rows = np.loadtxt(os.path.join(kroot, "CameraTrajectory.txt"), ndmin=2)
    check(rc == 0 and rows.shape == (N_KITTI, 12), f"run_kitti: rc {rc}, trajectory {rows.shape}")
    check(launches["fast_nms"] == N_KITTI and launches["orb_patch_desc"] == N_KITTI,
          f"run_kitti: K1/K2 launches {launches}")
    out["kitti_ms_per_frame_p50"], out["kitti_load_ms_per_pair_p50"] = _medians(text)
    print(f"disk (KITTI layout): {N_KITTI} frames, 12-column trajectory, p50 {out['kitti_ms_per_frame_p50']:.1f} "
          f"ms tracking + {out['kitti_load_ms_per_pair_p50']:.1f} ms PNG decode per pair")
    return out


def rectify_blocks() -> SlamConfig:
    """Real rectification blocks: LEFT K is EuRoC cam0's (the config's
    defaults), D its k1, k2, p1, p2 with k3 = 0, R a rotation of 0.5
    degrees, P of f 435.2 and c (367.45, 252.2); RIGHT the same with P's
    Tx = -47.9."""
    from orbslam2_tpu_torch.config import RectifyConfig

    c = CameraConfig()
    K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1.0]])
    D = np.array([[DISTORTION["k1"], DISTORTION["k2"], DISTORTION["p1"], DISTORTION["p2"], 0.0]])
    axis = np.array([0.3, 0.8, 0.2]) / np.linalg.norm([0.3, 0.8, 0.2])
    A = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = np.deg2rad(0.5)
    R = np.eye(3) + np.sin(a) * A + (1 - np.cos(a)) * A @ A
    P = np.array([[435.2, 0, 367.45, 0], [0, 435.2, 252.2, 0], [0, 0, 1, 0]])
    PR = P.copy()
    PR[0, 3] = -47.9
    blocks = [RectifyConfig(K=K, D=D, R=R, P=p, width=c.width, height=c.height) for p in (P, PR)]
    return SlamConfig(rectify_left=blocks[0], rectify_right=blocks[1])


def check_rectifier(frames) -> dict:
    """(c) The rectifier on the card against the CPU on real blocks: maps
    within 1e-4 px, images within 1 gray level; times one pair."""
    from orbslam2_tpu_torch.datasets.euroc import Rectifier

    rcfg = rectify_blocks()
    card, cpu = Rectifier(rcfg, DEVICE), Rectifier(rcfg, "cpu")
    map_err = float((card.maps.cpu() - cpu.maps).abs().max())
    pair = [np.clip(np.rint(im), 0, 255).astype(np.uint8) for im in frames[2]]
    got, want = card(*pair), cpu(*pair)
    img_err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    on_card = [torch.from_numpy(im).to(DEVICE) for im in pair]
    ms = cuda_ms(lambda: card(*on_card))
    print(f"rectifier card vs cpu: maps within {map_err:.2e} px, images within {img_err:.0f} gray levels; "
          f"{ms:.4f} ms per pair on the card (uint8 on the card in, float32 out)")
    check(map_err <= 1e-4, f"rectifier maps differ by {map_err} px")
    check(img_err <= 1, f"rectified images differ by {img_err} gray levels")
    return dict(map_err_px=map_err, img_err=img_err, ms_per_pair=ms)


def _wait(cond, what, timeout=60.0):
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < timeout, f"viewer: {what} within {timeout} s")
        time.sleep(0.05)


def run_viewer(cfg, frames, tmp) -> dict:
    """(d) `System(None, cfg, use_viewer=True)` over N_VIEWER frames: >= 2
    live renders and no live error, `draw_frame` marks > 50 features
    green, a saved map PNG decoded by `png.py` equals `render_array`,
    live_map.png written, the localization toggle and the reset applied by
    the live loop; (e) `shutdown(measure_frontend_split=True)` reports
    "ORB extraction" and "Stereo matching"."""
    from orbslam2_tpu_torch.datasets import png

    system = System(None, cfg, use_viewer=True, device=DEVICE)
    v = system.viewer
    v.out_dir = os.path.join(tmp, "viewer")
    for i, (imL, imR) in enumerate(frames[:N_VIEWER]):
        system.track_stereo(imL, imR, timestamp=i / 20.0)
    _wait(lambda: v.n_live_renders >= 2 or v.live_error is not None, "2 live renders")
    check(v.live_error is None, f"viewer: live error {v.live_error!r}")
    img = v.draw_frame()
    green = int((img == np.array([0, 255, 0], np.uint8)).all(-1).sum())
    path = os.path.join(tmp, "map.png")
    v.save(path)
    same = np.array_equal(png.read(path), v.render_array())
    live_map = os.path.exists(os.path.join(v.out_dir, "live_map.png"))
    v.set_localization_mode(True)
    _wait(lambda: system.tracker.only_tracking, "localization mode on")
    check(system.local_mapper.is_stopped(), "viewer: localization mode left the mapper running")
    v.set_localization_mode(False)
    _wait(lambda: not system.tracker.only_tracking, "localization mode off")
    v.request_reset()
    _wait(lambda: system.map.n_keyframes() == 0, "the reset")
    report = system.shutdown(measure_frontend_split=True)
    check(v._live_thread is None, "viewer: the live thread outlived shutdown")
    split = {name: system.timers.mean_stddev(name)[0] / 1e3 for name in ("ORB extraction", "Stereo matching")}
    out = dict(live_renders=v.n_live_renders, green=green, png_equals_render=same, live_map_png=live_map,
               orb_extraction_ms=split["ORB extraction"], stereo_matching_ms=split["Stereo matching"])
    print(f"viewer: {v.n_live_renders} live renders, {green} green feature pixels, saved map PNG equals "
          f"render_array: {same}, live_map.png: {live_map}, localization toggle and reset applied by the live "
          f"loop; stage split over 20 reps: ORB extraction {split['ORB extraction']:.3f} ms, Stereo matching "
          f"{split['Stereo matching']:.3f} ms")
    check(green > 50, f"viewer: {green} green feature pixels")
    check(same, "viewer: the saved map PNG differs from render_array")
    check(live_map, "viewer: no live_map.png")
    check("ORB extraction" in report and "Stereo matching" in report, "shutdown report lacks the stage split")
    return out


@contextlib.contextmanager
def sync_errors():
    """`torch.cuda.set_sync_debug_mode("error")` inside: a CUDA call that
    makes the host wait for the device raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def guard_dispatch(stack, tracker, dispatched: list):
    """Inside `stack`: the pipelined dispatch of `tracker` (`_assemble_fused`
    two frames ahead, `_full_step` with no_wait, the `_HostCopy` behind it)
    under `sync_errors`, and each dispatched frame's id appended to
    `dispatched`."""

    def guarded(when):
        def wrap(fn):
            def run(*a, **k):
                if not when(k):
                    return fn(*a, **k)
                with sync_errors():
                    return fn(*a, **k)
            return run
        return wrap

    def recording(fn):
        def run(images_u8, timestamp):
            dispatched.append(tracker.frame_id)
            return fn(images_u8, timestamp)
        return run

    stack.enter_context(patched(tracker, "_assemble_fused", guarded(lambda k: "pred_steps" in k)))
    stack.enter_context(patched(tracker, "_full_step", guarded(lambda k: k.get("no_wait", False))))
    stack.enter_context(patched(tracking, "_HostCopy", guarded(lambda k: True)))
    stack.enter_context(patched(tracker, "_track_pipelined", recording))


def device_busy(prof):
    """(device ms, device events) of a profile, from its raw events:
    building `prof.events()` over tens of thousands of kernels takes tens of
    seconds."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    return sum(e.duration_ns() for e in evs) / 1e6, len(evs)


def run_pipelined(cfg, frames, poses_gt):
    """The pipelined phase: the slice's frames on `System(VOCAB, cfg,
    enable_loop_closing=False)`, synchronous, then with pipelined tracking
    on, each with its launch counts set to 0 just before its first frame and
    read after its shutdown; frames 2..N-N_PIPE_PROFILED-1 timed on the host
    clock, the last N_PIPE_PROFILED under `torch.profiler` (the device's
    busy share of the wall time). The pipelined dispatch runs under
    `set_sync_debug_mode("error")`; a third run, pipelined without that
    guard, shows the guard's own cost. Run in a spawned process: profiler
    sessions in the main process before the kernels' device timings made
    those lose launches. Bars: synchronous, the slice's (>= N-1 solved, ATE
    < 0.06 m); pipelined, N trajectory entries, >= N-2 solved,
    ATE < PIPE_ATE_BAR over the solved entries, nothing pending after
    shutdown; K1, K2, K3 `stereo` once and K6 twice a frame, K5 twice and K3
    `frame` twice (both motion windows) on every dispatched frame. Returns
    (results, the pipelined run's launch counts)."""
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, n_timed = {}, N_FRAMES - N_PIPE_PROFILED
    for mode in ("synchronous", "pipelined", "pipelined, dispatch not guarded"):
        system = System(VOCAB, dataclasses.replace(cfg, pipelined_tracking=mode != "synchronous"),
                        enable_loop_closing=False)
        tracker, dispatched, ms = system.tracker, [], []
        with contextlib.ExitStack() as stack:
            if mode == "pipelined":
                guard_dispatch(stack, tracker, dispatched)
            reset_launch_counts()
            for i in range(n_timed):
                t0 = time.perf_counter()
                system.track_stereo(*frames[i], timestamp=i / 20.0)
                ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(n_timed, N_FRAMES):
                    system.track_stereo(*frames[i], timestamp=i / 20.0)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            system.shutdown()
            torch.cuda.synchronize()
            launches = launch_counts()
        busy_ms, n_device = device_busy(prof)
        spans = {k: statistics.mean(v) / 1e3 for k, v in system.timers.samples.items()
                 if k.startswith("Fused") or k == "Total tracking"}
        traj = tracker.trajectory
        solved = [(g, e.Tcw) for g, e in zip(poses_gt, traj) if e.Tcw is not None and not e.lost]
        rmse = ate_rmse(np.stack([center(e) for _, e in solved]), np.stack([center(g) for g, _ in solved]))
        out[mode] = dict(
            entries=len(traj), solved=len(solved), ate_rmse_m=rmse, dispatched=len(dispatched),
            pending_after_shutdown=len(tracker._pending), ms_per_frame_p50=statistics.median(ms[2:]),
            ms_per_frame_max=max(ms[2:]), profiled_ms_per_frame=wall_ms / N_PIPE_PROFILED,
            device_busy_share=busy_ms / wall_ms, device_events_per_frame=n_device / N_PIPE_PROFILED,
            mean_span_ms=spans,
            launches_per_frame={k: v / N_FRAMES for k, v in launches.items() if v})
        print(f"pipelined phase, {mode}: {out[mode]}")
    s, p = out["synchronous"], out["pipelined"]
    check(s["solved"] >= N_FRAMES - 1 and s["ate_rmse_m"] < 0.06, f"synchronous slice: {s}")
    check(p["entries"] == N_FRAMES and p["solved"] >= N_FRAMES - 2 and p["ate_rmse_m"] < PIPE_ATE_BAR
          and p["pending_after_shutdown"] == 0 and p["dispatched"] > 0, f"pipelined slice: {p}")
    for name in ("fast_nms", "orb_patch_desc", "hamming_best2:stereo"):
        check(launches[name] == N_FRAMES, f"pipelined: {name} {launches[name]} launches over {N_FRAMES} frames")
    check(launches["select_keypoints"] == 2 * N_FRAMES, f"pipelined: K6 {launches['select_keypoints']} launches")
    for name in ("pose_lm", "hamming_best2:frame"):
        check(launches[name] >= 2 * p["dispatched"],
              f"pipelined: {name} {launches[name]} launches for {p['dispatched']} dispatched frames")
    print(f"pipelined slice: {p['solved']}/{N_FRAMES} solved, ATE {p['ate_rmse_m']:.4f} m, {p['dispatched']} frames "
          f"dispatched with no host sync, p50 {p['ms_per_frame_p50']:.2f} ms (synchronous {s['ms_per_frame_p50']:.2f}), "
          f"max {p['ms_per_frame_max']:.2f} ({s['ms_per_frame_max']:.2f}), device busy "
          f"{p['device_busy_share']:.1%} ({s['device_busy_share']:.1%})")
    return out, launches


def cold_start(cfg, frames, warm: bool) -> dict:
    """In a process of its own (spawned, so CUDA starts cold): `System(VOCAB,
    cfg)` with loop closing on, warmed by `precompile` first when `warm`;
    the slice's frames tracked, N_BLACK black frames (LOST, no reset), frame
    KIDNAPPED's view relocalized, then one Sim3 detection (`LoopCloser.
    _compute_sim3`) between the newest and the oldest keyframe. Host ms
    (each ending synchronised) of frame 0, frame 1, the relocalizing attempt
    and the Sim3 detection."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    system = System(VOCAB, cfg)
    out = dict(warm=warm, construct_s=time.perf_counter() - t0)
    if warm:
        out["precompile_s"] = system.precompile()
    ms = []
    for i in range(len(frames)):
        t0 = time.perf_counter()
        system.track_stereo(*frames[i], timestamp=i / 20.0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    black = np.zeros_like(frames[0][0])
    n_kf = system.map.n_keyframes()
    for j in range(N_BLACK):
        system.track_stereo(black, black, timestamp=100.0 + j / 20.0)
    reset = system.map.n_keyframes() != n_kf
    reloc, attempts = system.relocalizer, []
    relocalize = reloc.relocalize

    def timed(frame):
        t0 = time.perf_counter()
        ok = relocalize(frame)
        torch.cuda.synchronize()
        attempts.append(((time.perf_counter() - t0) * 1e3, frame))
        return ok

    reloc.relocalize = timed
    T = system.track_stereo(*frames[KIDNAPPED], timestamp=101.0)
    if attempts:  # the same attempt again, warm
        timed(attempts[0][1])
    del reloc.relocalize
    lc, kfs = system.loop_closer, sorted(system.map.kf_valid)
    sim3 = []
    for _ in range(2):  # the first Sim3 detection, then the same again, warm
        lc._candidates = [kfs[0]]
        t0 = time.perf_counter()
        found = lc._compute_sim3(kfs[-1])
        torch.cuda.synchronize()
        sim3.append((time.perf_counter() - t0) * 1e3)
    system.shutdown()
    out.update(frame0_ms=ms[0], frame1_ms=ms[1], steady_p50_ms=statistics.median(ms[2:]),
               relocalized=T is not None and not reset,
               first_relocalization_ms=attempts[0][0] if attempts else None,
               repeated_relocalization_ms=attempts[1][0] if attempts else None, sim3_detection_ms=sim3[0],
               repeated_sim3_detection_ms=sim3[1], sim3_found=bool(found), keyframes=len(kfs))
    return out


def run_precompile(cfg, frames) -> dict:
    """The precompile phase: `cold_start` in a fresh process without, then
    with, `System.precompile`; the kidnapped view relocalizes and a Sim3 is
    computed in both (a Sim3 that fails a gate is reported, not checked)."""
    out = {}
    for warm in (False, True):
        with multiprocessing.get_context("spawn").Pool(1) as pool:
            key = "with_precompile" if warm else "without"
            out[key] = pool.apply(cold_start, (cfg, frames, warm))
        print(f"cold start {key}: {out[key]}")
        check(out[key]["relocalized"] and out[key]["first_relocalization_ms"] is not None,
              f"cold start {key}: the kidnapped view did not relocalize ({out[key]})")
        check_later(out[key]["sim3_found"], f"cold start {key}: no Sim3 between the first and last keyframe")
    return out


def pm_to_coo(prob: ba.BAProblemPM) -> ba.BAProblem:
    """The COO problem of a point-major one: one edge per valid slot, in row
    order."""
    p, d = torch.nonzero(prob.edge_valid, as_tuple=True)
    return ba.BAProblem(poses=prob.poses, points=prob.points, obs_kf=prob.obs_kf[p, d], obs_pt=p,
                        obs=prob.obs[p, d], inv_sigma2=prob.inv_sigma2[p, d], is_stereo=prob.is_stereo[p, d],
                        edge_valid=torch.ones_like(p, dtype=torch.bool), pose_fixed=prob.pose_fixed)


def run_coo_ba(local_ba) -> dict:
    """The COO phase: the slice's recorded first local BA as a COO problem,
    solved by `ba.ba_solve` twice (bit-identical), by the point-major
    `ba_solve_pm` on the recorded problem, and on a mesh of 2 shards of the
    card (`dist_ba.make_distributed_ba`) against one device, with
    tests/test_dist_ba.py's bars (poses within 5e-4, median point within
    1e-3, chi2 within 1e-3 relative). Host ms of each (the second of two
    calls, ending synchronised)."""
    (pm, cam, *_), _, _ = local_ba
    coo = pm_to_coo(pm)
    dev = pm.poses.device
    mesh = Mesh([dev] * 2)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    r1, coo_ms = timed(lambda: ba.ba_solve(coo, cam))
    r2 = ba.ba_solve(coo, cam)
    rpm, pm_ms = timed(lambda: ba.ba_solve_pm(pm, cam))
    sharded, sharded_ms = timed(lambda: dist_ba.make_distributed_ba(mesh, cam)(coo))
    torch.cuda.synchronize()
    replays = all(torch.equal(a, b) for a, b in zip(r1, r2))
    pose_gap = float((sharded.poses - r1.poses).abs().max())
    point_gap = float((sharded.points - r1.points).norm(dim=1).median())
    chi2_gap = abs(float(sharded.final_chi2) - float(r1.final_chi2)) / max(float(r1.final_chi2), 1e-12)
    out = dict(keyframes=pm.poses.shape[0], points=pm.points.shape[0], edges=coo.obs.shape[0],
               replays_equal=replays, coo_host_ms=coo_ms, pm_host_ms=pm_ms, sharded_host_ms=sharded_ms,
               shards_pose_gap=pose_gap, shards_median_point_gap_m=point_gap, shards_chi2_gap_rel=chi2_gap,
               coo_vs_pm_pose_gap=float((r1.poses - rpm.poses).abs().max()),
               coo_chi2=float(r1.final_chi2), pm_chi2=float(rpm.final_chi2))
    print(f"COO bundle adjustment on the recorded local BA: {out}")
    check(replays, "COO BA: two replays differ")
    check(pose_gap < 5e-4 and point_gap < 1e-3 and chi2_gap < 1e-3, f"COO BA on 2 shards: {out}")
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

    times = {}
    t_main = time.perf_counter()
    build.load()
    print(f"kernel build: {build.build_seconds:.2f} s ({build.library_path()})")
    for line in build.ptxas_report:
        print(f"ptxas: {line}")

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
    check_k5_edge_cases()
    check_k6_edge_cases()
    # cold starts, each in a fresh process, without and with System.precompile
    t0 = time.perf_counter()
    cold = run_precompile(cfg, frames)
    phase_done("cold starts and precompile (2 processes)", t0, times)

    reset_launch_counts()
    system, est, ms, per_frame, fused, calls, ba_devices, local_ba, recorded = run_slice(
        world, cfg, frames, "cuda", record=REC_FRAMES)
    torch.cuda.synchronize()
    launches = launch_counts()
    frame39 = system.tracker.last_frame
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
    results["pose_lm"] = check_k5_main_path(recorded["pose_lm"])
    results["select_keypoints"] = check_k6_main_path(recorded["select_keypoints"])
    del recorded

    # relocalization and localization mode on the same system, each path
    # with its own counts
    reloc, reloc_calls, ransac, reloc_frame, reloc_k4 = run_relocalization(system, frames, poses_gt)
    check_k4_call(system.vocabulary, *reloc_k4, "the relocalizer's call")
    results.update(check_k3_main_path({"kidnapped": [c for c in reloc_calls if c[0] == "mask:relocalization"]},
                                      rows=("mask:relocalization",), path="relocalization"))
    reloc["ransac"] = check_ransac_cpu(ransac)
    phase_done("slice and relocalization", t_main, times)
    mlpnp_reloc = run_mlpnp_relocalization(system, frames, poses_gt, times)
    undistortion = check_undistortion(cfg, frames, times)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pipelined, pipe_launches = pool.apply(run_pipelined, (cfg, frames, poses_gt))
    phase_done("pipelined and synchronous slices (own process)", t0, times)
    # loop closing: a System of its own on the loop world's figure-8
    t0 = time.perf_counter()
    loop, loop_launches, loop_calls, loop_ransac, loop_graph, loop_gba = run_loop()
    results.update(check_k3_main_path({"loop": loop_calls}, rows=LOOP_ROWS, path="loop"))
    loop["sim3_ransac"] = check_sim3_ransac_cpu(loop_ransac)
    check(local_ba is not None, "no local BA was recorded on the slice")
    loop["reproducibility"] = check_reproducible(local_ba, loop_gba, loop_graph)
    phase_done("loop", t0, times)
    t0 = time.perf_counter()
    coo = run_coo_ba(local_ba)
    phase_done("COO bundle adjustment", t0, times)
    # the monocular slice: a System of its own, before the kernel profiling
    mono, mono_launches, mono_rows = run_mono(times)
    results.update(mono_rows)
    t0 = time.perf_counter()
    # kernel profiling after the slice, so that no profiler session runs
    # before the slice's frames, and before the profile phase: profiler
    # sessions after that long one have traced no kernels on the H100
    for name, k in KERNELS.items():
        results[name][1]["device_ms"] = device_ms(results[name][3], k["kernel"], per_call=k.get("per_call", 1))
    stagings = k4_stagings(system.vocabulary, results["bow_transform"][3])
    results["bow_transform"][1]["staged_levels"] = system.vocabulary.stage_levels
    results["bow_transform"][1]["device_ms_by_staged_levels"] = stagings
    print(f"K4 bow_transform device-only ms per launch by staged levels: {stagings} (default "
          f"{system.vocabulary.stage_levels})")
    phase_done("kernel device times", t0, times)
    t0 = time.perf_counter()
    loop["essential_graph"] = check_essential_graph(loop_graph)
    phase_done("essential graph: cpu and profiled replays", t0, times)
    t0 = time.perf_counter()
    reloc["profiled"] = profile_relocalize(system, reloc_frame)
    localization = run_localization(system, frames, poses_gt)
    phase_done("relocalization replay and localization", t0, times)
    t0 = time.perf_counter()
    processed = lm.n_processed
    n_profiled = profile_frames(system, profile_set, N_FRAMES)[2]
    check(lm.n_processed > processed, "mapping did not resume after localization mode")
    print(f"mapping resumed: {lm.n_processed - processed} keyframes processed in the {n_profiled} profiled frames")

    path_launches = {"main": launches, "relocalization": reloc["launches"], "loop": loop_launches,
                     "mono": mono_launches}
    path_frames = {"main": N_FRAMES, "relocalization": N_BLACK + 1 + len(RESUMED), "loop": loop["frames"],
                   "mono": N_MONO}
    for name, k in KERNELS.items():
        path = k.get("path", "main")
        check(path_launches[path][name] > 0, f"kernel {name} was not launched on the {path} path")
    # one launch per frame: K1 and K2 over every level, K3's stereo mode
    for name in ("fast_nms", "orb_patch_desc", "hamming_best2:stereo"):
        check(launches[name] == N_FRAMES, f"{name}: {launches[name]} launches over {N_FRAMES} frames")
    # K6: one call per frame over every level, its two kernels
    check(launches["select_keypoints"] == 2 * N_FRAMES,
          f"select_keypoints: {launches['select_keypoints']} launches over {N_FRAMES} frames")
    # K5: the motion-model and local-map pose LMs of a fused frame
    k5_fused = [c["pose_lm"] for c, f in zip(per_frame, fused) if f]
    check(all(n == 2 for n in k5_fused), f"pose_lm launches on the fused frames: {k5_fused}")
    print(f"K5 pose_lm: {launches['pose_lm']} launches over {N_FRAMES} frames, 2 on each of the {len(k5_fused)} "
          f"fused frames; K6 select_keypoints: {launches['select_keypoints']} launches (one call, two kernels, a "
          f"frame)")
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
        calls_per_frame = per_frame_n / k.get("per_call", 1)  # the times are per call
        pipe_per_frame = pipe_launches[name] / N_FRAMES
        print(f"{name}: {per_frame_n:.3f} launches/frame ({path} path; pipelined slice {pipe_per_frame:.3f}); "
              f"per call: wrapper {t['ms']:.4f} ms, "
              f"device {t['device_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}), roofline share {bound_ms / t['device_ms']:.2%}; per frame: wrapper "
              f"{t['ms'] * calls_per_frame:.4f} ms, device {t['device_ms'] * calls_per_frame:.4f} ms; {smi}")
        rows.append({
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": n_launches, "path": path, "launches_per_frame": per_frame_n,
            "pipelined_launches": pipe_launches[name], "pipelined_launches_per_frame": pipe_per_frame,
            "max_abs_err": err,
            **t, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })

    phase_done("profile frames", t0, times)
    # the plain CPU path on the first frames, mapping included, in a
    # spawned process that tracks while the card runs the threaded slice
    # and the checkpoint block: same states, poses within 1 cm. The mesh
    # phase's process group solves the loop's recorded global BA beside
    # them too; the host times of that stretch are contended.
    ranks_dir = tempfile.TemporaryDirectory()
    ranks = start_ranks(loop_gba, ranks_dir.name)
    with multiprocessing.get_context("spawn").Pool(1) as cpu_pool:
        cpu_job = cpu_pool.apply_async(cpu_path, (cfg, frames[:N_CPU_FRAMES]))
        t0 = time.perf_counter()
        threaded = run_threaded(cfg, frames, poses_gt)
        phase_done("threaded slice", t0, times)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            checkpoint = run_checkpoint(system, frame39, tmp)
            disk = run_disk(cfg, frames, poses_gt, tmp)
            rectifier = check_rectifier(frames)
            viewer = run_viewer(cfg, frames, tmp)
        phase_done("checkpoint, disk drivers, rectifier, viewer", t0, times)
        t0 = time.perf_counter()
        est_cpu, times["cpu path (its own process)"] = cpu_job.get(timeout=1200)
    worst = 0.0
    for i, (a, b) in enumerate(zip(est[:N_CPU_FRAMES], est_cpu)):
        check((a is None) == (b is None), f"frame {i}: cuda/cpu tracking state differs")
        if a is not None:
            worst = max(worst, float(np.linalg.norm(center(a) - center(b))))
    print(f"cuda vs cpu plain path, first {N_CPU_FRAMES} frames (mapping included): max camera-centre gap "
          f"{worst:.2e} m")
    check(worst < 0.01, f"cuda and cpu poses differ by {worst} m")
    phase_done("waiting for the cpu path", t0, times)
    mono_loop, circuit, lap = run_mono_loop(times)
    threaded_loop = run_threaded_loop(circuit, lap, times)
    mesh = run_mesh(circuit, lap, loop_gba, loop_graph, ranks, times)
    ranks_dir.cleanup()
    times["total"] = time.perf_counter() - t_main
    print(f"phase times (s): {times}")
    print(f"chip_smoke.py total: {times['total']:.1f} s")

    check(not DEFERRED, f"{len(DEFERRED)} deferred check(s) failed: {DEFERRED}")
    print(json.dumps({"slice": {
        "frames": N_FRAMES, "tracked": n_tracked, "ate_rmse_m": rmse,
        "ms_per_frame_p50": statistics.median(steady), "ms_per_frame_max": max(steady),
        **mapping, "threaded": threaded, "card": smi,
    }, "relocalization": {k: v for k, v in reloc.items() if k != "launches"},
        "localization": {k: v for k, v in localization.items() if k != "launches"}, "loop": loop,
        "mlpnp_relocalization": mlpnp_reloc, "undistortion": undistortion, "mono": mono, "mono_loop": mono_loop,
        "threaded_loop": threaded_loop, "checkpoint": checkpoint, "disk": disk, "rectifier": rectifier,
        "viewer": viewer, "mesh": mesh, "pipelined": pipelined, "cold_start": cold, "coo_ba": coo,
        "phase_seconds": times}, default=str))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
