"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It

  1. prints the card (`nvidia-smi` name and power limit) and the versions;
  2. builds the port's CUDA kernels from `orbslam2_tpu_torch/csrc/`
     (into `build/kernels/`) and prints the build time;
  3. holds every kernel against its plain PyTorch version on the card at
     the main path's shapes (a rendered 752x480 stereo pair, every pyramid
     level, 2400 keypoints; 1200x1200 for the Hamming kernel) and times
     both with CUDA events;
  4. drives the main path, `System(..., device="cuda").track_stereo`, over
     the 40-frame synthetic sequence of tests/test_tracking.py, checks
     that every kernel was launched there, that >= 39 frames tracked with
     ATE RMSE < 0.06 m, and that the first frames agree with the port's
     plain CPU path;
  5. prints one JSON line describing the kernels, then the result line.

It exits non-zero, and prints no result, when any phase fails, when no
CUDA card is visible, or when the port cannot be imported.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from orbslam2_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.kernels import build
from orbslam2_tpu_torch.ops import fast, hamming, orb, patches
from orbslam2_tpu_torch.slam.system import System

N_FRAMES = 40
N_CPU_FRAMES = 12
N_PROFILE_FRAMES = 5
KERNELS = {
    "fast_nms": dict(
        wrapper=fast.fast_nms, source="orbslam2_tpu_torch/csrc/fast_nms.cu",
        replaces="orbslam2_tpu/ops/fast.py:25",
    ),
    "orb_patch_desc": dict(
        wrapper=patches.orb_patch_desc, source="orbslam2_tpu_torch/csrc/orb_patch_desc.cu",
        replaces="orbslam2_tpu/ops/patches.py:103",
    ),
    "hamming_best2": dict(
        wrapper=hamming.best2, source="orbslam2_tpu_torch/csrc/hamming_best2.cu",
        replaces="orbslam2_tpu/ops/hamming.py:27",
    ),
}


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
    """Per pyramid level: (image [2,h,w], xs, ys) as orb.extract builds them."""
    out = []
    img_l = images
    for lvl, (h, w) in enumerate(orb.level_sizes(*images.shape[1:], params)):
        if lvl > 0:
            img_l = orb.pyramid_level(img_l, (h, w))
        n_t = orb.features_per_level(params)[lvl]
        s = fast.fast_nms_plain(img_l)
        xs, ys, _, valid = orb._select_level_keypoints(s, n_t, params.ini_th, params.min_th)
        out.append((img_l, torch.where(valid, xs, orb.KP_BORDER), torch.where(valid, ys, orb.KP_BORDER)))
    return out


def check_fast_nms(levels):
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for img, _, _ in levels:
        got, want = fast.fast_nms(img), fast.fast_nms_plain(img)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"fast_nms differs from plain at {tuple(img.shape)}")
        err = max(err, float((got - want).abs().max()))
        ms += cuda_ms(lambda: fast.fast_nms(img))
        plain_ms += cuda_ms(lambda: fast.fast_nms_plain(img))
    print(f"K2 fast_nms: exact on all {len(levels)} levels; {ms:.4f} ms/frame (kernel) vs "
          f"{plain_ms:.4f} ms/frame (plain)")
    return err, ms, plain_ms


def check_orb_patch_desc(levels):
    ang_err, n_bits, n_flip, n_kp, ms, plain_ms = 0.0, 0, 0, 0, 0.0, 0.0
    for img, xs, ys in levels:
        a, d = patches.orb_patch_desc(img, xs, ys)
        a0, d0 = patches.orb_patch_desc_plain(img, xs, ys)
        torch.cuda.synchronize()
        dang = torch.remainder(a.double() - a0.double() + np.pi, 2 * np.pi) - np.pi
        ang_err = max(ang_err, float(dang.abs().max()))
        flips = (d ^ d0).cpu().numpy().view(np.uint32)
        n_flip += int(np.unpackbits(flips.view(np.uint8)).sum())
        n_bits += flips.size * 32
        n_kp += xs.numel()
        ms += cuda_ms(lambda: patches.orb_patch_desc(img, xs, ys))
        plain_ms += cuda_ms(lambda: patches.orb_patch_desc_plain(img, xs, ys))
    ber = n_flip / n_bits
    print(f"K1 orb_patch_desc: {n_kp} keypoints, max angle error {ang_err:.3e} rad, "
          f"bit error rate {ber:.3e}; {ms:.4f} ms/frame (kernel) vs {plain_ms:.4f} ms/frame (plain)")
    check(n_kp == 2400, f"K1 keypoint count {n_kp} != 2400")
    check(ang_err <= 1e-4, f"K1 angle error {ang_err} > 1e-4 rad")
    check(ber < 0.01, f"K1 bit error rate {ber} >= 1%")
    return ang_err, ms, plain_ms


def check_hamming_best2():
    gen = torch.Generator(device="cuda").manual_seed(0)
    N = M = 1200
    cases = {
        "random": torch.randint(-2**31, 2**31 - 1, (N + M, 8), generator=gen, device="cuda",
                                dtype=torch.int64).to(torch.int32),
        "ties": torch.tensor([0, 1, 3, -1, -2**31], device="cuda", dtype=torch.int32)[
            torch.randint(0, 5, (N + M, 8), generator=gen, device="cuda")],
    }
    err, timed = 0.0, None
    for name, words in cases.items():
        A, B = words[:N], words[N:]
        mask = torch.rand((N, M), generator=gen, device="cuda") < 0.05
        mask[:16] = False  # rows with no candidate
        mask[16, :] = False
        mask[16, 7] = True
        got = hamming.best2(A, B, mask)
        want = hamming.best2_plain(A, B, mask)
        torch.cuda.synchronize()
        for g, w, label in zip(got, want, ("idx1", "d1", "idx2", "d2")):
            check(torch.equal(g, w), f"hamming_best2 {label} differs from plain ({name})")
            err = max(err, float((g - w).abs().max()))
        if timed is None:
            timed = (cuda_ms(lambda: hamming.best2(A, B, mask)),
                     cuda_ms(lambda: hamming.best2_plain(A, B, mask)))
    print(f"K3 hamming_best2: exact (idx1, d1, idx2, d2) at {N}x{M}, random and tie-heavy; "
          f"{timed[0]:.4f} ms (kernel) vs {timed[1]:.4f} ms (plain)")
    return err, *timed


def run_slice(world, cfg, frames, device):
    system = System(None, cfg, device=device)
    est, ms = [], []
    for i, (imL, imR) in enumerate(frames):
        t0 = time.perf_counter()
        est.append(system.track_stereo(imL, imR, timestamp=i / 20.0))
        ms.append((time.perf_counter() - t0) * 1e3)
    return system, est, ms


def profile_frames(system, frames, first):
    """Track more frames under torch.profiler: stage host/device times per
    frame, the device's busy share of the wall time, the top kernels."""
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

    for (owner, name), fn in zip(stages, originals):
        setattr(owner, name, traced(fn, f"stage:{name}"))
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
    n = len(frames)
    # device-side events, without the ranges' own GPU annotations
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.name.startswith("stage:")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profile over {n} frames (profiler on): wall {wall_ms / n:.2f} ms/frame, "
          f"{len(kernels) / n:.0f} device kernels/frame, device busy {busy_ms / n:.3f} ms/frame "
          f"= {100 * busy_ms / wall_ms:.1f}% of wall (idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    for e in prof.key_averages():
        if e.key.startswith("stage:") and e.cpu_time_total > 0:
            dev = getattr(e, "device_time_total", 0.0)
            print(f"  {e.key[6:]}: {e.count / n:.1f} calls/frame, host {e.cpu_time_total / n / 1e3:.2f} "
                  f"ms/frame, device {dev / n / 1e3:.3f} ms/frame")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  kernel {name[:90]}: {t / n / 1e3:.3f} ms/frame, {c / n:.0f} launches/frame")
    return wall_ms / n, busy_ms / wall_ms


def center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3]


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
    levels = level_inputs(images, params)
    results = {
        "fast_nms": check_fast_nms(levels),
        "orb_patch_desc": check_orb_patch_desc(levels),
        "hamming_best2": check_hamming_best2(),
    }

    for k in KERNELS.values():
        k["wrapper"].launches = 0
    system, est, ms = run_slice(world, cfg, frames, "cuda")
    torch.cuda.synchronize()
    launches = {name: k["wrapper"].launches for name, k in KERNELS.items()}
    n_tracked = sum(T is not None for T in est)
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([center(e) for _, e in pairs]), np.stack([center(g) for g, _ in pairs]))
    steady = ms[2:]
    print(f"slice: {n_tracked}/{N_FRAMES} frames tracked, ATE RMSE {rmse:.4f} m, "
          f"{system.map.n_keyframes()} keyframes; ms/frame p50 {statistics.median(steady):.2f} "
          f"max {max(steady):.2f} (frames 2..{N_FRAMES - 1}; first two {ms[0]:.1f}, {ms[1]:.1f}); "
          f"launches {launches}")
    print(system.shutdown())
    profile_frames(system, profile_set, N_FRAMES)
    check(n_tracked >= N_FRAMES - 1, f"only {n_tracked}/{N_FRAMES} frames tracked")
    check(rmse < 0.06, f"ATE RMSE {rmse} >= 0.06 m")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    # the plain CPU path on the first frames: same states, poses within 1 cm
    ref, est_cpu, _ = run_slice(world, cfg, frames[:N_CPU_FRAMES], "cpu")
    worst = 0.0
    for i, (a, b) in enumerate(zip(est[:N_CPU_FRAMES], est_cpu)):
        check((a is None) == (b is None), f"frame {i}: cuda/cpu tracking state differs")
        if a is not None:
            worst = max(worst, float(np.linalg.norm(center(a) - center(b))))
    print(f"cuda vs cpu plain path, first {N_CPU_FRAMES} frames: max camera-centre gap {worst:.2e} m")
    check(worst < 0.01, f"cuda and cpu poses differ by {worst} m")

    print(json.dumps({"slice": {
        "frames": N_FRAMES, "tracked": n_tracked, "ate_rmse_m": rmse,
        "ms_per_frame_p50": statistics.median(steady), "ms_per_frame_max": max(steady),
        "card": smi,
    }}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": launches[name], "max_abs_err": results[name][0],
         "ms": results[name][1], "plain_ms": results[name][2]}
        for name, k in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
