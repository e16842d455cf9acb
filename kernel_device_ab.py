"""Device-only time per frame of the front end's kernels K2 and K1, and
per matcher call of the Hamming kernel K3, in one source tree of the port,
for comparing two trees on one card.

    python3 kernel_device_ab.py [--tree DIR] [--frames N]

Imports `orbslam2_tpu_torch` from DIR (default: the directory of this
file) and builds its kernels there. Two trees are compared by running the
script on each in turn within one machine session, for example a parent
commit unpacked by `git archive` and the working tree, in the order
parent, change, change, parent.

On the stereo pair of frame 2 of chip_smoke.py's synthetic sequence
(752x480, 8 levels, 1200 features per image) it makes one frame's K2 and
K1 launches as that tree's extractor makes them: one `fast_nms_levels`
and one `orb_patch_desc_levels` call where the tree has them, else one
`fast_nms` and one `orb_patch_desc` call per level (whose K1 wrapper
reflect-pads each level first). Under `torch.profiler`, one session per
frame, it sums for each of N frames the device durations of each kernel's
launches, and of the reflect-pad kernels apart, and prints the medians
over the frames (a frame whose trace lost a launch is dropped and
counted), with the card's `nvidia-smi` name and power limit, as one JSON
line.

For K3 it tracks the synthetic sequence with that tree's `System` on the
card up to frame 20 (a steady fused frame), records the arguments of that
frame's `stereo_match`, `search_by_projection_frame` and
`search_by_projection_points` calls, and times each call again the same
way: per call, the device time of its K3 launch, of all its device kernels
(the gate construction, where the tree builds one, and the post-processing
included) and their count.

It exits non-zero when no CUDA card is visible.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def frame_kernels(fn, names, n_frames):
    """Per frame, for each name, the device durations (ms) of the CUDA
    kernels whose name contains it, from one `torch.profiler` session per
    frame of fn()."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = []
    for _ in range(n_frames):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        frames.append({m: [e.time_range.elapsed_us() / 1e3 for e in evs if m in e.name] for m in names})
    return frames


def summarize(frames, name):
    """Median per-frame sum of `name`'s durations over the frames that show
    the most common launch count (a frame whose trace lost a launch is
    dropped and counted)."""
    counts = [len(f[name]) for f in frames]
    per = statistics.mode(counts)
    sums = [sum(f[name]) for f, c in zip(frames, counts) if c == per]
    return {"device_ms_per_frame": statistics.median(sums) if per else 0.0,
            "launches_per_frame": per, "frames_dropped": len(frames) - len(sums)}


K3_FRAME = 20
MATCHERS = ("stereo_match", "search_by_projection_frame", "search_by_projection_points")


def matcher_calls(world, n_features=1200):
    """The tree's matcher calls of frame K3_FRAME of the synthetic sequence,
    tracked on the card: {matcher name: (args, kwargs)} (the first call of
    each)."""
    from orbslam2_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
    from orbslam2_tpu_torch.ops import matchers
    from orbslam2_tpu_torch.slam.system import System

    cfg = SlamConfig(camera=CameraConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf,
                                         width=world.width, height=world.height, fps=20.0),
                     orb=OrbConfig(n_features=n_features))
    _, frames = world.render_sequence(K3_FRAME + 1, step=0.06)
    system = System(None, cfg, device="cuda")
    for i, (imL, imR) in enumerate(frames[:K3_FRAME]):
        system.track_stereo(imL, imR, timestamp=i / 20.0)
    calls, originals = {}, {name: getattr(matchers, name) for name in MATCHERS}

    def recording(name):
        def run(*args, **kwargs):
            calls.setdefault(name, (args, kwargs))
            return originals[name](*args, **kwargs)
        return run

    for name in MATCHERS:
        setattr(matchers, name, recording(name))
    try:
        system.track_stereo(*frames[K3_FRAME], timestamp=K3_FRAME / 20.0)
    finally:
        for name, fn in originals.items():
            setattr(matchers, name, fn)
    return {name: (originals[name], *calls[name]) for name in MATCHERS}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
    from orbslam2_tpu_torch.ops import fast, orb, patches

    if not torch.cuda.is_available():
        raise SystemExit("kernel_device_ab.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()

    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    _, frames = world.render_sequence(3, step=0.06)
    images = torch.from_numpy(np.stack(frames[2])).round().clamp(0, 255).to("cuda")
    params = orb.OrbParams()
    levels = [images]
    for size in orb.level_sizes(*images.shape[1:], params)[1:]:
        levels.append(orb.pyramid_level(levels[-1], size))
    xs_l, ys_l = [], []
    for img, n_t in zip(levels, orb.features_per_level(params)):
        xs, ys, _, valid = orb._select_level_keypoints(fast.fast_nms_plain(img), n_t,
                                                       params.ini_th, params.min_th)
        xs_l.append(torch.where(valid, xs, orb.KP_BORDER).contiguous())
        ys_l.append(torch.where(valid, ys, orb.KP_BORDER).contiguous())

    if hasattr(fast, "fast_nms_levels"):
        k2 = lambda: fast.fast_nms_levels(levels)
        k1 = lambda: patches.orb_patch_desc_levels(levels, xs_l, ys_l)
        api = "one call over all levels"
    else:
        k2 = lambda: [fast.fast_nms(img) for img in levels]
        k1 = lambda: [patches.orb_patch_desc(img, xs, ys) for img, xs, ys in zip(levels, xs_l, ys_l)]
        api = "one call per level"

    out = {"tree": os.path.abspath(args.tree), "api": api, "card": smi, "frames": args.frames}
    for name, fn, kernel in (("k2_fast_nms", k2, "fast_nms_kernel"), ("k1_orb_patch_desc", k1, "orb_patch_desc_kernel")):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        frames = frame_kernels(fn, (kernel, "reflection_pad"), args.frames)
        out[name] = {**summarize(frames, kernel),
                     "reflect_pad": summarize(frames, "reflection_pad")}
    for name, (fn, a, kw) in matcher_calls(world).items():
        call = lambda: fn(*a, **kw)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        frames = frame_kernels(call, ("hamming_best2_kernel", ""), args.frames)
        k3, whole = summarize(frames, "hamming_best2_kernel"), summarize(frames, "")
        out[f"k3_{name}"] = {  # per call
            "k3_device_ms": k3["device_ms_per_frame"], "k3_launches": k3["launches_per_frame"],
            "call_device_ms": whole["device_ms_per_frame"], "call_kernels": whole["launches_per_frame"],
            "calls_dropped": k3["frames_dropped"],
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
