"""Device-only time per frame of the front end's kernels K2 and K1, per
matcher call of the Hamming kernel K3, per launch of the BoW kernel K4, per
call of the pose LM kernel K5 and of the keypoint selection kernel K6, in
one source tree of the port, for comparing two trees on one card.

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

For K5 it records the arguments of frame 20's two `pose_optimize` calls
(the motion-model and the local-map pose LM of the fused step) and for K6
those of its `select_keypoints_levels` call (every level of both images),
and times each call again the same way: K5's `pose_lm_kernel` per call,
K6's two kernels summed per call; beside them, CUDA events around 200
back-to-back calls. Where the tree's K5 takes a cluster size
(`pose_opt.K5_CLUSTER`), K5 is also timed on the second call with clusters
of 1, 4, 8 and 16 CTAs. K5 and K6 are timed first, then K4.

For K4 it takes the descriptors of the last keyframe of that run (1200
slots) and times one `transform_words_nodes` call against the generic
vocabulary (`assets/vocab_generic.npz`) the same way, before the other
kernels; where the tree stages the top of the tree
(`bow.with_stage_levels`), also with 0-3 staged levels, and on the
first 1 and 132 descriptors; and, for scale,
the device time of a fill of 1200 int32.

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


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(a) for a in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(a) for a in x)
    return x


def matcher_calls(world, n_features=1200):
    """The tree's matcher calls of frame K3_FRAME of the synthetic sequence,
    tracked on the card: {matcher name: (fn, args, kwargs)} (the first call
    of each), the descriptors and valid flags of the last keyframe, and
    that frame's K5 and K6 calls {"k5": [(fn, args, kwargs)] (both),
    "k6": [(fn, args, kwargs)]}."""
    from orbslam2_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
    from orbslam2_tpu_torch.ops import matchers, orb, pose_opt
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

    kernel_calls = {"k5": [], "k6": []}
    kernel_fns = {"k5": (pose_opt, "pose_optimize"), "k6": (orb, "select_keypoints_levels")}
    kernel_originals = {k: getattr(owner, name) for k, (owner, name) in kernel_fns.items()}

    def kernel_recording(k):
        def run(*args, **kwargs):
            kernel_calls[k].append((kernel_originals[k], _clone(args), _clone(kwargs)))
            return kernel_originals[k](*args, **kwargs)
        # a wrapper counts its launches through its module's global name
        run.launches = getattr(kernel_originals[k], "launches", 0)
        return run

    for name in MATCHERS:
        setattr(matchers, name, recording(name))
    for k, (owner, name) in kernel_fns.items():
        setattr(owner, name, kernel_recording(k))
    try:
        system.track_stereo(*frames[K3_FRAME], timestamp=K3_FRAME / 20.0)
    finally:
        for name, fn in originals.items():
            setattr(matchers, name, fn)
        for k, (owner, name) in kernel_fns.items():
            setattr(owner, name, kernel_originals[k])
    kf = system.map.kf_frame[max(system.map.kf_valid)].dev
    return ({name: (originals[name], *calls[name]) for name in MATCHERS}, (kf.desc, kf.valid),
            kernel_calls)


def k5_k6_times(args, kernel_calls):
    """K5's device-only ms per call on frame K3_FRAME's two pose_optimize
    calls and K6's on its select_keypoints_levels call (both kernels), CUDA
    events around 200 back-to-back calls beside each, and, where the tree
    has `pose_opt.K5_CLUSTER`, K5's second call by cluster size."""
    import torch

    from orbslam2_tpu_torch.ops import pose_opt

    def timed(call, kernel):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        dev = summarize(frame_kernels(call, (kernel,), args.frames), kernel)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            call()
        end.record()
        torch.cuda.synchronize()
        return {"device_ms": dev["device_ms_per_frame"], "launches": dev["launches_per_frame"],
                "calls_dropped": dev["frames_dropped"], "events_ms_per_call": start.elapsed_time(end) / 200}

    out = {}
    calls = [("k5_pose_lm_call_1", "pose_lm_kernel", c) for c in kernel_calls["k5"][:1]]
    calls += [("k5_pose_lm_call_2", "pose_lm_kernel", c) for c in kernel_calls["k5"][1:2]]
    calls += [("k6_select_keypoints", "select_keypoints_", c) for c in kernel_calls["k6"][:1]]
    for label, kernel, (fn, a, kw) in calls:
        out[label] = timed(lambda: fn(*a, **kw), kernel)
        if kernel == "pose_lm_kernel":
            out[label]["edges"] = int(a[1].shape[0])
    for fn, a, kw in kernel_calls["k6"][:1]:  # K6's two kernels apart: the cell pass and the top-k pass
        frames = frame_kernels(lambda: fn(*a, **kw), ("select_keypoints_cells", "select_keypoints_topk"),
                               args.frames)
        out["k6_cells_device_ms"] = summarize(frames, "select_keypoints_cells")["device_ms_per_frame"]
        out["k6_topk_device_ms"] = summarize(frames, "select_keypoints_topk")["device_ms_per_frame"]
    out["k5_calls_recorded"] = len(kernel_calls["k5"])
    if hasattr(pose_opt, "K5_CLUSTER") and len(kernel_calls["k5"]) > 1:
        fn, a, kw = kernel_calls["k5"][1]
        default = pose_opt.K5_CLUSTER
        by_cluster = {}
        try:
            for n_cta in (1, 4, 8, 16):
                pose_opt.K5_CLUSTER = n_cta
                by_cluster[n_cta] = timed(lambda: fn(*a, **kw), "pose_lm_kernel")["device_ms"]
        finally:
            pose_opt.K5_CLUSTER = default
        out["k5_device_ms_by_cluster"] = by_cluster
        out["k5_cluster_default"] = default
    return out


def k4_times(args, desc, valid):
    """K4's device-only ms per launch on one keyframe's descriptors against
    the generic vocabulary: as the tree launches it and, where the tree
    stages the top of the tree, with 0-3 staged levels, and on the first 1
    and 132 descriptors; beside it, CUDA events around 200 back-to-back calls
    (launch gaps included); and a fill of 1200 int32 for scale."""
    import torch

    from orbslam2_tpu_torch.vocab import bow

    voc = bow.load_npz(os.path.join(os.path.abspath(args.tree), "assets", "vocab_generic.npz"), "cuda")
    runs = {"k4_default": (voc, desc.shape[0])}
    if hasattr(bow, "with_stage_levels"):
        runs.update({f"k4_staged_levels_{L}": (bow.with_stage_levels(voc, L), desc.shape[0]) for L in range(4)})
    # the same call on its first descriptors only: one warp, and one warp per SM
    runs.update({f"k4_first_{n}_descriptors": (voc, n) for n in (1, 132)})
    out = {"k4_descriptors": {"n": desc.shape[0], "valid": int(valid.sum())}}
    # the shortest kernel there is, for scale: a fill of 1200 int32
    fill = torch.empty(desc.shape[0], dtype=torch.int32, device="cuda")
    frames = frame_kernels(lambda: fill.fill_(1), ("",), args.frames)
    out["fill_1200_int32_device_ms"] = summarize(frames, "")["device_ms_per_frame"]
    for label, (v, n) in runs.items():
        call = lambda: bow.transform_words_nodes(v, desc[:n], valid[:n])  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        k4 = summarize(frame_kernels(call, ("bow_transform_kernel",), args.frames), "bow_transform_kernel")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            call()
        end.record()
        torch.cuda.synchronize()
        out[label] = {"device_ms": k4["device_ms_per_frame"], "launches": k4["launches_per_frame"],
                      "calls_dropped": k4["frames_dropped"], "events_ms_per_call": start.elapsed_time(end) / 200,
                      "staged_levels": getattr(v, "stage_levels", None)}
    return out


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
    # K5, K6 and K4 first: profiler sessions late in a long run of them have
    # traced no kernels on the H100
    calls, (kf_desc, kf_valid), kernel_calls = matcher_calls(world)
    out.update(k5_k6_times(args, kernel_calls))
    out.update(k4_times(args, kf_desc, kf_valid))
    for name, fn, kernel in (("k2_fast_nms", k2, "fast_nms_kernel"), ("k1_orb_patch_desc", k1, "orb_patch_desc_kernel")):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        frames = frame_kernels(fn, (kernel, "reflection_pad"), args.frames)
        out[name] = {**summarize(frames, kernel),
                     "reflect_pad": summarize(frames, "reflection_pad")}
    for name, (fn, a, kw) in calls.items():
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
