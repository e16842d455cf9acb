"""chip_smoke.py's threaded slice, run many times: what moves its ATE.

    python3 threaded_slice_probe.py [--runs N] [--seeds S ...] [--fps F ...]

Renders chip_smoke.py's 40-frame slice (the world of seed 7, and of each
other `--seeds` given), warms the card with one run, then runs
`System(VOCAB, cfg, enable_loop_closing=False, threaded=True)` over it
`--runs` times per world and feed rate: unpaced (0, as chip_smoke.py
feeds it) and each `--fps` given (a frame waits for its slot on the
clock, as the reference's drivers sleep the slack). Per run it prints the
ATE RMSE, frames tracked, keyframes made and mapped, local BAs, the
frames whose keyframe decision found the mapper busy (not accepting
keyframes), the mapper's queue length (max), and ms per frame (p50); then,
per world and rate, the spread of the ATE and its correlation with the
keyframes made. It reads the tracker and the mapper only through what
every version of the port has, so the same file runs in an older
checkout of the repository (copy it there). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

import chip_smoke as cs
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.kernels import build
from orbslam2_tpu_torch.slam.system import System
from orbslam2_tpu_torch.slam.tracking import Tracker


def run(cfg, frames, poses_gt, fps):
    system = System(cs.VOCAB, cfg, enable_loop_closing=False, threaded=True)
    lm = system.local_mapper
    decisions = []  # (keyframe made, mapper accepting) per decision
    need = Tracker._need_new_keyframe

    def counted(self, frame):
        idle = lm.accept_keyframes()
        made = need(self, frame)
        decisions.append((made, idle))
        return made

    Tracker._need_new_keyframe = counted
    try:
        est, ms, queue = [], [], []
        t_start = time.monotonic()
        for i, (imL, imR) in enumerate(frames):
            if fps:
                delay = t_start + i / fps - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            t0 = time.perf_counter()
            est.append(system.track_stereo(imL, imR, timestamp=i / 20.0))
            ms.append((time.perf_counter() - t0) * 1e3)
            queue.append(lm.queue_size())
        system.wait_idle()
        system.shutdown()
    finally:
        Tracker._need_new_keyframe = need
    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    rmse = ate_rmse(np.stack([cs.center(e) for _, e in pairs]), np.stack([cs.center(g) for g, _ in pairs]))
    return dict(ate=rmse, tracked=len(pairs), made=sum(m for m, _ in decisions), mapped=lm.n_processed,
                local_ba=lm.n_local_ba, busy=sum(not idle for _, idle in decisions), queue_max=max(queue),
                p50=statistics.median(ms[2:]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs="*", default=[7])
    ap.add_argument("--fps", type=float, nargs="*", default=[0.0, 20.0])
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    build.load()
    for seed in args.seeds:
        world = SyntheticWorld(n_points=900, seed=seed, baseline=0.2)
        cfg = cs.slam_config(world)
        poses_gt, frames = world.render_sequence(cs.N_FRAMES, step=0.06)
        run(cfg, frames, poses_gt, 0.0)  # warm-up: CUDA start-up and the first launches
        for fps in args.fps:
            rows = []
            for k in range(args.runs):
                r = run(cfg, frames, poses_gt, fps)
                rows.append(r)
                print(f"{args.tag} seed {seed} fps {fps or 'unpaced'} run {k}: ATE {r['ate']:.4f} m, tracked "
                      f"{r['tracked']}/{len(frames)}, keyframes made {r['made']} mapped {r['mapped']}, local BAs "
                      f"{r['local_ba']}, decisions with the mapper busy {r['busy']}, queue max {r['queue_max']}, "
                      f"ms/frame p50 {r['p50']:.2f}", flush=True)
            ate = np.array([r["ate"] for r in rows])
            made = np.array([r["made"] for r in rows], float)
            corr = float(np.corrcoef(ate, made)[0, 1]) if ate.std() > 0 and made.std() > 0 else float("nan")
            print(f"{args.tag} seed {seed} fps {fps or 'unpaced'}: ATE min {ate.min():.4f} median "
                  f"{np.median(ate):.4f} max {ate.max():.4f} m over {len(rows)} runs; keyframes made "
                  f"{sorted(int(m) for m in made)}; corr(ATE, keyframes made) {corr:.2f}", flush=True)


if __name__ == "__main__":
    main()
