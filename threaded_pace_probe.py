"""The threaded circuit on one card, fed unpaced and at the camera's rate.

    python3 threaded_pace_probe.py [--fps F ...]

Renders one lap of chip_smoke.py's circuit (the world of
tests/test_pipeline.py) with its renderer pool, then runs
`System(vocab_circuit, cfg, threaded=True)` over it and on around it
until its first loop (at most chip_smoke.THREADED_MAX_EXTRA frames past
the lap), once per feed rate: unpaced, and each `--fps` given (20 by
default, the camera's rate; a frame waits for its slot on the clock, as
the reference's drivers sleep the slack); and each rate under both
keyframe policies: the port's, where the tracker waits before a frame
while 3 keyframes wait for the mapper (`LocalMapper.wait_for_room`), and
the reference's, where it never waits and a keyframe is refused while 3
wait (the wait replaced by a no-op). Prints per run: frames, wall
seconds, frames lost (and the first ones), loops,
keyframes made and processed, local BAs, the mapper's queue length (max
and mean after each frame), ATE RMSE and the correction windows, then the
System's stage report. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import multiprocessing
import time

import numpy as np

import chip_smoke as cs
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.evaluation.ate import ate_rmse
from orbslam2_tpu_torch.kernels import build
from orbslam2_tpu_torch.slam.local_mapping import LocalMapper
from orbslam2_tpu_torch.slam.system import System


def run(frames, lap, fps, policy):
    cfg = cs.slam_config(SyntheticWorld(**cs.CIRCUIT_WORLD))
    system = System(cs.VOCAB_CIRCUIT, cfg, threaded=True)
    closer, lm = system.loop_closer, system.local_mapper
    est, queue, lost, t_start = [], [], [], time.monotonic()
    i = 0
    while (i < cs.N_CIRCUIT or closer.n_loops_closed == 0) and i < cs.N_CIRCUIT + cs.THREADED_MAX_EXTRA:
        if fps:
            delay = t_start + i / fps - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        est.append(system.track_stereo(*frames[i % cs.N_CIRCUIT], i / 20.0))
        queue.append(lm.queue_size())
        if est[-1] is None:
            lost.append(i)
        i += 1
    wall = time.monotonic() - t_start
    system.wait_idle(600.0)
    report = system.shutdown()
    gt = [lap[j % cs.N_CIRCUIT] for j in range(len(est))]
    pairs = [(g, e) for g, e in zip(gt, est) if e is not None]
    rmse = ate_rmse(np.stack([cs.center(e) for _, e in pairs]), np.stack([cs.center(g) for g, _ in pairs]))
    print(f"{policy} policy, fps {fps or 'unpaced'}: {len(est)} frames in {wall:.1f} s, lost {len(lost)} (first {lost[:10]}), loops "
          f"{closer.n_loops_closed}, keyframes {system.map.n_keyframes()}, processed {lm.n_processed}, local BAs "
          f"{lm.n_local_ba}, mapper queue max {max(queue)} mean {np.mean(queue):.2f}, ATE RMSE {rmse:.4f} m, "
          f"correction windows {[w1 - w0 for w0, w1 in closer.correction_windows]} s")
    print(report)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fps", type=float, nargs="*", default=[20.0])
    args = ap.parse_args()
    world = SyntheticWorld(**cs.CIRCUIT_WORLD)
    lap = world.trajectory_circuit(cs.N_CIRCUIT)
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(cs.RENDER_WORKERS, initializer=cs._render_init,
                                                   initargs=(lap, cs.CIRCUIT_WORLD, False)) as pool:
        frames = pool.map(cs._render, range(cs.N_CIRCUIT), chunksize=4)
    print(f"rendered {cs.N_CIRCUIT} frames in {time.time() - t0:.1f} s")
    build.load()
    wait = LocalMapper.wait_for_room
    for policy in ("wait", "refuse"):
        LocalMapper.wait_for_room = wait if policy == "wait" else (lambda self: None)
        try:
            for fps in [0.0, *args.fps]:
                run(frames, lap, fps, policy)
        finally:
            LocalMapper.wait_for_room = wait


if __name__ == "__main__":
    main()
