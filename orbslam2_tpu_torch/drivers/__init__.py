"""Command-line drivers of the port, run as modules:

    python -m orbslam2_tpu_torch.drivers.run_euroc ...
    python -m orbslam2_tpu_torch.drivers.run_kitti ...
    python -m orbslam2_tpu_torch.drivers.run_synthetic ...

Ports of examples/run_euroc.py, run_kitti.py and run_synthetic.py (the
reference's Examples/Stereo drivers), with the same positional CLI, prints
and output files. They run on the card; `--cpu` runs them on the CPU.
"""

from __future__ import annotations

import statistics
import time

import torch


def track_sequence(system, seq) -> tuple:
    """Track every pair of `seq` (EurocSequence / KittiSequence) through
    `system.track_stereo`, printing the state every 200 frames. Returns
    (load seconds, track seconds) per frame; a load (PNG decode and, for
    EuRoC, rectification) ends synchronised with the device."""
    sync = torch.cuda.synchronize if system.device.type == "cuda" else (lambda: None)
    load_times, track_times = [], []
    for i in range(len(seq)):
        t0 = time.perf_counter()
        imL, imR, t = seq[i]
        sync()
        t1 = time.perf_counter()
        system.track_stereo(imL, imR, t)
        dt = time.perf_counter() - t1
        load_times.append(t1 - t0)
        track_times.append(dt)
        # (the reference sleeps any slack to pace at camera rate,
        # stereo_euroc.cc:176-183; batch evaluation runs unpaced)
        if i % 200 == 0:
            print(
                f"frame {i}: state={system.get_tracking_state().name} "
                f"kfs={system.map.n_keyframes()} pts={len(system.map.pt_valid)} "
                f"{1e3*dt:.0f}ms"
            )
    tt = track_times[5:] or track_times
    lt = load_times[5:] or load_times
    print(f"\nmean tracking time: {1e3 * statistics.fmean(tt):.1f}ms  median: {1e3 * statistics.median(tt):.1f}ms")
    print(f"mean image load time: {1e3 * statistics.fmean(lt):.1f}ms  median: {1e3 * statistics.median(lt):.1f}ms")
    return load_times, track_times


def split_cpu_flag(argv):
    """(positional arguments with argv[0], device): `--cpu` selects the CPU."""
    return [a for a in argv if a != "--cpu"], "cpu" if "--cpu" in argv else "cuda"
