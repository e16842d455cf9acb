"""Host ms per frame of the port's stereo tracker on chip_smoke.py's
40-frame slice, fed five ways in turns in one process on one CUDA card:
what makes the EuRoC disk path (`drivers/run_euroc.py`) slower per frame
than the slice, when both run inside chip_smoke.py.

    python3 disk_path_probe.py [--rounds N]

The five ways, each a fresh System (vocabulary `assets/vocab_generic.npz`)
over the same 40 frames:
  * `slice`: numpy float32 frames, chip_smoke.py's config, loop closing
    off (chip_smoke.py's slice);
  * `loop`: the same with loop closing on (the drivers' default);
  * `tensor`: the frames as float32 tensors on the card, loop closing off;
  * `yaml`: numpy frames, the config read back from the EuRoC settings
    YAML that chip_smoke.py's disk phase writes, loop closing on;
  * `driver`: the drivers' own loop (`drivers.track_sequence`) over an
    `EurocSequence` of the frames written as PNGs in the EuRoC layout (PNG
    decode, rectification on the card, tensors into the tracker) with the
    YAML's config and loop closing on: the disk path without its prints
    and trajectory files.

Each way is timed as `drivers.track_sequence` times it: `track_stereo`'s host ms, no
synchronisation. One warm-up run of `slice` first; then N rounds (default
3), each running every way once, in an order that rotates with the round.
Per way it prints the p50 over frames 5..39 (the drivers' statistic) and
over frames 2..39 (chip_smoke.py's) of every round, and the frames
tracked. The last line is one JSON object with every number. It exits
non-zero when no CUDA card is visible.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

import chip_smoke as smoke
from orbslam2_tpu_torch.config import RectifyConfig, SlamConfig, load_config
from orbslam2_tpu_torch.datasets import euroc
from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld
from orbslam2_tpu_torch.drivers import track_sequence
from orbslam2_tpu_torch.kernels import build
from orbslam2_tpu_torch.slam.system import System

WAYS = ("slice", "loop", "tensor", "yaml", "driver")
DEVICE = "cuda"


def write_euroc(cfg, frames, tmp):
    """The frames as uint8 PNGs in the EuRoC layout and a settings YAML with
    identity LEFT/RIGHT blocks, as chip_smoke.py's disk phase writes them.
    Returns (left dir, right dir, timestamps file, settings path)."""
    u8 = [tuple(np.clip(np.rint(im), 0, 255).astype(np.uint8) for im in pair) for pair in frames]
    stamps = [smoke.EUROC_T0_NS + int(round(i * 0.05e9)) for i in range(len(u8))]
    left, right, times_file = euroc.write_sequence(os.path.join(tmp, "euroc"), u8, stamps)
    c = cfg.camera
    K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1.0]])
    eye = RectifyConfig(K=K, D=np.zeros((1, 5)), R=np.eye(3), P=np.concatenate([K, np.zeros((3, 1))], 1),
                        width=c.width, height=c.height)
    settings = os.path.join(tmp, "euroc.yaml")
    euroc.write_settings(settings, SlamConfig(camera=cfg.camera, orb=cfg.orb, rectify_left=eye, rectify_right=eye))
    return left, right, times_file, settings


def run_way(way, cfg, frames, disk) -> list:
    """Host ms of each frame's `track_stereo` for one way; the System is
    shut down before returning."""
    left, right, times_file, settings = disk
    if way == "driver":
        system = System(smoke.VOCAB, settings, device=DEVICE)
        seq = euroc.EurocSequence(left, right, times_file, system.config, DEVICE)
        with contextlib.redirect_stdout(io.StringIO()):
            _, track_s = track_sequence(system, seq)
        ms = [t * 1e3 for t in track_s]
    else:
        config = load_config(settings) if way == "yaml" else cfg
        system = System(smoke.VOCAB, config, enable_loop_closing=way in ("loop", "yaml"), device=DEVICE)
        feed = frames
        if way == "tensor":
            feed = [tuple(torch.from_numpy(im).to(DEVICE) for im in pair) for pair in frames]
        ms = []
        for i, (imL, imR) in enumerate(feed):
            t0 = time.perf_counter()
            system.track_stereo(imL, imR, i / 20.0)
            ms.append((time.perf_counter() - t0) * 1e3)
    tracked = sum(e.Tcw is not None for e in system.tracker.trajectory)
    system.shutdown()
    return ms, tracked


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    smoke.check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    build.load()
    world = SyntheticWorld(n_points=900, seed=7, baseline=0.2)
    cfg = smoke.slam_config(world)
    _, frames = world.render_sequence(smoke.N_FRAMES, step=0.06)
    out = {"card": smi, "rounds": args.rounds, "ways": {w: dict(p50_5=[], p50_2=[], tracked=[]) for w in WAYS}}
    with tempfile.TemporaryDirectory() as tmp:
        disk = write_euroc(cfg, frames, tmp)
        ms, _ = run_way("slice", cfg, frames, disk)
        out["warm_up_ms"] = ms[:3]
        for r in range(args.rounds):
            for way in WAYS[r % len(WAYS):] + WAYS[:r % len(WAYS)]:
                ms, tracked = run_way(way, cfg, frames, disk)
                row = out["ways"][way]
                row["p50_5"].append(statistics.median(ms[5:]))
                row["p50_2"].append(statistics.median(ms[2:]))
                row["tracked"].append(tracked)
                print(f"round {r} {way}: {tracked}/{len(frames)} tracked, p50 {row['p50_5'][-1]:.2f} ms "
                      f"(frames 5..39), {row['p50_2'][-1]:.2f} ms (frames 2..39)", flush=True)
    for way, row in out["ways"].items():
        row["median_p50_5"] = statistics.median(row["p50_5"])
        print(f"{way}: p50 over rounds {row['median_p50_5']:.2f} ms (frames 5..39), rounds {row['p50_5']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
