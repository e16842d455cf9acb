"""Circle by circle, the port against the JAX package on the figure-8 of
chip_smoke.py's loop phase, both on the CPU.

    python3 loop_lap_compare.py render --dir DIR [--workers 3] [--seed S]
    python3 loop_lap_compare.py run --package torch|jax --dir DIR [--limit N]
    python3 loop_lap_compare.py compare --dir DIR

`render` writes the 591 frames of the loop world's figure-8 (bench.py:
171-175), rendered as chip_smoke.py's loop phase renders them, to
DIR/frames.npy ([F, 2, 480, 752] uint8); `--seed` draws another world of
the same kind (default: the loop world's own, 21). `run` tracks them with one
package's `System("assets/vocab_generic.npz", cfg)` (loop closing on,
mapping and loop closing inline) on the CPU, and writes per frame the pose,
the keyframe and map point counts and the loops closed so far to
DIR/<package>.npz, every 10 frames, so that a run cut short keeps what it
reached. `compare` prints, for each package, how far it got, its online
ATE RMSE per circle (circle A before the handover, circle B after), the
frames and keyframes at which it closed its loops and its camera-centre
error every 25 frames (aligned as the ATE aligns), then the first frame
whose camera centres differ by more than 1 cm between the packages, with
both packages' keyframe and point counts there, as one JSON line.

Runs on the CPU are reproducible. A run takes about half an hour; run the
two packages in the background.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
VOCAB = os.path.join(HERE, "assets", "vocab_generic.npz")


def render(args):
    import chip_smoke as cs
    from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld

    world = SyntheticWorld(**{**cs.LOOP_WORLD, "seed": args.seed})
    poses_gt, meta = world.trajectory_figure8()
    out = np.lib.format.open_memmap(os.path.join(args.dir, "frames.npy.tmp"), mode="w+", dtype=np.uint8,
                                    shape=(len(poses_gt), 2, world.height, world.width))
    with multiprocessing.get_context("spawn").Pool(args.workers, initializer=_render_init,
                                                   initargs=(poses_gt, args.seed)) as pool:
        for i, (imL, imR) in enumerate(pool.imap(cs._render, range(len(poses_gt)), chunksize=1)):
            out[i, 0], out[i, 1] = imL, imR
    out.flush()
    del out
    os.replace(os.path.join(args.dir, "frames.npy.tmp"), os.path.join(args.dir, "frames.npy"))
    np.savez(os.path.join(args.dir, "truth.npz"), poses=np.stack(poses_gt), handover=meta["handover"])
    print(f"rendered {len(poses_gt)} frames, handover at {meta['handover']}")


def _render_init(poses, seed):
    import chip_smoke as cs
    from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld

    cs._render_state.update(world=SyntheticWorld(**{**cs.LOOP_WORLD, "seed": seed}), poses=poses)


def _system(package):
    """One package's `System` on the CPU, loop closing on."""
    import chip_smoke as cs
    from orbslam2_tpu_torch.datasets.synthetic import SyntheticWorld

    world = SyntheticWorld(**cs.LOOP_WORLD)
    if package == "torch":
        import torch

        torch.set_num_threads(2)
        from orbslam2_tpu_torch.slam.system import System

        system = System(VOCAB, cs.slam_config(world), device="cpu")
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from orbslam2_tpu.config import CameraConfig, OrbConfig, SlamConfig
        from orbslam2_tpu.slam.system import System

        cfg = SlamConfig(camera=CameraConfig(fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy, bf=world.bf,
                                             width=world.width, height=world.height, fps=20.0),
                         orb=OrbConfig(n_features=1200))
        system = System(VOCAB, cfg)
    return system


def run(args):
    frames = np.load(os.path.join(args.dir, "frames.npy"), mmap_mode="r")
    n = len(frames) if args.limit is None else min(args.limit, len(frames))
    system = _system(args.package)
    m, closer = system.map, system.loop_closer
    rec = {k: [] for k in ("Tcw", "n_kf", "n_points", "n_loops", "last_loop_kf", "seconds")}
    path = os.path.join(args.dir, f"{args.package}.npz")
    t0 = time.perf_counter()
    for i in range(n):
        T = system.track_stereo(np.array(frames[i, 0]), np.array(frames[i, 1]), timestamp=i / 20.0)
        rec["Tcw"].append(np.full((4, 4), np.nan) if T is None else np.asarray(T, np.float64))
        rec["n_kf"].append(m.n_keyframes())
        rec["n_points"].append(len(m.pt_valid))
        rec["n_loops"].append(closer.n_loops_closed)
        rec["last_loop_kf"].append(-1 if closer.last_loop_kf is None else int(closer.last_loop_kf))
        rec["seconds"].append(time.perf_counter() - t0)
        if (i + 1) % 10 == 0 or i + 1 == n:
            np.savez(path + ".tmp.npz", **{k: np.asarray(v) for k, v in rec.items()})
            os.replace(path + ".tmp.npz", path)
            print(f"{args.package}: frame {i + 1}/{n}, {m.n_keyframes()} keyframes, "
                  f"{closer.n_loops_closed} loops, {time.perf_counter() - t0:.0f} s", flush=True)


def _centres(T):
    return -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])


def compare(args):
    from orbslam2_tpu_torch.evaluation.ate import ate_rmse, umeyama_alignment

    truth = np.load(os.path.join(args.dir, "truth.npz"))
    gt, handover = _centres(truth["poses"].astype(np.float64)), int(truth["handover"])
    out, runs = {"handover": handover}, {}
    for package in ("torch", "jax"):
        path = os.path.join(args.dir, f"{package}.npz")
        if not os.path.exists(path):
            continue
        r = dict(np.load(path))
        runs[package] = r
        c = _centres(r["Tcw"])
        ok = np.isfinite(c).all(axis=1)
        idx = np.arange(len(c))
        circles = {}
        for name, sel in (("circle_a", ok & (idx < handover)), ("circle_b", ok & (idx >= handover))):
            if sel.sum() >= 3:
                circles[name] = ate_rmse(c[sel], gt[:len(c)][sel])
        loops = [(int(i), int(r["last_loop_kf"][i])) for i in np.nonzero(np.diff(r["n_loops"], prepend=0))[0]]
        R, t, s = umeyama_alignment(c[ok], gt[:len(c)][ok])
        err = np.linalg.norm(s * c @ R.T + t - gt[:len(c)], axis=1)
        out[package] = dict(frames=len(c), tracked=int(ok.sum()), ate_online=ate_rmse(c[ok], gt[:len(c)][ok]),
                            **circles, loops_at_frame_kf=loops, keyframes=int(r["n_kf"][-1]),
                            seconds=float(r["seconds"][-1]),
                            error_every_25=[None if not np.isfinite(e) else round(float(e), 4) for e in err[::25]])
    if len(runs) == 2:
        a, b = runs["torch"], runs["jax"]
        n = min(len(a["Tcw"]), len(b["Tcw"]))
        gap = np.linalg.norm(_centres(a["Tcw"][:n]) - _centres(b["Tcw"][:n]), axis=1)
        over = np.nonzero(~(gap <= 0.01))[0]
        first_kf = np.nonzero(a["n_kf"][:n] != b["n_kf"][:n])[0]
        out["compared_frames"] = n
        out["first_frame_over_1cm"] = None if not len(over) else dict(
            frame=int(over[0]), gap_m=float(gap[over[0]]),
            torch=dict(n_kf=int(a["n_kf"][over[0]]), n_points=int(a["n_points"][over[0]])),
            jax=dict(n_kf=int(b["n_kf"][over[0]]), n_points=int(b["n_points"][over[0]])))
        out["first_frame_keyframe_counts_differ"] = None if not len(first_kf) else int(first_kf[0])
        out["max_gap_m"] = float(np.nanmax(gap))
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("render", "run", "compare"))
    ap.add_argument("--dir", required=True)
    ap.add_argument("--package", choices=("torch", "jax"))
    ap.add_argument("--limit", type=int)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--seed", type=int, default=21)
    args = ap.parse_args()
    os.makedirs(args.dir, exist_ok=True)
    sys.path.insert(0, HERE)
    {"render": render, "run": run, "compare": compare}[args.what](args)


if __name__ == "__main__":
    main()
