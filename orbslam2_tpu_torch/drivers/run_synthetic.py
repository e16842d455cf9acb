"""Run stereo SLAM end-to-end on the synthetic world and report ATE.

The synthetic analog of the reference's Examples/Stereo/stereo_euroc.cc
driver: renders a known trajectory, tracks it, prints per-stage behavior
and the trajectory error. Port of examples/run_synthetic.py. Usage:

    python -m orbslam2_tpu_torch.drivers.run_synthetic [--frames 60] [--cpu] [--local-mapping]
        [--loop] [--viewer-out DIR] [--seed 7] [--mesh N]

`--mesh N` (with `--loop`) shards the loop closer's whole-map passes
(essential graph, global BA) over the first N cards, and fails when fewer
are visible; with `--cpu` over N shards on the CPU.
"""

import argparse
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--local-mapping", action="store_true")
    ap.add_argument(
        "--loop", action="store_true",
        help="circuit world with full pipeline (mapping + loop closing)",
    )
    ap.add_argument("--viewer-out", type=str, default=None,
                    help="directory for map snapshot PNGs")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the loop closer's whole-map passes over an N-device mesh "
                         "(with --cpu: N CPU shards); needs --loop")
    args = ap.parse_args(argv)
    if args.mesh > 0 and not args.loop:
        ap.error("--mesh shards the loop closer's passes: it needs --loop")

    import numpy as np
    import torch

    from ..config import CameraConfig, OrbConfig, SlamConfig
    from ..datasets.synthetic import SyntheticWorld
    from ..evaluation.ate import ate_rmse
    from ..slam.frontend import Frontend
    from ..slam.map import SlamMap
    from ..slam.tracking import Tracker

    device = "cpu" if args.cpu else "cuda"
    mesh = None
    if args.mesh > 0:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh, device=device)
    if args.loop:
        world = SyntheticWorld(
            n_points=2000, seed=args.seed, baseline=0.2, vertical_extent=6.0,
            cylinder_radius=11.0,
        )
    else:
        world = SyntheticWorld(n_points=900, seed=args.seed, baseline=0.2)
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=world.fx, fy=world.fy, cx=world.cx, cy=world.cy,
            bf=world.bf, width=world.width, height=world.height, fps=20.0,
        ),
        orb=OrbConfig(n_features=1200),
    )
    frontend = Frontend(cfg, device)
    slam_map = SlamMap(cfg.orb.n_features)
    tracker = Tracker(cfg, frontend, slam_map)
    closer = None
    if args.local_mapping or args.loop:
        from ..slam.local_mapping import LocalMapper

        tracker.local_mapper = LocalMapper(cfg, frontend, slam_map)
    if args.loop:
        from ..slam.loop_closing import LoopCloser
        from ..slam.relocalization import Relocalizer
        from ..vocab import train

        descs, docs = [], []
        for d, T in enumerate(world.trajectory_circuit(8)):
            imL, _ = world.render_stereo(T)
            f = frontend.process(imL, imL)
            v = f.valid.cpu().numpy()
            dd = f.desc.cpu().numpy().view(np.uint32)[v][:400]
            descs.append(np.ascontiguousarray(dd).view(np.uint8))
            docs.append(np.full(len(dd), d))
        voc = train.train_vocabulary(
            np.concatenate(descs), k=8, depth=3, doc_ids=np.concatenate(docs), device=device
        )
        reloc = Relocalizer(cfg, frontend, slam_map, voc)
        tracker.relocalizer = reloc
        closer = LoopCloser(cfg, frontend, slam_map, reloc, local_mapper=tracker.local_mapper, mesh=mesh)
        if closer.mesh is not None:
            print(f"whole-map passes sharded over {closer.mesh}")
        tracker.local_mapper.on_processed = closer.insert_keyframe

    print(f"device: {torch.device(device)}"
          + (f" ({torch.cuda.get_device_name(0)})" if device == "cuda" else ""))
    if args.loop:
        poses_gt = world.trajectory_circuit(args.frames)
        frames = [world.render_stereo(T) for T in poses_gt]
    else:
        poses_gt, frames = world.render_sequence(args.frames, step=0.06)

    est, times = [], []
    for i, (imL, imR) in enumerate(frames):
        t0 = time.time()
        Tcw = tracker.track(imL, imR, timestamp=i / 20.0)
        times.append(time.time() - t0)
        est.append(Tcw)
        if i % 20 == 0:
            print(
                f"frame {i}: state={tracker.state.name} "
                f"kps={tracker.last_frame.n_keypoints} "
                f"inliers={tracker.n_inliers} kfs={slam_map.n_keyframes()} "
                f"pts={len(slam_map.pt_valid)} {1e3*times[-1]:.0f}ms"
            )

    pairs = [(g, e) for g, e in zip(poses_gt, est) if e is not None]
    gt_xyz = np.stack([(-T[:3, :3].T @ T[:3, 3]) for T, _ in pairs])
    est_xyz = np.stack([(-T[:3, :3].T @ T[:3, 3]) for _, T in pairs])
    rmse = ate_rmse(est_xyz, gt_xyz)
    t = np.array(times[5:] or times)
    loops = f" | loops closed {closer.n_loops_closed}" if closer else ""
    print(
        f"\ntracked {len(pairs)}/{len(frames)} frames | "
        f"ATE RMSE {rmse*100:.2f} cm | "
        f"keyframes {slam_map.n_keyframes()} points {len(slam_map.pt_valid)}"
        f"{loops}"
    )
    if args.viewer_out:
        os.makedirs(args.viewer_out, exist_ok=True)

        class _SysShim:
            pass

        shim = _SysShim()
        shim.map = slam_map
        shim.tracker = tracker
        shim.config = cfg
        from ..slam.viewer import Viewer

        Viewer(shim).save(os.path.join(args.viewer_out, "map_final.png"))
        print(f"map snapshot: {args.viewer_out}/map_final.png")
    print(f"per-frame: mean {t.mean()*1e3:.1f}ms median {np.median(t)*1e3:.1f}ms -> {1/t.mean():.1f} fps")
    return 0 if rmse < 0.10 else 1


if __name__ == "__main__":
    sys.exit(main())
