"""KITTI odometry stereo driver — the reference's Examples/Stereo/stereo_kitti.cc.

Usage (matching the reference's positional CLI, stereo_kitti.cc):

    python -m orbslam2_tpu_torch.drivers.run_kitti <vocabulary.npz|ORBvoc.txt> <settings.yaml> \\
        <sequence_dir> [out_prefix] [--cpu]

`settings.yaml` is one of the reference's KITTI settings files
(Examples/Stereo/KITTI00-02.yaml / KITTI03.yaml / KITTI04-12.yaml — same
keys read here). `sequence_dir` holds image_0/ image_1/ times.txt.
KITTI frames are pre-rectified, so no remap stage runs. Writes the
KITTI-format trajectory (12 floats of [R|t] per line, reference
System.cpp:415-455) plus the TUM online/offline trajectories. Port of
examples/run_kitti.py.
"""

import sys

from . import split_cpu_flag, track_sequence


def main(argv=None):
    argv, device = split_cpu_flag(sys.argv if argv is None else argv)
    if len(argv) < 4:
        print(__doc__)
        return 2
    voc_path, settings, seq_dir = argv[1:4]
    out_prefix = argv[4] if len(argv) > 4 else ""

    from ..datasets.kitti import KittiSequence
    from ..slam.system import Sensor, System

    system = System(voc_path, settings, Sensor.STEREO, device=device)
    seq = KittiSequence(seq_dir, device)
    print(f"images in sequence: {len(seq)}")
    track_sequence(system, seq)
    print(system.shutdown())
    system.save_trajectory_kitti(out_prefix + "CameraTrajectory.txt")
    system.save_trajectory_tum(out_prefix + "CameraTrajectoryTUM.txt")
    system.save_offline_trajectory_tum(out_prefix + "OfflineCameraTrajectory.txt")
    print("trajectories saved")
    return 0


if __name__ == "__main__":
    sys.exit(main())
