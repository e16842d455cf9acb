"""EuRoC stereo driver — the reference's Examples/Stereo/stereo_euroc.cc.

Usage (matching the reference's positional CLI, stereo_euroc.cc:43-47):

    python -m orbslam2_tpu_torch.drivers.run_euroc <vocabulary.npz|ORBvoc.txt> <settings.yaml> \\
        <mav0/cam0/data> <mav0/cam1/data> <timestamps.txt> [out_prefix] [--cpu]

The settings YAML is the reference's own EuRoC.yaml (same keys, including
the LEFT./RIGHT. rectification blocks). Images are decoded on the host and
rectified on the card (`datasets/euroc.py`). Writes CameraTrajectory.txt,
OfflineCameraTrajectory.txt and KeyFrameTrajectory.txt in the reference's
TUM format and prints the per-stage timing report at shutdown. Port of
examples/run_euroc.py.
"""

import sys

from . import split_cpu_flag, track_sequence


def main(argv=None):
    argv, device = split_cpu_flag(sys.argv if argv is None else argv)
    if len(argv) < 6:
        print(__doc__)
        return 2
    voc_path, settings, left_dir, right_dir, times_file = argv[1:6]
    out_prefix = argv[6] if len(argv) > 6 else ""

    from ..datasets.euroc import EurocSequence
    from ..slam.system import Sensor, System

    system = System(voc_path, settings, Sensor.STEREO, device=device)
    seq = EurocSequence(left_dir, right_dir, times_file, system.config, device)
    print(f"images in sequence: {len(seq)}")
    track_sequence(system, seq)
    print(system.shutdown())
    system.save_trajectory_tum(out_prefix + "CameraTrajectory.txt")
    system.save_offline_trajectory_tum(out_prefix + "OfflineCameraTrajectory.txt")
    system.save_keyframe_trajectory_tum(out_prefix + "KeyFrameTrajectory.txt")
    print("trajectories saved")
    return 0


if __name__ == "__main__":
    sys.exit(main())
