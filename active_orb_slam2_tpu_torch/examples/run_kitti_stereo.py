"""Stereo SLAM on a KITTI odometry sequence (reference:
Examples/Stereo/stereo_kitti.cc).

    python -m active_orb_slam2_tpu_torch.examples.run_kitti_stereo <root> <seq>
        [--settings KITTI00-02.yaml] [--traj CameraTrajectory.txt]
        [--max-frames N] [--no-loop-closing] [--device cpu]

The trajectory is written in the KITTI format.
"""

from active_orb_slam2_tpu_torch.examples._common import (
    config, parser, report, track_all)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("root", help="KITTI odometry root (contains sequences/)")
    ap.add_argument("sequence", help="sequence id, e.g. 00")
    ap.add_argument("--traj", default="CameraTrajectory.txt")
    ap.add_argument("--no-loop-closing", action="store_true")
    args = ap.parse_args(argv)

    from active_orb_slam2_tpu_torch.io.datasets import KittiOdometryDataset
    from active_orb_slam2_tpu_torch.models.system import System
    ds = KittiOdometryDataset(args.root, args.sequence)
    slam = System(config(args, "stereo"),
                  use_loop_closing=not args.no_loop_closing,
                  device=args.device)
    times = track_all(slam, ds, slam.track_stereo, args.max_frames,
                      every=100)
    slam.save_trajectory_kitti(args.traj)
    report(slam, times)


if __name__ == "__main__":
    main()
