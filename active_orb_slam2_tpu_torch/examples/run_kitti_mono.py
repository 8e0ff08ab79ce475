"""Monocular SLAM on a KITTI odometry sequence (reference:
Examples/Monocular/mono_kitti.cc).

    python -m active_orb_slam2_tpu_torch.examples.run_kitti_mono <root> <seq>
        [--settings KITTI00-02.yaml] [--traj KeyFrameTrajectory.txt]
        [--max-frames N] [--device cpu]
"""

from active_orb_slam2_tpu_torch.examples._common import (
    config, parser, report, track_all)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("root", help="KITTI odometry root (contains sequences/)")
    ap.add_argument("sequence", help="sequence id, e.g. 00")
    ap.add_argument("--traj", default="KeyFrameTrajectory.txt")
    args = ap.parse_args(argv)

    from active_orb_slam2_tpu_torch.io.datasets import KittiOdometryDataset
    from active_orb_slam2_tpu_torch.models.system import System
    ds = KittiOdometryDataset(args.root, args.sequence)
    slam = System(config(args, "mono"), use_loop_closing=True,
                  device=args.device)
    times = track_all(slam, ((t, left) for t, left, _ in ds),
                      slam.track_mono, args.max_frames, every=100)
    slam.save_keyframe_trajectory_tum(args.traj)
    report(slam, times)


if __name__ == "__main__":
    main()
