"""Monocular SLAM on a TUM sequence (reference:
Examples/Monocular/mono_tum.cc).

    python -m active_orb_slam2_tpu_torch.examples.run_mono_tum <sequence_dir>
        [--settings TUM1.yaml] [--traj KeyFrameTrajectory.txt]
        [--frame-traj PATH] [--max-frames N] [--ate] [--device cpu]

``--ate`` scores the frame trajectory against ``groundtruth.txt`` after
a similarity alignment (monocular scale is free).
"""

from active_orb_slam2_tpu_torch.examples._common import (
    config, parser, report, track_all)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("sequence")
    ap.add_argument("--traj", default="KeyFrameTrajectory.txt")
    ap.add_argument("--frame-traj", default=None,
                    help="also write the frame trajectory here")
    ap.add_argument("--ate", action="store_true",
                    help="evaluate ATE (Sim3) against groundtruth.txt")
    args = ap.parse_args(argv)

    from active_orb_slam2_tpu_torch.io.datasets import TumRgbdDataset
    from active_orb_slam2_tpu_torch.models.system import System
    ds = TumRgbdDataset(args.sequence)
    slam = System(config(args, "mono"), use_loop_closing=True,
                  device=args.device)
    times = track_all(slam, ((t, gray) for t, gray, _ in ds),
                      slam.track_mono, args.max_frames)
    slam.save_keyframe_trajectory_tum(args.traj)
    if args.frame_traj:
        slam.save_trajectory_tum(args.frame_traj)
    report(slam, times)
    if args.ate:
        from active_orb_slam2_tpu_torch.utils.evaluate import (
            evaluate_ate_tum)
        rmse = evaluate_ate_tum(slam, ds.groundtruth(), fix_scale=False)
        print(f"ATE RMSE (Sim3): {rmse:.4f}")


if __name__ == "__main__":
    main()
