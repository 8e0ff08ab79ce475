"""Monocular SLAM on a EuRoC MAV sequence (reference:
Examples/Monocular/mono_euroc.cc).

    python -m active_orb_slam2_tpu_torch.examples.run_euroc_mono <root>
        [--settings EuRoC.yaml] [--traj KeyFrameTrajectory.txt]
        [--max-frames N] [--device cpu]

``root`` is the sequence directory that contains ``mav0/``.
"""

from active_orb_slam2_tpu_torch.examples._common import (
    config, parser, report, track_all)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("root", help="sequence directory containing mav0/")
    ap.add_argument("--traj", default="KeyFrameTrajectory.txt")
    args = ap.parse_args(argv)

    from active_orb_slam2_tpu_torch.io.datasets import EurocDataset
    from active_orb_slam2_tpu_torch.models.system import System
    ds = EurocDataset(args.root)
    slam = System(config(args, "mono"), use_loop_closing=True,
                  device=args.device)
    times = track_all(slam, ((t, cam0) for t, cam0, _ in ds),
                      slam.track_mono, args.max_frames, every=100)
    slam.save_keyframe_trajectory_tum(args.traj)
    report(slam, times)


if __name__ == "__main__":
    main()
