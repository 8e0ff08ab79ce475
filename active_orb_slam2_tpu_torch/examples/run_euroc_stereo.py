"""Stereo SLAM on a EuRoC MAV sequence (reference:
Examples/Stereo/stereo_euroc.cc).

    python -m active_orb_slam2_tpu_torch.examples.run_euroc_stereo <root>
        [--settings EuRoC.yaml] [--traj CameraTrajectory.txt]
        [--max-frames N] [--no-loop-closing] [--device cpu]

With ``--settings`` the file must carry the ``LEFT`` / ``RIGHT``
rectification blocks, as the reference requires; both images are
rectified before tracking.
"""

import sys

from active_orb_slam2_tpu_torch.examples._common import (
    config, parser, report, track_all)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("root", help="sequence directory containing mav0/")
    ap.add_argument("--traj", default="CameraTrajectory.txt")
    ap.add_argument("--no-loop-closing", action="store_true")
    args = ap.parse_args(argv)

    from active_orb_slam2_tpu_torch.config import load_rectification
    from active_orb_slam2_tpu_torch.io.datasets import (
        EurocDataset, stereo_rectify_maps)
    from active_orb_slam2_tpu_torch.models.system import System
    rect = None
    if args.settings:
        blocks = load_rectification(args.settings)
        if blocks is None:
            sys.exit("ERROR: settings file has no LEFT/RIGHT rectification "
                     "blocks; stereo EuRoC requires them")
        rect = stereo_rectify_maps(*blocks)
    ds = EurocDataset(args.root, rectify_maps=rect)
    slam = System(config(args, "stereo"),
                  use_loop_closing=not args.no_loop_closing,
                  device=args.device)
    times = track_all(slam, ds, slam.track_stereo, args.max_frames,
                      every=100)
    slam.save_trajectory_tum(args.traj)
    report(slam, times)


if __name__ == "__main__":
    main()
