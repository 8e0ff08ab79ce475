"""RGB-D SLAM on a TUM sequence (reference: Examples/RGB-D/rgbd_tum.cc).

    python -m active_orb_slam2_tpu_torch.examples.run_tum_rgbd <sequence_dir>
        [--settings TUM1.yaml] [--traj CameraTrajectory.txt]
        [--kf-traj KeyFrameTrajectory.txt] [--max-frames N]
        [--no-loop-closing] [--ate] [--metrics PATH] [--trace-out PATH]
        [--device cpu]

``--trace-out`` turns the tracer on (``utils/trace.py``) and writes the
run's spans and counters as Chrome trace-event JSON, which Perfetto
opens.
"""

from active_orb_slam2_tpu_torch.examples._common import (
    config, parser, report, track_all)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("sequence")
    ap.add_argument("--traj", default="CameraTrajectory.txt")
    ap.add_argument("--kf-traj", default="KeyFrameTrajectory.txt")
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--ate", action="store_true",
                    help="evaluate ATE against groundtruth.txt")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--trace-out", default=None,
                    help="Chrome trace-event JSON of the run's spans")
    args = ap.parse_args(argv)
    if args.trace_out:
        from active_orb_slam2_tpu_torch.utils import trace
        trace.enable()

    from active_orb_slam2_tpu_torch.io.datasets import TumRgbdDataset
    from active_orb_slam2_tpu_torch.models.system import System
    cfg = config(args, "rgbd")
    ds = TumRgbdDataset(args.sequence,
                        depth_factor=cfg.tracking.depth_map_factor)
    slam = System(cfg, use_loop_closing=not args.no_loop_closing,
                  device=args.device)
    times = track_all(slam, ds, slam.track_rgbd, args.max_frames)
    slam.save_trajectory_tum(args.traj)
    slam.save_keyframe_trajectory_tum(args.kf_traj)
    if args.metrics:
        slam.save_metrics(args.metrics)
    if args.trace_out:
        trace.disable()
        trace.write_chrome(args.trace_out)
    report(slam, times)
    if args.ate:
        from active_orb_slam2_tpu_torch.utils.evaluate import (
            evaluate_ate_tum)
        print(f"ATE RMSE: {evaluate_ate_tum(slam, ds.groundtruth()):.4f} m")


if __name__ == "__main__":
    main()
