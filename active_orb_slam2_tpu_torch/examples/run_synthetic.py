"""RGB-D or monocular SLAM on the synthetic box world (no dataset
needed), scored against its ground truth.

    python -m active_orb_slam2_tpu_torch.examples.run_synthetic
        [--frames 60] [--loop] [--vga] [--mono] [--device cpu]

``--loop`` drives the closed loop circle instead of the orbit; ``--mono``
tracks the gray images alone (orbit of radius 2 m, 2 degrees a frame,
ATE after a similarity alignment).
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--vga", action="store_true")
    ap.add_argument("--mono", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, loop_trajectory, make_sequence, orbit_trajectory)
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment

    if args.vga:
        cam = CameraParams(fx=525., fy=525., cx=319.5, cy=239.5, bf=40.,
                           width=640, height=480)
        orb = OrbConfig()
    else:
        cam = CameraParams(fx=260., fy=260., cx=159.5, cy=119.5, bf=20.8,
                           width=320, height=240)
        orb = OrbConfig(n_features=512, n_levels=4)
    cfg = SlamConfig(camera=cam, orb=orb,
                     tracking=TrackingConfig(th_depth=10.0),
                     map=MapConfig(max_keyframes=64, max_points=16384,
                                   local_ba_keyframes=8,
                                   local_ba_points=2048),
                     sensor="mono" if args.mono else "rgbd")
    if args.loop:
        traj = loop_trajectory(args.frames, radius=2.5)
    elif args.mono:
        traj = orbit_trajectory(args.frames, radius=2.0, step_deg=2.0)
    else:
        traj = orbit_trajectory(args.frames, step_deg=1.5)
    slam = System(cfg, use_loop_closing=True, device=args.device)

    gt, times = [], []
    for i, (g, d, Twc) in enumerate(make_sequence(
            args.frames, cam, world=default_world(), trajectory=traj)):
        t0 = time.perf_counter()
        if args.mono:
            slam.track_mono(g, i / 30.0)
        else:
            slam.track_rgbd(g, d, i / 30.0)
        times.append(time.perf_counter() - t0)
        gt.append(Twc[:3, 3])
    _, poses = slam.frame_trajectory()
    est, gt = camera_centers(poses), np.stack(gt)
    keep = np.linalg.norm(est, axis=1) > 1e-6 if args.mono \
        else np.ones(len(est), bool)
    rmse = umeyama_alignment(est[keep], gt[keep], fix_scale=not args.mono)[4]
    t_arr = np.array(times[3:])
    print(f"frames: {len(times)}  kfs: {slam.kf_seq}  "
          f"points: {int(slam.map.pt_valid.sum())}")
    print(f"median track: {np.median(t_arr) * 1e3:.1f} ms  "
          f"loops: {slam.n_loops_closed}")
    print(f"ATE RMSE: {rmse * 1000:.1f} mm")


if __name__ == "__main__":
    main()
