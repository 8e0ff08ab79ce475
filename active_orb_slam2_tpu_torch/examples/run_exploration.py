"""Active exploration demo (BASELINE config #5): the SLAM system drives
itself through the synthetic world — frontier goals, feature-safe A*,
replanning, relocalization recovery.

    python -m active_orb_slam2_tpu_torch.examples.run_exploration
        [--steps 15] [--device cpu]
"""

import argparse


START_XZ = (0.0, -2.0)
N_BOXES = 4


def exploration_config():
    """The example's configuration (``examples/run_exploration.py:33-46``
    of the JAX package): (SlamConfig, GridSpec2D)."""
    from active_orb_slam2_tpu_torch.active import GridSpec2D
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    cam = CameraParams(fx=260., fy=260., cx=159.5, cy=119.5, bf=20.8,
                       width=320, height=240)
    cfg = SlamConfig(camera=cam,
                     orb=OrbConfig(n_features=512, n_levels=4),
                     tracking=TrackingConfig(th_depth=10.0),
                     map=MapConfig(max_keyframes=64, max_points=16384,
                                   local_ba_keyframes=8,
                                   local_ba_points=2048))
    spec = GridSpec2D(origin_x=-4.0, origin_z=-4.0, resolution=0.25,
                      width=32, height=32)
    return cfg, spec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="torch device the System runs on (default cuda)")
    args = ap.parse_args(argv)

    from active_orb_slam2_tpu_torch.active.explorer import run_exploration
    from active_orb_slam2_tpu_torch.io.synthetic import default_world
    from active_orb_slam2_tpu_torch.models.system import System

    cfg, spec = exploration_config()
    slam = System(cfg, use_loop_closing=True, device=args.device)
    log = run_exploration(slam, default_world(n_boxes=N_BOXES), spec,
                          n_steps=args.steps, start_xz=START_XZ)
    print(f"steps: {len(log.positions)}  replans: {log.replans}")
    print(f"coverage: {log.coverage[0]:.3f} -> {log.coverage[-1]:.3f}")
    print(f"map points: {log.n_points[0]} -> {log.n_points[-1]}")
    print(f"keyframes: {slam.kf_seq}  loops: {slam.n_loops_closed}")


if __name__ == "__main__":
    main()
