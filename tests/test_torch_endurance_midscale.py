"""``tests/test_endurance_midscale.py`` on the port: 500 frames (two
laps of a 250-pose circle) through the full pipeline on the CPU, loop
closing and culling on, at a 128-keyframe arena; the similarity-aligned
ATE stays below 0.25 m and keyframe slots are recycled.  Slow, as the
JAX package's is."""

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu_torch.config import (
    MapConfig, OrbConfig, SlamConfig, TrackingConfig)
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.io.synthetic import (
    default_world, loop_trajectory, render_rgbd)
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
from active_orb_slam2_tpu_torch.models.system import OK, System
from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

CAM = CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                   width=320, height=240)


def test_midscale_endurance_two_laps():
    unique, frames = 250, 500
    world = default_world(n_boxes=8)
    traj = loop_trajectory(unique, radius=1.2)
    cache = []
    for Twc in traj:
        g, d = render_rgbd(world, CAM, Twc)
        cache.append((np.clip(g, 0, 255).astype(np.uint8),
                      np.clip(d * 1e3, 0, 65535).astype(np.uint16),
                      Twc[:3, 3].copy()))
    cfg = SlamConfig(
        camera=CAM, orb=OrbConfig(n_features=1024, n_levels=8),
        tracking=TrackingConfig(th_depth=8.0, kf_max_interval=8),
        map=MapConfig(max_keyframes=128, max_points=16384,
                      local_ba_keyframes=8, local_ba_points=2048))
    slam = System(cfg, use_mapping=True, use_loop_closing=True, device="cpu")
    gt = []
    for i in range(frames):
        g, d, c = cache[i % unique]
        slam.track_rgbd(g, d, i / 30.0)
        gt.append(c)
    slam.flush()
    assert slam._state == OK
    _, poses = slam.frame_trajectory()
    ate = umeyama_alignment(camera_centers(poses), np.stack(gt))[4]
    lc = slam.loop_closer
    print(f"mid-scale ATE {ate:.4f} m, loops {slam.n_loops_closed}, "
          f"rejected {lc.n_rejected}, candidates {lc.n_candidates}, "
          f"keyframes {slam.kf_seq}, live {slam.n_live_kf}", flush=True)
    assert ate < 0.25, (
        f"mid-scale ATE {ate:.3f} m (loops={slam.n_loops_closed} "
        f"rejected={lc.n_rejected} kf={slam.kf_seq})")
    assert slam.kf_seq > 20
