"""``tests/test_long_sequence.py`` on the port: a 12-keyframe arena
driven far past its capacity by a 360-frame orbit (0.25 degrees a
frame) on the CPU; keyframe culling must free slots that later
keyframes reuse, with tracking healthy to the end.  Slow, as the JAX
package's is."""

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu_torch.config import (
    MapConfig, OrbConfig, SlamConfig, TrackingConfig)
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.io.synthetic import (
    default_world, make_sequence, orbit_trajectory)
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
from active_orb_slam2_tpu_torch.models.system import OK, System
from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

CAM = CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                   width=320, height=240)
N_FRAMES = 360
MAX_KF = 12


@pytest.fixture(scope="module")
def long_run():
    cfg = SlamConfig(
        camera=CAM, orb=OrbConfig(n_features=512, n_levels=4),
        tracking=TrackingConfig(th_depth=10.0, kf_max_interval=8),
        map=MapConfig(max_keyframes=MAX_KF, max_points=6144,
                      local_ba_keyframes=6, local_ba_points=1024))
    slam = System(cfg, device="cpu")
    gt_centers, states, kf_counts = [], [], []
    for i, (g, d, Twc) in enumerate(make_sequence(
            N_FRAMES, CAM, world=default_world(),
            trajectory=orbit_trajectory(N_FRAMES, step_deg=0.25))):
        slam.track_rgbd(g, d, i / 30.0)
        gt_centers.append(Twc[:3, 3])
        if i % 40 == 0:
            slam.flush()
            states.append(slam._state)
            kf_counts.append(slam.kf_seq)
    slam.flush()
    return slam, np.stack(gt_centers), states, kf_counts


def test_tracking_survives(long_run):
    slam, _, states, _ = long_run
    assert slam.state == OK
    assert all(s == OK for s in states[1:]), states


def test_slot_recycling_keeps_mapping_alive(long_run):
    slam, _, _, kf_counts = long_run
    assert slam.kf_seq > 2 * MAX_KF, slam.kf_seq
    assert kf_counts[-1] > kf_counts[-3], kf_counts
    live = int(slam.map.kf_valid.sum())
    assert live <= MAX_KF
    assert slam.n_live_kf == live, (slam.n_live_kf, live)


def test_long_ate_bounded(long_run):
    slam, gt, _, _ = long_run
    _, poses = slam.frame_trajectory()
    rmse = umeyama_alignment(camera_centers(poses), gt, fix_scale=True)[4]
    print(f"360-frame orbit, 12-keyframe arena: ATE {rmse:.4f} m, "
          f"{slam.kf_seq} keyframes inserted", flush=True)
    assert rmse < 0.08, rmse
