"""Trajectory evaluation: ATE and RPE (numpy).

The counterpart of ``active_orb_slam2_tpu/utils/evaluate.py``:
nearest-timestamp association, ATE after alignment
(``geometry/horn.py::umeyama_alignment``, imported from there as the
JAX module does), translational RPE, and the ATE of a finished run
against TUM ground truth.
"""

import numpy as np

from active_orb_slam2_tpu_torch.geometry.horn import (  # noqa: F401
    umeyama_alignment)
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers


def associate_timestamps(ta, tb, max_dt: float = 0.02):
    """Index pairs (i, j) with |ta[i] - tb[j]| <= max_dt, nearest."""
    pairs = []
    j = 0
    for i, t in enumerate(ta):
        while j + 1 < len(tb) and abs(tb[j + 1] - t) <= abs(tb[j] - t):
            j += 1
        if abs(tb[j] - t) <= max_dt:
            pairs.append((i, j))
    return pairs


def ate_rmse(est_ts, est_centers, gt_ts, gt_centers,
             fix_scale: bool = True, max_dt: float = 0.02) -> float:
    """Absolute trajectory error after alignment (NaN below 3 pairs)."""
    pairs = associate_timestamps(est_ts, gt_ts, max_dt)
    if len(pairs) < 3:
        return float("nan")
    ei = np.array([i for i, _ in pairs])
    gi = np.array([j for _, j in pairs])
    return umeyama_alignment(np.asarray(est_centers)[ei],
                             np.asarray(gt_centers)[gi],
                             fix_scale=fix_scale)[4]


def rpe_translation(est_ts, est_centers, gt_ts, gt_centers,
                    delta_frames: int = 30, max_dt: float = 0.02):
    """Relative pose (translation drift) error over ``delta_frames``."""
    pairs = associate_timestamps(est_ts, gt_ts, max_dt)
    errs = []
    for k in range(len(pairs) - delta_frames):
        i0, j0 = pairs[k]
        i1, j1 = pairs[k + delta_frames]
        d_est = est_centers[i1] - est_centers[i0]
        d_gt = gt_centers[j1] - gt_centers[j0]
        errs.append(np.linalg.norm(d_est - d_gt))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan")


def evaluate_ate_tum(slam, groundtruth, fix_scale: bool = True) -> float:
    """ATE of a finished ``System`` run against TUM ground-truth records
    [(t, [tx ty tz qx qy qz qw])]."""
    ts, poses = slam.frame_trajectory()
    gt_ts = np.array([t for t, _ in groundtruth])
    gt_centers = np.stack([v[:3] for _, v in groundtruth])
    return ate_rmse(ts, camera_centers(poses), gt_ts, gt_centers,
                    fix_scale=fix_scale)
