"""Trajectory evaluation: ATE and RPE (numpy).

The counterpart of ``active_orb_slam2_tpu/utils/evaluate.py`` and of
``geometry/horn.py::umeyama_alignment``, in numpy so that the port can
score a run with no JAX installed: nearest-timestamp association, ATE
after alignment, translational RPE, and the ATE of a finished run
against TUM ground truth.  The alignment is Umeyama's SVD solution, the
same least-squares optimum as Horn's quaternion method.
"""

import numpy as np

from active_orb_slam2_tpu_torch.io.trajectory import camera_centers


def umeyama_alignment(src, dst, fix_scale: bool = False):
    """Similarity (or, with ``fix_scale``, rigid) transform with
    dst ~ s R src + t for [N, 3] point sets.

    Returns (aligned_src [N, 3], R [3, 3], t [3], s, rmse).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cs, cd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(cd.T @ cs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = 1.0 if fix_scale else float(np.trace(np.diag(D) @ S)
                                    / max((cs * cs).sum(1).mean(), 1e-12))
    t = mu_d - s * R @ mu_s
    aligned = s * src @ R.T + t
    rmse = float(np.sqrt(((aligned - dst) ** 2).sum(1).mean()))
    return aligned, R, t, s, rmse



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
