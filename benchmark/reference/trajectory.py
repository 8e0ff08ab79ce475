"""Trajectory and map arithmetic in float64 NumPy: poses as matrices,
Umeyama's rigid alignment (ATE), TUM's relative pose error
(``evaluate_rpe.py``: translational RMSE of the relative motion over a
fixed frame distance), and a map point's distance to the surfaces of
the box world that the traffic renders.
"""

import numpy as np


def tcw_to_twc(poses):
    """[N, 7] Tcw ``[qw qx qy qz tx ty tz]`` -> [N, 4, 4] camera-to-world."""
    p = np.asarray(poses, np.float64)
    q = p[:, :4] / np.linalg.norm(p[:, :4], axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y), 2 * (x * y + w * z),
                  1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1).reshape(-1, 3, 3)
    T = np.tile(np.eye(4), (len(p), 1, 1))
    T[:, :3, :3] = R.transpose(0, 2, 1)
    T[:, :3, 3] = -np.einsum("nji,nj->ni", R, p[:, 4:7])
    return T


def umeyama(src, dst):
    """Rigid (R, t, rmse) with dst ~ R src + t for [N, 3] point sets."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    U, _, Vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s) / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    t = mu_d - R @ mu_s
    rmse = float(np.sqrt((((src @ R.T + t) - dst) ** 2).sum(1).mean()))
    return R, t, rmse


def rpe_translation(est_twc, gt_twc, delta):
    """TUM's translational RPE (RMSE, metres) of [N, 4, 4] trajectories
    over pairs ``delta`` frames apart; NaN with no such pair."""
    errs = []
    for i in range(len(est_twc) - delta):
        rel_e = np.linalg.inv(est_twc[i]) @ est_twc[i + delta]
        rel_g = np.linalg.inv(gt_twc[i]) @ gt_twc[i + delta]
        errs.append(np.linalg.norm((np.linalg.inv(rel_g) @ rel_e)[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan")


def surface_distance(points, lo, hi, boxes):
    """Distance [N] of world points to the nearest surface of the room
    [lo, hi] and of the obstacle boxes [M, 2, 3]."""
    p = np.asarray(points, np.float64)
    d = np.minimum(np.abs(p - lo), np.abs(p - hi))
    # distance to a wall plane, counted inside the wall's extent
    best = np.full(len(p), np.inf)
    for ax in range(3):
        others = [a for a in range(3) if a != ax]
        out = np.zeros(len(p))
        for a in others:
            out += np.square(np.maximum(np.maximum(lo[a] - p[:, a],
                                                   p[:, a] - hi[a]), 0.0))
        best = np.minimum(best, np.sqrt(d[:, ax] ** 2 + out))
    for b0, b1 in np.asarray(boxes, np.float64).reshape(-1, 2, 3):
        c, h = (b0 + b1) / 2.0, (b1 - b0) / 2.0
        q = np.abs(p - c) - h
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
        inside = np.minimum(q.max(1), 0.0)
        best = np.minimum(best, np.abs(outside + inside))
    return best
