"""Motion-only pose optimization (``Optimizer::PoseOptimization``).

Port of the pose-optimization half of
``active_orb_slam2_tpu/models/optimizer.py`` (bundle adjustment waits
for local mapping).  :func:`pose_optimization` is the reference form of
the motion-only BA and the oracle of the fused kernel
(``ops/pose_opt_kernel.py``).

Edge convention: every observation is a 3-vector residual (u, v, uR);
monocular observations zero the third component.  Information is
``inv_sigma2(level) * I``; Huber deltas are sqrt(5.991) mono and
sqrt(7.815) stereo.
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.geometry.se3 import quat_rotate, se3_retract

CHI2_MONO = 5.991      # 95% chi2, 2 dof
CHI2_STEREO = 7.815    # 95% chi2, 3 dof
# 2 log(1.2), evaluated in float32 as the JAX package evaluates it
LOG_SCALE2 = float(2.0 * torch.log(torch.tensor(1.2, dtype=torch.float32)))


class PoseOptResult(NamedTuple):
    pose: torch.Tensor       # [7]
    inliers: torch.Tensor    # [E] bool
    n_inliers: torch.Tensor  # int32
    chi2: torch.Tensor       # float32 (inlier chi2 sum)


def inv_sigma2(level):
    """Per-level information weight 1 / 1.2^(2 level)."""
    return torch.exp(-level.to(torch.float32) * LOG_SCALE2)


def solve_spd(H, b, n: int = 6):
    """Unrolled Cholesky solve of one small SPD system, H [n, n], b [n]
    -> x [n], with the JAX package's pivot floor of 1e-20."""
    h = [[H[i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = h[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-20))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = h[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def edge_terms(cam: CameraParams, pose, pw, obs_uvr, stf):
    """Residuals and pose Jacobian of all edges at one pose, in component
    form: r [3, E], J [3, 6, E], zpos [E] bool.  ``stf`` [E] float is 1
    for stereo edges and 0 for monocular ones."""
    pc = quat_rotate(pose[:4], pw) + pose[4:7]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    r = torch.stack([u - obs_uvr[:, 0], v - obs_uvr[:, 1],
                     stf * (ur - obs_uvr[:, 2])])
    zero = torch.zeros_like(x)
    jpc = [
        [cam.fx * iz, zero, -cam.fx * x * iz2],
        [zero, cam.fy * iz, -cam.fy * y * iz2],
        [stf * cam.fx * iz, zero, stf * (-cam.fx * x * iz2 + cam.bf * iz2)],
    ]
    # d pc / d delta = [-[pc]x | I] (left perturbation on Tcw)
    px = [[zero, -z, y], [z, zero, -x], [-y, x, zero]]
    J = [[-(jpc[a][0] * px[0][i] + jpc[a][1] * px[1][i]
            + jpc[a][2] * px[2][i]) for i in range(3)] + jpc[a]
         for a in range(3)]
    return r, torch.stack([torch.stack(row) for row in J]), z > 0


def damped(H, lam):
    """H + lam diag(H) + 1e-9 I."""
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    return H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye


def pose_optimization(cam: CameraParams, pose0, pw, obs_uvr, level,
                      has_stereo, valid, rounds: int = 4,
                      iters_per_round: int = 10) -> PoseOptResult:
    """Motion-only BA: 4 rounds x 10 damped Gauss-Newton iterations; after
    each round edges are reclassified by chi2 and outliers leave the next
    round; Huber in rounds 0-1.

    Args: pose0 [7]; pw [E, 3]; obs_uvr [E, 3]; level [E] int;
      has_stereo / valid [E] bool.
    """
    w_info = inv_sigma2(level)
    stf = has_stereo.to(torch.float32)
    chi2_th = torch.where(has_stereo, CHI2_STEREO, CHI2_MONO).to(torch.float32)
    delta = torch.sqrt(chi2_th)
    E = pw.shape[0]

    def chi2_at(pose):
        r, _, zpos = edge_terms(cam, pose, pw, obs_uvr, stf)
        return w_info * (r * r).sum(0), zpos

    def lm_round(pose, inliers, use_huber):
        inl_f = inliers.to(torch.float32)
        best_pose = pose
        best_chi2 = torch.tensor(float("inf"), device=pw.device)
        lam = torch.tensor(1e-4, device=pw.device)
        for _ in range(iters_per_round):
            r, J, zpos = edge_terms(cam, pose, pw, obs_uvr, stf)
            c2 = w_info * (r * r).sum(0)
            gate = inl_f * zpos.to(torch.float32)
            chi2 = (c2 * gate).sum()
            worse = chi2 > best_chi2
            lam = torch.clamp(torch.where(worse, lam * 4.0, lam * 0.5),
                              1e-8, 1e2)
            best_pose = torch.where(worse, best_pose, pose)
            best_chi2 = torch.minimum(chi2, best_chi2)
            hub = torch.clamp(delta / torch.sqrt(torch.clamp(c2, min=1e-12)),
                              max=1.0) if use_huber else 1.0
            w = w_info * hub * gate
            # normal equations as one product: M [7, 3E] holds the six
            # Jacobian columns and the residual
            M = torch.cat([J.permute(1, 0, 2).reshape(6, 3 * E),
                           r.reshape(1, 3 * E)])
            A = (M * w.repeat(3)[None]) @ M.T
            step = solve_spd(damped(A[:6, :6], lam), -A[:6, 6])
            pose = torch.where(worse, best_pose, se3_retract(pose, step))
        # final acceptance of the last proposed step
        c2, zpos = chi2_at(pose)
        cand_chi2 = torch.where(inliers & zpos, c2, torch.zeros_like(c2)).sum()
        return torch.where(cand_chi2 <= best_chi2, pose, best_pose)

    pose = pose0
    inliers = valid
    for rnd in range(rounds):
        pose = lm_round(pose, inliers, rnd < 2)
        c2, zpos = chi2_at(pose)
        inliers = valid & zpos & (c2 <= chi2_th)
    c2, _ = chi2_at(pose)
    return PoseOptResult(
        pose=pose, inliers=inliers,
        n_inliers=inliers.sum().to(torch.int32),
        chi2=torch.where(inliers, c2, torch.zeros_like(c2)).sum())
