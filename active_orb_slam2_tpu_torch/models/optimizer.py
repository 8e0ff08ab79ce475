"""Motion-only pose optimization and Schur-complement bundle adjustment.

Port of ``active_orb_slam2_tpu/models/optimizer.py``.
:func:`pose_optimization` is the reference form of the motion-only BA
and the oracle of the fused kernel (``ops/pose_opt_kernel.py``).
:func:`bundle_adjustment` is the local BA of the keyframe mapping: the
same Schur step with the dense [Pl, Lt, 6, 3] coupling, LM damping
before the reduction, carried-chi2 accept/reject and chi2
reclassification.  Float32 throughout (the JAX package pins its BA
products to ``highest``; TF32 stays off).  The reduced camera system is
solved by ``torch.linalg.solve_ex`` without its error check, which
would wait on the card; like ``jnp.linalg.solve`` it is an LU solve
that returns non-finite values for a singular system.

Edge convention: every observation is a 3-vector residual (u, v, uR);
monocular observations zero the third component.  Information is
``inv_sigma2(level) * I``; Huber deltas are sqrt(5.991) mono and
sqrt(7.815) stereo.
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.geometry.linalg3 import inv3
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.geometry.se3 import (
    quat_rotate, quat_to_mat, se3_retract)

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
    """Residuals and pose Jacobian of all edges at one pose [7] or at one
    pose per edge [E, 7], in component form: r [3, E], J [3, 6, E], zpos
    [E] bool.  ``stf`` [E] float is 1 for stereo edges and 0 for
    monocular ones.  J[:, 3:6] is d residual / d pc."""
    pc = quat_rotate(pose[..., :4], pw) + pose[..., 4:7]
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


# --------------------------------------------------------- bundle adjustment

class BAEdges(NamedTuple):
    """Fixed-shape edge list: E edges over Lt cameras and Pl points."""
    cam_idx: torch.Tensor     # [E] int into the camera block
    pt_idx: torch.Tensor      # [E] int into the point block
    obs_uvr: torch.Tensor     # [E, 3]
    level: torch.Tensor       # [E] int
    has_stereo: torch.Tensor  # [E] bool
    valid: torch.Tensor       # [E] bool


class BAResult(NamedTuple):
    poses: torch.Tensor        # [Lt, 7]
    points: torch.Tensor       # [Pl, 3]
    edge_inliers: torch.Tensor  # [E] bool
    chi2: torch.Tensor


def edge_residual_jac(cam: CameraParams, pose_e, pw, obs_uvr, has_stereo):
    """Residuals r [E, 3], pose Jacobians Jc [E, 3, 6], point Jacobians
    Jx [E, 3, 3] and zpos [E] of edges at one pose each (pose_e [E, 7])
    (the JAX package's ``optimizer.py::_edge_residual_jac``)."""
    r, J, zpos = edge_terms(cam, pose_e, pw, obs_uvr,
                            has_stereo.to(torch.float32))
    Jc = J.permute(2, 0, 1)
    return r.T, Jc, Jc[..., 3:6] @ quat_to_mat(pose_e[:, :4]), zpos


def huber_weight(c2, has_stereo):
    """IRLS weight of the Huber kernel at the reference's deltas:
    min(1, delta / sqrt(chi2))."""
    chi2_th = torch.where(has_stereo, CHI2_STEREO, CHI2_MONO).to(
        torch.float32)
    return torch.clamp(torch.sqrt(chi2_th)
                       / torch.sqrt(torch.clamp(c2, min=1e-12)), max=1.0)


def _ba_linearize(cam, poses, points, e: BAEdges, inliers):
    """Residuals r [E, 3], Jacobians Jc [E, 3, 6] and Jx [E, 3, 3],
    Huber IRLS weights w [E], chi2 c2 [E] and zpos [E] at the current
    estimate."""
    r, Jc, Jx, zpos = edge_residual_jac(cam, poses[e.cam_idx],
                                        points[e.pt_idx], e.obs_uvr,
                                        e.has_stereo)
    w_info = inv_sigma2(e.level)
    c2 = w_info * (r * r).sum(-1)
    w = w_info * huber_weight(c2, e.has_stereo)
    w = torch.where(inliers & zpos, w, 0.0)
    return r, Jc, Jx, w, c2, zpos


def _gram(Ja, w, Jb):
    """sum over the residual rows of w Ja^T Jb, per edge: [E, n, m]."""
    return (Ja * w[:, None, None]).transpose(1, 2) @ Jb


def _embed_diag(blocks):
    """[L, 6, 6] block-diagonal -> [L*6, L*6] dense."""
    L = blocks.shape[0]
    eye = torch.eye(L, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("lij,lm->limj", blocks, eye).reshape(L * 6, L * 6)


def _ba_solve_step(cam, poses, points, e: BAEdges, fixed_cam, inliers, lam):
    """One Schur-reduced damped Gauss-Newton step.
    Returns (delta_poses [Lt, 6], delta_points [Pl, 3], chi2 at the
    current estimate)."""
    Lt, Pl = poses.shape[0], points.shape[0]
    dev = points.device
    r, Jc, Jx, w, c2, zpos = _ba_linearize(cam, poses, points, e, inliers)
    chi2 = torch.where(inliers & zpos, c2, 0.0).sum()
    cam_free = ~fixed_cam[e.cam_idx]
    Jc = Jc * cam_free[:, None, None]
    ci, pi = e.cam_idx.long(), e.pt_idx.long()
    wr = (w[:, None] * r)[:, :, None]                      # [E, 3, 1]

    Hcc = torch.zeros((Lt, 6, 6), device=dev).index_add_(
        0, ci, _gram(Jc, w, Jc))
    bc = torch.zeros((Lt, 6), device=dev).index_add_(
        0, ci, -(Jc.transpose(1, 2) @ wr)[..., 0])
    Hpp = torch.zeros((Pl, 3, 3), device=dev).index_add_(
        0, pi, _gram(Jx, w, Jx))
    bp = torch.zeros((Pl, 3), device=dev).index_add_(
        0, pi, -(Jx.transpose(1, 2) @ wr)[..., 0])
    # camera-point coupling, dense per (point, camera): [Pl, Lt, 6, 3]
    B = torch.zeros((Pl * Lt, 6, 3), device=dev).index_add_(
        0, pi * Lt + ci, _gram(Jc, w, Jx)).view(Pl, Lt, 6, 3)

    # LM diagonal damping on both blocks before the reduction
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    Hpp_inv = inv3(Hpp + lam * Hpp * eye3 + 1e-6 * eye3, eps=1e-30)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-6 * eye6

    C = torch.einsum("plij,pjk->plik", B, Hpp_inv)         # [Pl, Lt, 6, 3]
    S_red = torch.einsum("plik,pmjk->limj", C, B)          # [Lt, 6, Lt, 6]
    S = _embed_diag(Hcc_d) - S_red.reshape(Lt * 6, Lt * 6)
    g = (bc - torch.einsum("plik,pk->li", C, bp)).reshape(Lt * 6)

    # pin fixed cameras to identity rows
    fixed_rows = fixed_cam[:, None].expand(Lt, 6).reshape(-1)
    S = torch.where(fixed_rows[:, None] | fixed_rows[None, :],
                    torch.eye(Lt * 6, device=dev), S)
    g = torch.where(fixed_rows, 0.0, g)

    dc = torch.linalg.solve_ex(S, g[:, None], check_errors=False)[0]
    dc = dc.reshape(Lt, 6)
    dp = (Hpp_inv @ (bp - torch.einsum("plik,li->pk", B, dc))[..., None])
    return dc, dp[..., 0], chi2


def _ba_chi2(cam, poses, points, e: BAEdges, inliers):
    _, _, _, _, c2, zpos = _ba_linearize(cam, poses, points, e, inliers)
    return torch.where(inliers & zpos, c2, 0.0).sum()


def bundle_adjustment(cam: CameraParams, poses0, points0, e: BAEdges,
                      fixed_cam, iters_a: int = 5, iters_b: int = 10
                      ) -> BAResult:
    """Local / global BA with the reference's 5 + 10 schedule
    (``Optimizer::LocalBundleAdjustment``): ``iters_a`` LM iterations,
    chi2 reclassification, ``iters_b`` more, final outlier flags.

    Args: poses0 [Lt, 7]; points0 [Pl, 3]; fixed_cam [Lt] bool; e: edges.
    """
    dev = points0.device
    chi2_th = torch.where(e.has_stereo, CHI2_STEREO, CHI2_MONO).to(
        torch.float32)

    def lm_iters(poses, points, inliers, n):
        # carried-chi2 accept/reject: one linearization per iteration,
        # the current chi2 judges the previous step
        best_p, best_x = poses, points
        best_chi2 = torch.full((), float("inf"), device=dev)
        lam = torch.full((), 1e-4, device=dev)
        for _ in range(n):
            dc, dp, chi2 = _ba_solve_step(cam, poses, points, e, fixed_cam,
                                          inliers, lam)
            worse = chi2 > best_chi2
            lam = torch.clamp(torch.where(worse, lam * 4.0, lam * 0.5),
                              1e-8, 1e2)
            best_p = torch.where(worse, best_p, poses)
            best_x = torch.where(worse, best_x, points)
            best_chi2 = torch.minimum(chi2, best_chi2)
            poses = torch.where(worse, best_p, se3_retract(poses, dc))
            points = torch.where(worse, best_x, points + dp)
        better = _ba_chi2(cam, poses, points, e, inliers) <= best_chi2
        return (torch.where(better, poses, best_p),
                torch.where(better, points, best_x))

    def reclassify(poses, points, inliers):
        _, _, _, _, c2, zpos = _ba_linearize(cam, poses, points, e, inliers)
        return e.valid & zpos & (c2 <= chi2_th), c2

    poses, points = lm_iters(poses0, points0, e.valid, iters_a)
    inliers, _ = reclassify(poses, points, e.valid)
    poses, points = lm_iters(poses, points, inliers, iters_b)
    inliers, c2 = reclassify(poses, points, inliers)
    return BAResult(poses=poses, points=points, edge_inliers=inliers,
                    chi2=torch.where(inliers, c2, 0.0).sum())
