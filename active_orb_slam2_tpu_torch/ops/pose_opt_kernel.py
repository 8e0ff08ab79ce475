"""Fused motion-only BA: dispatch between the CUDA kernel and its plain
PyTorch version.

Port of ``active_orb_slam2_tpu/ops/pose_opt_kernel.py``, whose Pallas
kernel runs the whole optimization (4 rounds x 10 damped Gauss-Newton
iterations, chi2 reclassification) in one program.  On the card the
port runs ``csrc/pose_opt.cu`` (wrapped by ``kernels/pose_opt.py``); on
the CPU it runs :func:`pose_optimization_fused_torch`, the same
algorithm on [E] tensors.  Both take a leading axis of independent
problems (the relocalizer's candidates), which the kernel solves in one
launch of one block per problem.  Both keep the Pallas kernel's own final
acceptance ``sum(c2 * inl * zpos) <= best``, which differs slightly from
``models/optimizer.py::pose_optimization``.
"""

import functools

import torch

from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.geometry.se3 import quat_mul, quat_rotate
from active_orb_slam2_tpu_torch.models.optimizer import (
    CHI2_MONO, CHI2_STEREO, PoseOptResult, damped, edge_terms, inv_sigma2,
    solve_spd)

W_LEVELS = 32       # levels in the kernel's information table


@functools.lru_cache(maxsize=None)
def w_info_table(device: torch.device):
    """``inv_sigma2`` of levels 0..31, made once per device by the same
    operation the plain version applies to each edge's level, so the
    kernel's weights have the plain version's bits on that device."""
    return inv_sigma2(torch.arange(W_LEVELS, dtype=torch.int32, device=device))


def _retract(pose, step):
    """exp(step) * pose with the Pallas kernel's scalar series."""
    w, v = step[:3], step[3:]
    t2 = (w * w).sum()
    t = torch.sqrt(t2)
    small = t < 1e-6
    k = torch.where(small, 0.5 - t2 / 48.0,
                    torch.sin(0.5 * t) / torch.clamp(t, min=1e-20))
    eq = torch.cat([torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * t))[None],
                    k * w])
    a = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.clamp(t2, min=1e-20))
    b = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / torch.clamp(t2 * t, min=1e-20))
    w1 = torch.linalg.cross(w, v, dim=-1)
    w2 = torch.linalg.cross(w, w1, dim=-1)
    nq = quat_mul(eq, pose[:4])
    nq = nq / torch.clamp(torch.sqrt((nq * nq).sum()), min=1e-12)
    return torch.cat([nq, quat_rotate(eq, pose[4:7]) + (v + a * w1 + b * w2)])


def pose_optimization_fused_torch(cam: CameraParams, pose0, pw, obs_uvr,
                                  level, has_stereo, valid, rounds: int = 4,
                                  iters_per_round: int = 10) -> PoseOptResult:
    """Plain PyTorch version of the fused kernel: pose0 [7], pw [E, 3],
    obs_uvr [E, 3], level [E] int, has_stereo / valid [E] bool, or the
    same with a leading axis of problems (pose0 [P, 7], pw [P, E, 3],
    ...), which the kernel solves in one launch and this version one
    problem after another."""
    if pose0.dim() == 2:
        res = [_fused_one(cam, *args, rounds, iters_per_round)
               for args in zip(pose0, pw, obs_uvr, level, has_stereo, valid)]
        return PoseOptResult(*(torch.stack(f) for f in zip(*res)))
    return _fused_one(cam, pose0, pw, obs_uvr, level, has_stereo, valid,
                      rounds, iters_per_round)


def _fused_one(cam, pose0, pw, obs_uvr, level, has_stereo, valid, rounds,
               iters_per_round):
    w_info = inv_sigma2(level)
    stf = has_stereo.to(torch.float32)
    valid_f = valid.to(torch.float32)
    chi2_th = torch.where(has_stereo, CHI2_STEREO, CHI2_MONO).to(torch.float32)
    delta_h = torch.sqrt(chi2_th)

    def linearize(pose):
        r, J, zpos = edge_terms(cam, pose, pw, obs_uvr, stf)
        return r, J, w_info * (r * r).sum(0), zpos.to(torch.float32)

    pose = pose0.to(torch.float32)
    inl = valid_f
    for rnd in range(rounds):
        best = pose
        best_chi2 = torch.tensor(float("inf"), device=pw.device)
        lam = torch.tensor(1e-4, device=pw.device)
        for _ in range(iters_per_round):
            r, J, c2, zpos = linearize(pose)
            gate = inl * zpos
            chi2 = (c2 * gate).sum()
            worse = chi2 > best_chi2
            lam = torch.clamp(torch.where(worse, lam * 4.0, lam * 0.5),
                              1e-8, 1e2)
            best = torch.where(worse, best, pose)
            best_chi2 = torch.minimum(chi2, best_chi2)
            hub = torch.clamp(delta_h / torch.sqrt(torch.clamp(c2, min=1e-12)),
                              max=1.0) if rnd < 2 else 1.0
            w = w_info * hub * gate
            # the kernel's 21 + 6 reductions: sum_e w (J_a,i J_a,j summed
            # over the three residual rows)
            H = ((J[:, :, None, :] * J[:, None, :, :]).sum(0) * w).sum(-1)
            b = -((J * r[:, None, :]).sum(0) * w).sum(-1)
            step = solve_spd(damped(H, lam), b)
            pose = torch.where(worse, best, _retract(pose, step))
        # final acceptance of the last proposed step
        _, _, c2c, zposc = linearize(pose)
        better = (c2c * inl * zposc).sum() <= best_chi2
        pose = torch.where(better, pose, best)
        # chi2 reclassification for the next round
        _, _, c2r, zposr = linearize(pose)
        inl = valid_f * zposr * (c2r <= chi2_th).to(torch.float32)
    _, _, c2f, _ = linearize(pose)
    inliers = inl > 0.5
    return PoseOptResult(pose=pose, inliers=inliers,
                         n_inliers=inliers.sum().to(torch.int32),
                         chi2=(c2f * inl).sum())


def pose_optimization_fused(cam: CameraParams, pose0, pw, obs_uvr, level,
                            has_stereo, valid, rounds: int = 4,
                            iters_per_round: int = 10) -> PoseOptResult:
    """Motion-only BA of one problem ([E] edges) or of a leading axis of
    problems ([P, E]) in one launch: CUDA tensors run the hand-written
    kernel on the tensors as they are, CPU tensors
    :func:`pose_optimization_fused_torch`."""
    if not pw.is_cuda:
        return pose_optimization_fused_torch(
            cam, pose0, pw, obs_uvr, level, has_stereo, valid, rounds,
            iters_per_round)
    from active_orb_slam2_tpu_torch.kernels.pose_opt import pose_opt_cuda
    out, n_inliers, inliers = pose_opt_cuda(
        cam, pose0, pw, obs_uvr, level, has_stereo, valid,
        w_info_table(pw.device), rounds, iters_per_round)
    return PoseOptResult(pose=out[..., :7], inliers=inliers,
                         n_inliers=n_inliers, chi2=out[..., 7])
