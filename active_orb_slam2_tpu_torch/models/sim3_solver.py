"""Sim3 between two keyframes: batched Horn RANSAC, then LM refinement.

Port of ``active_orb_slam2_tpu/models/sim3_solver.py`` (the reference's
``Sim3Solver`` and ``Optimizer::OptimizeSim3``).  All hypotheses are
sampled at once (Gumbel top-3 over the valid correspondences) and
solved by one batched 4x4 ``eigh``; the winner is refit by weighted
Horn.  The random numbers come in as an argument (``noise`` [n_hyp,
M]), so a caller can feed the JAX package's ``jax.random.gumbel``.
``optimize_sim3`` takes its Jacobian by ``torch.func.jacfwd`` where the
JAX package uses ``jax.jacfwd``, and its 7x7 solve is ``solve_ex``
without the error check, which would wait on the card.
"""

from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.geometry.horn import horn_align
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.geometry.se3 import (
    quat_rotate, sim3_apply, sim3_compose, sim3_exp, sim3_inverse)
from active_orb_slam2_tpu_torch.ops.topk import stable_topk

CHI2_SIM3 = 9.210     # the reference's maxError (99% chi2, 2 dof)
N_HYPOTHESES = 256


class Sim3Result(NamedTuple):
    sim3_ab: torch.Tensor    # [8] maps b-camera coords -> a-camera coords
    inliers: torch.Tensor    # [M] bool
    n_inliers: torch.Tensor  # int32
    ok: torch.Tensor         # bool


def gumbel_noise(n_hyp: int, m: int, generator, device):
    """The RANSAC's random numbers: Gumbel noise [n_hyp, m], -log(-log u)
    with u uniform in [tiny, 1), drawn from ``generator``."""
    u = torch.rand((n_hyp, m), generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(torch.float32).tiny)))


def _project(cam: CameraParams, pc):
    z = torch.where(pc[..., 2].abs() < 1e-9, 1e-9, pc[..., 2])
    return torch.stack([cam.fx * pc[..., 0] / z + cam.cx,
                        cam.fy * pc[..., 1] / z + cam.cy], dim=-1)


def _inliers(cam, q, t, s, xyz_a, xyz_b, uv_a, uv_b, sigma2_a, sigma2_b,
             valid):
    """Both-direction reprojection gate of hypotheses (q, t, s) with
    leading axes [...] against every correspondence: [..., M] bool."""
    pa = s[..., None, None] * quat_rotate(q[..., None, :], xyz_b) \
        + t[..., None, :]                                     # b -> a frame
    ra = _project(cam, pa) - uv_a
    e_a = (ra * ra).sum(-1) / sigma2_a
    si = 1.0 / torch.clamp(s, min=1e-9)
    qi = torch.cat([q[..., :1], -q[..., 1:]], -1)
    pb = si[..., None, None] * quat_rotate(qi[..., None, :],
                                           xyz_a - t[..., None, :])
    rb = _project(cam, pb) - uv_b
    e_b = (rb * rb).sum(-1) / sigma2_b
    return valid & (e_a < CHI2_SIM3) & (e_b < CHI2_SIM3) \
        & (pa[..., 2] > 0) & (pb[..., 2] > 0)


def sim3_ransac(noise, cam: CameraParams, xyz_a, xyz_b, uv_a, uv_b,
                sigma2_a, sigma2_b, valid, fix_scale: bool = False,
                min_inliers: int = 20) -> Sim3Result:
    """S_ab (dst a, src b) from matched camera-frame points xyz_a/xyz_b
    [M, 3], their pixels uv_a/uv_b [M, 2] and level variances sigma2_*
    [M]; ``noise`` [n_hyp, M] picks each hypothesis's 3 correspondences
    (its top-3 valid entries).  The first hypothesis with the most
    inliers wins, then a weighted Horn refit on its inliers replaces it
    if that keeps at least as many."""
    g = torch.where(valid[None, :], noise, float("-inf"))
    _, picks = stable_topk(g, 3)                               # [n_hyp, 3]
    q, t, s = horn_align(xyz_b[picks], xyz_a[picks], fix_scale=fix_scale)
    args = (xyz_a, xyz_b, uv_a, uv_b, sigma2_a, sigma2_b, valid)
    inl = _inliers(cam, q, t, s, *args)                        # [n_hyp, M]
    counts = inl.sum(-1)
    best = torch.argmax(counts).view(1)                        # first max
    best_inl = inl.index_select(0, best)[0]
    qr, tr, sr = horn_align(xyz_b, xyz_a, weights=best_inl.to(torch.float32),
                            fix_scale=fix_scale)
    ref_inl = _inliers(cam, qr, tr, sr, *args)
    use_ref = ref_inl.sum() >= counts.index_select(0, best)[0]
    q_f = torch.where(use_ref, qr, q.index_select(0, best)[0])
    t_f = torch.where(use_ref, tr, t.index_select(0, best)[0])
    s_f = torch.where(use_ref, sr, s.index_select(0, best)[0])
    inl_f = torch.where(use_ref, ref_inl, best_inl)
    n = inl_f.sum().to(torch.int32)
    return Sim3Result(sim3_ab=torch.cat([q_f, t_f, s_f[None]]), inliers=inl_f,
                      n_inliers=n, ok=n >= min_inliers)


def optimize_sim3(cam: CameraParams, s_ab0, xyz_a, xyz_b, uv_a, uv_b,
                  sigma2_a, sigma2_b, valid, iters1: int = 5,
                  iters2: int = 10, fix_scale: bool = False,
                  chi2_th: float = 10.0, huber: float = 10.0 ** 0.5,
                  lam0: float = 1e-4):
    """``Optimizer::OptimizeSim3``: LM over the relative Sim3 with
    bidirectional projection residuals and a Huber kernel, ``iters1``
    iterations on every correspondence, the chi2 > 10 ones dropped, then
    ``iters2`` more.  ``s_ab0`` [8] is the start (Horn's estimate).
    Returns (s_ab [8], inliers [M], n_inliers int32)."""
    dev = xyz_a.device
    sd_a = torch.sqrt(sigma2_a)[:, None]
    sd_b = torch.sqrt(sigma2_b)[:, None]

    def residuals(delta, mask):
        """Pixel residuals [M, 4] (masked) and per-direction chi2 [M, 2]."""
        S = sim3_compose(sim3_exp(delta), s_ab0)
        ra = (_project(cam, sim3_apply(S, xyz_b)) - uv_a) / sd_a
        rb = (_project(cam, sim3_apply(sim3_inverse(S), xyz_a)) - uv_b) \
            / sd_b
        chi2 = torch.stack([(ra * ra).sum(-1), (rb * rb).sum(-1)], -1)
        return torch.where(mask[:, None], torch.cat([ra, rb], -1), 0.0), chi2

    def cost(d, mask):
        r, _ = residuals(d, mask)
        e2 = (r * r).sum(-1)
        e = torch.sqrt(torch.clamp(e2, min=1e-12))
        c = torch.where(e <= huber, 0.5 * e2, huber * (e - 0.5 * huber))
        return torch.where(mask, c, 0.0).sum()

    eye7 = torch.eye(7, device=dev)
    free7 = (torch.arange(7, device=dev) < (6 if fix_scale else 7)).to(
        torch.float32)

    def lm_phase(d, mask, n_iters):
        lam = torch.full((), lam0, device=dev)
        c_d = cost(d, mask)
        for _ in range(n_iters):
            def res(x):
                r = residuals(x, mask)[0]
                return r, r
            J, r = torch.func.jacfwd(res, has_aux=True)(d)
            e = torch.sqrt(torch.clamp((r * r).sum(-1), min=1e-12))
            w_h = torch.where(mask, torch.where(e <= huber, 1.0, huber / e),
                              0.0)
            H = torch.einsum("mri,m,mrj->ij", J, w_h, J)
            g = -torch.einsum("mri,m,mr->i", J, w_h, r)
            if fix_scale:
                # the scale dof clamped: identity row and column, no gradient
                H = H * free7[:, None] * free7[None, :] \
                    + torch.diag(1.0 - free7)
                g = g * free7
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye7
            step = torch.linalg.solve_ex(Hd, g[:, None],
                                         check_errors=False)[0][:, 0]
            cand = d + step
            c_cand = cost(cand, mask)
            better = c_cand <= c_d
            d = torch.where(better, cand, d)
            c_d = torch.where(better, c_cand, c_d)
            lam = torch.clamp(torch.where(better, lam * 0.5, lam * 10.0),
                              1e-9, 1e6)
        return d

    d1 = lm_phase(torch.zeros(7, device=dev), valid, iters1)
    _, chi2 = residuals(d1, valid)
    inl = valid & (chi2[:, 0] < chi2_th) & (chi2[:, 1] < chi2_th)
    d2 = lm_phase(d1, inl, iters2)
    _, chi2f = residuals(d2, inl)
    inl_f = inl & (chi2f[:, 0] < chi2_th) & (chi2f[:, 1] < chi2_th)
    s_out = sim3_compose(sim3_exp(d2), s_ab0)
    if fix_scale:
        s_out = torch.cat([s_out[:7], s_ab0[7:8]])
    return s_out, inl_f, inl_f.sum().to(torch.int32)
