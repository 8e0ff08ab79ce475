"""Monocular map initialization: the homography / fundamental race.

Port of ``active_orb_slam2_tpu/models/initializer.py``
(``Initializer``): 200 8-point hypotheses of each model drawn at once
and scored against every match, the best of each refit twice by least
squares over its inliers, the model chosen by ``RH = SH / (SH + SF) >
0.40``, and the reconstruction: E = F in normalized coordinates
decomposed into 4 (R, t) candidates, H by Faugeras' SVD into 8, and
``CheckRT`` triangulating every match under all 12 candidates at once
and voting by depth, parallax and reprojection.

Coordinates are normalized by the intrinsics throughout.  The random
numbers come in as an argument (the Gumbel noise [n_hyp, M]), so a
caller can feed the JAX package's.

One difference in precision.  The JAX package solves the DLTs by a
float32 ``eigh``; the 8-point fundamental system is ill-conditioned in
float32, so two LAPACK builds (or cuSOLVER) elect differing hypotheses
and refits from the same data.  The port solves the 9x9 systems in
float64 (then rounds the eigenvector to float32), so the card and the
CPU agree; ``tests/test_torch_initializer.py`` gives the JAX package the
same float64 solve to compare the two.  The SVDs stay float32, as in the
JAX package: their sign choices permute the candidates, not the set.
``torch.linalg`` checks its solvers' results on the host, so an
initialization attempt waits on the card (the JAX package's waits at
``bool(ok)``).  ``H^-1`` is the closed-form adjugate inverse, which
gives non-finite scores, not an exception, for a singular hypothesis.
"""

from typing import NamedTuple

import math

import torch

from active_orb_slam2_tpu_torch.geometry.linalg3 import det3, inv3
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.geometry.se3 import mat_to_quat
from active_orb_slam2_tpu_torch.geometry.triangulation import triangulate_dlt
from active_orb_slam2_tpu_torch.ops.topk import stable_topk

SIGMA_PX = 1.0
N_HYPOTHESES = 200
MIN_SET = 8
MIN_TRIANGULATED = 80
MIN_PARALLAX_DEG = 1.0
RH_THRESHOLD = 0.40
N_REFITS = 2


class InitResult(NamedTuple):
    ok: torch.Tensor         # bool
    pose2: torch.Tensor      # [7] Tcw of frame 2 (frame 1 at identity)
    points: torch.Tensor     # [M, 3] triangulated world points
    point_ok: torch.Tensor   # [M] bool
    used_h: torch.Tensor     # bool: the homography won


def _smallest_eigvec(AtA):
    """Eigenvector of the smallest eigenvalue of [..., n, n] symmetric,
    solved in float64."""
    vec = torch.linalg.eigh(AtA.to(torch.float64)).eigenvectors[..., :, 0]
    return vec.to(AtA.dtype)


def _dlt_h(x1, x2, w=None):
    """Homography DLT x2 ~ H x1 over [..., S, 2] correspondences, with
    optional per-correspondence weights [..., S]; -> [..., 3, 3]."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u)
    z = torch.zeros_like(u)
    r1 = torch.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], -1)
    r2 = torch.stack([u, v, o, z, z, z, -up * u, -up * v, -up], -1)
    A = torch.cat([r1, r2], dim=-2)
    Aw = A if w is None else A * torch.cat([w, w], dim=-1)[..., None]
    vec = _smallest_eigvec(Aw.transpose(-1, -2) @ A)
    return vec.reshape(A.shape[:-2] + (3, 3))


def _dlt_f(x1, x2, w=None):
    """8-point fundamental DLT, projected to rank 2; optional weights."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, o], -1)
    Aw = A if w is None else A * w[..., None]
    F = _smallest_eigvec(Aw.transpose(-1, -2) @ A).reshape(
        A.shape[:-2] + (3, 3))
    U, s, Vh = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return U @ (s[..., None] * Vh)


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _h_score(H, x1, x2, valid, sigma2):
    """Symmetric transfer score (``CheckHomography``); (score [...],
    inlier mask [..., M])."""
    th = 5.991 * sigma2

    def transfer(H, a, b):
        p = _homogeneous(a) @ H.transpose(-1, -2)
        w = torch.where(p[..., 2:].abs() < 1e-12, 1e-12, p[..., 2:])
        return ((p[..., :2] / w - b) ** 2).sum(-1)

    e12 = transfer(H, x1, x2)
    e21 = transfer(inv3(H), x2, x1)
    ok = valid & (e12 < th) & (e21 < th)
    score = torch.where(valid & (e12 < th), th - e12, 0.0) + \
        torch.where(valid & (e21 < th), th - e21, 0.0)
    return score.sum(-1), ok


def _f_score(F, x1, x2, valid, sigma2):
    """Epipolar-distance score (``CheckFundamental``)."""
    th = 3.841 * sigma2
    th_score = 5.991 * sigma2
    p1, p2 = _homogeneous(x1), _homogeneous(x2)
    l2 = p1 @ F.transpose(-1, -2)                    # lines in image 2
    l1 = p2 @ F                                      # lines in image 1
    d2 = (p2 * l2).sum(-1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = (p1 * l1).sum(-1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    ok = valid & (d1 < th) & (d2 < th)
    score = torch.where(valid & (d1 < th), th_score - d1, 0.0) + \
        torch.where(valid & (d2 < th), th_score - d2, 0.0)
    return score.sum(-1), ok


def _unit(t):
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def _decompose_e(E):
    """E [3, 3] -> 4 (R, t) candidates: ([4, 3, 3], [4, 3])."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vh = Vh * torch.sign(det3(Vh))[..., None, None]
    # U W and U W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    u0, u1, u2 = U.unbind(-1)
    R1 = torch.stack([u1, -u0, u2], -1) @ Vh
    R2 = torch.stack([-u1, u0, u2], -1) @ Vh
    t = _unit(U[..., :, 2])
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _xz_matrix(a00, a02, a11: float, a20, a22):
    """[[a00, 0, a02], [0, a11, 0], [a20, 0, a22]], batched."""
    z = torch.zeros_like(a00)
    return torch.stack([torch.stack([a00, z, a02], -1),
                        torch.stack([z, torch.full_like(a00, a11), z], -1),
                        torch.stack([a20, z, a22], -1)], -2)


def _decompose_h(H):
    """Faugeras' SVD decomposition of a normalized homography [3, 3] ->
    8 (R, t) candidates: ([8, 3, 3], [8, 3])."""
    U, s, Vh = torch.linalg.svd(H)
    d1, d2, d3 = s[..., 0], s[..., 1], s[..., 2]
    detUV = det3(U) * det3(Vh)
    eps = 1e-9
    den = torch.clamp(d1 ** 2 - d3 ** 2, min=eps)
    x1 = torch.sqrt(torch.clamp((d1 ** 2 - d2 ** 2) / den, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 ** 2 - d3 ** 2) / den, min=0.0))
    root = torch.sqrt(torch.clamp((d1 ** 2 - d2 ** 2) * (d2 ** 2 - d3 ** 2),
                                  min=0.0))
    Rs, ts = [], []
    # d' = d2
    sin_t = root / torch.clamp((d1 + d3) * d2, min=eps)
    cos_t = (d2 ** 2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = _xz_matrix(cos_t, -st, 1.0, st, cos_t)
            tp = torch.stack([e1 * x1, torch.zeros_like(x1), -e3 * x3],
                             -1) * (d1 - d3)[..., None]
            Rs.append(detUV[..., None, None] * U @ Rp @ Vh)
            ts.append((U @ tp[..., None])[..., 0])
    # d' = -d2
    sin_p = root / torch.clamp((d1 - d3) * d2, min=eps)
    cos_p = (d1 * d3 - d2 ** 2) / torch.clamp((d1 - d3) * d2, min=eps)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = _xz_matrix(cos_p, sp, -1.0, sp, -cos_p)
            tp = torch.stack([e1 * x1, torch.zeros_like(x1), e3 * x3],
                             -1) * (d1 + d3)[..., None]
            Rs.append(detUV[..., None, None] * U @ Rp @ Vh)
            ts.append((U @ tp[..., None])[..., 0])
    return torch.stack(Rs), _unit(torch.stack(ts))


def _check_rt(R, t, x1, x2, valid, sigma2):
    """Triangulate every match under each candidate (R [C, 3, 3], t [C,
    3]) and vote (``CheckRT``); (good [C, M], xw [C, M, 3], cos parallax
    [C, M])."""
    C, M = R.shape[0], x1.shape[0]
    dev = R.device
    eye34 = torch.cat([torch.eye(3, device=dev), torch.zeros(3, 1, device=dev)],
                      -1)
    P2 = torch.cat([R, t[..., :, None]], -1)                 # [C, 3, 4]
    xw, okt = triangulate_dlt(eye34.expand(C, M, 3, 4),
                              P2[:, None].expand(C, M, 3, 4),
                              x1.expand(C, M, 2), x2.expand(C, M, 2))
    z1 = xw[..., 2]
    pc2 = xw @ R.transpose(-1, -2) + t[:, None]
    z2 = pc2[..., 2]
    o2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]      # centre 2
    r2 = xw - o2[:, None]
    cosp = (xw * r2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(xw, dim=-1)
        * torch.linalg.vector_norm(r2, dim=-1), min=1e-12)
    th = 4.0 * sigma2
    p1 = xw[..., :2] / torch.clamp(z1[..., None], min=1e-12)
    e1 = ((p1 - x1) ** 2).sum(-1)
    p2 = pc2[..., :2] / torch.clamp(z2[..., None], min=1e-12)
    e2 = ((p2 - x2) ** 2).sum(-1)
    good = (valid & okt & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < th) & (e2 < th))
    return good, xw, cosp


def warm_up_solvers(device, n_hyp: int = N_HYPOTHESES):
    """Run the initializer's solvers once at its shapes (the batched and
    the single float64 9x9 ``eigh``, the batched and the single 3x3
    ``svd``) on identity matrices, so that their one-time setup on the
    card is paid when the ``System`` is built, not by the first
    initialization attempt.  Waits on the card."""
    eye9 = torch.eye(9, dtype=torch.float64, device=device)
    eye3 = torch.eye(3, device=device)
    for a, b in ((eye9.expand(n_hyp, 9, 9), eye3.expand(n_hyp, 3, 3)),
                 (eye9, eye3)):
        torch.linalg.eigh(a)
        torch.linalg.svd(b)


def build_initializer(cam: CameraParams, n_hyp: int = N_HYPOTHESES,
                      min_triangulated: int = MIN_TRIANGULATED,
                      min_parallax_deg: float = MIN_PARALLAX_DEG):
    """Return ``(noise [n_hyp, M], uv1 [M, 2], uv2 [M, 2], valid [M]) ->
    InitResult``; ``noise`` is Gumbel noise (``sim3_solver.gumbel_noise``
    or the JAX package's ``jax.random.gumbel``)."""
    sigma_n = SIGMA_PX / cam.fx          # pixel sigma, normalized coords
    sigma2 = sigma_n * sigma_n
    cos_min = math.cos(math.radians(min_parallax_deg))

    def norm(uv):
        return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                            (uv[..., 1] - cam.cy) / cam.fy], -1)

    def initialize(noise, uv1, uv2, valid) -> InitResult:
        x1, x2 = norm(uv1), norm(uv2)
        M = x1.shape[0]
        g = torch.where(valid[None], noise, -math.inf)
        _, picks = stable_topk(g, MIN_SET)                   # 8-point sets
        Hs = _dlt_h(x1[picks], x2[picks])
        Fs = _dlt_f(x1[picks], x2[picks])
        h_scores, _ = _h_score(Hs, x1, x2, valid, sigma2)
        f_scores, _ = _f_score(Fs, x1, x2, valid, sigma2)
        bh = torch.argmax(h_scores).view(1)                  # first max wins
        bf = torch.argmax(f_scores).view(1)
        SH, SF = h_scores[bh][0], f_scores[bf][0]
        H, F = Hs[bh][0], Fs[bf][0]
        # least-squares refits over the inliers: the minimal model is too
        # noisy for CheckRT's gates
        for _ in range(N_REFITS):
            _, h_inl = _h_score(H, x1, x2, valid, sigma2)
            _, f_inl = _f_score(F, x1, x2, valid, sigma2)
            H = _dlt_h(x1, x2, h_inl.to(torch.float32))
            F = _dlt_f(x1, x2, f_inl.to(torch.float32))
        _, h_inl = _h_score(H, x1, x2, valid, sigma2)
        _, f_inl = _f_score(F, x1, x2, valid, sigma2)
        use_h = SH / torch.clamp(SH + SF, min=1e-12) > RH_THRESHOLD

        Rh, th_ = _decompose_h(H)
        Rf, tf = _decompose_e(F)
        R_all = torch.cat([Rh, Rf])
        t_all = torch.cat([th_, tf])
        inl = torch.where(use_h, h_inl, f_inl)
        good, xw, cosp = _check_rt(R_all, t_all, x1, x2, inl, sigma2)
        is_h_cand = torch.arange(12, device=x1.device) < 8
        cand_ok = torch.where(use_h, is_h_cand, ~is_h_cand)
        counts = torch.where(cand_ok, good.sum(-1), -1)
        best = torch.argmax(counts).view(1)                  # first max wins
        n_good = counts[best][0]
        # the runner-up must be clearly worse (secondBest < 0.75 best)
        second = torch.sort(counts).values[-2]
        # the parallax of the 50th best point must exceed the bound
        cosp_best = torch.where(good[best][0], cosp[best][0], 1.0)
        kth = torch.sort(cosp_best).values[min(50, M - 1)]
        ok = ((n_good >= min_triangulated) & (second < 0.75 * n_good)
              & (kth < cos_min))
        pose2 = torch.cat([mat_to_quat(R_all[best][0]), t_all[best][0]])
        return InitResult(ok=ok, pose2=pose2, points=xw[best][0],
                          point_ok=good[best][0], used_h=use_h)

    return initialize
