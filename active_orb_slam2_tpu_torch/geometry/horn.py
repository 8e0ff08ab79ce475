"""Horn's closed-form absolute orientation (the Sim3 RANSAC's solver)
and the trajectory alignment of ATE.

Port of ``active_orb_slam2_tpu/geometry/horn.py``.  ``horn_align`` is
Horn's 1987 quaternion method, batched over leading axes, so the Sim3
RANSAC solves all its hypotheses in one 4x4 ``eigh``.
``umeyama_alignment`` aligns two trajectories' positions for ATE; it
runs on the host in float64 numpy (Umeyama's SVD solution, the same
least-squares optimum as Horn's method) and returns the rotation as a
matrix where the JAX function returns a quaternion.

``torch.linalg.eigh`` raises on a non-finite matrix where JAX returns
NaN, so such systems are solved as the identity and their results set
to NaN.  Its error check waits on the card; the one caller,
``LoopCloser.compute_sim3``, waits for its verdict anyway.
"""

import numpy as np
import torch

from active_orb_slam2_tpu_torch.geometry.se3 import quat_rotate


def horn_align(src, dst, weights=None, fix_scale: bool = False):
    """Closed-form similarity transform dst ~ s R(q) src + t.

    Args: src, dst [..., N, 3]; weights [..., N] non-negative (optional);
      ``fix_scale`` for stereo / RGB-D (s = 1).
    Returns (q [..., 4], t [..., 3], s [...]).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    wn = weights / wsum
    mu_s = (wn[..., None] * src).sum(-2)
    mu_d = (wn[..., None] * dst).sum(-2)
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    # weighted correlation S_ab = sum w cs_a cd_b (Horn's l = src, r = dst)
    M = torch.einsum("...n,...ni,...nj->...ij", wn, cs, cd)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
        Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
        Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
        Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz,
    ], dim=-1).reshape(M.shape[:-2] + (4, 4))
    finite = torch.isfinite(N).all(-1).all(-1)
    eye = torch.eye(4, dtype=N.dtype, device=N.device)
    _, vecs = torch.linalg.eigh(torch.where(finite[..., None, None], N, eye))
    q = vecs[..., :, -1]                                  # largest eigenvalue
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    q = torch.where(finite[..., None], q, float("nan"))

    rs = quat_rotate(q[..., None, :], cs)
    if fix_scale:
        s = torch.ones(q.shape[:-1], dtype=src.dtype, device=src.device)
    else:
        num = (wn * (cd * rs).sum(-1)).sum(-1)
        den = torch.clamp((wn * (rs * rs).sum(-1)).sum(-1), min=1e-12)
        s = num / den
    t = mu_d - s[..., None] * quat_rotate(q, mu_s)
    return q, t, s


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
