"""Horn's closed-form absolute orientation (the Sim3 RANSAC's solver).

Port of ``active_orb_slam2_tpu/geometry/horn.py::horn_align``: Horn's
1987 quaternion method, batched over leading axes, so the Sim3 RANSAC
solves all its hypotheses in one 4x4 ``eigh``.  The JAX module's
``umeyama_alignment`` (trajectory ATE) has its counterpart in the port's
numpy ``utils/evaluate.py::umeyama_alignment``, which is the one the
port keeps.

``torch.linalg.eigh`` raises on a non-finite matrix where JAX returns
NaN, so such systems are solved as the identity and their results set
to NaN.  Its error check waits on the card; the one caller,
``LoopCloser.compute_sim3``, waits for its verdict anyway.
"""

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
