"""Trajectory evaluation: ATE after Umeyama alignment (numpy).

The counterpart of ``active_orb_slam2_tpu/utils/evaluate.py`` and of
``geometry/horn.py::umeyama_alignment``, in numpy so that the port can
score a run with no JAX installed.  The alignment is Umeyama's SVD
solution, the same least-squares optimum as Horn's quaternion method.
"""

import numpy as np


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

