"""Batched two-view DLT triangulation with a Gauss-Newton polish.

Port of ``active_orb_slam2_tpu/geometry/triangulation.py``.  The JAX
package takes the eigenvector of the smallest eigenvalue of the 4x4
DLT normal matrix from ``jnp.linalg.eigh``.  ``torch.linalg.eigh`` checks
its convergence flag on the host, which waits on the card, so the port
diagonalizes the batch of 4x4 matrices with a fixed number of cyclic
Jacobi sweeps in tensor ops (float64, then back to float32): the same
function, with the eigenvalues sorted ascending for the rank gate.  The
eigenvector's sign does not matter after the division by ``w``.

The intrinsics come from ``CameraParams`` (Python floats) instead of a
``K`` matrix.
"""

import torch

from active_orb_slam2_tpu_torch.geometry.linalg3 import solve3
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.geometry.se3 import se3_to_mat44

_PAIRS = ((0, 1), (2, 3), (0, 2), (1, 3), (0, 3), (1, 2))
JACOBI_SWEEPS = 6
REFINE_ITERS = 2          # Gauss-Newton polish steps


def _normalize_uv(cam: CameraParams, uv):
    """Pixels [..., 2] -> normalized camera coordinates."""
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def jacobi_eigh4(A):
    """Eigen-decomposition of a batch of symmetric 4x4 matrices [..., 4, 4]
    by cyclic Jacobi rotations.  Returns (vals [..., 4] ascending,
    vecs [..., 4, 4] with the eigenvectors as columns), in A's dtype."""
    A = A.clone()
    V = torch.eye(4, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(JACOBI_SWEEPS):
        for p, q in _PAIRS:
            app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
            nz = apq != 0
            theta = (aqq - app) / (2.0 * torch.where(nz, apq, 1.0))
            sgn = torch.where(theta >= 0, 1.0, -1.0).to(A.dtype)
            t = sgn / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(nz & torch.isfinite(t), t, 0.0)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            # A <- J^T A J, V <- V J for the rotation J in the (p, q) plane
            ap, aq = A[..., :, p].clone(), A[..., :, q].clone()
            A[..., :, p] = c[..., None] * ap - s[..., None] * aq
            A[..., :, q] = s[..., None] * ap + c[..., None] * aq
            ap, aq = A[..., p, :].clone(), A[..., q, :].clone()
            A[..., p, :] = c[..., None] * ap - s[..., None] * aq
            A[..., q, :] = s[..., None] * ap + c[..., None] * aq
            vp, vq = V[..., :, p].clone(), V[..., :, q].clone()
            V[..., :, p] = c[..., None] * vp - s[..., None] * vq
            V[..., :, q] = s[..., None] * vp + c[..., None] * vq
    vals = torch.diagonal(A, dim1=-2, dim2=-1)
    vals, order = torch.sort(vals, dim=-1, stable=True)
    vecs = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return vals, vecs


def triangulate_dlt(P1, P2, uv1, uv2):
    """Batched two-view DLT.  P1, P2 broadcastable to [..., 3, 4]; uv1,
    uv2 [..., 2].  Returns (xw [..., 3], ok [...])."""
    rows = [
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)   # [..., 4, 4]
    AtA = A.transpose(-1, -2) @ A
    vals, vecs = jacobi_eigh4(AtA.to(torch.float64))
    vals = vals.to(AtA.dtype)
    x = vecs[..., :, 0].to(AtA.dtype)                   # smallest eigenvalue
    w = x[..., 3]
    # a unique solution needs exactly one near-zero eigenvalue; a
    # zero-baseline system has a 2-D nullspace
    well_posed = vals[..., 1] > 1e-7 * torch.clamp(vals[..., 3], min=1e-12)
    ok = (w.abs() > 1e-9) & well_posed
    xw = x[..., :3] / torch.where(ok, w, 1.0)[..., None]
    return xw, ok & torch.isfinite(xw).all(-1)


def triangulate_pairs(cam: CameraParams, Tcw1, Tcw2, uv1, uv2):
    """Triangulate matched pixel pairs between two posed cameras, in
    normalized camera coordinates, polished by ``REFINE_ITERS``
    Gauss-Newton steps on the normalized reprojection error.

    Tcw* [7] or [..., 7]; uv* [..., 2].  Returns (xw [..., 3], ok [...]).
    """
    P1 = se3_to_mat44(Tcw1)[..., :3, :]
    P2 = se3_to_mat44(Tcw2)[..., :3, :]
    n1 = _normalize_uv(cam, uv1)
    n2 = _normalize_uv(cam, uv2)
    xw, ok = triangulate_dlt(P1, P2, n1, n2)
    eye3 = torch.eye(3, dtype=xw.dtype, device=xw.device)

    def res_jac(P, n, x):
        pc = (P[..., :3] @ x[..., None])[..., 0] + P[..., 3]
        z = pc[..., 2:3]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        r = pc[..., :2] / z - n
        zz = z[..., 0]
        zero = torch.zeros_like(zz)
        J_pc = torch.stack([
            torch.stack([1.0 / zz, zero, -pc[..., 0] / (zz * zz)], -1),
            torch.stack([zero, 1.0 / zz, -pc[..., 1] / (zz * zz)], -1),
        ], dim=-2)                                      # [..., 2, 3]
        return r, J_pc @ P[..., :3]

    for _ in range(REFINE_ITERS):
        r1, J1 = res_jac(P1, n1, xw)
        r2, J2 = res_jac(P2, n2, xw)
        r = torch.cat([r1, r2], dim=-1)                 # [..., 4]
        J = torch.cat([J1, J2], dim=-2)                 # [..., 4, 3]
        H = J.transpose(-1, -2) @ J + 1e-9 * eye3
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        xw = xw - solve3(H, g, eps=1e-30)
    return xw, ok & torch.isfinite(xw).all(-1)
