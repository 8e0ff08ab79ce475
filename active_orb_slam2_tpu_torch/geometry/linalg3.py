"""Closed-form 3x3 linear algebra.

Port of ``active_orb_slam2_tpu/geometry/linalg3.py``: the adjugate
inverse with the same optional floor on the determinant.  Batched 3x3
systems (the point blocks of the Schur step, the triangulation polish)
stay elementwise tensor ops, with no solver call that checks its result
on the host.
"""

import torch


def det3(m):
    """Batched determinant of [..., 3, 3] by cofactor expansion."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def inv3(A, eps: float = 0.0):
    """Batched closed-form inverse of [..., 3, 3] via the adjugate; a
    determinant smaller than ``eps`` in magnitude is replaced by
    +-``eps``."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    if eps:
        floor = torch.where(det < 0, -eps, eps).to(det.dtype)
        det = torch.where(det.abs() < eps, floor, det)
    # reciprocal, not 1.0 / det: under torch.func a 0-d det divided into
    # a Python float comes out float64
    idet = torch.reciprocal(det)
    adj = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2)
    return adj * idet[..., None, None]


def solve3(A, b, eps: float = 0.0):
    """Batched solve of [..., 3, 3] x = [..., 3] via the adjugate."""
    return (inv3(A, eps=eps) @ b[..., None])[..., 0]
