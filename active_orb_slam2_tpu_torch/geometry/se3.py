"""SE(3) rigid and Sim(3) similarity transforms on flat tensors.

Port of ``active_orb_slam2_tpu/geometry/se3.py``.  Same representation:

* pose: 7-vector ``[qw, qx, qy, qz, tx, ty, tz]`` acting as
  ``x_out = R(q) @ x + t``; ``Tcw`` maps world -> camera.
* Sim3: 8-vector ``[qw, qx, qy, qz, tx, ty, tz, s]`` acting as
  ``x_out = s R x + t``.
* tangents: SE3 ``[omega(3), nu(3)]``, Sim3 ``[omega(3), nu(3), sigma]``.

All functions broadcast over leading axes; float32 throughout.  The
small-angle and small-scale branches are the reference's ``where``
selections, both sides computed, so that forward-mode derivatives
(``torch.func.jacfwd`` in the Sim3 solvers) take the selected side's.
"""

import torch

from active_orb_slam2_tpu_torch.geometry.linalg3 import solve3

_EPS = 1e-9


def quat_normalize(q):
    """Normalize quaternion(s) [..., 4]; guards the zero quaternion."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_mul(a, b):
    """Hamilton product a*b, both [..., 4] = [w, x, y, z]."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate v [..., 3] by q [..., 4]: v + 2 qv x (qv x v + qw v)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v, dim=-1) + qw * v
    return v + 2.0 * torch.linalg.cross(qv, uv, dim=-1)


def quat_to_mat(q):
    """Quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] with w >= 0.

    Branch-free Shepperd, as the JAX package: all four candidate
    quaternions (each scaled by 4 times a squared component), the one
    with the largest magnitude kept (first on ties), normalized, sign
    made canonical.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cand = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
    ], dim=-2)                                        # [..., 4 cand, 4]
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_from_axis_angle(axis, angle):
    """Unit axis [..., 3], angle [...] -> quaternion."""
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def _so3_exp(w):
    """so(3) vector [..., 3] -> quaternion, Taylor-safe near zero."""
    theta2 = (w * w).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(0.5 * theta))
    return torch.cat([cw, k * w], dim=-1)


def _so3_log(q):
    """Quaternion -> so(3) vector [..., 3]."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)       # w >= 0 branch
    qv = q[..., 1:]
    sin_half = torch.sqrt((qv * qv).sum(-1, keepdim=True))
    cos_half = q[..., :1]
    angle = 2.0 * torch.atan2(sin_half, cos_half)
    small = sin_half < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(cos_half, min=_EPS),
                        angle / torch.clamp(sin_half, min=_EPS))
    return scale * qv


def _hat(w):
    """[..., 3] -> skew matrix [..., 3, 3]."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        z, -w[..., 2], w[..., 1],
        w[..., 2], z, -w[..., 0],
        -w[..., 1], w[..., 0], z,
    ], dim=-1).reshape(w.shape[:-1] + (3, 3))


def _left_jacobian_so3(w):
    """SO(3) left Jacobian J_l(w) [..., 3, 3] (Taylor-safe)."""
    theta2 = (w * w).sum(-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = _hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta2 * theta, min=_EPS))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * W2


def se3_identity(shape=(), device=None):
    out = torch.zeros(tuple(shape) + (7,), dtype=torch.float32, device=device)
    out[..., 0] = 1.0
    return out


def se3_compose(a, b):
    """(a*b)(x) = a(b(x)); both [..., 7]."""
    q = quat_mul(a[..., :4], b[..., :4])
    t = quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return torch.cat([quat_normalize(q), t], dim=-1)


def se3_inverse(p):
    qi = quat_conj(p[..., :4])
    ti = -quat_rotate(qi, p[..., 4:7])
    return torch.cat([qi, ti], dim=-1)


def se3_apply(p, x):
    """Apply pose [..., 7] to point(s) [..., 3]."""
    return quat_rotate(p[..., :4], x) + p[..., 4:7]


def se3_exp(delta):
    """Twist [..., 6] = [omega, nu] -> SE3 [..., 7] (exact exp map)."""
    w, v = delta[..., :3], delta[..., 3:6]
    q = _so3_exp(w)
    t = (_left_jacobian_so3(w) @ v[..., None])[..., 0]
    return torch.cat([q, t], dim=-1)


def se3_log(p):
    """SE3 [..., 7] -> twist [..., 6] = [omega, nu]."""
    w = _so3_log(p[..., :4])
    v = solve3(_left_jacobian_so3(w), p[..., 4:7], eps=1e-30)
    return torch.cat([w, v], dim=-1)


def se3_retract(p, delta):
    """Left-multiplicative update exp(delta) * p."""
    return se3_compose(se3_exp(delta), p)


def se3_to_mat44(p):
    R = quat_to_mat(p[..., :4])
    t = p[..., 4:7]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # built on the device: a tensor from a Python list would be a
    # host-to-device copy that waits on the stream
    bottom = torch.zeros(p.shape[:-1] + (1, 4), dtype=p.dtype,
                         device=p.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mat44_to_se3(m):
    return torch.cat([mat_to_quat(m[..., :3, :3]), m[..., :3, 3]], dim=-1)


# ---------------------------------------------------------------------- Sim(3)

def sim3_identity(shape=(), device=None):
    out = torch.zeros(tuple(shape) + (8,), dtype=torch.float32, device=device)
    out[..., 0] = 1.0
    out[..., 7] = 1.0
    return out


def sim3_from_se3(p, s=None):
    """SE3 [..., 7] (+ optional scale [...]) -> Sim3 [..., 8]."""
    if s is None:
        s = torch.ones_like(p[..., 0])
    return torch.cat([p, s[..., None]], dim=-1)


def sim3_to_se3(g):
    """Drop the scale, translation divided by it (``Tiw = [R, t/s]``, the
    reference's recovery after the essential graph)."""
    return torch.cat([g[..., :4], g[..., 4:7] / torch.clamp(g[..., 7:8],
                                                            min=_EPS)], dim=-1)


def sim3_apply(g, x):
    """x' = s R x + t."""
    return g[..., 7:8] * quat_rotate(g[..., :4], x) + g[..., 4:7]


def sim3_compose(a, b):
    """(a*b)(x) = a(b(x)): R = Ra Rb, s = sa sb, t = sa Ra tb + ta."""
    q = quat_normalize(quat_mul(a[..., :4], b[..., :4]))
    s = a[..., 7:8] * b[..., 7:8]
    t = a[..., 7:8] * quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return torch.cat([q, t, s], dim=-1)


def sim3_inverse(g):
    qi = quat_conj(g[..., :4])
    si = 1.0 / torch.clamp(g[..., 7:8], min=_EPS)
    ti = -si * quat_rotate(qi, g[..., 4:7])
    return torch.cat([qi, ti, si], dim=-1)


def sim3_exp(delta):
    """Sim3 tangent [..., 7] = [omega, nu, sigma] -> Sim3 [..., 8], with
    the exact W-matrix form of g2o's sim3.h: t = W(omega, sigma) nu,
    s = exp(sigma)."""
    w, v, sig = delta[..., :3], delta[..., 3:6], delta[..., 6]
    s = torch.exp(sig)
    t = (_sim3_w(w, sig, s) @ v[..., None])[..., 0]
    return torch.cat([_so3_exp(w), t, s[..., None]], dim=-1)


def _sim3_w(w, sig, s):
    """The W matrix [..., 3, 3] of omega [..., 3], sigma [...] and s =
    exp(sigma), its coefficients at their limits where sigma or theta is
    tiny."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = _hat(w)
    W2 = W @ W
    sig_ = sig[..., None, None]
    s_ = s[..., None, None]
    th_ = theta[..., None, None]
    th2_ = theta2[..., None, None]
    small_sig = sig_.abs() < 1e-5
    small_th = th2_ < 1e-8

    # coefficients of I, W and W^2
    A = torch.where(small_sig, 1.0 + sig_ / 2.0,
                    (s_ - 1.0) / torch.where(small_sig, 1.0, sig_))
    denom = torch.clamp(sig_ * sig_ + th2_, min=_EPS)
    sin_t, cos_t = torch.sin(th_), torch.cos(th_)
    Bg = (s_ * sin_t * sig_ + (1.0 - s_ * cos_t) * th_) / (th_ * denom)
    Cg = (A - ((s_ * cos_t - 1.0) * sig_ + s_ * sin_t * th_) / denom) \
        / torch.clamp(th2_, min=_EPS)
    B0 = (1.0 - cos_t) / torch.clamp(th2_, min=_EPS)
    C0 = (th_ - sin_t) / torch.clamp(th2_ * th_, min=_EPS)
    B = torch.where(small_sig, B0, Bg)
    C = torch.where(small_sig, C0, Cg)
    sig_safe = torch.where(small_sig, 1.0, sig_)
    Bt = torch.where(small_sig, 0.5 + sig_ / 3.0,
                     (s_ * sig_ - s_ + 1.0) / (sig_safe * sig_safe))
    Ct = torch.where(small_sig, 1.0 / 6.0 + sig_ / 8.0,
                     (s_ * (sig_ * sig_ - 2.0 * sig_ + 2.0) - 2.0)
                     / (2.0 * sig_safe ** 3))
    B = torch.where(small_th, Bt, B)
    C = torch.where(small_th, Ct, C)

    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return A * eye + B * W + C * W2


def sim3_log(g):
    """Sim3 [..., 8] -> tangent [..., 7]: omega and sigma in closed form,
    nu from the 3x3 W system.  (The JAX package builds W's columns by
    sim3_exp on the unit nu, W e_i, which is W's column exactly.)"""
    w = _so3_log(g[..., :4])
    sig = torch.log(torch.clamp(g[..., 7], min=_EPS))
    v = solve3(_sim3_w(w, sig, torch.exp(sig)), g[..., 4:7], eps=1e-30)
    return torch.cat([w, v, sig[..., None]], dim=-1)
