"""Camera model: pinhole + stereo/RGB-D virtual-right projection, frustum.

Port of ``active_orb_slam2_tpu/geometry/projection.py``.  ``CameraParams``
is declared here again (same fields and defaults) because the JAX
module that declares it imports jax.
"""

import functools
from typing import NamedTuple

import torch

from active_orb_slam2_tpu_torch.geometry.se3 import (
    quat_conj, quat_rotate, se3_apply)


class CameraParams(NamedTuple):
    """Static pinhole intrinsics (undistorted coordinates).

    ``min_x``/``max_x``/``min_y``/``max_y`` are the undistorted image
    bounds; the sentinel -1 on a max means the raw image bound.
    """
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float          # baseline * fx (stereo/RGB-D); 0 for monocular
    width: int
    height: int
    min_x: float = 0.0
    max_x: float = -1.0
    min_y: float = 0.0
    max_y: float = -1.0

    def bounds(self):
        """Resolved (min_x, max_x, min_y, max_y) as plain floats."""
        return (float(self.min_x),
                float(self.max_x) if self.max_x >= 0 else float(self.width),
                float(self.min_y),
                float(self.max_y) if self.max_y >= 0 else float(self.height))

    @property
    def baseline(self):
        return self.bf / self.fx

    @property
    def K(self):
        """The 3x3 intrinsic matrix, float32 on the CPU."""
        return torch.tensor([[self.fx, 0.0, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)


def _safe_inv_z(z):
    return 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: CameraParams, pc):
    """Camera-frame points [..., 3] -> pixels [..., 2] and depth [...]."""
    z = pc[..., 2]
    inv_z = _safe_inv_z(z)
    u = cam.fx * pc[..., 0] * inv_z + cam.cx
    v = cam.fy * pc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(cam: CameraParams, pc):
    """Camera points [..., 3] -> (u, v, uR) [..., 3] and depth;
    uR = u - bf/z is the virtual right-image x-coordinate."""
    uv, z = project(cam, pc)
    ur = uv[..., 0] - cam.bf * _safe_inv_z(z)
    return torch.cat([uv, ur[..., None]], dim=-1), z


def backproject(cam: CameraParams, uv, depth):
    """Pixels [..., 2] and depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def predict_scale(dist, max_dist, scale_factor: float, n_levels: int):
    """Pyramid level a point should appear at from its viewing distance:
    ceil(log(max_dist / dist) / log(scale_factor)), clipped."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-9), min=1e-9)
    level = torch.ceil(torch.log(ratio) / _log_f32(scale_factor, dist.device))
    return torch.clamp(level, 0, n_levels - 1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _log_f32(x: float, device: torch.device):
    """log of float32(x) in float32, as ``jnp.log(x)`` gives it, as a
    tensor on ``device`` (a tensor divisor keeps true division on the
    card, where a Python-scalar divisor becomes a reciprocal multiply).
    Made once per device: a device scalar made from a Python float is a
    host-to-device copy that waits on the stream."""
    return torch.log(torch.tensor(x, dtype=torch.float32)).to(device)


def in_frustum(cam: CameraParams, Tcw, pw, normal, min_dist, max_dist,
               view_cos_limit: float = 0.5, margin: float = 0.0):
    """Vectorized ``Frame::isInFrustum`` over the point arena.

    ``Tcw`` is one pose [7], or poses [..., 1, 7] that broadcast against
    the points [N] (the active layer's scorer passes [Q, 1, 7]).
    Returns (visible [..., N] bool, uv [..., N, 2], depth, dist and
    view_cos [..., N]).
    """
    pc = se3_apply(Tcw, pw)
    uv, z = project(cam, pc)
    ow = -quat_rotate(quat_conj(Tcw[..., :4]), Tcw[..., 4:7])
    po = pw - ow
    dist = torch.linalg.vector_norm(po, dim=-1)
    view_cos = (po * normal).sum(-1) / torch.clamp(dist, min=1e-9)

    x0, x1, y0, y1 = cam.bounds()
    ok = z > 0.0
    ok &= (uv[..., 0] >= x0 - margin) & (uv[..., 0] < x1 + margin)
    ok &= (uv[..., 1] >= y0 - margin) & (uv[..., 1] < y1 + margin)
    ok &= (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    ok &= view_cos > view_cos_limit
    return ok, uv, z, dist, view_cos
