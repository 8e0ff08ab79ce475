"""Keypoint undistortion: fixed-point inverse of the radtan model.

Port of ``active_orb_slam2_tpu/ops/undistort.py``.  The inverse iterates
``(x, y) <- ((x_d - dx) / radial, (y_d - dy) / radial)`` from
``(x_d, y_d)``, the scheme ``cv::undistortPoints`` uses.  The forward
model (``distort_normalized``) and the warp of an ideal image into the
distorted camera (``distort_warp_image``) make synthetic distorted
frames; neither is on the tracking path.
"""

import numpy as np
import torch


def distort_normalized(dist, x, y):
    """Forward radtan on normalized coordinates (numpy arrays or
    tensors): returns (x_d, y_d)."""
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return x_d, y_d


def undistort_points(cam, dist, uv, iters: int = 8):
    """Distorted pixel coords [N, 2] -> undistorted pixel coords [N, 2];
    ``dist`` is the static (k1, k2, p1, p2, k3) tuple."""
    k1, k2, p1, p2, k3 = (float(v) for v in dist)
    # tensor divisors: on the card a Python-scalar divisor becomes a
    # reciprocal multiply, which rounds otherwise than the CPU and JAX
    x_d = (uv[:, 0] - cam.cx) / torch.full_like(uv[:, 0], cam.fx)
    y_d = (uv[:, 1] - cam.cy) / torch.full_like(uv[:, 1], cam.fy)
    x, y = x_d, y_d
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x_d - dx) / radial
        y = (y_d - dy) / radial
    return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], dim=-1)


def compute_image_bounds(cam, dist):
    """Undistorted image bounds (min_x, max_x, min_y, max_y) from the
    four corners (``Frame::ComputeImageBounds``)."""
    if not any(float(v) != 0.0 for v in dist):
        return 0.0, float(cam.width), 0.0, float(cam.height)
    corners = torch.tensor([[0.0, 0.0], [cam.width, 0.0],
                            [0.0, cam.height], [cam.width, cam.height]],
                           dtype=torch.float32)
    und = undistort_points(cam, dist, corners).tolist()
    return (min(und[0][0], und[2][0]), max(und[1][0], und[3][0]),
            min(und[0][1], und[1][1]), max(und[2][1], und[3][1]))


def distort_warp_image(cam, dist, img):
    """A distorted view of the ideal pinhole image ``img`` [H, W] (numpy):
    output pixel p samples the source at undistort(p), bilinearly, in
    float64 on the host.  The undistortion runs on a float32 CPU
    tensor, as the JAX function's runs in float32."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    uv = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], axis=-1)
                          .astype(np.float32))
    src = undistort_points(cam, dist, uv).numpy().astype(np.float64)
    sx = np.clip(src[:, 0], 0, w - 1.001)
    sy = np.clip(src[:, 1], 0, h - 1.001)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx_ = sx - x0
    fy_ = sy - y0
    im = img.astype(np.float64)
    out = (im[y0, x0] * (1 - fx_) * (1 - fy_)
           + im[y0, x0 + 1] * fx_ * (1 - fy_)
           + im[y0 + 1, x0] * (1 - fx_) * fy_
           + im[y0 + 1, x0 + 1] * fx_ * fy_)
    return out.reshape(h, w)
