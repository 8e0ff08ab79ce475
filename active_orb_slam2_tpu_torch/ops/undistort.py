"""Keypoint undistortion: fixed-point inverse of the radtan model.

Port of ``active_orb_slam2_tpu/ops/undistort.py`` (``undistort_points``
and ``compute_image_bounds``).  The inverse iterates
``(x, y) <- ((x_d - dx) / radial, (y_d - dy) / radial)`` from
``(x_d, y_d)``, the scheme ``cv::undistortPoints`` uses.
"""

import torch


def undistort_points(cam, dist, uv, iters: int = 8):
    """Distorted pixel coords [N, 2] -> undistorted pixel coords [N, 2];
    ``dist`` is the static (k1, k2, p1, p2, k3) tuple."""
    k1, k2, p1, p2, k3 = (float(v) for v in dist)
    x_d = (uv[:, 0] - cam.cx) / cam.fx
    y_d = (uv[:, 1] - cam.cy) / cam.fy
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
