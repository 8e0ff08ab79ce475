"""The synthetic box world on the device: the room, its blocky 3-D
texture, exact ray casting of gray and depth, the camera paths, the lens
warp and the sensor noise.

A PyTorch copy of the program's ``io/synthetic.py`` (``default_world``,
``blocky_texture``, ``render_rgbd``, ``loop_trajectory``,
``orbit_trajectory``, ``tour_trajectory``, ``make_sequence``'s noise
models) and ``ops/undistort.py``'s warp of an
ideal image into a radtan lens, made to render hundreds of frames on the
card in a few large calls.  ``scale`` multiplies the world, the path and
the texture's cell size alike, so a scaled world seen by a camera with
a baseline scaled the same gives the unscaled world's images.
"""

from typing import NamedTuple

import numpy as np
import torch

OCTAVE_FREQS = (1.2, 2.4, 4.8)


class World(NamedTuple):
    lo: np.ndarray       # [3] room corner
    hi: np.ndarray       # [3]
    boxes: np.ndarray    # [M, 2, 3] obstacle boxes
    seed: int            # texture hash seed
    scale: float         # texture cell scale


def box_world(n_boxes=8, seed=0, scale=1.0) -> World:
    """``io/synthetic.py::default_world`` scaled by ``scale``."""
    rng = np.random.default_rng(seed + 99)
    centers = rng.uniform([-3.0, -2.2, 1.2], [3.0, 2.2, 3.6],
                          size=(n_boxes, 3))
    sizes = rng.uniform(0.3, 0.9, size=(n_boxes, 3))
    boxes = np.stack([centers - sizes / 2, centers + sizes / 2],
                     axis=1).astype(np.float32)
    s = np.float32(scale)
    return World(lo=np.array([-4.0, -3.0, -4.0], np.float32) * s,
                 hi=np.array([4.0, 3.0, 4.0], np.float32) * s,
                 boxes=boxes * s, seed=seed, scale=float(scale))


def loop_poses(idx, frames_per_lap, radius):
    """Camera-to-world [len(idx), 4, 4] float32 of
    ``io/synthetic.py::loop_trajectory``'s circle in the xz-plane with a
    tangent heading; frame i is at angle 2 pi i / frames_per_lap."""
    out = []
    for i in idx:
        th = 2.0 * np.pi * i / frames_per_lap
        pos = np.array([radius * np.sin(th), 0.0, -radius * np.cos(th)],
                       np.float32)
        fwd = np.array([np.cos(th), 0.0, np.sin(th)], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, up, fwd, pos
        out.append(T)
    return np.stack(out)


def orbit_poses(idx, radius, step_deg):
    """Camera-to-world [len(idx), 4, 4] float32 of
    ``io/synthetic.py::orbit_trajectory``: an orbit of ``step_deg`` a
    frame with bobbing, yaw and pitch, looking along +z."""
    out = []
    for i in idx:
        a = np.deg2rad(step_deg * i)
        pos = np.array([radius * np.sin(a), 0.4 * np.sin(2.3 * a),
                        radius * (np.cos(a) - 1.0) * 0.5], np.float32)
        yaw = 0.25 * np.sin(a * 1.7)
        pitch = 0.1 * np.sin(a * 0.9)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = pos
        out.append(T)
    return np.stack(out)


def tour_poses(idx, frames_per_lap, ax, az, fx, fz):
    """Camera-to-world [len(idx), 4, 4] float32 of
    ``io/synthetic.py::tour_trajectory(frames_per_lap, ax, az, fx, fz)``:
    a Lissajous figure through the room with a tangent heading and a
    0.3 m bob; frame i is at t = 2 pi i / (frames_per_lap - 1), so the
    lap's last frame is back at the first one's x and z, not its
    height."""
    out = []
    for i in idx:
        t = 2.0 * np.pi * i / (frames_per_lap - 1)
        pos = np.array([ax * np.sin(fx * t), 0.3 * np.sin(3.1 * t),
                        az * np.sin(fz * t) * 0.5], np.float32)
        vel = np.array([ax * fx * np.cos(fx * t), 0.0,
                        az * fz * np.cos(fz * t) * 0.5], np.float32)
        nv = np.linalg.norm(vel)
        fwd = vel / nv if nv > 1e-6 else np.array([0, 0, 1], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, up2, fwd, pos
        out.append(T)
    return np.stack(out)


def _hash3(ix, iy, iz, seed):
    h = (ix.to(torch.int64) * 73856093 ^ iy.to(torch.int64) * 19349663
         ^ iz.to(torch.int64) * 83492791 ^ int(seed) * 2654435761)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.float32) / 65535.0


def texture(p, seed, scale):
    out = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    amp, total = 1.0, 0.0
    for octave, freq in enumerate(OCTAVE_FREQS):
        q = torch.floor(p * float(freq / scale))
        out += amp * _hash3(q[..., 0], q[..., 1], q[..., 2], seed + octave)
        total += amp
        amp *= 0.6
    return out / total


def _cast(world, fx, fy, cx, cy, width, height, twc):
    """Gray and depth [B, H, W] of one ray a pixel, poses twc [B, 4, 4]."""
    dev = twc.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) - cx) / fx
    ys = (torch.arange(height, dtype=torch.float32, device=dev) - cy) / fy
    dirs_c = torch.stack(torch.broadcast_tensors(
        xs[None, :], ys[:, None],
        torch.ones((height, width), dtype=torch.float32, device=dev)), -1)
    R, t = twc[:, :3, :3], twc[:, :3, 3]
    dirs = torch.einsum("hwj,bij->bhwi", dirs_c, R)          # [B, H, W, 3]
    origin = t[:, None, None, :]
    lo = torch.as_tensor(world.lo, device=dev)
    hi = torch.as_tensor(world.hi, device=dev)
    t_far = torch.where(dirs > 0, (hi - origin) / dirs, (lo - origin) / dirs)
    t_far = torch.where(dirs.abs() < 1e-9, float("inf"), t_far)
    t_hit = t_far.amin(-1)
    inv_d = torch.where(dirs.abs() < 1e-9, float("inf"), 1.0 / dirs)
    for b in world.boxes:
        b0 = torch.as_tensor(b[0], device=dev)
        b1 = torch.as_tensor(b[1], device=dev)
        ta = (b0 - origin) * inv_d
        tb = (b1 - origin) * inv_d
        t_near = torch.minimum(ta, tb).amax(-1)
        t_exit = torch.maximum(ta, tb).amin(-1)
        hit = (t_near < t_exit) & (t_near > 1e-3)
        t_hit = torch.where(hit & (t_near < t_hit), t_near, t_hit)
    pts = origin + dirs * t_hit[..., None]
    return texture(pts, world.seed, world.scale) * 255.0, t_hit


def render(world, cam, twc, supersample=1):
    """(gray, depth) [B, H, W] float32 of ``io/synthetic.py::render_rgbd``
    for poses ``twc`` [B, 4, 4] (a tensor on the rendering device):
    ``supersample``^2 rays a pixel, box-filtered gray, point-sampled
    depth.  ``cam`` has fx, fy, cx, cy, width, height."""
    s = int(supersample)
    if s == 1:
        return _cast(world, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                     cam.height, twc)
    g, d = _cast(world, cam.fx * s, cam.fy * s, (cam.cx + 0.5) * s - 0.5,
                 (cam.cy + 0.5) * s - 0.5, cam.width * s, cam.height * s, twc)
    B, h, w = twc.shape[0], cam.height, cam.width
    g = g.reshape(B, h, s, w, s).mean(dim=(2, 4))
    return g, d.reshape(B, h, s, w, s)[:, :, 0, :, 0]


def undistort_grid(cam, dist, iters=8):
    """Source pixel [H*W, 2] (float32, on the CPU) of each pixel of the
    distorted image: the radtan inverse of ``ops/undistort.py``."""
    k1, k2, p1, p2, k3 = (float(v) for v in dist)
    ys, xs = np.mgrid[0:cam.height, 0:cam.width]
    uv = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1)
                          .astype(np.float32))
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
    return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], -1)


class Warp:
    """The bilinear warp of ideal images into the distorted camera, in
    float64, with its taps made once (``ops/undistort.py::
    distort_warp_image`` for a batch)."""

    def __init__(self, cam, dist, device):
        src = undistort_grid(cam, dist).to(torch.float64)
        h, w = cam.height, cam.width
        sx = torch.clamp(src[:, 0], 0, w - 1.001)
        sy = torch.clamp(src[:, 1], 0, h - 1.001)
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx_, fy_ = sx - x0, sy - y0
        x0, y0 = x0.long(), y0.long()
        self.idx = torch.stack([y0 * w + x0, y0 * w + x0 + 1,
                                (y0 + 1) * w + x0, (y0 + 1) * w + x0 + 1]
                               ).to(device)
        self.wts = torch.stack([(1 - fx_) * (1 - fy_), fx_ * (1 - fy_),
                                (1 - fx_) * fy_, fx_ * fy_]).to(device)
        self.shape = (h, w)

    def __call__(self, img):
        flat = img.reshape(img.shape[0], -1).to(torch.float64)
        out = sum(flat[:, self.idx[k]] * self.wts[k] for k in range(4))
        return out.reshape(img.shape[0], *self.shape)


def photo_noise(gray, sigma, gen):
    """Additive Gaussian gray-level noise, clipped to 0..255."""
    n = torch.randn(gray.shape, generator=gen, device=gray.device,
                    dtype=torch.float32)
    return torch.clamp(gray + n * sigma, 0.0, 255.0)


def kinect_noise(depth, scale, gen):
    """Kinect v1 axial noise, sigma(z) = 0.0012 + 0.0019 (z - 0.4)^2 m
    (Khoshelham and Elberink 2012), times ``scale``."""
    n = torch.randn(depth.shape, generator=gen, device=depth.device,
                    dtype=torch.float32)
    sigma = scale * (0.0012 + 0.0019 * torch.square(depth - 0.4))
    return depth + n * sigma


def to_uint8(gray):
    """``np.clip(g, 0, 255).astype(np.uint8)``: truncation."""
    return torch.clamp(gray, 0, 255).to(torch.uint8)


def to_mm(depth):
    """``np.clip(d * 1e3, 0, 65535).astype(np.uint16)``, held as int32
    on the device (the copy to the host makes it uint16)."""
    return torch.clamp(depth * 1e3, 0, 65535).to(torch.int32)

