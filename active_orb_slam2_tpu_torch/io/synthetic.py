"""Synthetic RGB-D world: a textured box room rendered with exact depth.

The reference validates only on real datasets (SURVEY.md §4); none are
available in this environment, so this module provides a ground-truth
RGB-D sequence generator for end-to-end tests and benchmarks: a camera
moving inside an axis-aligned textured box, rendered by exact
ray/box intersection with a multi-scale blocky 3-D procedural texture
(sharp block edges everywhere -> dense FAST corners at every scale).

Rendering is pure numpy (host-side test fixture, not a hot path).  This
is a copy of ``active_orb_slam2_tpu/io/synthetic.py`` that renders the
same frames; the port keeps its own because the JAX module imports
``CameraParams`` from a module that imports jax.
"""

from typing import NamedTuple

import numpy as np

from active_orb_slam2_tpu_torch.geometry.projection import CameraParams


def _hash3(ix, iy, iz, seed):
    """Deterministic integer lattice hash -> [0, 1) floats."""
    h = (ix.astype(np.int64) * 73856093 ^ iy.astype(np.int64) * 19349663
         ^ iz.astype(np.int64) * 83492791 ^ np.int64(seed) * 2654435761)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).astype(np.float32) / 65535.0


def blocky_texture(p, seed: int = 0):
    """Multi-scale blocky value texture at world points p [..., 3]."""
    out = np.zeros(p.shape[:-1], dtype=np.float32)
    amp, total = 1.0, 0.0
    # band-limited: finest octave projects to >= ~8 px at working
    # distances, so descriptors stay stable under small view changes
    for octave, freq in enumerate((1.2, 2.4, 4.8)):
        q = np.floor(p * freq)
        out += amp * _hash3(q[..., 0], q[..., 1], q[..., 2], seed + octave)
        total += amp
        amp *= 0.6
    return out / total


class BoxWorld(NamedTuple):
    """Axis-aligned room [lo, hi] the camera flies inside, plus interior
    obstacle boxes [M, 2, 3] that give the scene real depth structure."""
    lo: np.ndarray
    hi: np.ndarray
    boxes: np.ndarray
    seed: int = 0


def default_world(n_boxes: int = 8, seed: int = 0) -> BoxWorld:
    rng = np.random.default_rng(seed + 99)
    centers = rng.uniform([-3.0, -2.2, 1.2], [3.0, 2.2, 3.6],
                          size=(n_boxes, 3))
    sizes = rng.uniform(0.3, 0.9, size=(n_boxes, 3))
    boxes = np.stack([centers - sizes / 2, centers + sizes / 2],
                     axis=1).astype(np.float32)
    return BoxWorld(lo=np.array([-4.0, -3.0, -4.0], np.float32),
                    hi=np.array([4.0, 3.0, 4.0], np.float32),
                    boxes=boxes, seed=seed)


def render_rgbd(world: BoxWorld, cam: CameraParams, Twc: np.ndarray,
                supersample: int = 2):
    """Render (gray [H, W] in 0..255, depth [H, W] metric) from
    camera-to-world pose Twc (4x4).

    Rays are cast through each subpixel (``supersample``^2 per pixel,
    box-filtered down — a crude camera PSF so block edges antialias
    like a real sensor); the first box intersection gives exact depth.
    """
    if supersample > 1:
        hi_cam = cam._replace(
            fx=cam.fx * supersample, fy=cam.fy * supersample,
            cx=(cam.cx + 0.5) * supersample - 0.5,
            cy=(cam.cy + 0.5) * supersample - 0.5,
            width=cam.width * supersample, height=cam.height * supersample)
        gray, depth = render_rgbd(world, hi_cam, Twc, supersample=1)
        s = supersample
        h, w = cam.height, cam.width
        gray = gray.reshape(h, s, w, s).mean(axis=(1, 3))
        depth = depth.reshape(h, s, w, s)[:, 0, :, 0]  # point-sample depth
        return gray.astype(np.float32), depth.astype(np.float32)

    h, w = cam.height, cam.width
    xs = (np.arange(w, dtype=np.float32) - cam.cx) / cam.fx
    ys = (np.arange(h, dtype=np.float32) - cam.cy) / cam.fy
    dirs_c = np.stack(np.broadcast_arrays(
        xs[None, :], ys[:, None], np.ones((h, w), np.float32)), axis=-1)
    R, t = Twc[:3, :3], Twc[:3, 3]
    dirs_w = dirs_c @ R.T                                  # [H, W, 3]
    origin = t[None, None, :]

    # slab method: for each axis, ray hits far wall at t = (bound - o)/d
    with np.errstate(divide="ignore", invalid="ignore"):
        t_hi = (world.hi[None, None] - origin) / dirs_w
        t_lo = (world.lo[None, None] - origin) / dirs_w
    t_far = np.where(dirs_w > 0, t_hi, t_lo)
    t_far = np.where(np.abs(dirs_w) < 1e-9, np.inf, t_far)
    t_hit = np.min(t_far, axis=-1)                         # [H, W]

    # interior obstacle boxes: entry-point intersection
    with np.errstate(divide="ignore"):
        inv_d = np.where(np.abs(dirs_w) < 1e-9, np.inf, 1.0 / dirs_w)
    for b in world.boxes:
        ta = (b[0][None, None] - origin) * inv_d
        tb = (b[1][None, None] - origin) * inv_d
        t_near = np.maximum.reduce(np.minimum(ta, tb), axis=-1)
        t_exit = np.minimum.reduce(np.maximum(ta, tb), axis=-1)
        hit = (t_near < t_exit) & (t_near > 1e-3)
        t_hit = np.where(hit & (t_near < t_hit), t_near, t_hit)

    hit_pts = origin + dirs_w * t_hit[..., None]

    gray = blocky_texture(hit_pts, world.seed) * 255.0
    depth = t_hit * 1.0  # dirs_c z-component is 1 -> t equals depth in cam z
    # depth along camera z: ray param times dir_c z (==1) in camera frame
    return gray.astype(np.float32), depth.astype(np.float32)


def orbit_trajectory(n_frames: int, radius: float = 1.2,
                     step_deg: float = 1.5):
    """Smooth trajectory: slow orbit + bobbing, looking roughly at -z
    wall. Returns list of Twc 4x4 (camera-to-world)."""
    poses = []
    for i in range(n_frames):
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
        poses.append(T)
    return poses


def loop_trajectory(n_frames: int, radius: float = 1.5):
    """Closed circle in the xz-plane with tangent heading (drives a loop
    and returns exactly to the start — the loop-closure fixture)."""
    poses = []
    for i in range(n_frames):
        th = 2.0 * np.pi * i / (n_frames - 1)
        pos = np.array([radius * np.sin(th), 0.0,
                        -radius * np.cos(th)], np.float32)
        fwd = np.array([np.cos(th), 0.0, np.sin(th)], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, up, fwd, pos
        poses.append(T)
    return poses


def tour_trajectory(n_frames: int, ax: float = 2.6, az: float = 2.6,
                    fx: float = 1.0, fz: float = 2.0):
    """Closed Lissajous tour through the room with tangent heading —
    covers far more viewpoint area than a circle (many distinct views,
    so keyframe culling cannot collapse the live set) and returns to
    the start, plus self-crossings mid-run.  The KITTI-00-shaped
    endurance fixture: distinct territory most of the time, genuine
    revisits at the crossings and the lap boundary."""
    poses = []
    for i in range(n_frames):
        t = 2.0 * np.pi * i / (n_frames - 1)
        pos = np.array([ax * np.sin(fx * t),
                        0.3 * np.sin(3.1 * t),
                        az * np.sin(fz * t) * 0.5], np.float32)
        # tangent direction (normalized velocity)
        vel = np.array([ax * fx * np.cos(fx * t),
                        0.0,
                        az * fz * np.cos(fz * t) * 0.5], np.float32)
        nv = np.linalg.norm(vel)
        fwd = vel / nv if nv > 1e-6 else np.array([0, 0, 1], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, up2, fwd, pos
        poses.append(T)
    return poses


def make_sequence(n_frames: int, cam: CameraParams, world=None,
                  trajectory=None, photo_noise: float = 0.0,
                  depth_noise: float = 0.0, seed: int = 7):
    """Generator of (gray, depth, Twc_gt) frames.

    Sensor-noise models for the hardened parity proxy (the real
    datasets are unreachable in this environment — SURVEY.md §6):

      * ``photo_noise``: additive Gaussian gray-level noise (sigma in
        0..255 units; ~2-4 for a decent camera).
      * ``depth_noise``: scale on a Kinect-style quadratic axial noise
        model, sigma(z) = 0.0012 + 0.0019 (z - 0.4)^2 metres
        (Khoshelham & Elberink 2012); 1.0 = realistic Kinect v1.
    """
    world = world or default_world()
    trajectory = trajectory or orbit_trajectory(n_frames)
    rng = np.random.default_rng(seed)
    for Twc in trajectory[:n_frames]:
        gray, depth = render_rgbd(world, cam, Twc)
        if photo_noise > 0.0:
            gray = gray + rng.normal(0.0, photo_noise, gray.shape)
            gray = np.clip(gray, 0.0, 255.0).astype(np.float32)
        if depth_noise > 0.0:
            sigma = depth_noise * (
                0.0012 + 0.0019 * np.square(depth - 0.4))
            depth = (depth + rng.normal(0.0, 1.0, depth.shape)
                     * sigma).astype(np.float32)
        yield gray, depth, Twc
