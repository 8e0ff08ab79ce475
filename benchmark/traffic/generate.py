"""The general traffic generator: reads a traffic mix's data file
(``benchmark/workloads/<traffic>.json``) and makes, on the device, every
frame that a run can hand in, with its ground-truth pose.

The mix fixes the world, the path (``loop``, ``orbit`` or ``tour``: the
circle, the orbit and the Lissajous tour of ``io/synthetic.py``) and its
speed, the order in which the path is driven, the render, the sensor
noise, the warm-up and the mode.
``--seed`` draws the sensor noise of every frame and, on a path driven
``forward``, the starting point: one of the mix's ``start_points``
points spaced evenly around the lap.  A ``sweep`` maps the path's poses
in order in the warm-up, then drives back and forth over them; it starts
where the warm-up ended, so every seed sends the same frames in the
same order, with its own noise.
"""

from typing import NamedTuple

import numpy as np
import torch

from benchmark.traffic import world as W

CHUNK = 16          # frames rendered in one call


class Traffic(NamedTuple):
    images: tuple          # host uint8 [N, H, W] (and the right image or
                           # uint16 depth [N, H, W])
    twc: np.ndarray        # [N, 4, 4] ground truth, camera to world
    timestamps: np.ndarray  # [N] seconds of camera time
    start: int             # first frame's index on the path
    world: W.World


def frames_needed(mix, fps, seconds):
    """Warm-up, the longest window at the camera's rate, and the traced
    stretch after it."""
    return (int(mix["warmup"]["frames"]) + int(np.ceil(fps * seconds)) + 1
            + int(mix["profile_frames"]))


def cycle(path):
    """Distinct poses of the path: a lap of the loop or of the tour, or
    the orbit's frames."""
    return int(path["frames_per_lap"] if path["kind"] in ("loop", "tour")
               else path["frames"])


def start_index(mix, seed):
    """The seed's starting point on a path driven forward: one of the
    path's ``start_points`` points spaced evenly around the lap; a sweep
    starts at its first pose."""
    path = mix["path"]
    if path.get("order", "forward") == "sweep":
        return 0
    lap = cycle(path)
    n = int(path["start_points"])
    k = int(np.random.default_rng(int(seed) % (2 ** 63)).integers(n))
    return k * (lap // n)


def path_indices(mix, seed, n_frames):
    """The path pose of each frame handed in."""
    path = mix["path"]
    m = cycle(path)
    k = np.arange(n_frames)
    if path.get("order", "forward") == "sweep":
        k = k % (2 * (m - 1))
        return np.where(k < m, k, 2 * (m - 1) - k)
    return (start_index(mix, seed) + k) % m


def poses(path, idx, scale):
    """Camera-to-world [len(idx), 4, 4] of the path's poses ``idx``; the
    path's sizes are multiplied by the world's ``scale``."""
    if path["kind"] == "tour":
        twc = W.tour_poses(idx, cycle(path), float(path["ax_m"]),
                           float(path["az_m"]), float(path["fx"]),
                           float(path["fz"]))
        twc[:, :3, 3] *= np.float32(scale)
        return twc
    r = float(path["radius_m"]) * scale
    if path["kind"] == "loop":
        return W.loop_poses(idx, cycle(path), r)
    return W.orbit_poses(idx, r, float(path["step_deg"]))


def _gen(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make(mix, cam, fps, sensor, seed, n_frames, device):
    """Render ``n_frames`` frames of the mix for ``cam`` (a settings
    camera: fx fy cx cy bf width height dist) at ``fps`` frames a second
    of camera time on ``device``, and copy them to the host.  Each
    distinct pose is rendered once; the noise is drawn for every frame."""
    wd, path, rnd, noise = (mix["world"], mix["path"], mix["render"],
                            mix["noise"])
    scale = float(wd.get("scale", 1.0))
    world = W.box_world(int(wd["n_boxes"]), int(wd.get("world_seed", 0)),
                        scale)
    idx = path_indices(mix, seed, n_frames)
    twc = poses(path, idx, scale)
    uniq, inv = np.unique(idx, return_inverse=True)
    base = poses(path, uniq, scale)
    gen = _gen(seed, device)
    ss = int(rnd["supersample"])
    warp = W.Warp(cam, cam.dist, device) if rnd.get("lens") else None
    h, w = cam.height, cam.width
    ideal = []
    for i in range(0, len(uniq), CHUNK):
        t = torch.from_numpy(base[i:i + CHUNK]).to(device)
        if sensor == "stereo":
            t_r = t.clone()
            t_r[:, :3, 3] += t[:, :3, 0] * float(cam.bf / cam.fx)
            ideal.append((W.render(world, cam, t, ss)[0],
                          W.render(world, cam, t_r, ss)[0]))
        else:
            g, d = W.render(world, cam, t, ss)
            if warp is not None:
                g, d = warp(g).float(), warp(d).float()
            ideal.append((g, d))
    first_all = torch.cat([a for a, _ in ideal])
    second_all = torch.cat([b for _, b in ideal])
    del ideal
    first = np.empty((n_frames, h, w), np.uint8)
    second = np.empty((n_frames, h, w),
                      np.uint8 if sensor == "stereo" else np.uint16)
    inv_t = torch.from_numpy(inv).to(device)
    for i in range(0, n_frames, CHUNK):
        sel = inv_t[i:i + CHUNK]
        a = W.photo_noise(first_all[sel], noise["photo_sigma"], gen)
        first[i:i + CHUNK] = W.to_uint8(a).cpu().numpy()
        if sensor == "stereo":
            b = W.photo_noise(second_all[sel], noise["photo_sigma"], gen)
            second[i:i + CHUNK] = W.to_uint8(b).cpu().numpy()
        else:
            b = W.kinect_noise(second_all[sel], noise["depth_kinect_scale"],
                               gen)
            second[i:i + CHUNK] = W.to_mm(b).cpu().numpy().astype(np.uint16)
    return Traffic(images=(first, second), twc=twc,
                   timestamps=np.arange(n_frames) / fps, start=int(idx[0]),
                   world=world)
