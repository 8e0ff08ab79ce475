"""The device renderer against the program's numpy renderer, the lens
warp, the scaled stereo circuit, the paths against the program's and
against their formulas as first written, and the seeding of the
traffic.

The texture is a hash of ``floor(p * freq)`` of the hit point, so a
pixel whose ray hits within rounding of a block edge may take the
neighbouring block's value when the hit point is computed by another
sequence of float32 operations (an einsum against numpy's matmul);
everywhere else the two renderers agree to rounding.  So the gray
images are held to rounding on all but a small share of pixels.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import settings
from benchmark.traffic import generate
from benchmark.traffic import world as W

# share of pixels allowed to take a neighbouring texture block
EDGE_SHARE = 0.005


def small_cam(fx=129.3, fy=129.1, cx=79.6, cy=63.8, w=160, h=120,
              bf=10.0, dist=(0.0,) * 5):
    return settings.Camera(fx, fy, cx, cy, bf, w, h, dist)


def program_render(world, cam, twc, ss):
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch.io.synthetic import BoxWorld, render_rgbd
    bw = BoxWorld(lo=world.lo, hi=world.hi, boxes=world.boxes,
                  seed=world.seed)
    c = CameraParams(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width,
                     cam.height)
    return render_rgbd(bw, c, twc, supersample=ss)


def off_share(a, b, atol):
    return float(np.mean(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64)) > atol))


@pytest.mark.parametrize("ss", [1, 2])
@pytest.mark.parametrize("n_boxes", [0, 8])
def test_render_matches_program_renderer(ss, n_boxes):
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, loop_trajectory)
    world = W.box_world(n_boxes, 0)
    pw = default_world(n_boxes)
    assert np.array_equal(world.boxes, pw.boxes)
    assert np.array_equal(world.lo, pw.lo) and np.array_equal(world.hi, pw.hi)
    cam = small_cam()
    idx = [0, 37, 400, 1111]
    twc = W.loop_poses(idx, 1704, 2.5)
    ref = loop_trajectory(1705, 2.5)
    for k, i in enumerate(idx):
        assert np.allclose(twc[k], ref[i], atol=1e-6)
    g, d = W.render(world, cam, torch.from_numpy(twc), ss)
    for k in range(len(idx)):
        pg, pd = program_render(world, cam, twc[k], ss)
        assert off_share(g[k].numpy(), pg, 1e-3) <= EDGE_SHARE
        # depth has no texture edge: rounding only
        assert np.allclose(d[k].numpy(), pd, rtol=1e-5)


def test_lens_warp_matches_program_warp():
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch.ops.undistort import distort_warp_image
    dist = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
    cam = small_cam(dist=dist)
    g, d = W.render(W.box_world(0, 0), cam,
                    torch.from_numpy(W.loop_poses([5], 1704, 2.5)), 2)
    warp = W.Warp(cam, dist, torch.device("cpu"))
    c = CameraParams(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width,
                     cam.height)
    for img in (g, d):
        mine = warp(img)[0].numpy()
        theirs = distort_warp_image(c, dist, img[0].numpy())
        assert np.allclose(mine, theirs, rtol=1e-12, atol=1e-9)


def test_scaled_circuit_gives_unscaled_stereo_images():
    """KITTI's baseline in the world scaled x4.476 against the repo's
    0.12 m baseline in the unscaled world: the same pair of images, but
    at texture edges (4.476 x 0.12 m is KITTI's 0.537 m to 0.03%)."""
    f = 707.0912 / 4
    cam = small_cam(fx=f, fy=f, cx=601.8873 / 4, cy=183.1104 / 4,
                    w=306, h=92, bf=379.8145 / 4)
    scale = 4.476
    pairs = []
    for s, base in ((1.0, 0.12), (scale, cam.bf / cam.fx)):
        world = W.box_world(0, 0, s)
        t_l = torch.from_numpy(W.loop_poses([0, 50, 100], 149, 2.5 * s))
        t_r = t_l.clone()
        t_r[:, :3, 3] += t_l[:, :3, 0] * float(base)
        pairs.append((W.render(world, cam, t_l)[0],
                      W.render(world, cam, t_r)[0]))
    for a, b in zip(pairs[0], pairs[1]):
        assert off_share(a.numpy(), b.numpy(), 1e-3) <= 0.02


def _mix(name):
    from benchmark.harness import definitions
    return definitions.mix(name)


@pytest.mark.parametrize("name,sensor", [("explore_loop", "rgbd"),
                                         ("localize_sweep", "rgbd"),
                                         ("revisit_laps", "stereo"),
                                         ("tour_verify", "rgbd")])
def test_seed_fixes_the_traffic(name, sensor):
    mix = _mix(name)
    mix["render"]["supersample"] = 1
    cam = small_cam(dist=(0.26, -0.95, -0.005, 0.003, 1.16)
                    if sensor == "rgbd" else (0.0,) * 5)
    dev = torch.device("cpu")
    big = 2 ** 31 + 12345
    a = generate.make(mix, cam, 30.0, sensor, big, 3, dev)
    b = generate.make(mix, cam, 30.0, sensor, big, 3, dev)
    c = generate.make(mix, cam, 30.0, sensor, big + 1, 3, dev)
    for x, y in zip(a.images, b.images):
        assert np.array_equal(x, y)
    assert a.start == b.start
    # the seed draws the sensor noise of every frame
    assert mix["noise"]["photo_sigma"] > 0
    assert not np.array_equal(a.images[0], c.images[0])
    assert a.images[0].dtype == np.uint8
    assert a.images[1].dtype == (np.uint8 if sensor == "stereo"
                                 else np.uint16)


@pytest.mark.parametrize("name", ["explore_loop", "revisit_laps",
                                  "tour_verify"])
def test_seed_draws_the_start_of_a_forward_path(name):
    mix = _mix(name)
    n = mix["path"]["start_points"]
    lap = generate.cycle(mix["path"])
    starts = {generate.start_index(mix, 2 ** 31 + s) for s in range(64)}
    assert len(starts) > 1
    assert starts <= {k * (lap // n) for k in range(n)}
    idx = generate.path_indices(mix, 2 ** 31 + 5, lap + 2)
    assert np.array_equal(np.diff(idx) % lap, np.ones(lap + 1))


def test_sweep_maps_the_path_then_drives_back_and_forth():
    mix = _mix("localize_sweep")
    m = generate.cycle(mix["path"])
    assert mix["warmup"]["frames"] == m
    for seed in (1, 2 ** 31 + 7):
        idx = generate.path_indices(mix, seed, 3 * m)
        assert np.array_equal(idx[:m], np.arange(m))
        assert np.array_equal(idx[m:2 * m - 1], np.arange(m - 2, -1, -1))
        assert np.abs(np.diff(idx)).max() == 1
    twc = generate.poses(mix["path"], np.arange(m), 1.0)
    from active_orb_slam2_tpu_torch.io.synthetic import orbit_trajectory
    ref = orbit_trajectory(m, mix["path"]["radius_m"],
                           mix["path"]["step_deg"])
    assert np.allclose(twc, np.stack(ref), atol=1e-6)


def test_tour_is_the_programs_tour():
    """Two laps of the tour kind, pose for pose the program's
    ``tour_trajectory`` driven as ``traj[i % frames_per_lap]``, with the
    step in height at the lap boundary kept."""
    from active_orb_slam2_tpu_torch.io.synthetic import tour_trajectory
    mix = _mix("tour_verify")
    path = mix["path"]
    lap = generate.cycle(path)
    ref = np.stack(tour_trajectory(lap, path["ax_m"], path["az_m"],
                                   path["fx"], path["fz"]))
    start = generate.start_index(mix, 2 ** 31 + 3)
    idx = generate.path_indices(mix, 2 ** 31 + 3, 2 * lap)
    assert idx[0] == start and np.array_equal(np.sort(idx[:lap]),
                                              np.arange(lap))
    twc = generate.poses(path, idx, 1.0)
    assert twc.dtype == np.float32
    assert np.array_equal(twc, ref[idx])
    step = twc[idx == 0][0, :3, 3] - twc[idx == lap - 1][0, :3, 3]
    assert np.abs(step[[0, 2]]).max() < 1e-6
    assert abs(abs(step[1]) - 0.176) < 1e-3
    # a scaled world scales the tour's lengths and not its headings
    half = generate.poses(path, idx, 0.5)
    assert np.array_equal(half[:, :3, :3], twc[:, :3, :3])
    assert np.array_equal(half[:, :3, 3], twc[:, :3, 3] * np.float32(0.5))


def _loop_poses_as_first_written(idx, frames_per_lap, radius):
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


def _orbit_poses_as_first_written(idx, radius, step_deg):
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


def _poses_as_first_written(path, idx, scale):
    r = float(path["radius_m"]) * scale
    if path["kind"] == "loop":
        return _loop_poses_as_first_written(idx, int(path["frames_per_lap"]),
                                            r)
    return _orbit_poses_as_first_written(idx, r, float(path["step_deg"]))


@pytest.mark.parametrize("name", ["explore_loop", "localize_sweep",
                                  "revisit_laps"])
def test_loop_and_orbit_paths_are_unchanged(name, monkeypatch):
    """The loop and orbit kinds give, bit for bit, the poses of their
    formulas as the benchmark first had them, and so the same frames for
    a seed."""
    mix = _mix(name)
    path, scale = mix["path"], float(mix["world"].get("scale", 1.0))
    for seed in (7, 2 ** 31 + 11):
        idx = generate.path_indices(mix, seed, 2 * generate.cycle(path) + 5)
        assert np.array_equal(generate.poses(path, idx, scale),
                              _poses_as_first_written(path, idx, scale))
    if name != "localize_sweep":
        return
    mix["render"]["supersample"] = 1
    cam = small_cam(dist=(0.26, -0.95, -0.005, 0.003, 1.16))
    dev = torch.device("cpu")
    now = generate.make(mix, cam, 15.0, "rgbd", 2 ** 31 + 99, 4, dev)
    monkeypatch.setattr(generate, "poses", _poses_as_first_written)
    then = generate.make(mix, cam, 15.0, "rgbd", 2 ** 31 + 99, 4, dev)
    for a, b in zip(now.images, then.images):
        assert np.array_equal(a, b)
    assert np.array_equal(now.twc, then.twc)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_renders_the_cpu_images(card):
    world = W.box_world(8, 0)
    cam = small_cam()
    twc = torch.from_numpy(W.loop_poses([3, 700], 1704, 2.5))
    g_c, d_c = W.render(world, cam, twc.to(card), 2)
    g, d = W.render(world, cam, twc, 2)
    assert off_share(g_c.cpu().numpy(), g.numpy(), 1e-3) <= EDGE_SHARE
    assert np.allclose(d_c.cpu().numpy(), d.numpy(), rtol=1e-5)
