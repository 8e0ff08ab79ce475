"""Keypoint undistortion and the distorted-camera path: the port's
counterparts of ``tests/test_undistort.py``'s six tests, each beside the
JAX functions, and a short distorted run of both ``System``s.

Tolerances: undistorted pixels within 1e-3 px of the JAX package's (both
float32, 8 fixed-point iterations); the forward model exact (the same
float64 numpy arithmetic); the warp within 1e-3 grey levels (its source
coordinates come from each package's float32 undistortion); image bounds
within 1e-3 px; the short run as ``tests/test_torch_slice.py`` holds the
undistorted one: camera centres within 5 mm, local-stage inliers within
5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu import config as jcfg
from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.io.trajectory import camera_centers as j_centers
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu.ops import undistort as jund
from active_orb_slam2_tpu_torch import config as tcfg
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams as TCam
from active_orb_slam2_tpu_torch.geometry.projection import in_frustum
from active_orb_slam2_tpu_torch.geometry.se3 import se3_identity
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
from active_orb_slam2_tpu_torch.models import system as tsys
from active_orb_slam2_tpu_torch.ops import undistort as tund
from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment

torch.set_num_threads(1)

# tests/test_undistort.py:20-23: TUM fr1's calibration and radtan
CAM = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0, width=640,
           height=480)
DIST = (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)
ZERO = (0.0, 0.0, 0.0, 0.0, 0.0)
UV_ATOL = 1e-3
WARP_ATOL = 1e-3


def _forward_distort_np(cam, dist, uv_und):
    x = (uv_und[:, 0] - cam["cx"]) / cam["fx"]
    y = (uv_und[:, 1] - cam["cy"]) / cam["fy"]
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([x_d * cam["fx"] + cam["cx"],
                     y_d * cam["fy"] + cam["cy"]], axis=-1)


def both_undistorted(dist, raw):
    j = np.asarray(jund.undistort_points(JCam(**CAM), dist,
                                         jnp.asarray(raw)))
    t = tund.undistort_points(TCam(**CAM), dist, torch.from_numpy(
        raw.astype(np.float32))).numpy()
    return j, t


def test_undistort_roundtrip():
    rng = np.random.default_rng(0)
    raw = np.stack([rng.uniform(10, 630, 500),
                    rng.uniform(10, 470, 500)], axis=-1)
    j, t = both_undistorted(DIST, raw)
    assert np.abs(_forward_distort_np(CAM, DIST, t) - raw).max() < 0.05
    np.testing.assert_allclose(t, j, atol=UV_ATOL)


def test_undistort_identity_when_zero():
    rng = np.random.default_rng(1)
    raw = np.stack([rng.uniform(0, 640, 64),
                    rng.uniform(0, 480, 64)], axis=-1)
    j, t = both_undistorted(ZERO, raw)
    np.testing.assert_allclose(t, raw, atol=1e-4)
    np.testing.assert_allclose(t, j, atol=UV_ATOL)


def test_distort_normalized_matches_oracle():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 0.5, 100)
    y = rng.uniform(-0.4, 0.4, 100)
    xd, yd = tund.distort_normalized(DIST, x, y)
    uv = np.stack([x * CAM["fx"] + CAM["cx"], y * CAM["fy"] + CAM["cy"]], -1)
    ref = _forward_distort_np(CAM, DIST, uv)
    np.testing.assert_allclose(xd * CAM["fx"] + CAM["cx"], ref[:, 0],
                               atol=1e-9)
    np.testing.assert_allclose(yd * CAM["fy"] + CAM["cy"], ref[:, 1],
                               atol=1e-9)
    jxd, jyd = jund.distort_normalized(DIST, x, y)
    assert np.array_equal(xd, jxd) and np.array_equal(yd, jyd)
    # on tensors, the same arithmetic
    txd, tyd = tund.distort_normalized(DIST, torch.from_numpy(x),
                                       torch.from_numpy(y))
    np.testing.assert_allclose(txd.numpy(), xd, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tyd.numpy(), yd, rtol=0, atol=1e-12)


def test_image_bounds_barrel():
    b = tund.compute_image_bounds(TCam(**CAM), DIST)
    assert b[0] < b[1] and b[2] < b[3]
    b0 = tund.compute_image_bounds(TCam(**CAM), (0, 0, 0, 0, 0))
    assert b0 == (0.0, 640.0, 0.0, 480.0)
    assert any(abs(x - y) > 0.5 for x, y in zip(b, b0))
    np.testing.assert_allclose(
        b, jund.compute_image_bounds(JCam(**CAM), DIST), atol=UV_ATOL)


def test_frustum_uses_undistorted_bounds():
    """EuRoC-like barrel (k1 < 0): the undistorted bounds extend past the
    raw box, and the frustum gates must clip to them."""
    dist = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
    cam = TCam(**CAM)
    x0, x1, y0, y1 = tund.compute_image_bounds(cam, dist)
    np.testing.assert_allclose(
        (x0, x1, y0, y1), jund.compute_image_bounds(JCam(**CAM), dist),
        atol=UV_ATOL)
    assert x0 < 0 and x1 > cam.width, (x0, x1)
    cam_b = cam._replace(min_x=x0, max_x=x1, min_y=y0, max_y=y1)
    z = 2.0
    us = np.array([x0 + 1.0, x1 - 1.0, cam.cx, cam.cx])
    vs = np.array([cam.cy, cam.cy, y0 + 1.0, y1 - 1.0])
    pw = torch.from_numpy(np.stack([(us - cam.cx) / cam.fx * z,
                                    (vs - cam.cy) / cam.fy * z,
                                    np.full(4, z)], -1).astype(np.float32))
    normal = torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    mind, maxd = torch.full((4,), 0.1), torch.full((4,), 100.0)
    vis_raw = in_frustum(cam, se3_identity(), pw, normal, mind, maxd)[0]
    vis_b = in_frustum(cam_b, se3_identity(), pw, normal, mind, maxd)[0]
    assert not bool(vis_raw.any())
    assert bool(vis_b.all())


@pytest.fixture(scope="module")
def rendered():
    """One VGA frame of the orbit with TUM fr1's intrinsics (gray, depth)."""
    (g, d, _), = list(jsyn.make_sequence(
        1, JCam(**CAM), world=jsyn.default_world(),
        trajectory=jsyn.orbit_trajectory(1, step_deg=0.8)))
    return g, d


@pytest.mark.parametrize("which", ["gray", "depth"])
def test_distort_warp_image_matches_jax(rendered, which):
    img = rendered[0] if which == "gray" else rendered[1]
    t = tund.distort_warp_image(TCam(**CAM), DIST, img)
    j = jund.distort_warp_image(JCam(**CAM), DIST, img)
    assert t.shape == img.shape and t.dtype == np.float64
    np.testing.assert_allclose(t, j, rtol=0, atol=WARP_ATOL)


# ---------------------------------------------------- distorted tracking

SMALL_CAM = dict(fx=517.3 / 2, fy=516.5 / 2, cx=159.05, cy=127.4, bf=20.0,
                 width=320, height=240)


def small_configs(dist):
    """320x240 with TUM fr1's intrinsics halved, 256 features, 4 levels,
    a 32 / 8,192 arena; ``dist`` with its undistorted bounds."""
    out = []
    for mod, Cam, und in ((jcfg, JCam, jund), (tcfg, TCam, tund)):
        cam = Cam(**SMALL_CAM)
        if any(dist):
            x0, x1, y0, y1 = und.compute_image_bounds(cam, dist)
            cam = cam._replace(min_x=x0, max_x=x1, min_y=y0, max_y=y1)
        out.append(mod.SlamConfig(
            camera=cam, orb=mod.OrbConfig(n_features=256, n_levels=4),
            tracking=mod.TrackingConfig(th_depth=8.0),
            map=mod.MapConfig(max_keyframes=32, max_points=8192,
                              local_ba_keyframes=8, local_ba_points=2048),
            distortion=tuple(dist)))
    return out


def distorted_frames(cam, dist, n, step_deg):
    """``n`` orbit frames warped into the distorted camera (JAX's warp, so
    both packages track the same images), and the true centres."""
    frames, gt = [], []
    for g, d, Twc in jsyn.make_sequence(
            n, JCam(**cam), world=jsyn.default_world(),
            trajectory=jsyn.orbit_trajectory(n, step_deg=step_deg)):
        gw = jund.distort_warp_image(JCam(**cam), dist, g)
        dw = jund.distort_warp_image(JCam(**cam), dist, d)
        frames.append((np.clip(gw, 0, 255).astype(np.uint8),
                       np.clip(dw * 1e3, 0, 65535).astype(np.uint16)))
        gt.append(Twc[:3, 3])
    return frames, np.stack(gt)


def test_distorted_tracking_matches_jax():
    """8 frames through TUM fr1's distortion, mapping off, both packages:
    every frame OK, camera centres within 5 mm, inliers within 5%."""
    frames, _ = distorted_frames(SMALL_CAM, DIST, 8, 2.0)
    jc, tc = small_configs(DIST)
    jslam = jsys.System(jc, use_mapping=False, pipeline_depth=0,
                        retire_batch=1)
    tslam = tsys.System(tc, use_mapping=False, device="cpu")
    for i, (g, d) in enumerate(frames):
        jslam.track_rgbd(g, d, i / 30.0)
        tslam.track_rgbd(g, d, i / 30.0)
        assert jslam.state == jsys.OK and tslam.state == tsys.OK
    jc_ = np.asarray(j_centers(jslam.frame_trajectory()[1]))
    tc_ = camera_centers(tslam.frame_trajectory()[1])
    assert np.linalg.norm(jc_ - tc_, axis=1).max() <= 5e-3
    nj = np.array([m["n_inliers"] for m in jslam.metrics])
    nt = np.array([m["n_inliers"] for m in tslam.metrics])
    assert len(nj) == len(nt) == 7
    assert (np.abs(nt - nj) <= 0.05 * nj).all(), (nj, nt)


@pytest.mark.slow
def test_e2e_distorted_rgbd_ate_beside_jax():
    """``tests/test_undistort.py::test_e2e_distorted_rgbd_ate`` on the
    port (40 frames, the test's radtan profile, mapping on), the JAX
    package's ATE beside it: both meet the test's two bars.  With
    mapping on the two maps part through the local-BA write-back
    (ROADMAP queue 3, quirk g), so the ATEs are printed, not matched
    (measured: the port 0.0082 m and 0.0781 m unmodelled, the JAX
    package 0.0174 m and 0.0680 m)."""
    cam = dict(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8, width=320,
               height=240)
    dist = (0.25, -0.3, 0.0, 0.0, 0.0)
    frames, gt = distorted_frames(cam, dist, 40, 1.2)

    def run(pkg, d):
        mod, Cam, und, System, centers = pkg
        c = Cam(**cam)
        if any(d):
            x0, x1, y0, y1 = und.compute_image_bounds(c, d)
            c = c._replace(min_x=x0, max_x=x1, min_y=y0, max_y=y1)
        cfg = mod.SlamConfig(
            camera=c, orb=mod.OrbConfig(n_features=512, n_levels=4),
            tracking=mod.TrackingConfig(th_depth=12.0),
            map=mod.MapConfig(max_keyframes=32, max_points=8192,
                              local_ba_keyframes=8, local_ba_points=2048),
            distortion=d)
        slam = System(cfg)
        for i, (g, dm) in enumerate(frames):
            slam.track_rgbd(g, dm, i / 30.0)
        return umeyama_alignment(np.asarray(centers(
            slam.frame_trajectory()[1])), gt, fix_scale=True)[4]

    jax_pkg = (jcfg, JCam, jund, lambda c: jsys.System(
        c, pipeline_depth=0, retire_batch=1), j_centers)
    port = (tcfg, TCam, tund, lambda c: tsys.System(c, device="cpu"),
            camera_centers)
    ate = {(name, on): run(pkg, dist if on else ZERO)
           for name, pkg in (("jax", jax_pkg), ("port", port))
           for on in (True, False)}
    print("distorted e2e ATE (m):", ate)
    for side in ("port", "jax"):
        assert ate[side, True] < 0.06, ate
        assert ate[side, True] < 0.5 * ate[side, False], ate


def test_undistortion_is_the_division_jit_rewrites():
    """Quirk x (ROADMAP queue 3, item t): the port's undistortion equals
    the JAX function run eagerly bit for bit; the same function compiled
    (as the JAX package's frame step runs it) parts from both in the
    last bits of about 40% of the points: XLA's algebraic simplifier
    turns ``/ cam.fx`` (a constant) into a multiply by its reciprocal
    and folds constant factors together."""
    raw = (np.random.default_rng(0).random((4096, 2))
           * [SMALL_CAM["width"], SMALL_CAM["height"]]).astype(np.float32)
    dist = (0.25, -0.3, 0.0, 0.0, 0.0)
    port = tund.undistort_points(TCam(**SMALL_CAM), dist,
                                 torch.from_numpy(raw)).numpy()
    eager = np.asarray(jund.undistort_points(JCam(**SMALL_CAM), dist,
                                             jnp.asarray(raw)))
    jit = np.asarray(jax.jit(lambda u: jund.undistort_points(
        JCam(**SMALL_CAM), dist, u))(jnp.asarray(raw)))
    np.testing.assert_array_equal(port, eager)
    parted = (jit != eager).any(axis=1)
    assert 0.1 < parted.mean() < 0.9, parted.mean()
    np.testing.assert_allclose(jit, eager, atol=1e-4)


@pytest.mark.slow
def test_distorted_gap_is_the_write_back():
    """ROADMAP queue 3, item t: ``test_e2e_distorted_rgbd_ate_beside_jax``'s
    distorted run (40 frames, profile (0.25, -0.3), mapping on), every
    frame retired before the next on both sides.  With the JAX package's
    local-BA write-back patched into the port
    (``tests/test_torch_mapping.py::jax_write_back``, quirk g) the two
    parted at keyframe 2 (646 points against 644), with the
    undistortion modelled or not: the frames differ (printed, not
    asserted).  Fed the JAX
    package's own frames as well (``jax_frames``), the port makes the
    JAX package's keyframes and points after every frame and comes
    within 1e-4 m of its ATE.  Prints each side's keyframes and points
    after every frame, the ATEs, and per frame the keypoints whose
    descriptor or position differ between the two packages' frames."""
    from active_orb_slam2_tpu_torch.models import frame as tframe
    from tests.test_torch_mapping import jax_frames, jax_write_back
    cam = dict(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8, width=320,
               height=240)
    dist = (0.25, -0.3, 0.0, 0.0, 0.0)
    frames, gt = distorted_frames(cam, dist, 40, 1.2)

    def config(mod, Cam, und):
        c = Cam(**cam)
        x0, x1, y0, y1 = und.compute_image_bounds(c, dist)
        return mod.SlamConfig(
            camera=c._replace(min_x=x0, max_x=x1, min_y=y0, max_y=y1),
            orb=mod.OrbConfig(n_features=512, n_levels=4),
            tracking=mod.TrackingConfig(th_depth=12.0),
            map=mod.MapConfig(max_keyframes=32, max_points=8192,
                              local_ba_keyframes=8, local_ba_points=2048),
            distortion=dist)

    def run(slam, centers):
        rows = []
        for i, (g, dm) in enumerate(frames):
            slam.track_rgbd(g, dm, i / 30.0)
            slam.state
            rows.append((slam.kf_seq,
                         int(np.asarray(slam.map.pt_valid.sum()))))
        ate = umeyama_alignment(np.asarray(centers(
            slam.frame_trajectory()[1])), gt, fix_scale=True)[4]
        return ate, rows

    tc = config(tcfg, TCam, tund)
    jslam = jsys.System(config(jcfg, JCam, jund), pipeline_depth=0,
                        retire_batch=1)
    fed = jax_frames(jslam)
    ate_j, rows_j = run(jslam, j_centers)
    ate_t, rows_t = run(tsys.System(tc, device="cpu"), camera_centers)
    with jax_write_back():
        ate_w, rows_w = run(tsys.System(tc, device="cpu"), camera_centers)
        with fed.port_pipeline():
            ate_x, rows_x = run(tsys.System(tc, device="cpu"),
                                camera_centers)
    make_rgbd = tframe.build_frame_pipeline(tc)[0]
    parted = []
    for i, (g, dm) in enumerate(frames):
        own, jf = make_rgbd(torch.from_numpy(g), torch.from_numpy(dm))[0], \
            fed.port_frame(i)
        parted.append((int((own.desc != jf.desc).any(1).sum()),
                       int((own.uv != jf.uv).any(1).sum())))
    print("item t: ATE jax", ate_j, "port", ate_t, "port+write-back", ate_w,
          "port+write-back+JAX frames", ate_x)
    print("rows jax", rows_j)
    print("rows port", rows_t)
    print("rows port+write-back", rows_w)
    print("keypoints parted (descriptor, position) per frame", parted)
    assert len(fed.frames) == len(frames)
    assert rows_x == rows_j
    assert abs(ate_x - ate_j) <= 1e-4, (ate_x, ate_j)
