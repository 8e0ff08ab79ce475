"""Monocular SLAM on the port beside the JAX package, at
``tests/test_e2e_mono.py``'s size (320x240, 512 features, 4 levels, a
32-keyframe arena) and scene (the orbit of radius 2 m, 2 degrees a
frame).

The initial matching and the two-keyframe map are compared stage by
stage on the same inputs.  The free-running ``System``s part after the
first local BA that meets quirk g (ROADMAP queue 3: the JAX package
loses the pose write-back of a local camera that reappears as a masked
lane of its fixed ring): the port alone makes 231 points at the fourth
keyframe where the JAX package makes 242.  With the JAX package's
write-back patched into the port (``tests/test_torch_mapping.py::
jax_write_back``) the two make the same keyframes and point counts at
every frame.
"""

import dataclasses

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.io.synthetic import (
    default_world, make_sequence, orbit_trajectory)
from active_orb_slam2_tpu.io.trajectory import camera_centers as j_centers
from active_orb_slam2_tpu.models.frame import build_frame_pipeline
from active_orb_slam2_tpu.models.map_state import empty_map as j_empty_map
from active_orb_slam2_tpu.models import initializer as jinit
from active_orb_slam2_tpu.models import mono_init as jmono
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu_torch import config as tcfg
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models import mono_init as tmono
from active_orb_slam2_tpu_torch.models import system as tsys
from active_orb_slam2_tpu_torch.models.frame import FrameData
from active_orb_slam2_tpu_torch.models.map_state import empty_map
from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
from tests import test_e2e_mono as e2e
from tests.test_torch_mapping import jax_write_back

torch.set_num_threads(1)

JC = e2e.CFG
TC = tcfg.SlamConfig(
    camera=CameraParams(fx=JC.camera.fx, fy=JC.camera.fy, cx=JC.camera.cx,
                        cy=JC.camera.cy, bf=JC.camera.bf,
                        width=JC.camera.width, height=JC.camera.height),
    orb=tcfg.OrbConfig(**dataclasses.asdict(JC.orb)),
    tracking=tcfg.TrackingConfig(**dataclasses.asdict(JC.tracking)),
    map=tcfg.MapConfig(**dataclasses.asdict(JC.map)), sensor="mono")


def orbit(n):
    return list(make_sequence(n, JC.camera, world=default_world(),
                              trajectory=orbit_trajectory(
                                  n, radius=2.0, step_deg=2.0)))


@pytest.fixture(scope="module")
def pair():
    """Frames 0 and 1 of the orbit as the JAX package builds them, the
    JAX package's match of 1 against 0 and its initializer's result with
    the first key ``System`` draws (``split(PRNGKey(3))[1]``)."""
    import jax
    import jax.numpy as jnp
    _, make_mono = build_frame_pipeline(JC)
    frames = [make_mono(jnp.asarray(g))[0] for g, _, _ in orbit(2)]
    idx, n = jmono.build_mono_matcher(JC)(*frames)
    _, sub = jax.random.split(jax.random.PRNGKey(3))
    init = jinit.build_initializer(JC.camera)(
        sub, frames[0].uv, frames[1].uv[jnp.clip(idx, 0)], idx >= 0)
    return frames, idx, int(n), init


def port_frame(f):
    return FrameData(**{k: convert.to_torch(np.asarray(v))
                        for k, v in f._asdict().items()})


def test_mono_matcher_matches_jax(pair):
    """The same match of every feature (integer distances and gates)."""
    frames, idx, n, _ = pair
    got, got_n = tmono.build_mono_matcher(TC)(*map(port_frame, frames))
    np.testing.assert_array_equal(got.numpy(), np.asarray(idx))
    assert int(got_n) == n >= 100


def test_create_initial_map_matches_jax(pair):
    """The two-keyframe map from the same frames and reconstruction: the
    same slots, flags and feature -> point maps, descriptors bit for bit,
    points within 1e-3 and keyframe 1's pose within 1e-3 after the gauge
    and the BA (measured 2.4e-5 and 1.2e-5)."""
    frames, idx, _, init = pair
    assert bool(init.ok)
    jm, jkp1, jpose, jn = jmono.build_create_initial_map(JC)(
        j_empty_map(JC.map, JC.orb), *frames, init.pose2, init.points,
        init.point_ok, idx)
    m = empty_map(TC.map, TC.orb)
    t = convert.to_torch
    m, kp1, pose, n = tmono.build_create_initial_map(TC)(
        m, *map(port_frame, frames), t(np.asarray(init.pose2)),
        t(np.asarray(init.points)), t(np.asarray(init.point_ok)),
        t(np.asarray(idx)))
    assert int(n) == int(jn) >= 80
    np.testing.assert_array_equal(kp1.numpy(), np.asarray(jkp1))
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-3)
    got = convert.map_to_jax_numpy(m)
    want = {f: np.asarray(getattr(jm, f)) for f in jm._fields}
    for f in got:
        if f in ("pt_xyz", "kf_pose", "pt_normal", "pt_min_dist",
                 "pt_max_dist"):
            np.testing.assert_allclose(got[f], want[f], atol=1e-3, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def run(slam, frames):
    """Track ``frames``; (state after each frame, (kf_seq, live points)
    after each frame, camera centres of the trajectory)."""
    states, rows = [], []
    for i, (g, _, _) in enumerate(frames):
        slam.track_mono(g, i / 30.0)
        states.append(slam.state)
        rows.append((slam.kf_seq, int(np.asarray(slam.map.pt_valid.sum()))))
    _, poses = slam.frame_trajectory()
    centers = j_centers if isinstance(slam, jsys.System) else camera_centers
    return states, rows, np.asarray(centers(poses))


@pytest.fixture(scope="module")
def short_runs():
    frames = orbit(12)
    jax_side = run(jsys.System(JC), frames)
    port = run(tsys.System(TC, device="cpu"), frames)
    with jax_write_back():
        witness = run(tsys.System(TC, device="cpu"), frames)
    return jax_side, port, witness


def test_mono_system_matches_jax(short_runs):
    """12 frames: both initialize at frame 1 with the same point count and
    track every later frame; the port's camera centres, replayed against
    the final keyframe poses, within 2 cm of the JAX package's (measured
    13.5 mm: quirk g), and with the JAX write-back the same keyframes and
    points at every frame and the centres within 1e-3 (measured
    1.1e-5)."""
    (js, jr, jc), (ts, tr, tc), (ws, wr, wc) = short_runs
    assert js == ts == ws == [jsys.NOT_INITIALIZED] + [jsys.OK] * 11
    assert tr[1] == jr[1] and tr[1][0] == 2 and tr[1][1] >= 80
    assert wr == jr
    assert np.linalg.norm(tc - jc, axis=1).max() <= 0.02
    err = np.linalg.norm(wc - jc, axis=1).max()
    print(f"mono centres: port {np.linalg.norm(tc - jc, axis=1).max():.6f}, "
          f"with the JAX write-back {err:.6f}")
    assert err <= 1e-3


def test_mono_system_defaults():
    """``System(sensor="mono")`` retires each frame before the next, its
    loop closer verifies with free scale, and ``reset`` drops the
    initialization reference."""
    slam = tsys.System(TC, use_loop_closing=True, device="cpu")
    assert (slam.pipeline_depth, slam.retire_batch) == (0, 1)
    assert not slam.loop_closer.fix_scale         # Sim3 with free scale
    for i, (g, _, _) in enumerate(orbit(2)):
        slam.track_mono(g, i / 30.0)
    assert slam.state == tsys.OK and slam.kf_seq == 2
    assert [k for _, k in slam.kf_records] == [0, 1]
    assert slam.kf_records[0][0] == pytest.approx(1 / 30.0 - 1 / 30.0)
    slam.reset()
    assert slam._ref_frame is None and slam.state == tsys.NOT_INITIALIZED
    assert int(slam.map.pt_valid.sum()) == 0


def test_mono_relocalizes_after_blackout():
    """The relocalization re-entry with mono frames: after 8 frames, two
    black frames are LOST; frame 8 relocalizes from its own ORB frame
    against the keyframes and tracking resumes."""
    frames = orbit(10)
    slam = tsys.System(TC, device="cpu")
    for i in range(8):
        slam.track_mono(frames[i][0], i / 30.0)
    assert slam.state == tsys.OK and slam.kf_seq >= 3
    states = []
    for i, g in enumerate([np.zeros_like(frames[0][0])] * 2
                          + [frames[8][0], frames[9][0]]):
        slam.track_mono(g, (8 + i) / 30.0)
        states.append(slam.state)
    assert states == [tsys.LOST, tsys.LOST, tsys.OK, tsys.OK]
    assert slam.relocalizer is not None
    assert slam.metrics[-2]["n_inliers"] >= 50


def test_mono_loop_verification_free_scale():
    """The loop closer of a mono ``System`` verifies with free scale: on
    the map of 12 frames, keyframe 4 against keyframe 2 (same map, so
    the answer is their relative pose at scale 1) verifies with the
    scale within 2% of 1 and the rotation and translation within 5e-3
    of the relative pose (measured: scale 0.99617, 1.9e-3)."""
    from active_orb_slam2_tpu_torch.geometry.se3 import (
        se3_compose, se3_inverse)
    slam = tsys.System(TC, use_loop_closing=True, device="cpu")
    for i, (g, _, _) in enumerate(orbit(12)):
        slam.track_mono(g, i / 30.0)
    assert slam.kf_seq >= 5
    ok, s_cm, n = slam.loop_closer.compute_sim3(slam.map, 4, 2)
    assert ok and n >= 40
    rel = se3_compose(slam.map.kf_pose[4], se3_inverse(slam.map.kf_pose[2]))
    assert abs(float(s_cm[7]) - 1.0) < 0.02
    np.testing.assert_allclose(s_cm[:7].numpy(), rel.numpy(), atol=5e-3)


@pytest.mark.slow
def test_mono_ate_beside_jax():
    """``tests/test_e2e_mono.py`` on the port (40 frames): Sim3 ATE over
    the frames after initialization below 0.05 m, with the JAX package's
    beside it; with the JAX write-back, within 1e-3 m of it (measured
    JAX 0.030284 m, port with the write-back 0.030273 m)."""
    frames = orbit(40)
    gt = np.stack([Twc[:3, 3] for _, _, Twc in frames])

    def ate(centers):
        moved = np.linalg.norm(centers, axis=1) > 1e-6
        assert moved.sum() > 20
        return umeyama_alignment(centers[moved], gt[moved],
                                 fix_scale=False)[4]

    jax_side = run(jsys.System(JC), frames)
    port = run(tsys.System(TC, device="cpu"), frames)
    with jax_write_back():
        witness = run(tsys.System(TC, device="cpu"), frames)
    a_j, a_t, a_w = (ate(r[2]) for r in (jax_side, port, witness))
    print(f"mono ATE: JAX {a_j:.6f} m, port {a_t:.6f} m, port with the JAX "
          f"write-back {a_w:.6f} m")
    assert port[0][-1] == tsys.OK and a_t < 0.05
    assert abs(a_w - a_j) <= 1e-3


@pytest.mark.slow
def test_mono_vga_ate_beside_jax():
    """``chip_smoke.py``'s mono phase on the CPU, with the JAX package
    beside it: ``SlamConfig(sensor="mono")`` (VGA, 1024 features, 8
    levels, default arena) with loop closing over 60 frames of the
    orbit; both track every frame after initialization with Sim3 ATE
    below 0.05 m.  Full width: run it on a machine with the memory for
    both packages (``JAX_PLATFORMS=cpu``)."""
    from active_orb_slam2_tpu.config import SlamConfig as JSlamConfig
    frames = list(make_sequence(60, JSlamConfig(sensor="mono").camera,
                                world=default_world(),
                                trajectory=orbit_trajectory(
                                    60, radius=2.0, step_deg=2.0)))
    gt = np.stack([Twc[:3, 3] for _, _, Twc in frames])
    ate = {}
    for name, slam in (
            ("jax", jsys.System(JSlamConfig(sensor="mono"),
                                use_loop_closing=True)),
            ("port", tsys.System(tcfg.SlamConfig(sensor="mono"),
                                 use_loop_closing=True, device="cpu"))):
        states, rows, centers = run(slam, frames)
        assert states[-1] == 1 and rows[-1][0] >= 2, (name, rows[-1])
        moved = np.linalg.norm(centers, axis=1) > 1e-6
        ate[name] = umeyama_alignment(centers[moved], gt[moved],
                                      fix_scale=False)[4]
        print(f"mono VGA {name}: keyframes {rows[-1][0]}, points "
              f"{rows[-1][1]}, tracked after initialization "
              f"{int(moved.sum())}, Sim3 ATE {ate[name]:.6f} m")
    assert ate["port"] < 0.05 and ate["jax"] < 0.05, ate
