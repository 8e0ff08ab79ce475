"""The port's stereo matching and stereo tracking against the JAX
package's, on the CPU, at ``tests/test_stereo.py``'s configuration
(320x240, baseline 0.12 m, 512 features, 4 levels).

``compute_stereo_matches`` is fed the JAX package's own ORB features of
a rendered pair; the images are uint8 values in float32, so the SADs are
exact integers on both sides and the subpixel step sees the same
numbers.  The outlier filter's median follows ``jnp.median``, NaN as
soon as one feature is unmatched (ROADMAP queue 3, item k): a real frame
leaves it inert, a frame whose every feature matched makes it act; both
are checked.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu.ops import stereo as jstereo
from active_orb_slam2_tpu.ops.orb import build_extractor
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models import system as tsys
from active_orb_slam2_tpu_torch.ops import stereo as tstereo
from active_orb_slam2_tpu_torch.ops.orb import OrbFeatures
from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
from tests.test_torch_mapping import jax_write_back
from tests.test_torch_tracking import configs

torch.set_num_threads(1)

BASELINE = 0.12


def stereo_configs():
    jc, tc = configs()
    out = []
    for c in (jc, tc):
        cam = c.camera._replace(bf=c.camera.fx * BASELINE)
        out.append(dataclasses.replace(
            c, camera=cam, sensor="stereo",
            tracking=dataclasses.replace(c.tracking, th_depth=12.0)))
    return out


JC, TC = stereo_configs()


def render_pair(world, Twc):
    """Left image, right image (the left pose moved by the baseline along
    its x axis) and the left depth."""
    right = np.eye(4, dtype=np.float32)
    right[0, 3] = BASELINE
    gl, dl = jsyn.render_rgbd(world, JC.camera, Twc)
    gr, _ = jsyn.render_rgbd(world, JC.camera, Twc @ right)
    return (np.clip(gl, 0, 255).astype(np.uint8),
            np.clip(gr, 0, 255).astype(np.uint8), dl)


def test_jnp_median_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 8, 512):
        x = rng.normal(size=n).astype(np.float32)
        for with_nan in (False, True):
            if with_nan:
                x = x.copy()
                x[rng.integers(0, n)] = np.nan
            ref = np.asarray(jnp.median(jnp.asarray(x)))
            got = tstereo.jnp_median(torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def pair_features():
    """The JAX package's ORB features of both images of one rendered
    pair, as numpy arrays, with the images as float32."""
    gl, gr, _ = render_pair(jsyn.default_world(), jsyn.orbit_trajectory(3)[0])
    extract = build_extractor(JC.orb, JC.camera.height, JC.camera.width)
    il, ir = gl.astype(np.float32), gr.astype(np.float32)
    fl, fr = (extract(jnp.asarray(i)) for i in (il, ir))
    return ({f: np.asarray(getattr(fl, f)) for f in fl._fields},
            {f: np.asarray(getattr(fr, f)) for f in fr._fields}, il, ir)


def both_stereo(feats_l, feats_r, il, ir):
    """(ur, depth) of each package on the same features and images."""
    from active_orb_slam2_tpu.ops.orb import OrbFeatures as JFeat
    jur, jdep = jstereo.compute_stereo_matches(
        JC.camera, *(JFeat(**{k: jnp.asarray(v) for k, v in f.items()})
                     for f in (feats_l, feats_r)), jnp.asarray(il),
        jnp.asarray(ir))
    tur, tdep = tstereo.compute_stereo_matches(
        TC.camera, *(OrbFeatures(**{k: convert.to_torch(v)
                                    for k, v in f.items()})
                     for f in (feats_l, feats_r)), torch.from_numpy(il),
        torch.from_numpy(ir))
    return (np.asarray(jur), np.asarray(jdep)), (tur.numpy(), tdep.numpy())


def check_agree(jres, tres):
    (jur, jdep), (tur, tdep) = jres, tres
    ok = jur >= 0
    np.testing.assert_array_equal(tur >= 0, ok)
    np.testing.assert_allclose(tur[ok], jur[ok], atol=1e-4)
    assert (tur[~ok] == -1).all() and (tdep[~ok] == 0).all()
    np.testing.assert_allclose(tdep[ok], jdep[ok], rtol=1e-5)
    return ok


def test_stereo_matches_match_jax(pair_features):
    """A real frame: some features are unmatched, so the median is NaN
    on both sides and the SAD filter keeps every match."""
    fl, fr, il, ir = pair_features
    ok = check_agree(*both_stereo(fl, fr, il, ir))
    assert 150 < ok.sum() < fl["valid"].sum(), ok.sum()


def test_stereo_sad_filter_acts_when_every_feature_matched(pair_features):
    """The left features that matched, alone: every one of them matches
    again (the right features are unchanged), the median is finite, and
    the 2.1 x median filter drops the worst SADs, the same on both
    sides."""
    fl, fr, il, ir = pair_features
    (jur, _), _ = both_stereo(fl, fr, il, ir)
    keep = np.flatnonzero(jur >= 0)
    sub = {k: v[keep] for k, v in fl.items()}
    ok = check_agree(*both_stereo(sub, fr, il, ir))
    assert 0 < ok.sum() < len(keep), (len(keep), ok.sum())


def test_stereo_depth_is_bf_over_disparity_exactly(pair_features):
    """The depth of each match is bf / disparity rounded once, bit for bit
    the JAX package's (``cam.bf / tensor`` in PyTorch is a reciprocal
    times bf, which rounds twice and parted in the last bit for about a
    fifth of the features; at the KITTI shape that rounding of the
    initial map's points turned the first tracked pair's motion stage
    from 86 inliers to 0)."""
    fl, fr, il, ir = pair_features
    (jur, jdep), (tur, tdep) = both_stereo(fl, fr, il, ir)
    np.testing.assert_array_equal(tur, jur)
    np.testing.assert_array_equal(tdep, jdep)


def test_rgbd_virtual_right_is_one_division():
    """RGB-D's virtual right coordinate u - bf / d, bit for bit the JAX
    package's, on seeded keypoints over a depth map with holes."""
    from active_orb_slam2_tpu.models import frame as jframe
    from active_orb_slam2_tpu.ops.orb import OrbFeatures as JFeat
    from active_orb_slam2_tpu_torch.models import frame as tframe
    rng = np.random.default_rng(5)
    n, cam = 512, JC.camera
    feats = dict(
        uv=rng.uniform(0, [cam.width - 1, cam.height - 1], (n, 2)).astype(
            np.float32),
        level=rng.integers(0, 4, n).astype(np.int32),
        angle=rng.uniform(0, 6.28, n).astype(np.float32),
        response=rng.uniform(0, 50, n).astype(np.float32),
        desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
        valid=rng.random(n) < 0.9)
    depth = rng.uniform(0.3, 9.0, (cam.height, cam.width)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    fj = jframe.frame_from_features(
        JFeat(**{k: jnp.asarray(v) for k, v in feats.items()}), JC.camera,
        jnp.asarray(depth))
    ft = tframe.frame_from_features(
        OrbFeatures(**{k: convert.to_torch(v) for k, v in feats.items()}),
        TC.camera, torch.from_numpy(depth))
    assert (np.asarray(fj.ur) >= 0).sum() > 300
    np.testing.assert_array_equal(ft.ur.numpy(), np.asarray(fj.ur))
    np.testing.assert_array_equal(ft.depth.numpy(), np.asarray(fj.depth))


def run_stereo(slam, n_frames, n_traj=None):
    """Track the first ``n_frames`` pairs of the orbit; returns the state
    and the tracked camera centre after each, and the true centres."""
    world = jsyn.default_world()
    traj = jsyn.orbit_trajectory(n_traj or n_frames, step_deg=2.0)
    states, centres, gt = [], [], []
    for i, Twc in enumerate(traj[:n_frames]):
        gl, gr, _ = render_pair(world, Twc)
        Tcw = np.asarray(slam.track_stereo(gl, gr, i / 30.0), np.float64)
        states.append(slam.state)
        centres.append(-Tcw[:3, :3].T @ Tcw[:3, 3])
        gt.append(Twc[:3, 3])
    return states, np.stack(centres), np.stack(gt)


def test_stereo_system_matches_jax():
    """8 stereo frames on both sides (mapping on): every frame tracks and
    the tracked camera centres agree within 2 mm.  (The replayed
    trajectories may differ more: the JAX package's local BA loses some
    keyframe poses, ROADMAP queue 3, item g.)  Then, on the port, two
    black pairs lose track and the next real pair relocalizes."""
    jslam = jsys.System(JC, pipeline_depth=0, retire_batch=1)
    tslam = tsys.System(TC, device="cpu")
    jstates, jc, _ = run_stereo(jslam, 8, 20)
    tstates, tc, _ = run_stereo(tslam, 8, 20)
    assert jstates == [jsys.OK] * 8 and tstates == [tsys.OK] * 8
    err = np.linalg.norm(jc - tc, axis=1)
    assert err.max() <= 2e-3, err
    assert int(tslam.track.n_inliers) > 50
    assert tslam.kf_seq >= 2 and tslam.relocalizer is None
    black = np.zeros((JC.camera.height, JC.camera.width), np.uint8)
    for i in (8, 9):
        tslam.track_stereo(black, black, i / 30.0)
    assert tslam.state == tsys.LOST
    gl, gr, _ = render_pair(jsyn.default_world(),
                            jsyn.orbit_trajectory(20, step_deg=2.0)[8])
    tslam.track_stereo(gl, gr, 10 / 30.0)
    assert tslam.state == tsys.OK and tslam.relocalizer is not None
    assert int(tslam.track.n_inliers) > 50


@pytest.mark.slow
def test_stereo_pipeline_tracks_20_frames():
    """``tests/test_stereo.py::test_stereo_pipeline_tracks`` on the port."""
    slam = tsys.System(TC, device="cpu")
    states, _, gt = run_stereo(slam, 20)
    assert states[-1] == tsys.OK
    assert int(slam.track.n_inliers) > 50
    est = camera_centers(slam.frame_trajectory()[1])
    assert umeyama_alignment(est, gt, fix_scale=True)[4] < 0.06


def circuit_pairs(cam, n, base=BASELINE, supersample=2):
    """The first ``n`` stereo pairs of ``bench.py``'s 150-frame circuit
    (no boxes, radius 2.5 m) and their true centres; the right eye is the
    left pose moved by the baseline along its x axis."""
    world = jsyn.default_world(n_boxes=0)
    pairs, gt = [], []
    for Twc in jsyn.loop_trajectory(150, radius=2.5)[:n]:
        right = Twc.copy()
        right[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([base, 0, 0],
                                                           np.float32)
        pairs.append([np.clip(jsyn.render_rgbd(world, cam, T,
                                               supersample=supersample)[0],
                              0, 255).astype(np.uint8) for T in (Twc, right)])
        gt.append(Twc[:3, 3])
    return pairs, np.stack(gt)


def track_pairs(slam, pairs, gt, centres, dt):
    """Each pair retired before the next; returns the rigid ATE and
    (state, keyframes, live points) after every pair."""
    rows = []
    for i, (left, right) in enumerate(pairs):
        slam.track_stereo(left, right, i * dt)
        rows.append((int(slam.state), slam.kf_seq,
                     int(np.asarray(slam.map.pt_valid.sum()))))
    est = np.asarray(centres(slam.frame_trajectory()[1]))
    return umeyama_alignment(est, gt, fix_scale=True)[4], rows


def test_stereo_gap_is_the_local_ba_write_back():
    """The stereo ATE gap (ROADMAP queue 3, item m): the first 20 pairs of
    the circuit at 320x240 (mapping on, a keyframe at least every 8
    pairs) through both packages.  The port and the JAX package part
    (measured: port 0.009901 m, JAX 0.012604 m); with the JAX package's
    local-BA write-back patched into the port, the port makes the JAX
    package's keyframes and point counts after every pair and its ATE
    comes within 1e-4 m of the JAX package's (measured 3.6e-5 m)."""
    from active_orb_slam2_tpu.io.trajectory import camera_centers as jcc
    jc, tc = (dataclasses.replace(c, tracking=dataclasses.replace(
        c.tracking, kf_max_interval=8)) for c in (JC, TC))
    pairs, gt = circuit_pairs(jc.camera, 20)
    ate_j, rows_j = track_pairs(jsys.System(jc, pipeline_depth=0,
                                            retire_batch=1), pairs, gt, jcc,
                                0.1)
    ate_t, rows_t = track_pairs(tsys.System(tc, device="cpu"), pairs, gt,
                                camera_centers, 0.1)
    with jax_write_back():
        ate_w, rows_w = track_pairs(tsys.System(tc, device="cpu"), pairs, gt,
                                    camera_centers, 0.1)
    assert all(r[0] == tsys.OK for r in rows_t + rows_w)
    assert rows_w == rows_j, (rows_w, rows_j)
    assert rows_t != rows_j
    assert abs(ate_w - ate_j) <= 1e-4, (ate_w, ate_j)
    assert abs(ate_t - ate_j) > 1e-3, (ate_t, ate_j)


def kitti_configs(base=0.12):
    """``bench.py::stereo_kitti_shape``'s configuration in each package:
    1226x370, 2000 features, 8 levels, ThDepth 35 baselines, a keyframe
    at least every 8 pairs, the default arena."""
    from active_orb_slam2_tpu.config import (MapConfig, OrbConfig,
                                             SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch import config as tcfg
    from active_orb_slam2_tpu_torch.geometry.projection import (
        CameraParams as TCam)
    w, h, f = 1226, 370, 707.0
    cam = dict(fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0, bf=f * base,
               width=w, height=h)
    jc = SlamConfig(camera=CameraParams(**cam),
                    orb=OrbConfig(n_features=2000, n_levels=8),
                    tracking=TrackingConfig(th_depth=35.0 * base,
                                            kf_max_interval=8),
                    map=MapConfig())
    tc = tcfg.SlamConfig(camera=TCam(**cam),
                         orb=tcfg.OrbConfig(n_features=2000, n_levels=8),
                         tracking=tcfg.TrackingConfig(th_depth=35.0 * base,
                                                      kf_max_interval=8),
                         map=tcfg.MapConfig())
    return jc, tc


@pytest.mark.slow
def test_stereo_kitti_shape_ate_beside_jax():
    """The first 30 pairs of ``bench.py::stereo_kitti_shape`` (1226x370,
    2000 features, mapping on, loop closing off on both sides), the
    stereo run of ``chip_smoke.py``, through both packages on the CPU:
    every frame tracks, and the port's ATE (rigid, scale 1) stays within
    5 mm of the JAX package's.  Full size: a run takes minutes and a few
    GiB, so it is meant for a machine with room for it."""
    from active_orb_slam2_tpu.io.trajectory import camera_centers as jcc
    jc, tc = kitti_configs()
    pairs, gt = circuit_pairs(jc.camera, 30, base=0.12, supersample=1)
    ates = {}
    for name, slam, centres, ok in (
            ("jax", jsys.System(jc, use_loop_closing=False, pipeline_depth=0,
                                retire_batch=1), jcc, jsys.OK),
            ("port", tsys.System(tc, device="cpu"), camera_centers, tsys.OK)):
        for i, (left, right) in enumerate(pairs):
            slam.track_stereo(left, right, i / 10.0)
        assert slam.state == ok                       # drains the pipeline
        states = [m["state"] for m in slam.metrics]
        assert states == [ok] * 29, (name, states)
        est = np.asarray(centres(slam.frame_trajectory()[1]))
        ates[name] = umeyama_alignment(est, gt, fix_scale=True)[4]
        print(f"KITTI-shape stereo ATE over 30 pairs, {name}: "
              f"{ates[name]:.5f} m", flush=True)
    assert abs(ates["port"] - ates["jax"]) <= 5e-3, ates


@pytest.mark.slow
def test_stereo_kitti_shape_gap_is_the_write_back():
    """The same 30 KITTI-shape pairs, each retired before the next: with
    the JAX package's local-BA write-back patched in, the port makes the
    JAX package's keyframes after every pair, its point counts within 1%
    (keypoint angles still part in the last bits, quirk a; measured: one
    point off from pair 6) and its ATE comes within 1e-4 m of the JAX
    package's (ROADMAP queue 3, item m; measured 0.009951 m against
    0.009901 m).  Full size: meant for a machine with room for it."""
    from active_orb_slam2_tpu.io.trajectory import camera_centers as jcc
    jc, tc = kitti_configs()
    pairs, gt = circuit_pairs(jc.camera, 30, base=0.12, supersample=1)
    ate_j, rows_j = track_pairs(jsys.System(jc, pipeline_depth=0,
                                            retire_batch=1), pairs, gt, jcc,
                                0.1)
    with jax_write_back():
        ate_w, rows_w = track_pairs(tsys.System(tc, device="cpu"), pairs, gt,
                                    camera_centers, 0.1)
    off = max(abs(w[2] - j[2]) / j[2] for w, j in zip(rows_w, rows_j))
    print(f"KITTI-shape stereo ATE over 30 pairs: JAX {ate_j:.6f} m, port "
          f"with the JAX write-back {ate_w:.6f} m; point counts at most "
          f"{off:.4%} apart", flush=True)
    assert [w[:2] for w in rows_w] == [j[:2] for j in rows_j], (rows_w,
                                                                 rows_j)
    assert off <= 0.01, (rows_w, rows_j)
    assert abs(ate_w - ate_j) <= 1e-4, (ate_w, ate_j)
