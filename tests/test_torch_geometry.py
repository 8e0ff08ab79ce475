"""The port's geometry and configuration against the JAX package.

Random poses and points are made with numpy from a seed and fed to both
packages; results agree to float32 tolerance (atol 1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu import config as jcfg
from active_orb_slam2_tpu.geometry import projection as jproj
from active_orb_slam2_tpu.geometry import se3 as jse3
from active_orb_slam2_tpu_torch import config as tcfg
from active_orb_slam2_tpu_torch.geometry import projection as tproj
from active_orb_slam2_tpu_torch.geometry import se3 as tse3

torch.set_num_threads(1)

ATOL = 1e-5
CAM_ARGS = dict(fx=260.0, fy=255.0, cx=159.5, cy=119.5, bf=20.8,
                width=320, height=240)


def _poses(rng, n):
    tw = rng.normal(0.0, 0.4, (n, 6)).astype(np.float32)
    return np.array(jse3.se3_exp(jnp.asarray(tw))), tw


def _close(a_torch, b_jax, atol=ATOL):
    np.testing.assert_allclose(a_torch.numpy(), np.asarray(b_jax),
                               atol=atol, rtol=0)


def test_se3_ops_match_jax():
    rng = np.random.default_rng(0)
    p, tw = _poses(rng, 64)
    q, _ = _poses(rng, 64)
    x = rng.normal(0.0, 2.0, (64, 3)).astype(np.float32)
    tp, tq, tx = map(torch.from_numpy, (p, q, x))
    _close(tse3.se3_exp(torch.from_numpy(tw)), p)
    _close(tse3.se3_compose(tp, tq), jse3.se3_compose(p, q))
    _close(tse3.se3_inverse(tp), jse3.se3_inverse(p))
    _close(tse3.se3_apply(tp, tx), jse3.se3_apply(p, x))
    _close(tse3.se3_retract(tp, torch.from_numpy(tw) * 0.1),
           jse3.se3_retract(p, tw * 0.1))
    _close(tse3.se3_to_mat44(tp), jse3.se3_to_mat44(p))
    _close(tse3.quat_to_mat(tp[:, :4]), jse3.quat_to_mat(p[:, :4]))
    _close(tse3.quat_mul(tp[:, :4], tq[:, :4]),
           jse3.quat_mul(p[:, :4], q[:, :4]))
    _close(tse3.se3_identity((3,)), jse3.se3_identity((3,)))
    # tiny twists take the Taylor branches
    small = (tw * 1e-6).astype(np.float32)
    _close(tse3.se3_exp(torch.from_numpy(small)), jse3.se3_exp(small))


def test_mat_to_quat_matches_jax():
    """Random rotations and ones near 180 degrees about each axis, where
    the largest Shepperd candidate changes; equal up to the sign that
    w = 0 leaves open (1e-6)."""
    rng = np.random.default_rng(7)
    q = np.concatenate([rng.normal(size=(200, 4)),
                        [[1e-3, 1, 0, 0], [1e-3, 0, 1, 0], [1e-3, 0, 0, 1],
                         [0, 1, 1, 0], [0.5, 0.5, 0.5, 0.5]]])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = np.asarray(jse3.quat_to_mat(jnp.asarray(q, jnp.float32)))
    ref = np.asarray(jse3.mat_to_quat(jnp.asarray(R)))
    got = tse3.mat_to_quat(torch.from_numpy(R)).numpy()
    assert (got[:, 0] >= 0).all()
    err = np.minimum(np.abs(got - ref).max(1), np.abs(got + ref).max(1))
    assert err.max() <= 1e-6, err.max()


def test_projection_and_frustum_match_jax():
    rng = np.random.default_rng(1)
    jcam = jproj.CameraParams(**CAM_ARGS)
    tcam = tproj.CameraParams(**CAM_ARGS)
    pc = rng.uniform([-2, -2, -0.5], [2, 2, 8], (256, 3)).astype(np.float32)
    uvr_t, z_t = tproj.project_stereo(tcam, torch.from_numpy(pc))
    uvr_j, z_j = jproj.project_stereo(jcam, pc)
    front = pc[:, 2] > 0.05
    np.testing.assert_allclose(uvr_t.numpy()[front], np.asarray(uvr_j)[front],
                               rtol=1e-6, atol=1e-3)
    _close(z_t, z_j)

    dist = rng.uniform(0.1, 10.0, 256).astype(np.float32)
    maxd = rng.uniform(0.1, 10.0, 256).astype(np.float32)
    np.testing.assert_array_equal(
        tproj.predict_scale(torch.from_numpy(dist), torch.from_numpy(maxd),
                            1.2, 8).numpy(),
        np.asarray(jproj.predict_scale(dist, maxd, 1.2, 8)))

    pose, _ = _poses(rng, 1)
    pw = rng.uniform([-3, -3, 0], [3, 3, 8], (512, 3)).astype(np.float32)
    normal = rng.normal(size=(512, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    mind = rng.uniform(0.1, 1.0, 512).astype(np.float32)
    out_t = tproj.in_frustum(tcam, torch.from_numpy(pose[0]),
                             torch.from_numpy(pw), torch.from_numpy(normal),
                             torch.from_numpy(mind),
                             torch.from_numpy(mind * 8))
    out_j = jproj.in_frustum(jcam, pose[0], pw, normal, mind, mind * 8)
    agree = (out_t[0].numpy() == np.asarray(out_j[0])).mean()
    assert agree == 1.0, agree
    for a, b in zip(out_t[2:], out_j[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["OrbConfig", "TrackingConfig", "MapConfig",
                                  "SlamConfig"])
def test_config_fields_and_defaults_match_jax(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    jf = [(f.name, getattr(j, f.name)) for f in dataclasses.fields(j)]
    tf = [(f.name, getattr(t, f.name)) for f in dataclasses.fields(t)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, a), (_, b) in zip(jf, tf):
        if n in ("camera", "orb", "tracking", "map"):
            a = tuple(a) if n == "camera" else dataclasses.asdict(a)
            b = tuple(b) if n == "camera" else dataclasses.asdict(b)
        assert a == b, n


def test_camera_params_match_jax():
    jc = jproj.CameraParams(**CAM_ARGS)
    tc = tproj.CameraParams(**CAM_ARGS)
    assert jc._fields == tc._fields and tuple(jc) == tuple(tc)
    assert jc.bounds() == tc.bounds() and jc.baseline == tc.baseline
    jb = jc._replace(min_x=3.0, max_x=300.0)
    tb = tc._replace(min_x=3.0, max_x=300.0)
    assert jb.bounds() == tb.bounds()


def test_load_settings_matches_jax(tmp_path):
    from tests.test_dataset_integration import EUROC_RECT_YAML, TUM_YAML
    p = tmp_path / "tum.yaml"
    p.write_text(TUM_YAML)
    j = jcfg.load_settings(str(p), sensor="rgbd")
    t = tcfg.load_settings(str(p), sensor="rgbd")
    assert tuple(j.camera) == tuple(t.camera)
    assert dataclasses.asdict(j.orb) == dataclasses.asdict(t.orb)
    assert dataclasses.asdict(j.tracking) == dataclasses.asdict(t.tracking)
    assert (j.fps, j.sensor, j.distortion) == (t.fps, t.sensor, t.distortion)
    assert tcfg.load_rectification(str(p)) is None
    q = tmp_path / "euroc.yaml"
    q.write_text(EUROC_RECT_YAML)
    for a, b in zip(jcfg.load_rectification(str(q)),
                    tcfg.load_rectification(str(q))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_undistort_matches_jax():
    from active_orb_slam2_tpu.ops import undistort as jund
    from active_orb_slam2_tpu_torch.ops import undistort as tund
    dist = (0.26, -0.9, -0.001, 0.002, 1.1)
    rng = np.random.default_rng(2)
    uv = rng.uniform([0, 0], [320, 240], (128, 2)).astype(np.float32)
    _close(tund.undistort_points(tproj.CameraParams(**CAM_ARGS), dist,
                                 torch.from_numpy(uv)),
           jund.undistort_points(jproj.CameraParams(**CAM_ARGS), dist, uv),
           atol=1e-3)
    np.testing.assert_allclose(
        tund.compute_image_bounds(tproj.CameraParams(**CAM_ARGS), dist),
        jund.compute_image_bounds(jproj.CameraParams(**CAM_ARGS), dist),
        atol=1e-3)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_umeyama_matches_jax(fix_scale):
    from active_orb_slam2_tpu.geometry.horn import umeyama_alignment as jum
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    rng = np.random.default_rng(7)
    src = rng.normal(0, 1, (40, 3)).astype(np.float32)
    R = np.asarray(jse3.quat_to_mat(_poses(rng, 1)[0][0, :4]))
    dst = (1.3 * src @ R.T + [0.2, -0.1, 0.4]
           + rng.normal(0, 0.01, (40, 3))).astype(np.float32)
    aligned, _, _, s, rmse = umeyama_alignment(src, dst, fix_scale)
    ja, _, _, js, jrmse = jum(jnp.asarray(src), jnp.asarray(dst), fix_scale)
    np.testing.assert_allclose(aligned, np.asarray(ja), atol=1e-4)
    np.testing.assert_allclose([s, rmse], [float(js), float(jrmse)],
                               rtol=1e-4)


def test_trajectory_io_matches_jax(tmp_path):
    from active_orb_slam2_tpu.io import trajectory as jtraj
    from active_orb_slam2_tpu_torch.io import trajectory as ttraj
    rng = np.random.default_rng(8)
    kf, _ = _poses(rng, 4)
    tcr, _ = _poses(rng, 6)
    recs = [(i / 30.0, [0, 1, 3, -1, 2, 0][i], tcr[i]) for i in range(6)]
    ts_t, p_t = ttraj.resolve_frame_poses(recs, kf)
    ts_j, p_j = jtraj.resolve_frame_poses(recs, kf)
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_allclose(p_t, p_j, atol=1e-6)
    np.testing.assert_allclose(ttraj.camera_centers(p_t),
                               jtraj.camera_centers(p_j), atol=1e-5)
    for fn, args in (("save_tum", (ts_t, p_t)), ("save_kitti", (p_t,))):
        getattr(ttraj, fn)(str(tmp_path / "t.txt"), *args)
        getattr(jtraj, fn)(str(tmp_path / "j.txt"), *args)
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t.txt"),
                                   np.loadtxt(tmp_path / "j.txt"), atol=1e-5)
