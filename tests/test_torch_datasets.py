"""The port's dataset path: the cases of ``tests/test_dataset_integration.py``
on the port's loaders (``io/datasets.py``), settings and evaluation
(``utils/evaluate.py``) and ``System`` on the CPU, the loaders beside
the JAX package's on the same files, and the port's entry points run as
``python -m`` over synthetic TUM, KITTI and EuRoC directories written
under ``tmp_path``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.io import datasets as jds
from active_orb_slam2_tpu.utils import evaluate as jeval
from active_orb_slam2_tpu_torch import config as tcfg
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.io import datasets as tds
from active_orb_slam2_tpu_torch.io.synthetic import (
    default_world, make_sequence, orbit_trajectory)
from active_orb_slam2_tpu_torch.models.system import OK, System
from active_orb_slam2_tpu_torch.utils import evaluate as teval
from active_orb_slam2_tpu_torch.geometry.se3 import mat44_to_se3
from tests.test_dataset_integration import (  # noqa: F401 (fixture)
    EUROC_RECT_YAML, TUM_YAML, tum_dir)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                   width=320, height=240)
CFG = tcfg.SlamConfig(     # tests/test_e2e_rgbd.py's configuration
    camera=CAM, orb=tcfg.OrbConfig(n_features=512, n_levels=4),
    tracking=tcfg.TrackingConfig(th_depth=8.0),
    map=tcfg.MapConfig(max_keyframes=32, max_points=8192,
                       local_ba_keyframes=8, local_ba_points=2048))


def test_load_settings_yaml(tum_dir):
    cfg = tcfg.load_settings(str(tum_dir / "TUM_synth.yaml"), sensor="rgbd")
    assert cfg.camera.fx == 260.0
    assert cfg.camera.bf == 20.8
    assert cfg.orb.n_features == 512
    assert cfg.orb.n_levels == 4
    assert abs(cfg.tracking.th_depth - 40.0 * 20.8 / 260.0) < 1e-6


def test_tum_loader_and_association(tum_dir):
    ds = tds.TumRgbdDataset(str(tum_dir))
    assert len(ds) == 16
    t, gray, depth_mm = next(iter(ds))
    assert gray.dtype == np.uint8 and gray.shape == (240, 320)
    assert depth_mm.dtype == np.uint16
    assert 1000 < np.median(depth_mm[depth_mm > 0]) < 12000
    # the JAX package's loader gives the same frames and ground truth
    for (t, g, d), (jt, jg, jd) in zip(ds, jds.TumRgbdDataset(str(tum_dir))):
        assert t == jt
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(d, jd)
    for (t, v), (jt, jv) in zip(ds.groundtruth(),
                                jds.TumRgbdDataset(str(tum_dir)).groundtruth()):
        assert t == jt
        np.testing.assert_array_equal(v, jv)


def test_full_cli_flow(tum_dir, tmp_path):
    """The run_tum_rgbd flow as a function on the port, on the CPU:
    loaders -> System -> trajectory file -> ATE against
    groundtruth.txt below 0.05 m."""
    ds = tds.TumRgbdDataset(str(tum_dir))
    slam = System(CFG, device="cpu")
    for t, gray, depth_mm in ds:
        slam.track_rgbd(gray, depth_mm, t)
    assert slam.state == OK
    traj = tmp_path / "CameraTrajectory.txt"
    slam.save_trajectory_tum(str(traj))
    data = np.loadtxt(traj)
    assert data.shape == (16, 8)
    np.testing.assert_allclose(data[0, 0], 1000.0, atol=1e-3)
    rmse = teval.evaluate_ate_tum(slam, ds.groundtruth())
    assert rmse < 0.05, rmse


def test_euroc_rectification_roundtrip(tmp_path):
    """LEFT/RIGHT blocks -> rectify maps -> remap, on the port's copies,
    and the maps equal to the JAX package's."""
    y = tmp_path / "EuRoC.yaml"
    y.write_text(EUROC_RECT_YAML)
    blocks = tcfg.load_rectification(str(y))
    assert blocks is not None
    (mlx, mly), (mrx, mry) = tds.stereo_rectify_maps(*blocks)
    assert mlx.shape == (480, 752)
    (jlx, jly), (jrx, jry) = jds.stereo_rectify_maps(*blocks)
    for a, b in ((mlx, jlx), (mly, jly), (mrx, jrx), (mry, jry)):
        np.testing.assert_array_equal(a, b)
    cy, cx = 252, 367
    assert abs(mlx[cy, cx] - cx) < 3.0 and abs(mly[cy, cx] - cy) < 6.0

    K = blocks[0]
    P = np.concatenate([K, np.zeros((3, 1))], 1)
    (ilx, ily), _ = tds.stereo_rectify_maps(
        K, np.zeros(5), np.eye(3), P, K, np.zeros(5), np.eye(3), P,
        752, 480)
    ys, xs = np.mgrid[0:480, 0:752]
    np.testing.assert_allclose(ilx, xs, atol=1e-9)
    np.testing.assert_allclose(ily, ys, atol=1e-9)
    img = (np.arange(480 * 752) % 251).reshape(480, 752).astype(np.uint8)
    out = tds.remap_bilinear(img, ilx, ily)
    np.testing.assert_array_equal(out[1:-1, 1:-1], img[1:-1, 1:-1])


def test_no_rectification_returns_none(tum_dir):
    assert tcfg.load_rectification(str(tum_dir / "TUM_synth.yaml")) is None


def test_evaluation_matches_jax():
    """Association, ATE (rigid and similarity) and RPE against the JAX
    package's on the same noisy trajectories: indices equal, errors
    within 1e-6 relative."""
    rng = np.random.default_rng(4)
    gt_ts = np.arange(60) / 30.0
    est_ts = gt_ts[5:] + rng.uniform(-0.01, 0.01, 55)
    gt = np.cumsum(rng.normal(0, 0.05, (60, 3)), 0)
    est = 1.7 * gt[5:] + rng.normal(0, 0.01, (55, 3)) + [0.3, -0.2, 1.0]
    assert teval.associate_timestamps(est_ts, gt_ts) == \
        jeval.associate_timestamps(est_ts, gt_ts)
    for fix in (True, False):
        np.testing.assert_allclose(
            teval.ate_rmse(est_ts, est, gt_ts, gt, fix_scale=fix),
            jeval.ate_rmse(est_ts, est, gt_ts, gt, fix_scale=fix), rtol=1e-5)
    np.testing.assert_allclose(
        teval.rpe_translation(est_ts, est, gt_ts, gt, delta_frames=10),
        jeval.rpe_translation(est_ts, est, gt_ts, gt, delta_frames=10),
        rtol=1e-6)
    assert np.isnan(teval.ate_rmse(est_ts[:2], est[:2], gt_ts, gt))


# ------------------------------------------------------------- entry points

MONO_YAML = TUM_YAML.replace("Camera.bf: 20.8\n", "")


def identity_rectification(width, height, fx, cx, cy, bf):
    """``LEFT`` / ``RIGHT`` blocks of a rectified pair with no distortion
    (K = P), in the settings' YAML form."""
    def mat(name, rows, cols, data):
        return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}"
                f"\n   dt: d\n   data: [{', '.join(map(str, data))}]\n")
    K = [fx, 0.0, cx, 0.0, fx, cy, 0.0, 0.0, 1.0]
    out = ""
    for side, tx in (("LEFT", 0.0), ("RIGHT", -bf)):
        out += (f"{side}.height: {height}\n{side}.width: {width}\n"
                + mat(f"{side}.D", 1, 5, [0.0] * 5) + mat(f"{side}.K", 3, 3, K)
                + mat(f"{side}.R", 3, 3, [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0])
                + mat(f"{side}.P", 3, 4, [fx, 0.0, cx, tx, 0.0, fx, cy, 0.0,
                                          0.0, 0.0, 1.0, 0.0]))
    return out


def write_pngs(d, frames, names):
    from PIL import Image
    d.mkdir(parents=True, exist_ok=True)
    for g, name in zip(frames, names):
        Image.fromarray(np.clip(g, 0, 255).astype(np.uint8), "L").save(
            d / name)


@pytest.fixture(scope="module")
def mono_tum_dir(tmp_path_factory):
    """A TUM directory of 16 frames of ``tests/test_e2e_mono.py``'s orbit
    (radius 2 m, 2 degrees a frame), with ground truth and settings."""
    from PIL import Image
    d = tmp_path_factory.mktemp("tum_mono")
    (d / "rgb").mkdir()
    (d / "depth").mkdir()
    rgb, dep, gt = [], [], []
    for i, (g, depth, Twc) in enumerate(make_sequence(
            16, CAM, world=default_world(),
            trajectory=orbit_trajectory(16, radius=2.0, step_deg=2.0))):
        t = 1000.0 + i / 30.0
        Image.fromarray(np.clip(g, 0, 255).astype(np.uint8), "L").save(
            d / "rgb" / f"{t:.6f}.png")
        Image.fromarray(np.clip(depth * 5000.0, 0, 65535).astype(
            np.uint16)).save(d / "depth" / f"{t:.6f}.png")
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t:.6f} depth/{t:.6f}.png")
        p = mat44_to_se3(torch.from_numpy(Twc.astype(np.float32))).numpy()
        gt.append(f"{t:.6f} {p[4]} {p[5]} {p[6]} {p[1]} {p[2]} {p[3]} {p[0]}")
    (d / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (d / "depth.txt").write_text("\n".join(dep) + "\n")
    (d / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    (d / "mono.yaml").write_text(MONO_YAML)
    return d


def run_entry(name, *args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", f"active_orb_slam2_tpu_torch.examples.{name}",
         *args, "--device", "cpu"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_run_mono_tum_entry_point(mono_tum_dir, tmp_path):
    """``python -m ...examples.run_mono_tum --device cpu`` over the
    synthetic TUM directory: it initializes, writes both trajectories,
    and its Sim3 ATE is below ``tests/test_e2e_mono.py``'s 0.05."""
    out = run_entry("run_mono_tum", str(mono_tum_dir), "--settings",
                    str(mono_tum_dir / "mono.yaml"), "--ate", "--frame-traj",
                    "frames.txt", cwd=tmp_path)
    kf = np.loadtxt(tmp_path / "KeyFrameTrajectory.txt")
    assert kf.ndim == 2 and kf.shape[0] >= 2 and kf.shape[1] == 8
    assert np.loadtxt(tmp_path / "frames.txt").shape == (16, 8)
    ate = float(out.split("ATE RMSE (Sim3):")[1].split()[0])
    assert ate < 0.05, out


def test_run_tum_rgbd_entry_point(tum_dir, tmp_path):
    out = run_entry("run_tum_rgbd", str(tum_dir), "--settings",
                    str(tum_dir / "TUM_synth.yaml"), "--ate",
                    "--no-loop-closing", "--metrics", "m.jsonl",
                    cwd=tmp_path)
    assert np.loadtxt(tmp_path / "CameraTrajectory.txt").shape == (16, 8)
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) >= 15
    assert float(out.split("ATE RMSE:")[1].split()[0]) < 0.05, out


def test_kitti_and_euroc_entry_points(tmp_path):
    """The KITTI and EuRoC entry points, stereo and mono, on 6 synthetic
    frames in each layout (the right image is the left one shifted by a
    constant disparity): each runs to its end and writes its
    trajectory; the loaders match the JAX package's."""
    frames = [g for g, _, _ in make_sequence(
        6, CAM, world=default_world(),
        trajectory=orbit_trajectory(6, radius=2.0, step_deg=2.0))]
    right = [np.roll(g, -8, axis=1) for g in frames]
    seq = tmp_path / "kitti" / "sequences" / "00"
    names = [f"{i:06d}.png" for i in range(6)]
    write_pngs(seq / "image_0", frames, names)
    write_pngs(seq / "image_1", right, names)
    (seq / "times.txt").write_text("".join(f"{i / 10.0:e}\n"
                                           for i in range(6)))
    cam = tmp_path / "euroc" / "mav0"
    stamps = [f"{1403636579763555584 + i * 50000000}.png" for i in range(6)]
    write_pngs(cam / "cam0" / "data", frames, stamps)
    write_pngs(cam / "cam1" / "data", right, stamps)
    yaml = tmp_path / "settings.yaml"
    yaml.write_text(TUM_YAML)
    rect_yaml = tmp_path / "rectified.yaml"
    rect_yaml.write_text(TUM_YAML + identity_rectification(
        320, 240, CAM.fx, CAM.cx, CAM.cy, CAM.bf))

    for tds_set, jds_set in (
            (tds.KittiOdometryDataset(str(tmp_path / "kitti"), "00"),
             jds.KittiOdometryDataset(str(tmp_path / "kitti"), "00")),
            (tds.EurocDataset(str(tmp_path / "euroc")),
             jds.EurocDataset(str(tmp_path / "euroc")))):
        assert len(tds_set) == len(jds_set) == 6
        for a, b in zip(tds_set, jds_set):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])

    kitti = ("--settings", str(yaml), str(tmp_path / "kitti"), "00")
    euroc = ("--settings", str(yaml), str(tmp_path / "euroc"))
    for name, args, traj, cols in (
            ("run_kitti_stereo", kitti + ("--no-loop-closing",),
             "CameraTrajectory.txt", 12),
            ("run_kitti_mono", kitti, "KeyFrameTrajectory.txt", 8),
            ("run_euroc_stereo", ("--settings", str(rect_yaml),
                                  str(tmp_path / "euroc"),
                                  "--no-loop-closing"),
             "CameraTrajectory.txt", 8),
            ("run_euroc_mono", euroc, "KeyFrameTrajectory.txt", 8)):
        work = tmp_path / name
        work.mkdir()
        out = run_entry(name, *args, cwd=work)
        assert "frames: 6 " in out, (name, out)
        data = np.loadtxt(work / traj, ndmin=2)
        assert data.shape[1] == cols, name


def test_run_exploration_entry_point(tmp_path):
    """``python -m ...examples.run_exploration --device cpu --steps 1``:
    the example's configuration (320x240, loop closing on, the 32x32
    grid over ``default_world(n_boxes=4)``) plans once, moves, and prints
    the JAX example's four lines."""
    out = run_entry("run_exploration", "--steps", "1", cwd=tmp_path)
    lines = out.strip().splitlines()
    assert len(lines) == 4, out
    assert lines[0] == "steps: 1  replans: 1", out
    assert lines[1].startswith("coverage: ") and " -> " in lines[1]
    points = [int(v) for v in lines[2].split(":")[1].split("->")]
    assert len(points) == 2 and points[0] > 0, out
    assert lines[3].startswith("keyframes: ") and "loops: 0" in lines[3]
