"""The port's slice, ``System(cfg, use_mapping=False).track_rgbd``, free-
running beside the JAX package's on the orbit of ``test_e2e_rgbd.py``,
and the check that the port runs without JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.io.trajectory import camera_centers as j_centers
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
from active_orb_slam2_tpu_torch.models import system as tsys
from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
from tests.test_torch_tracking import configs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_both(n_frames):
    """Track the orbit on both sides; returns per-side (metrics, states
    after each frame, camera centres) and the ground-truth centres."""
    jc, tc = configs()
    jslam = jsys.System(jc, use_mapping=False)
    tslam = tsys.System(tc, use_mapping=False, device="cpu")
    gt, jstates, tstates = [], [], []
    for i, (g, d, Twc) in enumerate(jsyn.make_sequence(
            n_frames, jc.camera, world=jsyn.default_world(),
            trajectory=jsyn.orbit_trajectory(n_frames, step_deg=2.0))):
        jslam.track_rgbd(g, d, i / 30.0)
        tslam.track_rgbd(g, d, i / 30.0)
        jstates.append(jslam.state)
        tstates.append(tslam.state)
        gt.append(Twc[:3, 3])
    out = []
    for slam, states, centers in ((jslam, jstates, j_centers),
                                  (tslam, tstates, camera_centers)):
        _, poses = slam.frame_trajectory()
        out.append((slam.metrics, states, np.asarray(centers(poses))))
    return out, np.stack(gt)


def test_slice_free_running_matches_jax():
    (jres, tres), gt = run_both(12)
    for metrics, states, centers in (jres, tres):
        assert states == [jsys.OK] * 12 == [tsys.OK] * 12
        assert centers.shape == (12, 3)
    # per-frame camera centres within 5 mm
    err = np.linalg.norm(jres[2] - tres[2], axis=1)
    assert err.max() <= 5e-3, err
    # per-frame local-stage inliers within 5%
    nj = np.array([m["n_inliers"] for m in jres[0]])
    nt = np.array([m["n_inliers"] for m in tres[0]])
    assert len(nj) == len(nt) == 11
    assert (np.abs(nt - nj) <= 0.05 * nj).all(), (nj, nt)


@pytest.mark.slow
def test_slice_ate_matches_jax_30_frames():
    (jres, tres), gt = run_both(30)
    assert tres[1][-1] == tsys.OK
    ate_j = umeyama_alignment(jres[2], gt, fix_scale=True)[4]
    ate_t = umeyama_alignment(tres[2], gt, fix_scale=True)[4]
    assert abs(ate_t - ate_j) <= 0.005, (ate_t, ate_j)


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py, bench_torch.py and the
    port's endurance, long-sequence, tracking-profile, closure-dissector
    and determinism-trace scripts import without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import active_orb_slam2_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, bench_torch\n"
        "sys.path.insert(0, 'scripts')\n"
        "import run_torch_endurance, run_torch_long_sequence\n"
        "import profile_torch_track, dissect_torch_closure\n"
        "import trace_torch_determinism\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'active_orb_slam2_tpu.'))\n"
        "             or m == 'active_orb_slam2_tpu')\n"
        "assert not bad, bad\n"
        "new = ('models.relocalization', 'ops.stereo', 'models.vocabulary',\n"
        "       'models.sim3_solver', 'models.pose_graph', 'geometry.horn',\n"
        "       'parallel.dist_ba', 'models.loop_closing', 'utils.transfer',\n"
        "       'models.initializer', 'models.mono_init', 'io.datasets',\n"
        "       'io.native', 'utils.evaluate', 'examples.run_mono_tum',\n"
        "       'examples.run_tum_rgbd', 'examples.run_kitti_mono',\n"
        "       'examples.run_kitti_stereo', 'examples.run_euroc_mono',\n"
        "       'examples.run_euroc_stereo', 'examples.run_synthetic',\n"
        "       'active', 'active.occupancy', 'active.scoring',\n"
        "       'active.frontier', 'active.planner', 'active.explorer',\n"
        "       'examples.run_exploration', 'parallel.mesh',\n"
        "       'parallel.matcher', 'utils.viz')\n"
        "assert all(p.__name__ + '.' + m in sys.modules for m in new)\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_not_ported_paths_raise(tmp_path):
    _, tc = configs()
    # loop closing (ROADMAP item 15) is ported: the System constructs
    # with it, with or without mapping
    for mapping in (True, False):
        slam = tsys.System(tc, use_mapping=mapping, use_loop_closing=True,
                           device="cpu")
        assert slam.loop_closer is not None and slam.n_loops_closed == 0
    # local mapping (the default), map saving, localization-only mode and
    # relocalization are ported
    slam = tsys.System(tc, device="cpu")
    assert slam.use_mapping
    slam.save_map(str(tmp_path / "empty.npz"))
    # monocular input (ROADMAP item 17) is ported: a black mono frame
    # leaves the state NOT_INITIALIZED, and a mono System retires each
    # frame before the next
    mono = tsys.System(dataclasses.replace(tc, sensor="mono"), device="cpu")
    assert (mono.pipeline_depth, mono.retire_batch) == (0, 1)
    assert (slam.pipeline_depth, slam.retire_batch) == (6, 4)
    mono.track_mono(np.zeros((240, 320), np.uint8), 0.0)
    assert mono.state == tsys.NOT_INITIALIZED and mono.kf_seq == 0
    slam.activate_localization_mode()
    assert slam.localization_only
    # a LOST frame with an empty map fails to relocalize: it is recorded
    # LOST at the carried pose, with no exception
    slam._state = tsys.LOST
    slam.track_rgbd(np.zeros((240, 320), np.uint8),
                    np.zeros((240, 320), np.float32), 0.0)
    assert slam.state == tsys.LOST and slam.relocalizer is not None
    assert slam.metrics[-1]["state"] == tsys.LOST


def test_system_defaults_to_cuda():
    """The entry point runs on the card unless told otherwise; without a
    card it raises rather than falling back to the CPU."""
    import inspect
    default = inspect.signature(tsys.System).parameters["device"].default
    assert torch.device(default).type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    _, tc = configs()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsys.System(tc)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsys.System(tc, use_mapping=False, device="cuda")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsys.System(tc, use_loop_closing=True)


def test_trajectory_outputs(tmp_path):
    """Trajectory writers and metrics on a short port run."""
    _, tc = configs()
    slam = tsys.System(tc, use_mapping=False, device="cpu")
    for i, (g, d, _) in enumerate(jsyn.make_sequence(
            4, tc.camera, world=jsyn.default_world(),
            trajectory=jsyn.orbit_trajectory(4, step_deg=2.0))):
        mat = slam.track_rgbd(g, d, i / 30.0)
        assert mat.shape == (4, 4)
    slam.save_trajectory_tum(str(tmp_path / "t.txt"))
    slam.save_trajectory_kitti(str(tmp_path / "k.txt"))
    slam.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    slam.save_metrics(str(tmp_path / "m.jsonl"))
    tum = np.loadtxt(tmp_path / "t.txt")
    assert tum.shape == (4, 8)
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:8], axis=1), 1.0,
                               atol=1e-5)
    kitti = np.loadtxt(tmp_path / "k.txt")
    R = kitti[-1].reshape(3, 4)[:, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert np.loadtxt(tmp_path / "kf.txt").shape == (8,)
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 3
    slam.reset()
    assert slam.state == tsys.NOT_INITIALIZED and slam.rel_records == []
