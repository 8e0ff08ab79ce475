"""The port's ``System`` with local mapping on, beside the JAX package's,
on the orbit of ``test_e2e_rgbd.py`` (320x240, 512 features, 4 levels).

The two free-running trajectories differ legitimately: the JAX package's
local BA loses its pose write-back whenever a local camera reappears as
a masked lane of the fixed ring (ROADMAP queue 3, item g), the port's
does not.  So the comparison is at the level of states, keyframe counts
and camera centres.
"""

import dataclasses

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.io.trajectory import camera_centers as j_centers
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models import system as tsys
from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
from tests.test_torch_tracking import configs

torch.set_num_threads(1)

JC, TC = configs()


def orbit(n, n_traj=None, **kw):
    return list(jsyn.make_sequence(
        n, JC.camera, world=jsyn.default_world(),
        trajectory=jsyn.orbit_trajectory(n_traj or n, step_deg=2.0, **kw)))


def record_mapping_calls(slam):
    """Wrap the System's keyframe-mapping call; returns the list of the
    keyframe slots it is called with."""
    calls = []
    run = slam.keyframe_mapping

    def wrapped(m, k, seq):
        calls.append(k)
        return run(m, k, seq)

    slam.keyframe_mapping = wrapped
    return calls


def tracked_centre(Tcw):
    """Camera centre of a 4x4 Tcw as ``track_rgbd`` returns it."""
    Tcw = np.asarray(Tcw, np.float64)
    return -Tcw[:3, :3].T @ Tcw[:3, 3]


def run_port(cfg, frames, tracked=None):
    slam = tsys.System(cfg, device="cpu")
    calls = record_mapping_calls(slam)
    states, gt = [], []
    for i, (g, d, Twc) in enumerate(frames):
        Tcw = slam.track_rgbd(g, d, i / 30.0)
        states.append(slam.state)
        gt.append(Twc[:3, 3])
        if tracked is not None:
            tracked.append(tracked_centre(Tcw.numpy()))
    return slam, states, calls, np.stack(gt)


@pytest.fixture(scope="module")
def runs():
    """12 free-running frames on both sides with mapping on; each frame
    retires before the next, on both sides."""
    frames = orbit(12)
    jslam = jsys.System(JC, pipeline_depth=0, retire_batch=1)
    jstates, jtracked, ttracked = [], [], []
    for i, (g, d, _) in enumerate(frames):
        jtracked.append(tracked_centre(jslam.track_rgbd(g, d, i / 30.0)))
        jstates.append(jslam.state)
    tslam, tstates, calls, _ = run_port(TC, frames, ttracked)
    return (jslam, jstates, tslam, tstates, calls, frames,
            np.stack(jtracked), np.stack(ttracked))


def test_mapping_free_running_matches_jax(runs):
    jslam, jstates, tslam, tstates, calls, frames, jtracked, ttracked = runs
    assert jstates == [jsys.OK] * 12 and tstates == [tsys.OK] * 12
    assert tslam.kf_seq >= 2
    assert abs(tslam.kf_seq - jslam.kf_seq) <= 1, (tslam.kf_seq, jslam.kf_seq)
    # one keyframe-mapping call per keyframe event after the first
    assert len(calls) == tslam.kf_seq - 1
    # the poses tracking returned, frame by frame: within 1 cm (measured
    # up to 1.3 mm)
    err = np.linalg.norm(jtracked - ttracked, axis=1)
    assert err.max() <= 0.01, err
    _, pj = jslam.frame_trajectory()
    _, pt = tslam.frame_trajectory()
    cj, ct = j_centers(pj), camera_centers(pt)
    # the trajectories replayed against the final keyframe poses: the
    # port's local BA writes its poses back where the JAX package's loses
    # them, which moves the replayed frames of those keyframes: centres
    # within 1.5 cm (measured up to 1.06 cm), ATE within 3 mm
    err = np.linalg.norm(cj - ct, axis=1)
    assert err.max() <= 0.015, err
    gt = np.stack([Twc[:3, 3] for _, _, Twc in frames])
    ate_j = umeyama_alignment(cj, gt, fix_scale=True)[4]
    ate_t = umeyama_alignment(ct, gt, fix_scale=True)[4]
    assert abs(ate_t - ate_j) <= 0.003, (ate_t, ate_j)
    np.testing.assert_array_equal(tslam.map.kf_valid.numpy(),
                                  np.asarray(jslam.map.kf_valid))


def _same_arena(a: dict, b: dict):
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], f)


def test_save_load_map_round_trip(runs, tmp_path):
    """save_map / load_map within the port and across the two packages:
    the arena arrives unchanged and the system waits LOST for
    relocalization, which is ROADMAP item 14 in the port."""
    jslam, _, tslam, _, _, frames = runs[:6]
    ck = tslam.checkpoint()
    port_file = str(tmp_path / "port.npz")
    tslam.save_map(port_file)
    back = tsys.System(TC, device="cpu")
    back.load_map(port_file)
    assert back.state == tsys.LOST and back.kf_seq == tslam.kf_seq
    assert back.n_live_kf == int(ck["kf_valid"].sum())
    _same_arena(back.checkpoint(), ck)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        back.track_rgbd(*frames[0][:2], 1.0)

    j_from_port = jsys.System(JC)
    j_from_port.load_map(port_file)
    assert j_from_port.state == jsys.LOST
    _same_arena(j_from_port.checkpoint(), ck)

    jax_file = str(tmp_path / "jax.npz")
    jslam.save_map(jax_file)
    t_from_jax = tsys.System(TC, device="cpu")
    t_from_jax.load_map(jax_file)
    assert t_from_jax.state == tsys.LOST
    assert t_from_jax.kf_seq == jslam.kf_seq
    _same_arena(t_from_jax.checkpoint(), jslam.checkpoint())

    # restore() writes a checkpoint into another System's arena
    other = tsys.System(TC, device="cpu")
    other.restore(ck)
    _same_arena(convert.map_to_jax_numpy(other.map), ck)


def test_arena_full_culls_keyframes():
    """An 8-keyframe arena with a keyframe every 2 frames: keyframe
    culling, forced eviction, slot recycling and the cull-redirect
    lineage all run, and every frame keeps a finite pose."""
    tc = dataclasses.replace(
        TC, tracking=dataclasses.replace(TC.tracking, kf_max_interval=2),
        map=dataclasses.replace(TC.map, max_keyframes=8, max_points=16384))
    slam, states, calls, gt = run_port(tc, orbit(30))
    assert states == [tsys.OK] * 30
    assert slam.kf_seq > 8 and len(calls) == slam.kf_seq - 1
    n_culled = slam.kf_seq - slam.n_live_kf
    assert n_culled >= 5, n_culled
    assert slam.n_live_kf == int(slam.map.kf_valid.sum()) <= 8
    assert slam.n_forced_culls >= 1
    _, poses = slam.frame_trajectory()
    assert poses.shape == (30, 7) and np.isfinite(poses).all()
    ate = umeyama_alignment(camera_centers(poses), gt, fix_scale=True)[4]
    assert ate < 0.025, ate


@pytest.mark.slow
def test_e2e_rgbd_checks_on_port(tmp_path):
    """Every check of ``test_e2e_rgbd.py`` on the port's System."""
    slam, states, calls, gt = run_port(TC, orbit(30))
    assert slam.state == tsys.OK and states[-1] == tsys.OK
    assert int(slam.map.pt_valid.sum()) > 200
    assert int(slam.track.n_inliers) > 50
    assert len(calls) == slam.kf_seq - 1
    ts, poses = slam.frame_trajectory()
    assert camera_centers(poses).shape[0] == 30
    ate = umeyama_alignment(camera_centers(poses), gt, fix_scale=True)[4]
    assert ate < 0.025, ate
    assert 2 <= slam.kf_seq <= 25
    parents = slam.map.kf_parent.numpy()
    slots = np.where(slam.map.kf_valid.numpy())[0]
    assert (parents[slots[1:]] >= 0).all()
    # trajectory files
    slam.save_trajectory_tum(str(tmp_path / "traj.txt"))
    slam.save_trajectory_kitti(str(tmp_path / "traj_kitti.txt"))
    tum = np.loadtxt(tmp_path / "traj.txt")
    assert tum.shape == (30, 8)
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:8], axis=1), 1.0,
                               atol=1e-5)
    kitti = np.loadtxt(tmp_path / "traj_kitti.txt")
    assert kitti.shape == (30, 12)
    R = kitti[0].reshape(3, 4)[:, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    # checkpoint round trip
    ck = slam.checkpoint()
    slam2 = tsys.System(TC, device="cpu")
    slam2.restore(ck)
    np.testing.assert_array_equal(slam2.map.pt_valid.numpy(),
                                  slam.map.pt_valid.numpy())
    np.testing.assert_allclose(slam2.map.kf_pose.numpy(),
                               slam.map.kf_pose.numpy())
    # reset and re-initialisation
    seq = orbit(6, radius=2.0)
    s2 = tsys.System(TC, device="cpu")
    for i, (g, d, _) in enumerate(seq):
        s2.track_rgbd(g, d, i / 30.0)
    assert s2.kf_seq > 0
    s2.reset()
    assert s2.state == tsys.NOT_INITIALIZED
    assert s2.kf_seq == 0 and s2.rel_records == [] and s2.kf_records == []
    assert int(s2.map.pt_valid.sum()) == 0
    for i, (g, d, _) in enumerate(seq):
        s2.track_rgbd(g, d, i / 30.0)
    assert s2.kf_seq > 0 and s2.state == tsys.OK
