"""The port's ``System`` on LOST frames, after ``load_map`` and in
localization-only mode, beside the JAX package's where both run.

The orbit and configuration of ``test_e2e_rgbd.py`` (320x240, 512
features, 4 levels), mapping on, loop closing off on both sides; the
JAX System retires each frame before the next (``pipeline_depth=0,
retire_batch=1``) and the port's state is read after each frame, which
drains its pipeline too.
"""

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu_torch.models import system as tsys
from tests.test_torch_tracking import configs

torch.set_num_threads(1)

JC, TC = configs()
N_MAPPED = 18


def orbit(n):
    return list(jsyn.make_sequence(
        n, JC.camera, world=jsyn.default_world(),
        trajectory=jsyn.orbit_trajectory(n, step_deg=2.0)))


def tracked_centre(Tcw):
    Tcw = np.asarray(Tcw, np.float64)
    return -Tcw[:3, :3].T @ Tcw[:3, 3]


@pytest.fixture(scope="module")
def blackout(tmp_path_factory):
    """``tests/test_relocalization.py``'s flow on both sides: frames 0-17
    (each side then saves its map), 3 black frames, then frames 16-17
    again.  Returns per side the System, the (state, tracked centre)
    after each input and the map file."""
    frames = orbit(26)
    black = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    inputs = [f[:2] for f in frames[:N_MAPPED]] + [black] * 3 + \
        [f[:2] for f in frames[16:18]]
    tmp = tmp_path_factory.mktemp("maps")
    out = {}
    for name, slam in (("jax", jsys.System(JC, pipeline_depth=0,
                                           retire_batch=1)),
                       ("port", tsys.System(TC, device="cpu"))):
        seen = []
        for i, (g, d) in enumerate(inputs):
            Tcw = np.asarray(slam.track_rgbd(g, d, i / 30.0))
            seen.append((slam.state, tracked_centre(Tcw)))
            if i == N_MAPPED - 1:
                slam.save_map(str(tmp / f"{name}.npz"))
        out[name] = {"slam": slam, "seen": seen,
                     "path": str(tmp / f"{name}.npz")}
    out["frames"] = frames
    return out


def test_blackout_then_resume_matches_jax(blackout):
    for name, mod in (("jax", jsys), ("port", tsys)):
        slam = blackout[name]["slam"]
        states = [s for s, _ in blackout[name]["seen"]]
        assert states[:N_MAPPED] == [mod.OK] * N_MAPPED, (name, states)
        assert states[N_MAPPED:N_MAPPED + 3] == [mod.LOST] * 3, (name, states)
        assert states[N_MAPPED + 3:] == [mod.OK] * 2, (name, states)
        assert int(slam.track.n_inliers) > 50
    tslam = blackout["port"]["slam"]
    assert tslam.relocalizer is not None
    # the relocalized frame and the next, within 1 cm of the JAX package's
    for i in (N_MAPPED + 3, N_MAPPED + 4):
        err = np.linalg.norm(blackout["port"]["seen"][i][1]
                             - blackout["jax"]["seen"][i][1])
        assert err <= 0.01, (i, err)
    # every input has a trajectory record; the two failed attempts each
    # left a LOST metrics row
    assert len(tslam.frame_trajectory()[0]) == N_MAPPED + 5
    lost_rows = [m for m in tslam.metrics if m["state"] == tsys.LOST]
    assert [m["frame"] for m in lost_rows] == [N_MAPPED + 1, N_MAPPED + 2]
    assert all(m["wall_ms"] is None for m in lost_rows)


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_map_reuse_in_localization_mode(blackout, saved_by):
    """save_map -> a fresh port System -> load_map -> localization mode
    over frames 10-17: the first frame relocalizes into the loaded map,
    every frame tracks, and no keyframe is inserted.  The file comes
    from the port or from the JAX package."""
    slam = tsys.System(TC, device="cpu")
    slam.load_map(blackout[saved_by]["path"])
    assert slam.state == tsys.LOST
    kf_seq, n_live = slam.kf_seq, slam.n_live_kf
    slam.activate_localization_mode()
    states, inliers = [], []
    for i in range(10, N_MAPPED):
        slam.track_rgbd(*blackout["frames"][i][:2], i / 30.0)
        states.append(slam.state)
        inliers.append(int(slam.track.n_inliers))
    assert states == [tsys.OK] * len(states)
    assert inliers[0] > 50, inliers
    assert slam.relocalizer is not None and slam.localization_only
    assert (slam.kf_seq, slam.n_live_kf) == (kf_seq, n_live)
    assert len(slam.frame_trajectory()[0]) == len(states)
    slam.deactivate_localization_mode()
    assert not slam.localization_only


def test_motion_collapse_recovers_without_relocalization():
    """``tests/test_track_fallback.py`` on the port: a velocity kick
    breaks the motion-model search; the wide local search recovers, no
    frame is LOST and the relocalizer is never built."""
    frames = orbit(16)
    slam = tsys.System(TC, device="cpu", pipeline_depth=0, retire_batch=1)
    for i in range(10):
        slam.track_rgbd(*frames[i][:2], i / 30.0)
    assert slam.state == tsys.OK
    slam.track = slam.track._replace(
        velocity=torch.tensor([1.0, 0.0, 0.0, 0.0, 0.8, -0.6, 0.5]),
        vel_ok=torch.tensor(True))
    states = []
    for i in range(10, 16):
        slam.track_rgbd(*frames[i][:2], i / 30.0)
        states.append(slam.state)
    assert states == [tsys.OK] * 6
    assert slam.relocalizer is None
    kicked = next(m for m in slam.metrics if m["frame"] == 10)
    assert kicked["n_motion_inliers"] < 20            # the collapse
    assert slam.metrics[-1]["n_inliers"] > 50


def run_unmapped_arc(localization_mode: bool):
    """``tests/test_localization_mode.py``'s scene: map the first 18 of
    72 frames around a circle, then drive the rest in localization mode,
    or with keyframe insertion merely frozen; returns the states up to
    the first LOST."""
    n = 72
    frames = list(jsyn.make_sequence(
        n, TC.camera, world=jsyn.default_world(),
        trajectory=jsyn.loop_trajectory(n, radius=1.2)))
    slam = tsys.System(TC, device="cpu", pipeline_depth=0, retire_batch=1)
    for i in range(N_MAPPED):
        slam.track_rgbd(*frames[i][:2], i / 30.0)
    assert slam.state == tsys.OK
    if localization_mode:
        slam.activate_localization_mode()
    else:
        slam.use_mapping = False
    states = []
    for i in range(N_MAPPED, n):
        slam.track_rgbd(*frames[i][:2], i / 30.0)
        states.append(slam.state)
        if states[-1] == tsys.LOST:
            break
    return states


@pytest.mark.slow
def test_temporal_points_survive_unmapped_region():
    """``tests/test_localization_mode.py`` on the port: temporal points
    carry localization mode through the unmapped arc, well past where
    the frozen map loses track."""
    on = run_unmapped_arc(True)
    off = run_unmapped_arc(False)
    assert tsys.LOST in off, "control survived; the test is vacuous"
    assert sum(s == tsys.OK for s in on) > sum(s == tsys.OK for s in off) + 5
    assert tsys.LOST not in on
