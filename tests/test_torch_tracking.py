"""Teacher-forced tracking step: the port's against the JAX package's.

The JAX ``System`` (mapping off) runs frames 0-6 of the orbit of
``test_e2e_rgbd.py``; before each of frames 1-6 its map and tracking
state are recorded with the frame it builds.  Each record crosses to the
port through ``models/convert.py`` and one step runs on both sides,
with the keyframe insertion off and on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu import config as jcfg
from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
from active_orb_slam2_tpu.io.synthetic import (
    default_world, make_sequence, orbit_trajectory)
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu.models.frame import FrameData as JFrame
from active_orb_slam2_tpu.models.map_state import MapState as JMap
from active_orb_slam2_tpu.models.tracking import TrackState as JTrack
from active_orb_slam2_tpu_torch import config as tcfg
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams as TCam
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models.frame import FrameData
from active_orb_slam2_tpu_torch.models.map_state import MapState
from active_orb_slam2_tpu_torch.models.tracking import (
    build_track_step, init_track_state)

torch.set_num_threads(1)

CAM = dict(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8, width=320,
           height=240)


def configs():
    kw = dict(orb=dict(n_features=512, n_levels=4),
              tracking=dict(th_depth=8.0),
              map=dict(max_keyframes=32, max_points=8192,
                       local_ba_keyframes=8, local_ba_points=2048))

    def make(mod, cam):
        return mod.SlamConfig(
            camera=cam, orb=mod.OrbConfig(**kw["orb"]),
            tracking=mod.TrackingConfig(**kw["tracking"]),
            map=mod.MapConfig(**kw["map"]))
    return make(jcfg, JCam(**CAM)), make(tcfg, TCam(**CAM))


def np_fields(tup):
    return {f: np.asarray(getattr(tup, f)) for f in tup._fields}


@pytest.fixture(scope="module")
def records():
    """(map, frame, track) before each of frames 1-6, as numpy dicts."""
    jc, _ = configs()
    slam = jsys.System(jc, use_mapping=False)
    out = []
    for i, (g, d, _) in enumerate(make_sequence(
            7, jc.camera, world=default_world(),
            trajectory=orbit_trajectory(30, step_deg=2.0))):
        m, st = slam.map, slam.track
        slam.track_rgbd(g, d, i / 30.0)
        if i >= 1:
            out.append((np_fields(m), np_fields(slam._pending[-1]["frame"]),
                        np_fields(st)))
    slam.flush()
    return slam.track_step, out


def test_convert_round_trip(records):
    _, recs = records
    m_np, _, st_np = recs[0]
    back = convert.map_to_jax_numpy(convert.map_from_jax_numpy(m_np))
    for f in MapState._fields:
        assert back[f].dtype == m_np[f].dtype, f
        np.testing.assert_array_equal(back[f], m_np[f])
    st_back = convert.track_state_to_jax_numpy(
        convert.track_state_from_jax_numpy(st_np))
    for f in st_np:
        np.testing.assert_array_equal(st_back[f], st_np[f])
    # a fresh state has the JAX package's fields, dtypes and shapes
    fresh = convert.track_state_to_jax_numpy(init_track_state(512))
    ref = np_fields(jsys.init_track_state(512))
    for f in ref:
        assert fresh[f].dtype == ref[f].dtype and fresh[f].shape == \
            ref[f].shape, f
        np.testing.assert_array_equal(fresh[f], ref[f])


@pytest.mark.parametrize("allow_kf", [False, True])
def test_track_step_teacher_forced(records, allow_kf):
    jstep, recs = records
    _, tc = configs()
    tstep = build_track_step(tc)
    for n, (m_np, f_np, st_np) in enumerate(recs, start=1):
        st_j, stats_j, m_j = jstep(
            JMap(**{k: jnp.asarray(v) for k, v in m_np.items()}),
            JFrame(**{k: jnp.asarray(v) for k, v in f_np.items()}),
            JTrack(**{k: jnp.asarray(v) for k, v in st_np.items()}),
            allow_kf, False)
        frame_t = FrameData(**{k: torch.from_numpy(
            (v.view(np.int32) if v.dtype == np.uint32 else v).copy())
            for k, v in f_np.items()})
        st_t, stats_t, m_t = tstep(convert.map_from_jax_numpy(m_np), frame_t,
                                   convert.track_state_from_jax_numpy(st_np),
                                   allow_kf)
        sj, stt = np.asarray(stats_j), stats_t.numpy()
        # the two inlier counts within +-2; the rest of stats[0:8] exact
        assert np.abs(stt[:2] - sj[:2]).max() <= 2, (n, stt[:8], sj[:8])
        np.testing.assert_array_equal(stt[2:8], sj[2:8])
        np.testing.assert_allclose(stt[8:], sj[8:], atol=1e-4)
        np.testing.assert_allclose(st_t.pose.numpy(), np.asarray(st_j.pose),
                                   atol=1e-4)
        agree = (st_t.assoc.numpy() == np.asarray(st_j.assoc)).mean()
        assert agree >= 0.99, (n, agree)
        assert int(st_t.kf_seq) == int(st_j.kf_seq)
        assert int(st_t.last_kf_slot) == int(st_j.last_kf_slot)
        # the inserted keyframe and its new points
        assert int(m_t.pt_valid.sum()) == int(np.asarray(m_j.pt_valid).sum())
        assert int(m_t.kf_valid.sum()) == int(np.asarray(m_j.kf_valid).sum())
        if allow_kf:
            assert sj[6] >= 0, "the JAX step inserted no keyframe"
        np.testing.assert_array_equal(
            m_t.pt_visible.numpy() > 0, np.asarray(m_j.pt_visible) > 0)


def test_track_step_localization_mode(records):
    """``loc_mode=True`` (insertion off, as the System runs it): the last
    frame's close-depth features without a map point enter the motion
    stage as temporal points.  The test checks that they do (they add
    motion-stage inliers on both sides), then holds stats[0:8] exactly
    and the pose to 1e-4."""
    jstep, recs = records
    _, tc = configs()
    tstep = build_track_step(tc)
    n_tmp_used = 0
    for n, (m_np, f_np, st_np) in enumerate(recs, start=1):
        def jax_step(loc_mode):
            return jstep(
                JMap(**{k: jnp.asarray(v) for k, v in m_np.items()}),
                JFrame(**{k: jnp.asarray(v) for k, v in f_np.items()}),
                JTrack(**{k: jnp.asarray(v) for k, v in st_np.items()}),
                False, loc_mode)
        st_j, stats_j, _ = jax_step(True)
        stats_off = np.asarray(jax_step(False)[1])
        frame_t = FrameData(**{k: convert.to_torch(v)
                               for k, v in f_np.items()})
        st_t, stats_t, _ = tstep(convert.map_from_jax_numpy(m_np), frame_t,
                                 convert.track_state_from_jax_numpy(st_np),
                                 False, loc_mode=True)
        sj, stt = np.asarray(stats_j), stats_t.numpy()
        np.testing.assert_array_equal(stt[:8], sj[:8], err_msg=str(n))
        np.testing.assert_allclose(stt[8:], sj[8:], atol=1e-4)
        np.testing.assert_allclose(st_t.pose.numpy(), np.asarray(st_j.pose),
                                   atol=1e-4)
        assert (st_t.assoc.numpy() == np.asarray(st_j.assoc)).mean() >= 0.99
        assert sj[6] == -1                        # no keyframe inserted
        prev = st_np["assoc"]
        map_ok = (prev >= 0) & m_np["pt_valid"][np.clip(prev, 0, None)]
        if (st_np["tmp_ok"] & ~map_ok).any():
            n_tmp_used += int(sj[0] > stats_off[0])
    assert n_tmp_used >= 3, n_tmp_used
