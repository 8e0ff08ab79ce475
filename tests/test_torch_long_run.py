"""The long-run path of the port against the JAX package's, on the CPU:
the keyframe-mapping stage switches, the loop closer's knobs and its
48-keyframe vocabulary retrain with the sparse BoW path, and the
endurance script's ATE helpers.

The loop closer runs on a constructed arena (``loop_arena``): a camera
on a circle looking out at a textured cylinder, 48 keyframes of a first
lap and 12 of a second lap over the same places, the second lap's map
moved by a known drift (its own point ids, so the laps are not
covisible).  Keyframes enter the arena one event at a time, so the
vocabulary is trained at 4 live keyframes (512 words), retrained at 48
(10,000 words, scored through sparse rows), and the second lap's events
detect, verify and correct the loop.  The port's Sim3 RANSAC takes the
JAX package's Gumbel noise, so both sides verify with the same
hypotheses.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu import config as jcfg
from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
from active_orb_slam2_tpu.io import synthetic as jsyn
from active_orb_slam2_tpu.models import local_mapping as jlm
from active_orb_slam2_tpu.models import loop_closing as jlc
from active_orb_slam2_tpu.models import map_state as jms
from active_orb_slam2_tpu_torch import config as tcfg
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams as TCam
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models import local_mapping as tlm
from active_orb_slam2_tpu_torch.models import loop_closing as tlc
from active_orb_slam2_tpu_torch.models import system as tsys
from active_orb_slam2_tpu_torch.utils.transfer import landed
from tests.test_torch_loop_closing import JaxNoise
from tests.test_torch_mapping import jax_write_back
from tests.test_torch_tracking import CAM, configs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    """A script of ``scripts/`` as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np_map(m):
    return {f: np.asarray(getattr(m, f)).copy() for f in m._fields}


def jmap(arrays):
    return jms.MapState(**{f: jnp.asarray(v) for f, v in arrays.items()})


# ------------------------------------------------------- mapping switches

SWITCHES = [{}, {"triangulate": False}, {"fuse": False},
            {"local_ba": False}, {"cull": False}]


@pytest.fixture(scope="module")
def mapping_event():
    """(arena, kf_slot, kf_seq) of the last keyframe-mapping call of the
    port's System over 16 frames of a slow orbit (0.5 degrees a frame, a
    keyframe at least every 2 frames) whose keyframe culling picked a
    victim, as numpy."""
    jc, tc = (dataclasses.replace(c, tracking=dataclasses.replace(
        c.tracking, kf_max_interval=2)) for c in configs())
    slam = tsys.System(tc, device="cpu")
    recs = []
    run = slam.keyframe_mapping

    def record(m, k, seq):
        arrays = {f: v.copy() for f, v in convert.map_to_jax_numpy(m).items()}
        out = run(m, k, seq)
        recs.append((arrays, int(k), int(seq), int(out[1])))
        return out

    slam.keyframe_mapping = record
    for i, (g, d, _) in enumerate(jsyn.make_sequence(
            16, jc.camera, world=jsyn.default_world(),
            trajectory=jsyn.orbit_trajectory(16, step_deg=0.5))):
        slam.track_rgbd(g, d, i / 30.0)
        slam.state
    culled = [r for r in recs if r[3] >= 0]
    assert culled, [r[1:] for r in recs]
    return jc, tc, culled[-1][:3]


@pytest.mark.parametrize("switches", SWITCHES,
                         ids=["all", "no_triangulate", "no_fuse",
                              "no_local_ba", "no_cull"])
def test_keyframe_mapping_switches_match_jax(mapping_event, switches):
    """``build_keyframe_mapping`` with each stage switched off in turn,
    against the JAX package's, with the JAX local-BA write-back patched
    into the port (ROADMAP queue 3, item g): victim and its snapshots
    equal, poses within 1e-4, points within 1e-3 m, ``kf_point`` at
    least 99.9% equal and the keyframe flags and parents equal."""
    jc, tc, (arrays, k, seq) = mapping_event
    sw = {**dict(triangulate=True, fuse=True, local_ba=True, cull=True),
          **switches}
    mj, vj, vpj, vposj, vppj, Wj = jlm.build_keyframe_mapping(jc, **sw)(
        jmap(arrays), k, seq)
    with jax_write_back():
        run = tlm.build_keyframe_mapping(tc, **sw)
    mt, vt, vpt, vpost, vppt, Wt = run(convert.map_from_jax_numpy(arrays), k,
                                       seq)
    assert int(vt) == int(vj)
    assert (int(vt) >= 0) == sw["cull"], int(vt)
    assert int(vpt) == int(vpj)
    np.testing.assert_allclose(vpost.numpy(), np.asarray(vposj), atol=1e-4)
    np.testing.assert_allclose(vppt.numpy(), np.asarray(vppj), atol=1e-4)
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    t = convert.map_to_jax_numpy(mt)
    for f in ("kf_valid", "kf_parent", "pt_valid"):
        np.testing.assert_array_equal(t[f], np.asarray(getattr(mj, f)), f)
    np.testing.assert_allclose(t["kf_pose"], np.asarray(mj.kf_pose), atol=1e-4)
    np.testing.assert_allclose(t["pt_xyz"], np.asarray(mj.pt_xyz), atol=1e-3)
    agree = (t["kf_point"] == np.asarray(mj.kf_point)).mean()
    assert agree >= 0.999, agree
    # local BA moves the old points (the JAX write-back may lose the
    # poses), and nothing else moves them
    old = arrays["pt_valid"]
    moved = np.abs(t["pt_xyz"][old] - arrays["pt_xyz"][old]).max()
    assert (moved > 0) == sw["local_ba"], moved
    created = (t["pt_valid"] & ~arrays["pt_valid"]).sum()
    if not sw["triangulate"]:
        assert created == 0, created


# ------------------------------------------------------ the loop arena

N_LAP1, N_LAP2, N_FEAT = 48, 12, 128
N_WALL = 1200                  # textured points on the cylinder
# frame ids: 4 frames between keyframes, the second lap 800 frames
# after the first; a guard of 200 recent frames keeps the loop closer
# from matching the first lap with itself (random textures score alike
# in a small vocabulary)
FRAMES_PER_KF, LAP_GAP, GUARD = 4, 800, 200
WALL_RADIUS, PATH_RADIUS = 4.0, 1.0
# the second lap's map is moved by this (rotation about y, translation)
DRIFT_YAW, DRIFT_T = 0.05, np.array([0.2, 0.03, -0.12])


def loop_configs():
    """320x240, ``N_FEAT`` features, an arena of 64 keyframes."""
    kw = dict(orb=dict(n_features=N_FEAT, n_levels=4),
              tracking=dict(th_depth=8.0),
              map=dict(max_keyframes=64, max_points=4096,
                       local_ba_keyframes=8, local_ba_points=1024))

    def make(mod, cam):
        return mod.SlamConfig(
            camera=cam, orb=mod.OrbConfig(**kw["orb"]),
            tracking=mod.TrackingConfig(**kw["tracking"]),
            map=mod.MapConfig(**kw["map"]))
    return make(jcfg, JCam(**CAM)), make(tcfg, TCam(**CAM))


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _quat(R):
    """(w, x, y, z) of a rotation matrix (w >= 0)."""
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2.0
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def loop_arena(seed=0):
    """The constructed two-lap arena as numpy (the JAX package's field
    names and dtypes), with every keyframe's data written and none live:
    slots 0-47 are the first lap (keyframe i at 7.5 i degrees), 48-59 the
    second lap over the first 12 places.  Returns (arrays, true camera
    centres [60, 3])."""
    rng = np.random.default_rng(seed)
    jc, _ = loop_configs()
    m = np_map(jms.empty_map(jc.map, jc.orb))
    cam = jc.camera
    ang = rng.uniform(0, 2 * np.pi, N_WALL)
    wall = np.stack([WALL_RADIUS * np.sin(ang), rng.uniform(-1.5, 1.5, N_WALL),
                     WALL_RADIUS * np.cos(ang)], -1)
    wall_desc = rng.integers(0, 2 ** 32, (N_WALL, 8), dtype=np.uint32)
    D = np.eye(4)
    D[:3, :3], D[:3, 3] = _yaw(DRIFT_YAW), DRIFT_T
    centres = []
    for s in range(N_LAP1 + N_LAP2):
        lap, place = divmod(s, N_LAP1)
        th = 2 * np.pi * place / N_LAP1
        Twc = np.eye(4)
        Twc[:3, :3] = _yaw(th)               # looking out along its radius
        Twc[:3, 3] = PATH_RADIUS * np.array([np.sin(th), 0.0, np.cos(th)])
        centres.append(Twc[:3, 3].copy())
        Tcw = np.linalg.inv(Twc)
        pc = wall @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        seen = np.flatnonzero((z > 0.5) & (u > 2) & (u < cam.width - 3)
                              & (v > 2) & (v < cam.height - 3))[:N_FEAT]
        n = len(seen)
        uv = np.stack([u[seen], v[seen]], -1) + rng.normal(0, 0.3, (n, 2))
        if lap:                                # the drifted map's pose
            Tcw = Tcw @ np.linalg.inv(D)
        m["kf_pose"][s] = np.concatenate([_quat(Tcw[:3, :3]), Tcw[:3, 3]])
        m["kf_frame_id"][s] = FRAMES_PER_KF * s + lap * LAP_GAP
        m["kf_uv"][s, :n] = uv
        m["kf_depth"][s, :n] = z[seen]
        m["kf_ur"][s, :n] = uv[:, 0] - cam.bf / z[seen]
        m["kf_level"][s, :n] = rng.integers(0, 2, n)
        flips = np.zeros((n, 8), np.uint32)
        for _ in range(3):                     # ~3 bits flipped a view
            flips[np.arange(n), rng.integers(0, 8, n)] ^= (
                np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32))
        m["kf_desc"][s, :n] = wall_desc[seen] ^ flips
        m["kf_feat_valid"][s, :n] = True
        m["kf_point"][s, :n] = seen + lap * N_WALL
        m["kf_parent"][s] = s - 1 if s else -1
    for lap in (0, 1):
        ids = np.arange(N_WALL) + lap * N_WALL
        xyz = wall @ D[:3, :3].T + D[:3, 3] if lap else wall
        m["pt_xyz"][ids] = xyz
        m["pt_desc"][ids] = wall_desc
        m["pt_normal"][ids] = xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
        m["pt_min_dist"][ids], m["pt_max_dist"][ids] = 0.5, 20.0
        m["pt_valid"][ids] = True
        m["pt_visible"][ids] = m["pt_found"][ids] = 1
        m["pt_first_kf"][ids] = lap * N_LAP1
    return m, np.stack(centres)


RETRAIN_EVENT = N_LAP1 - 1     # the event that makes 48 keyframes live
CLOSE_EVENT = 55               # the closure (both packages, measured)


def live_arena(arrays, n_live):
    out = dict(arrays, kf_valid=arrays["kf_valid"].copy())
    out["kf_valid"][:n_live] = True
    return out


def slot_fid(arrays, n_live):
    return {s: int(arrays["kf_frame_id"][s]) for s in range(n_live)}


def run_loop_events(lc, m, arrays, port):
    """Feed keyframe slots 0-59 to ``lc`` one event at a time (each
    entering the arena first).  Records per event (vocabulary stage,
    words, the dispatched detection's (candidate, any) or None, closed,
    candidates, verification failures, rejections), and the BoW cache and
    the arena before the closure event."""
    events, snap = [], None
    for s in range(N_LAP1 + N_LAP2):
        if s == CLOSE_EVENT:
            snap = {"words": np.asarray(lc._bow_words).copy(),
                    "weights": np.asarray(lc._bow_weights).copy(),
                    "fid": lc._bow_fid.copy(), "dense": lc._bow_dense,
                    "scores": [np.asarray(lc.score_kf(m, k)).copy()
                               for k in range(N_LAP1, CLOSE_EVENT)]}
        if port:
            m.kf_valid[s] = True
        else:
            m = m._replace(kf_valid=m.kf_valid.at[s].set(True))
        m, closed = lc.process_keyframe(m, s, kf_seq=s + 1, n_live_kf=s + 1,
                                        slot_fid=slot_fid(arrays, s + 1))
        pend = lc._pending_detect
        if pend is None:
            dec = None
        elif port:
            dec = tuple(int(v) for v in landed(*pend["copy"]))
        else:
            dec = (int(pend["cand"]), int(pend["ok"]))
        events.append((lc._vocab_stage, lc.vocab and lc.vocab.n_words, dec,
                       bool(closed), lc.n_candidates, lc.n_verify_fail,
                       lc.n_rejected))
    return m, events, snap


@pytest.fixture(scope="module")
def loop_runs():
    """Both loop closers over the constructed arena's 60 events; the
    port's sparse and dense L1 scorings are counted."""
    arrays, _ = loop_arena()
    jc, tc = loop_configs()
    jl = jlc.LoopCloser(jc, recent_frames_guard=GUARD)
    jm, jev, jsnap = run_loop_events(jl, jmap(arrays), arrays, port=False)
    tl = tlc.LoopCloser(tc, recent_frames_guard=GUARD)
    tl._noise = JaxNoise()
    calls = {"sparse": [], "dense": []}
    with pytest.MonkeyPatch.context() as mp:
        for name, kind in (("l1_score_sparse", "sparse"),
                           ("l1_score", "dense")):
            def counted(*a, _f=getattr(tlc, name), _k=kind, **kw):
                calls[_k].append(tl._vocab_stage)
                return _f(*a, **kw)
            mp.setattr(tlc, name, counted)
        tm, tev, tsnap = run_loop_events(
            tl, convert.map_from_jax_numpy(arrays), arrays, port=True)
    jsnap["closure"], tsnap["closure"] = dict(jl.last_closure), dict(
        tl.last_closure)
    return arrays, (jl, jm, jev, jsnap), (tl, tm, tev, tsnap), calls


def test_loop_events_match_jax(loop_runs):
    """The same decisions at every event: no detection in the first lap
    (the guard), the 512-word vocabulary from 4 live keyframes, the
    10,000-word retrain at 48, then the second lap's consistent
    detection of the first lap, its verification and the accepted
    correction, at the same events on both sides."""
    arrays, (jl, jm, jev, jsnap), (tl, tm, tev, tsnap), _ = loop_runs
    assert tev == jev, [(i, a, b) for i, (a, b) in enumerate(zip(tev, jev))
                        if a != b]
    stages = [e[0] for e in jev]
    assert stages.index(1) == 3 and stages.index(2) == RETRAIN_EVENT
    assert jev[RETRAIN_EVENT][1] == 10_000
    closed = [i for i, e in enumerate(jev) if e[3]]
    assert closed == [CLOSE_EVENT], closed
    assert jev[-1][4:] == (1, 0, 0)
    for side in (jsnap["closure"], tsnap["closure"]):
        assert (side["cur_kf"], side["loop_kf"]) == (CLOSE_EVENT - 1, 7)
    np.testing.assert_allclose(tsnap["closure"]["s_cm"],
                               np.asarray(jsnap["closure"]["s_cm"]), atol=1e-3)
    np.testing.assert_allclose(tm.kf_pose.numpy(), np.asarray(jm.kf_pose),
                               atol=1e-3)
    assert tl.gba_remaining == jl.gba_remaining


def test_retrain_matches_jax_bit_for_bit(loop_runs):
    """Both loop closers retrain from the same corpus to the same
    10,000-word tree."""
    _, (jl, *_), (tl, *_), _ = loop_runs
    tv, jv = tl.vocab, jl.vocab
    assert (tv.k, tv.depth, tv.n_words) == (10, 4, 10_000)
    np.testing.assert_array_equal(tv.centers.numpy().view(np.uint32),
                                  np.asarray(jv.centers))
    np.testing.assert_array_equal(tv.children.numpy(), np.asarray(jv.children))
    np.testing.assert_array_equal(tv.word_id.numpy(), np.asarray(jv.word_id))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))


def test_sparse_rows_and_scores_match_jax(loop_runs):
    """Before the closure event: the sparse BoW rows of every live
    keyframe were rebuilt after the retrain (generation tags equal to the
    frame ids), equal on both sides; the L1 scores of each second-lap
    keyframe against the arena within 1e-5; every scoring after the
    retrain went through the sparse path."""
    arrays, (_, _, _, jsnap), (_, _, _, tsnap), calls = loop_runs
    assert jsnap["dense"] is None and tsnap["dense"] is None
    live = np.arange(CLOSE_EVENT)
    np.testing.assert_array_equal(tsnap["fid"][live],
                                  arrays["kf_frame_id"][live])
    np.testing.assert_array_equal(jsnap["fid"][live],
                                  arrays["kf_frame_id"][live])
    np.testing.assert_array_equal(tsnap["words"][live], jsnap["words"][live])
    np.testing.assert_allclose(tsnap["weights"][live], jsnap["weights"][live],
                               atol=1e-6)
    for st, sj in zip(tsnap["scores"], jsnap["scores"]):
        np.testing.assert_allclose(st, sj, atol=1e-5)
    # one sparse scoring per detection from the retrain event on, one per
    # score of the snapshot; no dense scoring after the retrain
    assert max(calls["dense"]) == 1 and min(calls["sparse"]) == 2
    assert len(calls["sparse"]) == 2 * CLOSE_EVENT - RETRAIN_EVENT - N_LAP1


def test_vocab_grow_off_keeps_512_words():
    """``vocab_grow=False``: one training, 512 words, on both sides."""
    arrays = live_arena(loop_arena()[0], N_LAP1 + N_LAP2)
    jc, tc = loop_configs()
    jl = jlc.LoopCloser(jc, vocab_grow=False)
    tl = tlc.LoopCloser(tc, vocab_grow=False)
    jm, tm = jmap(arrays), convert.map_from_jax_numpy(arrays)
    for n in (4, 48, 60):
        jv, tv = jl.ensure_vocabulary(jm, n_kf=n), tl.ensure_vocabulary(tm,
                                                                       n_kf=n)
        assert tv.n_words == jv.n_words == 512
        np.testing.assert_array_equal(tv.centers.numpy().view(np.uint32),
                                      np.asarray(jv.centers))
    assert tl._vocab_stage == jl._vocab_stage == 1


@pytest.mark.parametrize("gba_iters", [0, 1, 6])
def test_gba_iters_sets_the_deferred_budget(loop_runs, gba_iters):
    """``gba_remaining`` after an accepted correction is
    ``max(gba_iters - 1, 0)`` on both sides, with ``gba_iters`` set after
    construction (the endurance script's switch); the prompt global-BA
    iteration runs whatever it is, so the corrected poses agree.  Each
    closer's per-map state is cleared first, so this is the map's first
    closure on both sides."""
    arrays, (jl, *_, jsnap), (tl, *_), _ = loop_runs
    before = live_arena(arrays, CLOSE_EVENT + 1)
    s_cm = np.array(jsnap["closure"]["s_cm"])
    jl.reset_state()
    tl.reset_state()
    jl.gba_iters = tl.gba_iters = gba_iters
    try:
        jm, jok = jl.correct(jmap(before), CLOSE_EVENT - 1, 7,
                             jnp.asarray(s_cm))
        tm, tok = tl.correct(convert.map_from_jax_numpy(before),
                             CLOSE_EVENT - 1, 7, torch.from_numpy(s_cm))
    finally:
        jl.gba_iters = tl.gba_iters = tlc.GBA_ITERS
    assert jok and tok
    assert tl.gba_remaining == jl.gba_remaining == max(gba_iters - 1, 0)
    np.testing.assert_allclose(tm.kf_pose.numpy(), np.asarray(jm.kf_pose),
                               atol=1e-3)


@pytest.fixture(scope="module")
def strict_closers():
    """Each package's loop closer with one consistent group enough and a
    RANSAC inlier bar no pair can meet, on the arena with the first lap
    live and its vocabulary retrained."""
    arrays = live_arena(loop_arena()[0], N_LAP1)
    jc, tc = loop_configs()
    kw = dict(consistency_th=1, min_sim3_matches=10 ** 4,
              recent_frames_guard=GUARD)
    jl, tl = jlc.LoopCloser(jc, **kw), tlc.LoopCloser(tc, **kw)
    tl._noise = JaxNoise()
    jm, tm = jmap(arrays), convert.map_from_jax_numpy(arrays)
    for n in (4, N_LAP1):
        jl.ensure_vocabulary(jm, n_kf=n)
        tl.ensure_vocabulary(tm, n_kf=n)
    return arrays, (jl, jm), (tl, tm)


def test_consistency_th_changes_decisions_alike(loop_runs, strict_closers):
    """With ``consistency_th=1`` every second-lap event dispatches a
    decision and the first lap's place is found from the first event on,
    where the default needs three consecutive groups; the same on both
    sides."""
    arrays, (jl, jm), (tl, tm) = strict_closers
    jdec, tdec = [], []
    for s in range(N_LAP1, CLOSE_EVENT):
        jm = jm._replace(kf_valid=jm.kf_valid.at[s].set(True))
        tm.kf_valid[s] = True
        jp = jl.detect_async(jm, s, n_live_kf=s + 1, kf_seq=s + 1)
        tp = tl.detect_async(tm, s, n_live_kf=s + 1, kf_seq=s + 1)
        jdec.append((int(jp["cand"]), int(jp["ok"])))
        tdec.append(tuple(int(v) for v in landed(*tp["copy"])))
    assert tdec == jdec
    default = [e[2] for e in loop_runs[1][2][N_LAP1:CLOSE_EVENT]]
    assert sum(ok for _, ok in jdec) > sum(d[1] for d in default if d)


def test_min_sim3_matches_changes_verdict_alike(loop_runs, strict_closers):
    """The closing pair verifies under the default bars and fails under
    ``min_sim3_matches`` of 10,000 on both sides; the port reads the knob
    at use, so setting it on a built loop closer acts too."""
    arrays, (jl, _), (tl, _) = strict_closers
    before = live_arena(arrays, CLOSE_EVENT + 1)
    cur = CLOSE_EVENT - 1
    jok, _, jn = jl.compute_sim3(jmap(before), cur, 7)
    tok, _, tn = tl.compute_sim3(convert.map_from_jax_numpy(before), cur, 7)
    assert not jok and not tok and jn == tn
    jd, td = loop_runs[1][0], loop_runs[2][0]
    jok, _, jn = jd.compute_sim3(jmap(before), cur, 7)
    tok, _, tn = td.compute_sim3(convert.map_from_jax_numpy(before), cur, 7)
    assert jok and tok and jn == tn
    td.min_sim3_matches = 10 ** 4
    try:
        assert not td.compute_sim3(convert.map_from_jax_numpy(before), cur,
                                   7)[0]
    finally:
        td.min_sim3_matches = tlc.MIN_SIM3_MATCHES


# ------------------------------------------------------ the scripts' helpers

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_endurance_ate_helpers_match_jax_scripts(seed):
    """The port's endurance script's ATE helpers against the JAX scripts'
    on random trajectories: the similarity ATE against
    ``scripts/run_endurance.py::np_umeyama_ate``, the rigid one against
    ``geometry/horn.py::umeyama_alignment(fix_scale=True)`` (the JAX
    long-sequence script's), the per-frame errors against the aligned
    residuals of the JAX endurance script."""
    from active_orb_slam2_tpu.geometry.horn import umeyama_alignment
    port, jax_script = (load_script("run_torch_endurance"),
                        load_script("run_endurance"))
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(200, 3)) * [2.0, 0.3, 1.5]
    R = _yaw(rng.uniform(-np.pi, np.pi))
    est = 0.7 * (gt @ R.T) + rng.normal(0, 0.02, gt.shape) + [0.3, -1, 2]
    sim = port.np_umeyama_ate(est, gt)
    assert abs(sim - jax_script.np_umeyama_ate(est, gt)) <= 1e-12
    rigid = float(umeyama_alignment(jnp.asarray(est), jnp.asarray(gt),
                                    fix_scale=True)[-1])
    assert abs(port.np_umeyama_ate(est, gt, fix_scale=True) - rigid) \
        <= 1e-5 * rigid
    err = port.aligned_errors(est, gt)
    assert err.shape == (200,)
    assert abs(np.sqrt((err ** 2).mean()) - sim) <= 1e-12
