"""The port's loop closer against the JAX package's, on the CPU, on the
constructed closure of ``tests/test_loop_closing.py``: two arcs of the
loop circle tracked by the JAX ``System``, arc B's world moved by a
known drift, the arenas merged (built once, converted with
``models/convert.py``).

The port's Sim3 RANSAC takes the JAX package's Gumbel noise (its
``PRNGKey(7)`` split once per verification), so both sides verify with
the same hypotheses.  Over the last 8 keyframes of arc B the JAX
package's decisions are: consistent candidates at events 3 and 4 fail
verification, event 5 verifies but its correction is rejected by the
chi2 gate, event 6 closes the loop; the port must decide the same at
every event.

Where the packages part on purpose: the fuse's masked lanes write
feature 0 of each target keyframe back to its old value in the JAX
package (ROADMAP queue 3, item g), so a loop point added at feature 0
survives only in the port; a pending detection whose candidate slot was
re-tenanted, and a deferred GBA slice whose fixed slot was, are acted
on by the JAX package and skipped by the port (item e).
"""

import argparse
import copy
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.geometry import se3 as jse3
from active_orb_slam2_tpu.models import loop_closing as jlc
from active_orb_slam2_tpu.models.map_state import (
    MapState as JMap, covisibility_weights as jcovis)
from active_orb_slam2_tpu_torch import config as tcfg
from active_orb_slam2_tpu_torch.geometry import se3 as tse3
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams as TCam
from active_orb_slam2_tpu_torch.models import convert
from active_orb_slam2_tpu_torch.models import loop_closing as tlc
from active_orb_slam2_tpu_torch.models.map_state import (
    MapState as TMap, covisibility_weights as tcovis)
from scripts import dissect_closure as jdissect
from scripts.dissect_torch_closure import dissect
from scripts.run_torch_endurance import record_closures
from tests import test_loop_closing as jt

torch.set_num_threads(1)

JC = jt.CFG
TC = tcfg.SlamConfig(
    camera=TCam(**jt.CAM._asdict()),
    orb=tcfg.OrbConfig(n_features=512, n_levels=4),
    tracking=tcfg.TrackingConfig(th_depth=12.0),
    map=tcfg.MapConfig(max_keyframes=64, max_points=8192,
                       local_ba_keyframes=8, local_ba_points=2048))
N_EVENTS = 8


def np_map(m):
    return {f: np.asarray(getattr(m, f)) for f in m._fields}


def jmap(arrays):
    return JMap(**{f: jnp.asarray(v) for f, v in arrays.items()})


def tmap(arrays):
    return convert.map_from_jax_numpy(arrays)


def t(a):
    return torch.from_numpy(np.array(a))


class JaxNoise:
    """The JAX LoopCloser's random stream, handed to the port: each
    verification splits ``PRNGKey(7)`` and draws Gumbel [256, M]."""

    def __init__(self):
        self.key = jax.random.PRNGKey(7)

    def __call__(self, n_hyp, m, device):
        key, self.key = jax.random.split(self.key)
        return t(np.asarray(jax.random.gumbel(key, (n_hyp, m))))


def port_closer(**kw):
    lc = tlc.LoopCloser(TC, **kw)
    lc._noise = JaxNoise()
    return lc


@pytest.fixture(scope="module")
def setup():
    world = jt.default_world(n_boxes=0)
    traj = jt.loop_trajectory(jt.N, radius=2.5)
    frames = list(jt.make_sequence(jt.N, jt.CAM, world=world,
                                   trajectory=traj))
    slam_a = jt._track_arc(frames[:55], 0.0)
    slam_b = jt._track_arc(frames[95:] + frames[:20], 95 / 30.0)
    m, Ka, Kb = jt._merge_with_drift(slam_a, slam_b, jt.DRIFT)
    A = jse3.mat44_to_se3(jnp.array(np.linalg.inv(traj[0]) @ traj[95]))
    return np_map(m), Ka, Kb, np.asarray(A)


def slot_fids(arrays):
    return {int(s): int(arrays["kf_frame_id"][s])
            for s in np.flatnonzero(arrays["kf_valid"])}


def truth_error(pose0, pose, A):
    """``test_loop_detect_and_correct``'s error of a corrected arc-B pose
    against its ground truth in arc A's frame."""
    truth = jse3.se3_compose(jse3.se3_compose(jnp.asarray(pose0), jt.DRIFT),
                             jse3.se3_inverse(jnp.asarray(A)))
    return float(jnp.linalg.norm(jse3.se3_log(jse3.se3_compose(
        jnp.asarray(pose), jse3.se3_inverse(truth)))))


def same(n, slot_fid):
    return slot_fid


def run_events(lc, m, Ka, Kb, fid_edit):
    """Feed the last N_EVENTS arc-B keyframes with the slot -> frame id
    mirror ``fid_edit(n, slot_fid)`` of event n; after each event record
    (closed, n_candidates, n_verify_fail, n_rejected).  Stops after the
    closure."""
    out = []
    for n, k in enumerate(range(Ka + Kb - N_EVENTS, Ka + Kb)):
        sf = fid_edit(n, slot_fids(np_map(m)))
        m, closed = lc.process_keyframe(m, k, kf_seq=20 + n, slot_fid=sf)
        out.append((closed, lc.n_candidates, lc.n_verify_fail, lc.n_rejected))
        if closed:
            return m, out, k
    return m, out, None


# work on the rejected correction's records that runs beside the tests
# (the JAX dissector, a JAX process): started by ``sequences``
BACKGROUND = {}


@pytest.fixture(scope="module")
def sequences(setup, tmp_path_factory, request):
    arrays, Ka, Kb, A = setup
    dumps = tmp_path_factory.mktemp("sequence")
    jax_dump = str(dumps / "jax_rejected.npz")
    jl = jlc.LoopCloser(JC, recent_frames_guard=0)
    # the JAX loop closer dumps its rejected correction (event 5) to
    # /tmp/aos2_badloop.npz: np.savez_compressed is redirected here
    save = np.savez_compressed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np, "savez_compressed",
                   lambda _, **kw: save(jax_dump, **kw))
        jm, jout, jcur = run_events(jl, jmap(arrays), Ka, Kb, same)
    # the port records its own through dump_path
    tl = port_closer(recent_frames_guard=0,
                     dump_path=str(dumps / "rejected.npz"))
    tm, tout, tcur = run_events(tl, tmap(arrays), Ka, Kb, same)
    BACKGROUND.update(jax_dump=jax_dump,
                      jax_dissector=JaxDissector(jax_dump),
                      jax_script=jax_script(tl.dump_path))
    request.addfinalizer(stop_background)
    return (jl, np_map(jm), jout, jcur), (tl, tm, tout, tcur)


def test_event_sequence_matches_jax(setup, sequences):
    arrays, Ka, Kb, A = setup
    (jl, jm, jout, jcur), (tl, tm, tout, tcur) = sequences
    # the JAX package's decisions: two verification failures, a
    # correction rejected by the gate, then the closure at event 6
    assert [o[1:] for o in jout] == [(0, 0, 0)] * 3 + [
        (1, 1, 0), (2, 2, 0), (3, 2, 1), (4, 2, 1)], jout
    assert tout == jout, (tout, jout)
    assert jcur == tcur == Ka + Kb - N_EVENTS + 6
    assert tl.last_rejection is not None
    assert tl.last_rejection["chi2_post"] > tlc.CHI2_GATE * \
        tl.last_rejection["chi2_pre"] + tlc.CHI2_GATE_OFFSET
    # event 6 resolves event 5's detection: keyframe 21 closes on 1
    for side in (jl.last_closure, tl.last_closure):
        assert side["cur_kf"] == tcur - 1 and side["loop_kf"] == 1
    np.testing.assert_allclose(tl.last_closure["s_cm"],
                               np.asarray(jl.last_closure["s_cm"]), atol=1e-3)
    # the corrected pose meets test_loop_detect_and_correct's bars, and
    # lies within 1 cm of the JAX package's
    pose0 = arrays["kf_pose"][tcur]
    before = truth_error(pose0, pose0, A)
    after = truth_error(pose0, tm.kf_pose[tcur].numpy(), A)
    assert after < 0.15 * before and after < 0.5, (before, after)
    assert abs(after - truth_error(pose0, jm["kf_pose"][tcur], A)) < 0.01
    live = arrays["kf_valid"]
    cj = tlc._se3_center(t(jm["kf_pose"]))[live]
    ct = tlc._se3_center(tm.kf_pose)[live]
    assert float((cj - ct).norm(dim=-1).max()) < 0.01
    assert tl.gba_remaining == jl.gba_remaining == 5


def test_compute_sim3_matches_jax(setup, sequences):
    """The closing pair's verification from the arena of the closing
    event, with the same noise: ok and guided matches equal, S_cm within
    1e-3."""
    arrays, Ka, Kb, A = setup
    cur = sequences[0][0].last_closure["cur_kf"]
    jl = jlc.LoopCloser(JC, recent_frames_guard=0)
    tl = port_closer(recent_frames_guard=0)
    for _ in range(3):
        jok, js, jn = jl.compute_sim3(jmap(arrays), cur, 1)
        tok, ts, tn = tl.compute_sim3(tmap(arrays), cur, 1)
        assert jok == tok and jn == tn, (jok, tok, jn, tn)
        if jok:
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-3)


@pytest.fixture(scope="module")
def closing(setup, sequences):
    """The closing pair, its verified S_cm (the JAX package's) and the
    covisibility matrix."""
    arrays, Ka, Kb, A = setup
    cur = sequences[0][0].last_closure["cur_kf"]
    s_cm = np.asarray(sequences[0][0].last_closure["s_cm"])
    W = np.asarray(jcovis(jmap(arrays)))
    return arrays, cur, 1, s_cm, W


def test_map_mean_chi2_matches_jax(closing):
    arrays = closing[0]
    cj = float(jlc._map_mean_chi2(JC.camera, jmap(arrays)))
    ct = float(tlc._map_mean_chi2(TC.camera, tmap(arrays)))
    assert abs(ct - cj) <= 1e-5 * abs(cj), (ct, cj)
    np.testing.assert_array_equal(tcovis(tmap(arrays)).numpy(), closing[4])


def stage1(closing):
    arrays, cur, loop, s_cm, W = closing
    from active_orb_slam2_tpu.geometry.se3 import (
        sim3_compose, sim3_from_se3)
    pre = np.asarray(sim3_from_se3(jnp.asarray(arrays["kf_pose"])))
    scur = np.asarray(sim3_compose(jnp.asarray(s_cm),
                                   jnp.asarray(pre[loop])))
    group = ((W[cur] >= JC.map.covis_min_weight)
             | (np.arange(len(W)) == cur)) & arrays["kf_valid"]
    return pre, scur, group


def test_apply_sim3_correction_matches_jax(closing):
    arrays, cur = closing[:2]
    pre, scur, group = stage1(closing)
    jm, ja = jlc._apply_sim3_correction(jmap(arrays), jnp.asarray(pre),
                                        jnp.asarray(scur), cur,
                                        jnp.asarray(group))
    tm, ta = tlc._apply_sim3_correction(tmap(arrays), t(pre), t(scur), cur,
                                        t(group))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (ta.numpy() < len(pre)).sum() > 100
    np.testing.assert_allclose(tm.kf_pose.numpy(), np.asarray(jm.kf_pose),
                               atol=1e-5)
    np.testing.assert_allclose(tm.pt_xyz.numpy(), np.asarray(jm.pt_xyz),
                               atol=1e-4)


def test_fuse_matches_jax(closing):
    arrays, cur, loop, _, W = closing
    pre, scur, group = stage1(closing)
    moved, _ = jlc._apply_sim3_correction(jmap(arrays), jnp.asarray(pre),
                                          jnp.asarray(scur), cur,
                                          jnp.asarray(group))
    base = np_map(moved)
    jf = jlc._build_fuse(JC)(moved, cur, loop, jnp.asarray(W))
    tf = tlc._fuse(TC.camera, tmap(base), cur, loop, t(W))
    np.testing.assert_array_equal(tf.pt_valid.numpy(), np.asarray(jf.pt_valid))
    jk, tk = np.asarray(jf.kf_point), tf.kf_point.numpy()
    assert (jk != base["kf_point"]).sum() > 50        # the fuse acted
    # the only differing cells: feature 0 of a target keyframe, where the
    # port keeps an added observation the JAX package's masked lanes undo
    rows, cols = np.nonzero(tk != jk)
    assert (cols == 0).all(), (rows, cols)
    assert (jk[rows, cols] == base["kf_point"][rows, cols]).all()


def test_apply_posegraph_result_matches_jax(closing):
    arrays = closing[0]
    rng = np.random.default_rng(2)
    old = np.asarray(jse3.sim3_from_se3(jnp.asarray(arrays["kf_pose"])))
    d = rng.normal(0, 0.02, (len(old), 7)).astype(np.float32)
    new = np.asarray(jse3.sim3_compose(jse3.sim3_exp(jnp.asarray(d)),
                                       jnp.asarray(old)))
    K = len(old)
    pref = np.where(rng.random(len(arrays["pt_valid"])) < 0.3,
                    rng.integers(0, K, len(arrays["pt_valid"])), K)
    for p in (None, pref.astype(np.int32)):
        jm = jlc._apply_posegraph_result(
            jmap(arrays), jnp.asarray(old), jnp.asarray(new),
            None if p is None else jnp.asarray(p))
        tm = tlc._apply_posegraph_result(tmap(arrays), t(old), t(new),
                                         None if p is None else t(p))
        np.testing.assert_allclose(tm.kf_pose.numpy(), np.asarray(jm.kf_pose),
                                   atol=1e-5)
        np.testing.assert_allclose(tm.pt_xyz.numpy(), np.asarray(jm.pt_xyz),
                                   atol=1e-4)


@pytest.mark.parametrize("which", ["closing", "rejected"])
def test_correct_matches_jax(setup, sequences, closing, which):
    """``correct`` from the same arena and S_cm: the same verdict, the
    chi2 gate's numbers within 1e-3 relative, poses within 1e-3, points
    within 0.05 m."""
    arrays, cur, loop, s_cm, W = closing
    if which == "rejected":
        # the rejected event's pair and Sim3, from the port's record
        rej = sequences[1][0].last_rejection
        cur, loop, s_cm = rej["cur_kf"], rej["loop_kf"], rej["s_cm"]
    jl = jlc.LoopCloser(JC, recent_frames_guard=0)
    tl = port_closer(recent_frames_guard=0)
    jm, jok = jl.correct(jmap(arrays), cur, loop, jnp.asarray(s_cm),
                         W=jnp.asarray(W))
    tm, tok = tl.correct(tmap(arrays), cur, loop, t(s_cm), W=t(W))
    assert jok == tok == (which == "closing")
    if tok:
        jd, td = jl.last_closure, tl.last_closure
        np.testing.assert_allclose(tm.kf_pose.numpy(), np.asarray(jm.kf_pose),
                                   atol=1e-3)
        live = np.asarray(jm.pt_valid)
        np.testing.assert_array_equal(tm.pt_valid.numpy(), live)
        err = np.abs(tm.pt_xyz.numpy() - np.asarray(jm.pt_xyz))[live]
        assert err.max() <= 0.05, err.max()
        for k in ("chi2_pre", "chi2_post"):
            assert abs(td[k] - jd[k]) <= 1e-3 * jd[k], (k, td[k], jd[k])
    else:
        assert tl.last_rejection["chi2_post"] > 3.5 * \
            tl.last_rejection["chi2_pre"]
        np.testing.assert_array_equal(tm.kf_pose.numpy(), arrays["kf_pose"])


def test_recycled_candidate_slot(setup, sequences):
    """Event 3 resolves event 2's consistent candidate.  With the
    candidate's slot re-tenanted in the host mirror before event 3 (a
    new frame id), the JAX package still verifies against the slot,
    the port drops the stale detection; with the mirror unchanged both
    verify."""
    arrays, Ka, Kb, A = setup
    (jl_seq, *_), _ = sequences
    cand = {}

    def edit(jax_side):
        def f(n, sf):
            if n == 3:
                lc = jl if jax_side else tl
                pend = lc._pending_detect
                c = int(np.asarray(pend["cand"])) if jax_side else \
                    int(tlc.landed(*pend["copy"])[0])
                cand[jax_side] = c
                sf[c] = sf[c] + 1000
            return sf
        return f
    jl = jlc.LoopCloser(JC, recent_frames_guard=0)
    tl = port_closer(recent_frames_guard=0)
    Kl = Ka + Kb
    jm, tm = jmap(arrays), tmap(arrays)
    for n, k in enumerate(range(Kl - N_EVENTS, Kl - N_EVENTS + 4)):
        jm, _ = jl.process_keyframe(jm, k, 20 + n,
                                    slot_fid=edit(True)(n, slot_fids(arrays)))
        tm, _ = tl.process_keyframe(tm, k, 20 + n,
                                    slot_fid=edit(False)(n, slot_fids(arrays)))
    assert cand[True] == cand[False]
    assert jl.n_candidates == 1 and tl.n_candidates == 0
    # unchanged mirrors: both verify (and fail) as in the sequence
    jl2 = jlc.LoopCloser(JC, recent_frames_guard=0)
    tl2 = port_closer(recent_frames_guard=0)
    jm, tm = jmap(arrays), tmap(arrays)
    for n, k in enumerate(range(Kl - N_EVENTS, Kl - N_EVENTS + 4)):
        jm, _ = jl2.process_keyframe(jm, k, 20 + n, slot_fid=slot_fids(arrays))
        tm, _ = tl2.process_keyframe(tm, k, 20 + n, slot_fid=slot_fids(arrays))
    assert (jl2.n_candidates, jl2.n_verify_fail) == \
        (tl2.n_candidates, tl2.n_verify_fail) == (1, 1)
    assert jl_seq.n_candidates == 4


def test_recycled_gba_fixed_slot(setup, sequences):
    """After the closure the deferred GBA slices pin the loop keyframe's
    slot.  With that slot re-tenanted in the host mirror, the JAX package
    runs the slice pinning the new tenant, the port ends the budget; with
    the mirror unchanged both run it."""
    arrays, Ka, Kb, A = setup
    (jl, jm, _, cur), (tl, tm, _, _) = sequences
    loop = jl.last_closure["loop_kf"]
    k_next = cur + 1 if cur + 1 < Ka + Kb else cur
    for recycled in (False, True):
        jl2, tl2 = copy.copy(jl), copy.copy(tl)
        sf = slot_fids(jm)
        if recycled:
            sf[loop] += 1000
        tm2 = TMap(*[x.clone() for x in tm])
        jm2, _ = jl2.process_keyframe(jmap(jm), k_next, 40, slot_fid=sf)
        tm2, _ = tl2.process_keyframe(tm2, k_next, 40, slot_fid=sf)
        j_moved = np.abs(np.asarray(jm2.kf_pose) - jm["kf_pose"]).max()
        t_moved = float((tm2.kf_pose - tm.kf_pose).abs().max())
        assert j_moved > 1e-6 and jl2.gba_remaining == 3
        if recycled:
            assert t_moved == 0.0 and tl2.gba_remaining == 0
        else:
            assert t_moved > 1e-6 and tl2.gba_remaining == 3


# ------------------------- the correction record and the closure dissector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DUMP_KEYS = set(JMap._fields) | {"s_cm", "cur_kf", "loop_kf", "li", "lj",
                                     "new_n"}
STAGES = ("pre", "post_stage1", "post_pg", "post_gba1")


def replay(path, cg_iters, gba_iters=1):
    """The port's dissector on the CPU, at the test camera (the tour's)."""
    out = dissect(path, TC.camera, torch.device("cpu"), gba_iters=gba_iters,
                  cg_iters=cg_iters, log=lambda *a: None)
    out["post_gba1"] = out["post_gba"][0]
    return out


def parse_dissector(text):
    """The stage chi2s a dissector printed."""
    out = {}
    for line in text.splitlines():
        head, _, rest = line.partition(" chi2:")
        if not rest:
            continue
        key = {"pre": "pre", "post stage1": "post_stage1",
               "post-pg": "post_pg"}.get(head, head.replace("-", "_"))
        out[key] = float(rest.split()[0])
    return out


def assert_stages_close(port, jax_side, printed=0.0):
    """Each stage within 1e-3 relative (plus ``printed``, the rounding of
    numbers read from a print)."""
    for k in STAGES:
        assert abs(port[k] - jax_side[k]) <= 1e-3 * abs(jax_side[k]) \
            + printed, (k, port[k], jax_side[k])


@pytest.fixture(scope="module")
def rejected_dumps(sequences, closing, tmp_path_factory):
    """The port's rejected correction written through ``dump_path``: the
    sequence's (event 5) and ``test_correct_matches_jax``'s ``rejected``
    inputs; (dump, the gate's record) for each."""
    arrays, _, _, _, W = closing
    tl = sequences[1][0]
    rej = tl.last_rejection
    path = str(tmp_path_factory.mktemp("correct") / "rejected.npz")
    lc = port_closer(recent_frames_guard=0, dump_path=path)
    _, ok = lc.correct(tmap(arrays), rej["cur_kf"], rej["loop_kf"],
                       t(rej["s_cm"]), W=t(W))
    assert not ok
    return {"sequence": (tl.dump_path, rej),
            "correct": (path, lc.last_rejection)}


class JaxDissector(threading.Thread):
    """``scripts/dissect_closure.py``'s ``main()`` on a dump with
    ``--gba-iters 1``, in a thread of this process, started at once; its
    printed stage chi2s (``lines``) unrounded.  The script's module-level
    ``argparse``, ``round`` and ``print`` are swapped for the thread's
    run (nothing else here uses that module)."""

    def __init__(self, path):
        super().__init__(daemon=True)
        self.path, self.lines, self.error = path, [], None
        self.start()

    def run(self):
        argv = [self.path, "--gba-iters", "1"]

        class Parser(argparse.ArgumentParser):
            def parse_args(self, args=None, namespace=None):
                return super().parse_args(argv, namespace)

        saved = {k: jdissect.__dict__.get(k)
                 for k in ("argparse", "round", "print")}
        jdissect.argparse = SimpleNamespace(ArgumentParser=Parser)
        jdissect.round = lambda x, n=None: x
        jdissect.print = lambda *a: self.lines.append(" ".join(map(str, a)))
        try:
            jdissect.main()
        except Exception as ex:       # reported by the test that joins
            self.error = ex
        finally:
            for k, v in saved.items():
                if v is None:
                    del jdissect.__dict__[k]
                else:
                    setattr(jdissect, k, v)


def jax_script(path):
    """``scripts/dissect_closure.py --gba-iters 1``, unchanged, on
    ``path`` in a process of its own (JAX on the CPU), started at once."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, os.path.join("scripts", "dissect_closure.py"), path,
         "--gba-iters", "1"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def stop_background():
    proc = BACKGROUND.get("jax_script")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_dump(sequences):
    """The JAX package's dump of the sequence's rejected correction
    (event 5), captured by ``sequences``."""
    assert os.path.exists(BACKGROUND["jax_dump"])
    return BACKGROUND["jax_dump"]


@pytest.mark.parametrize("which", ["sequence", "correct"])
def test_dissector_reproduces_the_gate(rejected_dumps, which):
    """A rejected correction recorded through ``dump_path`` holds the JAX
    dump's keys and ``W``; replayed at the gate's 16 CG steps, its
    ``pre`` and ``post-gba1`` are the gate's chi2 before and after, bit
    for bit, and its verdict is the gate's."""
    path, gate = rejected_dumps[which]
    with np.load(path) as d:
        assert set(d.files) == JAX_DUMP_KEYS | {"W"}
        assert (int(d["cur_kf"]), int(d["loop_kf"])) == \
            (gate["cur_kf"], gate["loop_kf"])
    out = replay(path, cg_iters=16)
    assert out["W"] == "dump"
    assert out["pre"] == gate["chi2_pre"], (out["pre"], gate["chi2_pre"])
    assert out["post_gba1"] == gate["chi2_post"], \
        (out["post_gba1"], gate["chi2_post"])
    assert out["accepted"] is False


def test_jax_dump_replays_in_the_port(jax_dump):
    """The JAX package's dump of the same correction through the port's
    dissector: every stage's chi2 within 1e-3 relative of the JAX
    dissector's (``scripts/dissect_closure.py --gba-iters 1``, 24 CG
    steps, run in this process by ``JaxDissector``, its 3-decimal
    rounding of the printed numbers taken out)."""
    port = replay(jax_dump, cg_iters=24)
    dissector = BACKGROUND["jax_dissector"]
    dissector.join(timeout=900)
    assert not dissector.is_alive() and dissector.error is None, \
        dissector.error
    jax_side = parse_dissector("\n".join(dissector.lines))
    assert port["W"] == "recomputed"
    assert_stages_close(port, jax_side)


def test_endurance_dump_of_an_accepted_correction(closing, jax_dump,
                                                  tmp_path):
    """``scripts/run_torch_endurance.py --dump-closures``'s wrapper on the
    closing correction: the arena as it stood before the (accepted)
    correction, under the JAX dump's keys with its dtypes and shapes,
    plus ``W``; the replay at 16 CG steps gives the gate's numbers and
    accepts."""
    arrays, cur, loop, s_cm, W = closing
    lc = port_closer(recent_frames_guard=0)
    rows = record_closures(lc, str(tmp_path))
    _, ok = lc.correct(tmap(arrays), cur, loop, t(s_cm), W=t(W))
    assert ok and len(rows) == 1 and rows[0]["accepted"]
    assert rows[0]["file"].endswith("closure_0_accepted.npz")
    with np.load(rows[0]["file"]) as d, np.load(jax_dump) as j:
        assert set(d.files) == set(j.files) | {"W"}
        for k in j.files:
            assert (d[k].dtype, d[k].shape) == (j[k].dtype, j[k].shape), k
        for f in JMap._fields:
            np.testing.assert_array_equal(d[f], arrays[f].view(d[f].dtype))
        np.testing.assert_array_equal(d["W"], W)
    out = replay(rows[0]["file"], cg_iters=16)
    assert out["accepted"]
    assert (out["pre"], out["post_gba1"]) == \
        (lc.last_closure["chi2_pre"], lc.last_closure["chi2_post"])


def test_port_dump_replays_in_the_jax_script(rejected_dumps):
    """The port's dump of the sequence's rejected correction through the
    JAX script, unchanged, in a process of its own (``jax_script``,
    started by ``sequences``): it prints every stage, each within 1e-3
    relative of the port's dissector on the same dump, plus the 5e-4 of
    the script's 3-decimal print."""
    path, _ = rejected_dumps["sequence"]
    proc = BACKGROUND["jax_script"]
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err
    jax_side = parse_dissector(out)
    assert set(STAGES) <= set(jax_side), out
    assert_stages_close(replay(path, cg_iters=24), jax_side, printed=5e-4)


def tour_jax_config(K=512, P=65536):
    """The JAX package's configuration of the endurance tour (the camera
    ``scripts/dissect_closure.py`` fixes), for a K-keyframe, P-point
    arena."""
    from active_orb_slam2_tpu import config as jcfg
    from active_orb_slam2_tpu.geometry.projection import CameraParams
    cam = CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                       width=320, height=240)
    return jcfg.SlamConfig(
        camera=cam, orb=jcfg.OrbConfig(n_features=1024, n_levels=8),
        tracking=jcfg.TrackingConfig(th_depth=8.0, kf_max_interval=8),
        map=jcfg.MapConfig(max_keyframes=K, max_points=P))


def jax_gate(path, cfg=None, jax_dump_path=None):
    """The JAX package's ``LoopCloser.correct`` on a recorded correction
    (the dump's arena, ``s_cm`` and ``W``; ``W`` recomputed where the
    dump has none), driven from outside: its ``loop_edges`` are set so
    that its window gives the dump's ``li``, ``lj`` and ``new_n``, its
    gate's numbers are read where it fetches them, and the dump it
    writes on a rejection goes to ``jax_dump_path`` (else nowhere).
    ``cfg``: the JAX configuration (default: the tour's).  Returns
    {"accepted", "chi2_pre", "chi2_post"}."""
    from active_orb_slam2_tpu.models import system as jsys
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    li, lj, new_n = arrays["li"], arrays["lj"], int(arrays["new_n"])
    K, P = arrays["kf_pose"].shape[0], arrays["pt_xyz"].shape[0]
    jl = jlc.LoopCloser(cfg or tour_jax_config(K, P), recent_frames_guard=0)
    # a tagged edge whose slot's frame id differs is dropped from the
    # window, leaving its (li, lj) at -1
    jl._slot_fid = {-1: -1}
    jl.loop_edges = [(int(a), int(b), None, None) if a >= 0 else
                     (0, 0, -2, -2) for a, b in zip(li[:new_n], lj[:new_n])]
    diag = []
    fetch, save = jsys.host_fetch, np.savez_compressed

    def host_fetch(x):
        diag.append(np.asarray(fetch(x)))
        return diag[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsys, "host_fetch", host_fetch)
        mp.setattr(np, "savez_compressed", lambda _, **kw: None
                   if jax_dump_path is None else save(jax_dump_path, **kw))
        W = jnp.asarray(arrays["W"]) if "W" in arrays else None
        _, accepted = jl.correct(jmap({f: arrays[f] for f in JMap._fields}),
                                 int(arrays["cur_kf"]), int(arrays["loop_kf"]),
                                 jnp.asarray(arrays["s_cm"]), W=W,
                                 max_loop=len(li))
    return {"accepted": bool(accepted), "chi2_pre": float(diag[-1][0]),
            "chi2_post": float(diag[-1][1])}


@pytest.mark.slow
def test_jax_gate_on_a_port_dump(rejected_dumps, tmp_path):
    """``jax_gate`` on the port's recorded rejected correction gives the
    JAX package's verdict on it (rejected, as ``test_correct_matches_jax``
    finds), its chi2 before within 1e-3 relative of the port's gate, and
    the JAX package's own dump of it, which holds the same arena.  The
    chi2 after is printed, not matched: from the essential graph's map
    (chi2 ~107) one GBA iteration lands at 46.36 in the JAX package's
    compiled correction and at 53.46 in the port, where the JAX package's
    stages run one by one land at 53.46 too (measured)."""
    path, gate = rejected_dumps["correct"]
    out = jax_gate(path, JC, str(tmp_path / "jax.npz"))
    print("JAX gate", out, "port gate", gate["chi2_pre"], gate["chi2_post"])
    assert out["accepted"] is False
    assert abs(out["chi2_pre"] - gate["chi2_pre"]) <= 1e-3 * gate["chi2_pre"]
    with np.load(path) as a, np.load(tmp_path / "jax.npz") as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], k)


@pytest.mark.slow
def test_gate_accepts_a_poor_sim3_in_both_packages(closing):
    """ROADMAP queue 3, item v, in the small: the closing correction with
    its verified Sim3's translation moved 0.11 m (the error of closure 3
    of the endurance tour that both gates accepted, PERF.md §6), given
    to both loop closers: both gates take the same verdict, and both
    accept it, since one GBA iteration pulls the map's chi2 back under
    3.5 x before + 0.25.  The gate is the reference's: the port accepts what the JAX
    package accepts."""
    arrays, cur, loop, s_cm, W = closing
    poor = np.array(s_cm, np.float32)
    poor[4:7] += np.float32(0.11 / np.sqrt(3.0))
    jl = jlc.LoopCloser(JC, recent_frames_guard=0)
    tl = port_closer(recent_frames_guard=0)
    _, jok = jl.correct(jmap(arrays), cur, loop, jnp.asarray(poor),
                        W=jnp.asarray(W))
    _, tok = tl.correct(tmap(arrays), cur, loop, t(poor), W=t(W))
    print("JAX", jok, jl.last_closure and {k: jl.last_closure[k] for k in (
        "chi2_pre", "chi2_post")}, "port", tok, tl.last_closure or
        tl.last_rejection)
    assert jok == tok
    assert tok


# ----------------------------- tests/test_loop_closing.py's cases on the port

def test_loop_rejects_without_consistency(setup):
    arrays, Ka, Kb, _ = setup
    lc = port_closer(recent_frames_guard=0)
    _, closed = lc.process_keyframe(tmap(arrays), Ka + Kb - 1, kf_seq=20)
    assert not closed and lc.vocab is not None


def test_score_query_sparse_matches_dense(rng):
    """Above 4,096 words ``score_query`` takes the sparse BoW path; its
    scores equal the dense ones."""
    from active_orb_slam2_tpu_torch.models import vocabulary as tv
    from active_orb_slam2_tpu_torch.models.map_state import empty_map
    cfg = tcfg.SlamConfig(
        camera=TCam(fx=100., fy=100., cx=32., cy=32., bf=10., width=64,
                    height=64),
        orb=tcfg.OrbConfig(n_features=64, n_levels=2),
        tracking=tcfg.TrackingConfig(),
        map=tcfg.MapConfig(max_keyframes=4, max_points=256))
    k, depth = 9, 4
    children, word_id = tv._full_tree_children(k, depth)
    n_nodes = sum(k ** (l + 1) for l in range(depth))
    voc = tv._from_numpy(rng.integers(0, 2**32, (n_nodes, 8), dtype=np.uint32),
                         children, word_id, np.ones(k ** depth, np.float32),
                         k, depth)
    assert voc.n_words > tv.DENSE_MAX_WORDS
    lc = tlc.LoopCloser(cfg)
    lc.vocab = voc
    m = empty_map(cfg.map, cfg.orb)
    desc = rng.integers(0, 2**32, (4, 64, 8), dtype=np.uint32)
    m.kf_desc.copy_(t(desc.view(np.int32)))
    m.kf_feat_valid.fill_(True)
    m.kf_valid.fill_(True)
    q = t(desc[1].view(np.int32))
    ones = torch.ones(64, dtype=torch.bool)
    s_sparse = lc.score_query(m, q, ones)
    s_dense = tv.l1_score(tv.transform(voc, q, ones)[1], lc.kf_bows(m))
    np.testing.assert_allclose(s_sparse.numpy(), s_dense.numpy(), atol=1e-5)
    assert abs(float(s_sparse[1]) - 1.0) < 1e-5


def test_multi_loop_measurement_slots():
    """Each closed loop's verified Sim3 lands in its own edge slot."""
    K = 8
    lc = tlc.LoopCloser(TC)
    rng = np.random.default_rng(5)
    poses = tse3.se3_exp(t(rng.normal(0, 0.3, (K, 6)).astype(np.float32)))
    pre = tse3.sim3_from_se3(poses)
    valid = torch.ones(K, dtype=torch.bool)
    parent = t(np.concatenate([[-1], np.arange(K - 1)]).astype(np.int32))
    W = torch.zeros((K, K), dtype=torch.int32)

    def rel(i, j, tw):
        return tse3.sim3_compose(pre[j], tse3.sim3_compose(tse3.sim3_from_se3(
            tse3.se3_exp(torch.tensor(tw))), tse3.sim3_inverse(pre[i])))
    rel1 = rel(0, 5, [0, 0, 0, .1, 0, 0])
    lc.loop_edges.append((0, 5, None, None))
    e1 = lc._essential_edges(pre, valid, parent, W, rel1)
    E0 = e1.meas_ji.shape[0] - 32
    np.testing.assert_allclose(e1.meas_ji[E0].numpy(), rel1.numpy(), atol=1e-6)
    rel2 = rel(1, 7, [0, 0, 0, 0, .2, 0])
    lc.loop_edges.append((1, 7, None, None))
    e2 = lc._essential_edges(pre, valid, parent, W, rel2)
    np.testing.assert_allclose(e2.meas_ji[E0 + 1].numpy(), rel2.numpy(),
                               atol=1e-6)
    assert not np.allclose(e2.meas_ji[E0].numpy(), rel2.numpy(), atol=1e-4)
    assert bool(e2.valid[E0]) and bool(e2.valid[E0 + 1])
    assert (int(e2.i[E0]), int(e2.j[E0])) == (0, 5)
    assert (int(e2.i[E0 + 1]), int(e2.j[E0 + 1])) == (1, 7)


@pytest.mark.slow
def test_vga_closure_beside_jax():
    """``chip_smoke.py``'s constructed closure at VGA width
    (``bench.py::full_pipeline_window``'s configuration) on both packages
    on the CPU: each tracks the two arcs, merges them with the drift and
    runs its loop closer over the last 8 arc-B keyframes.  Both close the
    loop within ``test_loop_detect_and_correct``'s bars.  Each package
    tracks its own arcs, so the maps, and the event that closes, may
    differ (on an 8-core CPU: the JAX package at its 4th event, the port
    at its 6th; the port on an H100 at its 4th).  Full size: run it where
    the CPU has the memory (README)."""
    import chip_smoke
    from active_orb_slam2_tpu import config as jcfg
    from active_orb_slam2_tpu.geometry.projection import CameraParams as JCam
    from active_orb_slam2_tpu.io import synthetic as jsyn
    from active_orb_slam2_tpu.models import system as jsys
    from active_orb_slam2_tpu_torch.models import system as tsys
    tc = chip_smoke.vga_config("mapping")
    jc = jcfg.SlamConfig(
        camera=JCam(**tc.camera._asdict()),
        orb=jcfg.OrbConfig(**vars(tc.orb)),
        tracking=jcfg.TrackingConfig(**vars(tc.tracking)),
        map=jcfg.MapConfig(**vars(tc.map)))
    traj = jsyn.loop_trajectory(chip_smoke.N_LOOP, radius=2.5)
    frames = [f[:2] for f in jsyn.make_sequence(
        chip_smoke.N_LOOP, jc.camera, world=jsyn.default_world(n_boxes=0),
        trajectory=traj)]
    arcs = (frames[:55], frames[95:] + frames[:20])
    drift = np.asarray(jt.DRIFT)
    A = np.asarray(jse3.mat44_to_se3(jnp.asarray(
        np.linalg.inv(traj[0]) @ traj[95])))
    result = {}
    for name in ("jax", "port"):
        slams = []
        for s, arc in enumerate(arcs):
            slam = jsys.System(jc) if name == "jax" else \
                tsys.System(tc, device="cpu")
            for i, (g, d) in enumerate(arc):
                slam.track_rgbd(g, d, (95 * s + i) / 30.0)
            slam.flush()
            slams.append(slam)
        if name == "jax":
            m, Ka, Kb = jt._merge_with_drift(*slams, jt.DRIFT)
            lc = jlc.LoopCloser(jc, recent_frames_guard=0)
            arrays = np_map(m)
        else:
            arrays, Ka, Kb = chip_smoke.merge_with_drift(
                slams[0].checkpoint(), slams[1].checkpoint(), drift)
            m = tmap(arrays)
            lc = tlc.LoopCloser(tc, recent_frames_guard=0)
        m, out, cur = run_events(lc, m, Ka, Kb, same)
        errs = None
        if cur is not None:
            pose0 = arrays["kf_pose"][cur]
            errs = (truth_error(pose0, pose0, A),
                    truth_error(pose0, np.asarray(np_map(m)["kf_pose"][cur]),
                                A))
        result[name] = (Ka, Kb, out, cur, errs)
        print(name, result[name])
    for name in ("jax", "port"):
        assert result[name][3] is not None, (name, result[name])
        before, after = result[name][4]
        assert after < 0.15 * before and after < 0.5, (name, before, after)


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(
        description="the JAX package's gate on recorded corrections of the "
        "endurance tour (ROADMAP queue 3, item v): JAX_PLATFORMS=cpu "
        "python -m tests.test_torch_loop_closing DUMP... --json OUT")
    ap.add_argument("dumps", nargs="+")
    ap.add_argument("--json", required=True)
    args = ap.parse_args()
    rows = {}
    for p in args.dumps:
        rows[p] = jax_gate(p)
        print(p, rows[p], flush=True)
    with open(args.json, "w") as f:
        json.dump(rows, f, indent=1)
