"""The port's ``System`` with loop closing on, beside the JAX package's
(``tests/test_torch_localization.py``'s blackout flow: the orbit at
320x240, frames 0-17, 3 black frames, frames 16-17 again).  The JAX
System retires each frame before the next; the port's state is read
after each frame.  Both train the vocabulary at the same keyframe
event and pick the same BoW relocalization candidates after the
blackout, where the no-vocabulary path takes the newest keyframes."""

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu.models import relocalization as jrel
from active_orb_slam2_tpu.models import system as jsys
from active_orb_slam2_tpu_torch.models import system as tsys
from tests.test_torch_localization import N_MAPPED, orbit
from tests.test_torch_tracking import configs

torch.set_num_threads(1)

JC, TC = configs()


@pytest.fixture(scope="module")
def runs(monkeypatch_module):
    frames = orbit(18)
    black = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    inputs = [f[:2] for f in frames[:N_MAPPED]] + [black] * 3 + \
        [f[:2] for f in frames[16:18]]
    cands = {"jax": [], "port": []}

    def recording(build, side, to_np):
        def wrapped(cfg, n_candidates=8):
            relocalize = build(cfg, n_candidates=n_candidates)

            def call(m, frame, c, *rest):
                cands[side].append(to_np(c))
                return relocalize(m, frame, c, *rest)
            return call
        return wrapped
    monkeypatch_module.setattr(jrel, "build_relocalizer", recording(
        jrel.build_relocalizer, "jax", np.asarray))
    monkeypatch_module.setattr(tsys, "build_relocalizer", recording(
        tsys.build_relocalizer, "port", lambda c: c.numpy()))
    out = {}
    for name, slam in (("jax", jsys.System(JC, use_loop_closing=True,
                                           pipeline_depth=0, retire_batch=1)),
                       ("port", tsys.System(TC, use_loop_closing=True,
                                            device="cpu"))):
        states, vocab_at = [], None
        for i, (g, d) in enumerate(inputs):
            slam.track_rgbd(g, d, i / 30.0)
            states.append(slam.state)
            if vocab_at is None and slam.loop_closer.vocab is not None:
                vocab_at = (i, slam.kf_seq)
        out[name] = {"slam": slam, "states": states, "vocab_at": vocab_at,
                     "cands": cands[name]}
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_loop_system_matches_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert j["states"] == t["states"]
    assert t["states"][N_MAPPED:N_MAPPED + 3] == [tsys.LOST] * 3
    assert t["states"][-2:] == [tsys.OK] * 2
    # the vocabulary was trained at the same keyframe event, and it is
    # the same vocabulary
    assert j["vocab_at"] is not None and j["vocab_at"] == t["vocab_at"]
    jv, tv = j["slam"].loop_closer.vocab, t["slam"].loop_closer.vocab
    np.testing.assert_array_equal(tv.centers.numpy().view(np.uint32),
                                  np.asarray(jv.centers))
    # the same BoW candidates at every relocalization attempt (the second
    # and third black frames, then frame 16): on the black frames every
    # keyframe scores 0.5 up to the rounding of its
    # row's L1 sum, so the same set; on the frame that relocalizes the
    # same keyframes in the same order: the best scoring, not the newest
    assert len(j["cands"]) == len(t["cands"]) == 3
    for a, b in zip(j["cands"][:2], t["cands"][:2]):
        np.testing.assert_array_equal(np.sort(b), np.sort(a))
    np.testing.assert_array_equal(t["cands"][-1], j["cands"][-1])
    newest = [k for _, k in t["slam"].kf_records[-8:]][::-1]
    assert list(t["cands"][-1][:len(newest)]) != newest
    assert t["slam"].n_loops_closed == j["slam"].n_loops_closed == 0


@pytest.mark.slow
def test_full_pipeline_ate_beside_jax():
    """``tests/test_e2e_full_pipeline.py`` on the port (150 frames of the
    loop circle, mapping and loop closing on), with the JAX package's
    ATE on the same frames beside it."""
    from active_orb_slam2_tpu import config as jcfg
    from active_orb_slam2_tpu.io.trajectory import camera_centers as jcc
    from active_orb_slam2_tpu_torch import config as tcfg
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    from tests import test_e2e_full_pipeline as e2e

    def make(mod):
        return mod.SlamConfig(
            camera=(JC if mod is jcfg else TC).camera,
            orb=mod.OrbConfig(n_features=512, n_levels=4),
            tracking=mod.TrackingConfig(th_depth=12.0, kf_max_interval=10),
            map=mod.MapConfig(max_keyframes=48, max_points=8192,
                              local_ba_keyframes=8, local_ba_points=2048))
    frames = list(jsyn_sequence(e2e.N))
    gt = np.stack([Twc[:3, 3] for _, _, Twc in frames])
    ate = {}
    for name, slam, centers in (
            ("jax", jsys.System(make(jcfg), use_loop_closing=True), jcc),
            ("port", tsys.System(make(tcfg), use_loop_closing=True,
                                 device="cpu"), camera_centers)):
        for i, (g, d, _) in enumerate(frames):
            slam.track_rgbd(g, d, i / 30.0)
        assert slam.state == 1 and slam.loop_closer.vocab is not None
        _, poses = slam.frame_trajectory()
        ate[name] = umeyama_alignment(np.asarray(centers(poses)), gt,
                                      fix_scale=True)[4]
    print(f"full pipeline ATE: JAX {ate['jax']:.5f} m, port "
          f"{ate['port']:.5f} m")
    assert ate["port"] < 0.15, ate


def jsyn_sequence(n):
    from active_orb_slam2_tpu.io import synthetic as jsyn
    return jsyn.make_sequence(n, JC.camera, world=jsyn.default_world(n_boxes=0),
                              trajectory=jsyn.loop_trajectory(n, radius=2.5))
