"""The loop closer's decisions on the loop circle, the JAX package beside
the port, both on the CPU (ROADMAP queue 3, item n).

Both packages track the 150 frames of the loop circle and frames 0-19
again with mapping and loop closing on, each frame retired before the
next, at 320x240 and in ``chip_smoke.py``'s full-pipeline configuration
(phase 13: VGA, 1024 features, 8 levels, default arena).  Each keyframe
event and each verification is recorded as
``scripts/trace_torch_loop_decisions.py`` records the port's: the
candidate pair, the SearchByBoW matches, the Sim3 RANSAC inliers, the
inliers of each OptimizeSim3, the guided re-matches and the verdict.
Slow (the VGA case takes tens of minutes on an 8-core CPU):

    JAX_PLATFORMS=cpu python -m pytest -m slow -s \
        tests/test_torch_loop_circle_decisions.py

Run as a module (with ``JAX_PLATFORMS=cpu``) with ``--frames PATH.npz
--side jax|port-witness --json PATH`` it writes the JAX package's VGA
trace, or the port's with the JAX package's local-BA write-back, of
frames saved by ``--render PATH.npz``, so that the sides can run as
separate processes; the unpatched port's trace of the same frames comes
from ``scripts/trace_torch_loop_decisions.py --device cpu --pipeline
eager --frames-file PATH.npz``.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from scripts.trace_torch_loop_decisions import (
    detect_row, event_row, loop_config, loop_frames, patched, trace_port)
from tests.test_torch_mapping import jax_write_back

torch.set_num_threads(1)


def jax_config(tc=None):
    """The JAX package's copy of the port's configuration ``tc``
    (default: ``loop_config()``)."""
    from active_orb_slam2_tpu import config as jcfg
    from active_orb_slam2_tpu.geometry.projection import CameraParams
    tc = tc or loop_config()
    c = tc.camera
    return jcfg.SlamConfig(
        camera=CameraParams(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf,
                            width=c.width, height=c.height),
        orb=jcfg.OrbConfig(**dataclasses.asdict(tc.orb)),
        tracking=jcfg.TrackingConfig(**dataclasses.asdict(tc.tracking)),
        map=jcfg.MapConfig(**dataclasses.asdict(tc.map)))


def trace_jax(frames, tc=None):
    """The JAX package's full pipeline over ``frames`` in the port's
    configuration ``tc`` (default: ``loop_config()``), each frame retired
    before the next; (event rows, verification rows, detection rows,
    System).  The counts inside the jitted verification come out through
    ordered debug callbacks."""
    import jax
    from active_orb_slam2_tpu.models import loop_closing as jlcm
    from active_orb_slam2_tpu.models import sim3_solver as jsolver
    from active_orb_slam2_tpu.models import system as jsys
    slam = jsys.System(jax_config(tc), use_loop_closing=True,
                       pipeline_depth=0, retire_batch=1)
    lc = slam.loop_closer
    events, verifs, detects = [], [], []

    def rec(key):
        def cb(v):
            verifs[-1].setdefault(key, []).append(int(v))
        return cb

    def counted(key, pick):
        def wrap(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                jax.debug.callback(rec(key), pick(out), ordered=True)
                return out
            return call
        return wrap

    run_lc, run_sim3 = lc.process_keyframe, lc.compute_sim3

    def process_keyframe(m, k, kf_seq, **kw):
        out = run_lc(m, k, kf_seq, **kw)
        slam.map = out[0]
        events.append(event_row(slam, lc, k, kf_seq, out[1]))
        return out

    def compute_sim3(m, cur, loop):
        verifs.append({"kf_seq": slam.kf_seq, "cur": int(cur),
                       "loop": int(loop)})
        ok, s, n = run_sim3(m, cur, loop)
        verifs[-1]["verdict"] = bool(ok)
        return ok, s, n

    run_detect = lc._build_detect_fn()

    def detect(m, cur_kf, W, scores, prev_accept):
        out = run_detect(m, cur_kf, W, scores, prev_accept)
        detects.append(detect_row(slam.kf_seq, m, cur_kf, W, scores,
                                  prev_accept, out))
        return out

    lc.process_keyframe, lc.compute_sim3 = process_keyframe, compute_sim3
    lc._detect_fn = detect
    lm = counted("lm_inliers", lambda o: o[2])
    with patched(jlcm, {
            "_sim3_match_data_body": counted("bow_matches",
                                             lambda o: o[-1].sum()),
            "sim3_ransac": counted("ransac_inliers", lambda o: o.n_inliers),
            "optimize_sim3": lm,
            "_sim3_guided_refine_body": counted("guided_matches",
                                                lambda o: o[1])}), \
            patched(jsolver, {"optimize_sim3": lm}):
        for i, (g, d) in enumerate(frames):
            slam.track_rgbd(g, d, i / 30.0)
            slam.state
        slam.flush()
    return events, verifs, detects, slam


def summary(events, verifs, detects, slam):
    return {"events": events, "verifications": verifs,
            "detections": detects, "loops_closed": slam.n_loops_closed,
            "kf_seq": slam.kf_seq}


def replay_detection(row):
    """The port's DetectLoop on the inputs of a recorded call (either
    package's): (accepted keyframe slots, consistent candidate or -1)."""
    from types import SimpleNamespace
    from active_orb_slam2_tpu_torch.models.loop_closing import LoopCloser
    K = row["K"]
    slots = torch.tensor(row["slots"], dtype=torch.long)
    W = torch.zeros((K, K), dtype=torch.int32)
    W[slots[:, None], slots] = torch.tensor(row["W"], dtype=torch.int32)
    scores = torch.zeros(K)
    scores[slots] = torch.tensor([row["scores"][str(j)]
                                  for j in row["slots"]])
    valid = torch.zeros(K, dtype=torch.bool)
    valid[slots] = torch.tensor(row["valid"])
    fid = torch.full((K,), -1, dtype=torch.int32)
    fid[slots] = torch.tensor(row["fid"], dtype=torch.int32)
    prev = torch.zeros((len(row["prev"]), K), dtype=torch.bool)
    for g, acc in enumerate(row["prev"]):
        prev[g, acc] = True
    m = SimpleNamespace(max_keyframes=K, kf_valid=valid, kf_frame_id=fid)
    cand, ok, buf = LoopCloser(loop_config())._detect(
        m, row["cur"], W, scores, prev)
    return (torch.nonzero(buf[-1]).flatten().tolist(),
            int(cand) if bool(ok) else -1)


def detections_replay(side):
    """Every recorded detection of ``side`` against the port's DetectLoop
    on the same inputs: [(recorded accept, candidate), (replayed ...)]."""
    return [((r["accept"], r["cand"]), replay_detection(r))
            for r in side["detections"]]


def detection_margins(side):
    """Each loop detection that named a consistent candidate: (keyframe
    sequence, current keyframe, candidate, the candidate's BoW score
    less the minimum score)."""
    return [(r["kf_seq"], r["cur"], r["cand"],
             r["scores"][str(r["cand"])] - r["min_score"])
            for r in side["detections"] if r["cand"] >= 0]


def verdicts(side):
    return [(v["kf_seq"], v["cur"], v["loop"], v["verdict"])
            for v in side["verifications"]]


@pytest.mark.slow
def test_loop_circle_decisions_match_at_320x240():
    """``tests/test_e2e_full_pipeline.py``'s configuration (320x240, 512
    features, 4 levels, a 48-keyframe arena, a keyframe at least every
    10 frames): both packages verify the same three candidate pairs at
    the same keyframe events with the same verdicts (two false
    candidates across the circle rejected, the revisit closed), and each
    closes one loop.  Measured: the same keyframes at every event and
    point counts within 2."""
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    cfg = SlamConfig(
        camera=CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                            width=320, height=240),
        orb=OrbConfig(n_features=512, n_levels=4),
        tracking=TrackingConfig(th_depth=12.0, kf_max_interval=10),
        map=MapConfig(max_keyframes=48, max_points=8192,
                      local_ba_keyframes=8, local_ba_points=2048))
    with pytest.MonkeyPatch.context() as mp:
        import scripts.trace_torch_loop_decisions as tr
        mp.setattr(tr, "loop_config", lambda: cfg)
        mp.setattr(sys.modules[__name__], "loop_config", lambda: cfg)
        frames = [tr._render(i) for i in
                  list(range(tr.N_LOOP)) + list(range(tr.N_REVISIT))]
        jax_side = summary(*trace_jax(frames))
        port_side = summary(*trace_port(cfg, frames, torch.device("cpu")))
    assert verdicts(port_side) == verdicts(jax_side)
    assert [v[3] for v in verdicts(jax_side)] == [False, False, True]
    assert port_side["loops_closed"] == jax_side["loops_closed"] == 1
    assert [e["frame"] for e in port_side["events"]] == \
        [e["frame"] for e in jax_side["events"]]
    for recorded, replayed in detections_replay(jax_side):
        assert replayed == recorded


@pytest.mark.slow
def test_vga_decisions_named_cause():
    """ROADMAP queue 3, item n, at full width.  Both packages verify the
    same five false candidates across the circle at the same events and
    reject them (RANSAC inliers 0-4 of 20-43 SearchByBoW matches; the
    port makes the same decisions on the card).  The JAX package then
    detects the revisit (the keyframe of frame 147 against keyframe 0)
    and closes it.  Every one of the JAX package's loop detections,
    replayed through the port's DetectLoop on the same covisibility
    weights, scores and consistency buffer, gives the same accepted
    keyframes and candidate, so where the two packages part it is on
    the map the detection is given, not in the detection (there: the
    port's keyframe slot 7 is frame 44, not 45, and scores under the
    minimum score at the two detections before the revisit, where the
    JAX package's clears it by 0.003-0.004; without it keyframe 4's
    group, covisible with keyframe 0, is not accepted, and keyframe 0
    has no consistent predecessor at the revisit).  With the JAX
    package's local-BA write-back patched in
    (``tests/test_torch_mapping.py::jax_write_back``) the port detects
    and closes the revisit at the same keyframe event."""
    frames = loop_frames()
    jax_side = summary(*trace_jax(frames))
    port_side = summary(*trace_port(loop_config(), frames,
                                    torch.device("cpu")))
    with jax_write_back():
        witness = summary(*trace_port(loop_config(), frames,
                                      torch.device("cpu")))
    jv, pv, wv = (verdicts(s) for s in (jax_side, port_side, witness))
    assert pv[:5] == jv[:5] and not any(v[3] for v in jv[:5])
    assert jax_side["loops_closed"] == 1 and jv[-1][3]
    for recorded, replayed in detections_replay(jax_side):
        assert replayed == recorded
    assert witness["loops_closed"] == 1
    closing = [v for v in wv if v[3]]
    assert [(v[0], v[1]) for v in closing] == [(jv[-1][0], jv[-1][1])]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--render", help="render the frames into this .npz")
    ap.add_argument("--revisit", type=int, default=20,
                    help="with --render: frames of the circle rendered "
                         "again after it")
    ap.add_argument("--frames", help="frames saved by --render")
    ap.add_argument("--side", choices=("jax", "port-witness"))
    ap.add_argument("--json")
    args = ap.parse_args()
    if args.render:
        frames = loop_frames(revisit=args.revisit)
        np.savez(args.render, gray=np.stack([g for g, _ in frames]),
                 depth=np.stack([d for _, d in frames]))
        return 0
    with np.load(args.frames) as f:
        frames = list(zip(f["gray"], f["depth"]))
    torch.set_num_threads(int(os.environ.get("TRACE_THREADS", "4")))
    if args.side == "jax":
        side = summary(*trace_jax(frames))
    else:
        with jax_write_back():
            side = summary(*trace_port(loop_config(), frames,
                                       torch.device("cpu")))
    with open(args.json, "w") as f:
        json.dump(side, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())


N_LONG_REVISIT = 40


@pytest.mark.slow
def test_vga_long_revisit_closes_in_jax():
    """ROADMAP queue 3, item q: the loop circle at full width and frames
    0-39 again (``chip_smoke.py`` phase 13's revisit).  The port on the
    card closes the revisit there (verifying the keyframe of frame 169
    against keyframe 5 at the event of frame 177, a score margin of
    0.225 over the minimum); the JAX package, each frame retired before
    the next, closes at least one loop on the same frames.  Prints its
    verdicts, its closing events and the margin of every consistent
    candidate over the minimum score.  Tens of minutes: run it on an
    8-core CPU beside the card, not in the tier-1 run."""
    frames = loop_frames(revisit=N_LONG_REVISIT)
    jax_side = summary(*trace_jax(frames))
    print(json.dumps({
        "verdicts": verdicts(jax_side),
        "closed": [(e["kf_seq"], e["frame"]) for e in jax_side["events"]
                   if e["closed"]],
        "margins": detection_margins(jax_side),
        "loops_closed": jax_side["loops_closed"]}))
    assert jax_side["loops_closed"] >= 1
