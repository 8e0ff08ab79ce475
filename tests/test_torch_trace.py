"""The port's tracer (``utils/trace.py``) and the spans at its stage
boundaries, on a few frames of a shrunk RGB-D ``System`` (the benchmark's
``tum_fr1_rgbd`` configuration at a quarter of its size, frames of the
``localize_sweep`` traffic), on the CPU:

* off, it records nothing, reads no clock and calls no profiler range,
  and the poses and per-frame rows are those of a traced run;
* on, every stage span lies inside its layer span and every layer span
  inside its frame's ``system.track``; frame ids are consecutive, each
  frame has one ``frame.fast`` and one ``frame.topk`` a level;
* the kernels' launches are counted (on the card);
* a span placed on the profiler's clock through ``anchor()`` starts
  where a profiler range opened at the same point starts;
* with ``enable(sync=True)`` the keyframe-rate stages each have a span,
  and every span waits for the card;

and the benchmark's readers of the program's spans
(``benchmark/harness/program_trace.py``) on hand-built records.
"""

import collections
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from active_orb_slam2_tpu_torch.utils import trace

SHRINK = dict(factor=0.25, n_features=512, n_levels=4, max_keyframes=16,
              max_points=2048)
N_FRAMES = 8
LOC_FROM = 5          # localization mode from this frame on
SEED = 3_000_000_019

LAYERS = {"frame": "frame.", "track": "track.", "mapping": "mapping.",
          "loop": "loop."}


@pytest.fixture(scope="module")
def setting():
    from benchmark.harness import definitions, session
    from benchmark.traffic import generate
    cj, yaml_path = definitions.config("tum_fr1_rgbd")
    cfg = session.port_config(cj, yaml_path, SHRINK)
    rcam, _, _ = session.reference_config(cj, yaml_path, cfg)
    mix = definitions.mix("localize_sweep")
    mix["path"] = dict(mix["path"], frames=N_FRAMES)
    traffic = generate.make(mix, rcam, 15.0, "rgbd", SEED, N_FRAMES,
                            torch.device("cpu"))
    return cfg, traffic, definitions.resolve(cj["vocabulary"])


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def track(setting, mode, n=N_FRAMES, **system_kw):
    """Hand in ``n`` frames one at a time (each retired before the
    next); in ``localization`` mode the last ones localize."""
    from active_orb_slam2_tpu_torch.models.system import System
    cfg, traffic, vocab = setting
    kw = dict(use_mapping=True, use_loop_closing=True, vocab_path=vocab)
    kw.update(system_kw)
    slam = System(cfg, device="cpu", **kw)
    for i in range(n):
        if mode == "localization" and i == LOC_FROM:
            slam.activate_localization_mode()
        slam.track_rgbd(traffic.images[0][i], traffic.images[1][i],
                        float(traffic.timestamps[i]))
        slam.flush()
    return slam


def outputs(slam):
    ts, tcw = slam.frame_trajectory()
    rows = [{k: v for k, v in r.items() if k != "wall_ms"}
            for r in slam.metrics]
    return np.asarray(ts), np.asarray(tcw), rows


def _refuse(*_a, **_k):
    raise AssertionError("the tracer acted while off")


@pytest.mark.parametrize("mode", ["mapping", "localization"])
def test_off_records_nothing_and_changes_nothing(setting, mode,
                                                 monkeypatch):
    with monkeypatch.context() as mp:
        mp.setattr(trace, "perf_counter_ns", _refuse)
        mp.setattr(trace, "_synchronize", _refuse)
        mp.setattr(torch.profiler, "record_function", _refuse)
        off = outputs(track(setting, mode))
    assert trace.records() == []
    trace.enable()
    on = outputs(track(setting, mode))
    trace.disable()
    assert len(trace.records()) > 0
    np.testing.assert_array_equal(off[0], on[0])
    np.testing.assert_array_equal(off[1], on[1])
    assert off[2] == on[2]


def inside(inner, outer):
    return outer.t0_ns <= inner.t0_ns and inner.t1_ns <= outer.t1_ns


@pytest.mark.parametrize("mode", ["mapping", "localization"])
def test_spans_nest_by_layer_and_frame(setting, mode):
    trace.enable()
    slam = track(setting, mode)
    trace.disable()
    rec = trace.records()
    assert all(r.t1_ns is not None and r.t1_ns >= r.t0_ns for r in rec)
    roots = [r for r in rec if r.name == "system.track"]
    assert [r.frame for r in roots] == list(range(N_FRAMES))
    assert all(r.parent is None for r in roots)
    for i, r in enumerate(rec):
        if r.parent is not None:
            assert inside(r, rec[r.parent]), (r, rec[r.parent])
        # a stage span's parent is its layer's span
        for layer, prefix in LAYERS.items():
            if r.name.startswith(prefix):
                assert rec[r.parent].name == layer, r
        # a layer span lies inside its frame's root; a keyframe's mapping
        # and loop spans inside the retirement of its frame, in a later
        # call or in a flush between calls
        if r.name in ("frame", "track"):
            assert rec[r.parent].name == "system.track"
            assert rec[r.parent].frame == r.frame
        if r.name in ("mapping", "loop"):
            assert rec[r.parent].name == "system.retire"
            top = rec[r.parent]
            while top.parent is not None:
                top = rec[top.parent]
            assert top.name in ("system.track", "system.retire")
            assert top.frame is None or top.frame >= r.frame
    n_levels = slam.cfg.orb.n_levels
    per_frame = collections.Counter((r.name, r.frame) for r in rec)
    for f in range(N_FRAMES):
        assert per_frame["frame", f] == 1
        assert per_frame["frame.fast", f] == n_levels
        assert per_frame["frame.topk", f] == n_levels
        assert per_frame["frame.pyramid", f] == n_levels
        assert per_frame["frame.describe", f] == 1
        assert per_frame["system.upload", f] == 1
    tracked = range(1, N_FRAMES)      # frame 0 initializes the map
    for f in tracked:
        for stage in ("track", "track.motion", "track.local_map",
                      "track.keyframe"):
            assert per_frame[stage, f] == 1, (stage, f)
    assert per_frame["setup.system", None] == 1
    assert per_frame["setup.vocabulary", None] == 1
    assert any(r.name == "mapping" for r in rec)
    if mode == "localization":
        assert not any(r.name == "mapping" and r.frame >= LOC_FROM
                       for r in rec)


@pytest.mark.cuda
def test_kernel_launches_are_counted():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark.harness import definitions, session
    from benchmark.traffic import generate
    from active_orb_slam2_tpu_torch.models.system import System
    dev = torch.device("cuda", 0)
    cj, yaml_path = definitions.config("tum_fr1_rgbd")
    cfg = session.port_config(cj, yaml_path)
    rcam, _, _ = session.reference_config(cj, yaml_path, cfg)
    mix = definitions.mix("localize_sweep")
    n = 6
    mix["path"] = dict(mix["path"], frames=n)
    traffic = generate.make(mix, rcam, 15.0, "rgbd", SEED, n, dev)
    slam = System(cfg, use_mapping=True, device=dev)
    before = trace.counters()
    for i in range(n):
        slam.track_rgbd(traffic.images[0][i], traffic.images[1][i],
                        float(traffic.timestamps[i]))
        slam.flush()
    torch.cuda.synchronize()
    assert slam.state == 1
    after = trace.counters()
    launches = {k: after.get(k, 0) - before.get(k, 0)
                for k in ("k1.launches", "k2.launches")}
    assert launches == {"k1.launches": 2 * (n - 1), "k2.launches": n}


def test_anchor_places_spans_on_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.anchor()
        time.sleep(0.02)
        with trace.span("probe"):
            with torch.profiler.record_function("probe_range"):
                time.sleep(0.002)
    trace.disable()
    events = [(e.name(), e.start_ns())
              for e in prof.profiler.kineto_results.events()]
    offset = trace.profiler_offset_ns(events)
    assert offset is not None
    probe, = [r for r in trace.records() if r.name == "probe"]
    start, = [t for name, t in events if name == "probe_range"]
    assert abs(probe.t0_ns + offset - start) < 0.5e6


def test_sync_mode_spans_every_keyframe_stage(setting, monkeypatch):
    """With ``enable(sync=True)`` the keyframe-rate stages (the mapping
    call, loop detection, verification, correction, the GBA slice, the
    vocabulary training) each have a span, and every span waits for the
    card.  Verification and correction are stood in
    for by their verdicts (the spans are the object here, not the Sim3),
    on a closer that trains its vocabulary from the map."""
    import dataclasses
    cfg, traffic, _ = setting
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(
        cfg.tracking, kf_max_interval=1, kf_min_interval=0))
    waits = []
    monkeypatch.setattr(trace, "_synchronize", lambda: waits.append(1))
    trace.enable(sync=True)
    slam = track((cfg,) + setting[1:], "mapping", vocab_path=None)
    lc = slam.loop_closer
    assert lc.vocab is not None, "no vocabulary was trained"
    live = sorted(slam._slot_fid)
    cur, cand = live[-1], live[0]
    monkeypatch.setattr(lc, "compute_sim3",
                        lambda m, k, c: (True, torch.eye(4), None))

    def correct(m, k, c, s_cm, W=None):
        lc.gba_remaining = 2
        return m, True

    monkeypatch.setattr(lc, "correct", correct)
    lc.last_loop_kf_seq = -100
    lc._pending_detect = {
        "kf": cur, "fid": slam._slot_fid[cur], "fids": None,
        "kf_seq": slam.kf_seq, "copy": (torch.tensor([cand, 1]), None)}
    with trace.span("loop"):
        slam.map, closed = lc.process_keyframe(
            slam.map, cur, slam.kf_seq + 1, slot_fid=slam._slot_fid)
    assert closed
    with trace.span("loop"):
        slam.map, _ = lc.process_keyframe(
            slam.map, cur, slam.kf_seq + 2, slot_fid=slam._slot_fid)
    trace.disable()
    rec = trace.records()
    names = {r.name for r in rec}
    for stage in ("mapping", "mapping.local_ba", "loop.detect",
                  "loop.retrain", "loop.verify", "loop.correct",
                  "loop.gba_slice"):
        assert stage in names, stage
    assert len(waits) == len(rec)


# ----------------------------------------------- the benchmark's readers


def S(name, frame, t0_ms, t1_ms, parent=None):
    return trace.Span(name, frame, parent, int(t0_ms * 1e6),
                      int(t1_ms * 1e6))


def hand_built_run():
    """Two set-up spans, one warm-up frame (4) and two window frames
    (5, 6) with their stages."""
    rec = [S("setup.system", None, 0, 2000),
           S("setup.warm_up", None, 100, 1100, 0),
           S("system.track", 4, 3000, 3040),
           S("frame.fast", 4, 3001, 3011, 2),
           S("mapping", 3, 3020, 3030, 2)]
    for f, t in ((5, 4000), (6, 5000)):
        base = len(rec)
        rec += [S("system.track", f, t, t + 40),
                S("system.upload", f, t + 1, t + 2, base),
                S("frame", f, t + 2, t + 22, base),
                S("frame.fast", f, t + 3, t + 9, base + 2),
                S("frame.fast", f, t + 10, t + 13, base + 2),
                S("frame.topk", f, t + 13, t + 17, base + 2),
                S("track", f, t + 22, t + 38, base),
                S("track.motion", f, t + 22, t + 30, base + 6),
                S("track.local_map", f, t + 30, t + 36, base + 6),
                S("system.wait", f, t + 38, t + 38.5, base)]
    run = SimpleNamespace(n_window=2, window_bounds=(3.9, 5.5))
    return rec, run


@pytest.mark.parametrize("metric,value", [
    ("frame.fast.host_ms", 9.0), ("frame.topk.host_ms", 4.0),
    ("track.motion.host_ms", 8.0), ("track.local_map.host_ms", 6.0),
    ("system.upload.host_ms", 1.0), ("system.wait_ms", 0.5),
    ("setup.system_s", 2.0)])
def test_program_span_readers(metric, value):
    from benchmark.harness import program_trace
    rec, run = hand_built_run()
    read = program_trace.READERS[metric]
    assert read(run) is None                      # a run without spans
    run.program = program_trace.handover(rec, run.window_bounds)
    assert run.program.first_frame == 5
    assert read(run) == pytest.approx(value)
    assert program_trace.UNITS[metric] == ("s" if metric.endswith("_s")
                                           else "ms")


def test_program_span_sums_setup_and_idle():
    from benchmark.harness import program_trace
    rec, run = hand_built_run()
    run.program = program_trace.handover(rec, run.window_bounds)
    sums = program_trace.stage_sums(run)
    assert sums["frame_stages_ms"] == pytest.approx(13.0)
    assert sums["track_stages_ms"] == pytest.approx(14.0)
    totals = {k: (s, n) for k, s, n in
              program_trace.setup_totals(rec, run.program.first_frame)}
    assert totals == {"setup.system": (2.0, 1), "setup.warm_up": (1.0, 1),
                      "mapping": (pytest.approx(0.01), 1)}
    # device ops on the profiler's clock (us), 1 s after the host's
    offset = 10 ** 9
    us = lambda ms: (ms * 1e6 + offset) / 1e3      # noqa: E731
    # gaps: 4003.5-4004.5 in frame.fast, 4017.5-4021.5 in frame itself,
    # 4023-4029 in track.motion, 4041-4100 after the frame's root
    ev = [("k", True, us(4000), us(4003.5)),
          ("k", True, us(4004.5), us(4017.5)),
          ("k", True, us(4021.5), us(4023)),
          ("k", True, us(4029), us(4041)),
          ("k", True, us(4100), us(4100.1)),
          ("cpu", False, us(4000), us(4001))]
    idle = program_trace.idle_by_span(rec, offset, ev)
    assert idle == pytest.approx({"frame.fast": 1e-3, "frame": 4e-3,
                                  "track.motion": 6e-3, "(none)": 59e-3},
                                 abs=1e-6)
    assert program_trace.stage_idle_share(idle) == pytest.approx(7 / 11)
    assert program_trace.idle_by_span(rec, None, ev) == {}


def test_write_chrome(tmp_path):
    import json
    trace.enable()
    with trace.span("outer", frame=3):
        with trace.span("inner"):
            trace.count("test.probe", 2)
    trace.disable()
    path = tmp_path / "t.json"
    trace.write_chrome(path)
    ev = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in ev if e["ph"] == "X"}
    assert spans["inner"]["args"] == {"frame": 3, "parent": 0}
    assert spans["outer"]["ts"] == 0.0
    assert spans["inner"]["dur"] <= spans["outer"]["dur"]
    counts = [e["args"] for e in ev if e["ph"] == "C"]
    assert {"test.probe": 2} in counts


TUM_YAML = """%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 159.5
Camera.cy: 119.5
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 30.0
Camera.bf: 20.8
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_tum_entry_point_writes_the_trace(tmp_path, monkeypatch):
    """``run_tum_rgbd --trace-out`` over a six-frame TUM directory: the
    file holds every frame's root and its stages."""
    import json
    from PIL import Image
    from active_orb_slam2_tpu_torch.examples import run_tum_rgbd
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, make_sequence, orbit_trajectory)
    n = 6
    cam = CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                       width=320, height=240)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rgb, dep = [], []
    for i, (g, d, _) in enumerate(make_sequence(
            n, cam, world=default_world(),
            trajectory=orbit_trajectory(n, step_deg=2.0))):
        t = f"{1000.0 + i / 30.0:.6f}"
        Image.fromarray(np.clip(g, 0, 255).astype(np.uint8), "L").save(
            tmp_path / "rgb" / f"{t}.png")
        Image.fromarray(np.clip(d * 5000.0, 0, 65535).astype(np.uint16)
                        ).save(tmp_path / "depth" / f"{t}.png")
        rgb.append(f"{t} rgb/{t}.png")
        dep.append(f"{t} depth/{t}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(dep) + "\n")
    (tmp_path / "TUM.yaml").write_text(TUM_YAML)
    monkeypatch.chdir(tmp_path)
    run_tum_rgbd.main([str(tmp_path), "--settings", "TUM.yaml",
                       "--no-loop-closing", "--device", "cpu",
                       "--trace-out", "trace.json"])
    assert not trace._on
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = collections.Counter(e["name"] for e in ev if e["ph"] == "X")
    assert names["system.track"] == n
    assert names["frame.fast"] == 4 * n and names["track"] == n - 1
    assert names["setup.system"] == 1
