"""The check catches what it is there to catch: at a size a CPU test run
holds, the whole run (traffic, warm-up, the paced window, the check)
with the harness's look for a card skipped, against the cells' own
limits (``benchmark/checks/<cell>.json``).

* the program as it is passes every number that does not depend on the
  image size (at a quarter of the resolution the trajectory and the map
  are coarser than at the cell's size, so ``ate_m``, and
  ``map_point_m`` where a cell compares it, are held only where a fault
  is to move them);
* the control, the reference put in the program's place with its image
  arithmetic and its pose solve's edges in bfloat16 (one precision below
  the program's float32), comes out not correct;
* so does each fault a cell can have, by the number that should catch
  it: a tracking step that returns the state it was given (``ate_m``),
  half of each frame's keypoints left out (``kp_diff``), an answer (a
  word of each descriptor) altered where the frame is built
  (``desc_diff``).  A cell runs on one card, so no exchange between cards
  can be left out.
"""

import pytest
import torch

from benchmark import control
from benchmark.harness import check, definitions

SHRINK = {
    "rgbd_localize": dict(factor=0.25, n_features=512, n_levels=4,
                          max_keyframes=48, max_points=4096),
}
WARM = {"rgbd_localize": 40}
SECONDS = {"rgbd_localize": 3.0}
SEED = 3_000_000_019
SIZE_FREE = ("kp_diff", "desc_diff", "pose_gap_m")
CATCHES = {"control": ("kp_diff", "desc_diff", "pose_gap_m"),
           "state_unchanged": ("ate_m",), "half_batch": ("kp_diff",),
           "answer_altered": ("desc_diff",)}


def overrides(cell):
    mix = definitions.mix(definitions.cell(cell)["traffic"])
    ov = {"warmup": {"frames": WARM[cell]}, "profile_frames": 2,
          "check": dict(mix["check"], sample_frames=4, sample_solves=8)}
    if mix["path"].get("order") == "sweep":     # map the shorter path
        ov["path"] = dict(mix["path"], frames=WARM[cell])
    return ov


def run(cell, mode):
    ov = overrides(cell)
    ok, numbers, _ = control.run_mode(cell, SEED, SECONDS[cell], mode,
                                      torch.device("cpu"),
                                      shrink=SHRINK[cell], mix_overrides=ov,
                                      log=lambda m: None)
    return ok, numbers


@pytest.mark.parametrize("cell", sorted(SHRINK))
def test_program_passes(cell):
    _, numbers = run(cell, "program")
    limits = definitions.limits(cell)
    for k in SIZE_FREE:
        assert numbers[k] <= limits[k], (k, numbers)


@pytest.mark.parametrize("cell", sorted(SHRINK))
@pytest.mark.parametrize("mode", sorted(CATCHES))
def test_control_and_faults_fail(cell, mode):
    ok, numbers = run(cell, mode)
    limits = definitions.limits(cell)
    assert not ok, numbers
    assert any(not numbers[k] <= limits[k] for k in CATCHES[mode]), numbers


def test_traced_run_hands_over_the_programs_spans():
    """A traced run turns the program's tracer on and hands its spans to
    the readers: the layers' and stages' span metrics and
    ``setup.system_s`` read something, and the line carries the
    ``program`` entry."""
    from benchmark import run as bench
    from benchmark.harness import program_trace, session
    from active_orb_slam2_tpu_torch.utils import trace
    cell = "rgbd_localize"
    cpu = torch.device("cpu")
    r, numbers = session.run(cell, SEED, SECONDS[cell], True, cpu,
                             shrink=SHRINK[cell],
                             mix_overrides=overrides(cell), log=lambda m: None)
    assert trace.span("x") is trace.span("y")      # the tracer is off again
    assert r.program.first_frame is not None
    for name in ("frame.host_ms", "track.host_ms", "system.self_host_ms",
                 "track.motion.host_ms", "track.local_map.host_ms",
                 "system.upload.host_ms", "setup.system_s"):
        v = definitions.metric_reader(name)(r)
        assert v is not None and v > 0, name
        assert v == program_trace.READERS[name](r)
    line, _ = bench.result(r, numbers, definitions.limits(cell), True, cpu)
    assert line["program"]["first_frame"] == r.program.first_frame
    assert list(line)[-1] == "checks"
    assert "track.motion.host_ms" in line["metrics"]


def test_layer_readers_on_hand_built_spans():
    """The layer metrics from hand-built spans (ms): two window frames,
    the second retiring the first's keyframe event inside its root."""
    from types import SimpleNamespace
    from benchmark.harness import program_trace
    from active_orb_slam2_tpu_torch.utils.trace import Span

    def ms(*spans):          # (name, frame, parent, t0 ms, t1 ms)
        return [Span(n, f, p, int(a * 1e6), int(b * 1e6))
                for n, f, p, a, b in spans]
    rec = ms(("setup.system", None, None, 0, 2000),
             ("system.track", 4, None, 3000, 3010),     # before the window
             ("system.track", 5, None, 4000, 4030),
             ("frame", 5, 2, 4001, 4011),
             ("track", 5, 2, 4012, 4020),
             ("system.track", 6, None, 4100, 4400),
             ("frame", 6, 5, 4101, 4111),
             ("track", 6, 5, 4112, 4122),
             ("system.retire", 6, 5, 4123, 4390),
             ("mapping", 5, 8, 4124, 4224),
             ("mapping.local_ba", 5, 9, 4130, 4200),
             ("loop", 5, 8, 4230, 4380),
             ("loop.verify", 5, 11, 4231, 4379))
    run = SimpleNamespace(n_window=2, window_bounds=(3.9, 4.5))
    run.program = program_trace.handover(rec, run.window_bounds)
    assert run.program.first_frame == 5
    want = {"frame.host_ms": 10.0, "track.host_ms": 9.0,
            # 30 - 10 - 8, and 300 - 10 - 10 - 100 - 150
            "system.self_host_ms": (12.0 + 30.0) / 2,
            "mapping.host_ms_per_kf": 100.0, "loop.host_ms_per_kf": 150.0}
    for name, value in want.items():
        assert program_trace.READERS[name](run) == pytest.approx(value), name
        assert definitions.metric_reader(name)(run) == pytest.approx(value)


def test_verdict_compares_the_numbers_the_limits_name():
    numbers = {"kp_diff": 0.0, "ate_m": 0.01, "map_point_m": 9.0}
    ok, rows = check.verdict(numbers, {"kp_diff": 0.01, "ate_m": 0.04})
    assert ok and [r[0] for r in rows] == ["kp_diff", "ate_m"]
    assert not check.verdict(numbers, {"kp_diff": 0.01, "desc_diff": 1.0})[0]
    assert not check.verdict(numbers, {})[0]
