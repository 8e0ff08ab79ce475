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


def run(cell, mode):
    mix = definitions.mix(definitions.cell(cell)["traffic"])
    ov = {"warmup": {"frames": WARM[cell]}, "profile_frames": 2,
          "check": dict(mix["check"], sample_frames=4, sample_solves=8)}
    if mix["path"].get("order") == "sweep":     # map the shorter path
        ov["path"] = dict(mix["path"], frames=WARM[cell])
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


def test_verdict_compares_the_numbers_the_limits_name():
    numbers = {"kp_diff": 0.0, "ate_m": 0.01, "map_point_m": 9.0}
    ok, rows = check.verdict(numbers, {"kp_diff": 0.01, "ate_m": 0.04})
    assert ok and [r[0] for r in rows] == ["kp_diff", "ate_m"]
    assert not check.verdict(numbers, {"kp_diff": 0.01, "desc_diff": 1.0})[0]
    assert not check.verdict(numbers, {})[0]
