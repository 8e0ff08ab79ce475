"""``bench_torch.py`` on the CPU at a small size: its windows run and
make ``bench.py``'s record, its FLOP model is the JAX script's, and
without a card it refuses to run.

The windows run at 320x240 with 512 features and 4 levels: 18 frames
of the tracking window, 24 of the full pipeline, 8 stereo pairs (3
timed), a 48-keyframe / 2,048-point BA problem, a 256-wide op-floor
probe and 2 mesh ranks.  The numbers are the CPU's; only the record's
form is checked.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from active_orb_slam2_tpu_torch.config import OrbConfig
from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
from active_orb_slam2_tpu_torch.io.synthetic import (
    default_world, loop_trajectory, make_sequence, orbit_trajectory,
    render_rgbd)
from tests.test_torch_tracking import CAM

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_ORB = OrbConfig(n_features=512, n_levels=4)
SMALL_BA = (48, 2048, 8)


def small(cfg, cam):
    return dataclasses.replace(cfg, camera=cam, orb=SMALL_ORB)


def orbit_frames(n):
    cam = CameraParams(**CAM)
    return [(np.clip(g, 0, 255).astype(np.uint8),
             np.clip(d * 1e3, 0, 65535).astype(np.uint16))
            for g, d, _ in make_sequence(
                n, cam, world=default_world(),
                trajectory=orbit_trajectory(
                    n, step_deg=bench_torch.ORBIT_STEP_DEG))]


def stereo_pairs(n):
    """``n`` pairs of a 320x240 circuit, the right eye moved by 0.12 m."""
    cam = CameraParams(**dict(CAM, bf=260.0 * bench_torch.STEREO_BASELINE_M))
    traj = loop_trajectory(n * 10, radius=2.5)[:n]
    pairs = []
    for Twc in traj:
        right = Twc.copy()
        right[:3, 3] += Twc[:3, :3] @ np.array(
            [bench_torch.STEREO_BASELINE_M, 0.0, 0.0], np.float32)
        pairs.append(tuple(np.clip(render_rgbd(
            default_world(n_boxes=0), cam, T, supersample=1)[0], 0,
            255).astype(np.uint8) for T in (Twc, right)))
    cfg = small(bench_torch.stereo_config(), cam)
    return cfg, pairs, np.stack([T[:3, 3].astype(np.float64) for T in traj])


@pytest.fixture(scope="module")
def record():
    cam = CameraParams(**CAM)
    frames = orbit_frames(24)
    dev = torch.device("cpu")
    total_ms, window_ms, slam = bench_torch.tracking_window(
        frames[:18], small(bench_torch.tracking_config(), cam), dev)
    mapping_ms = bench_torch.mapping_timing(slam, reps=2)
    full = bench_torch.full_pipeline_window(
        frames, dev, small(bench_torch.full_pipeline_config(), cam))
    cfg, pairs, gt = stereo_pairs(8)
    stereo = bench_torch.stereo_kitti_shape(dev, cfg, pairs, gt, n_timed=3)
    ba = bench_torch.ba_roofline(dev, small=SMALL_BA, big=SMALL_BA, iters=2)
    floor = bench_torch.ba_op_floor_evidence(dev, n=256, problem=SMALL_BA,
                                             reps=3)
    mesh = bench_torch.mesh_scaling_efficiency(ranks=2)
    return bench_torch.make_record((total_ms, window_ms), mapping_ms, full,
                                   stereo, ba, floor, mesh,
                                   bench_torch.device_info(dev))


def test_record_has_bench_r05_keys(record):
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        parsed = json.load(f)["parsed"]
    assert set(record) == set(parsed) | {"device"}
    assert set(record["ba_op_floor_evidence"]) == \
        set(parsed["ba_op_floor_evidence"])
    assert record["device"] == {"name": "cpu"}
    assert record["unit"] == parsed["unit"] and \
        record["metric"] == parsed["metric"]
    assert len(record["tracking_window_ms"]) == 3
    assert record["ba_peak_tflops_assumed"] == 67.0
    for k, v in record.items():
        assert v is not None, k
        if isinstance(v, float):
            assert np.isfinite(v) and v >= 0, (k, v)
    json.dumps(record)


def test_record_counts(record):
    """The counts in the record are the small runs' own."""
    assert record["full_pipeline_kfs"] >= 2
    assert record["stereo_kitti_shape_kfs"] >= 1
    assert record["stereo_kitti_shape_loops"] == 0
    # a CG step dispatches a fixed number of operations
    ops = record["ba_op_floor_evidence"]["cg_body_ops"]
    assert ops == int(ops) and ops > 0


@pytest.mark.parametrize("shape", [(48, 8192, 8), (512, 65_536, 8),
                                   (512, 16_384, 4)])
def test_ba_flops_per_iter_matches_jax_script(shape):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import bench_ba_scaling
    K, Pn, O = shape
    got = bench_torch._ba_script().ba_flops_per_iter(K=K, Pn=Pn, O=O)
    want = bench_ba_scaling.ba_flops_per_iter(K=K, Pn=Pn, O=O)
    assert type(got) is int and got == want


def test_refuses_to_run_without_a_card():
    """No card here: the bench exits nonzero and prints no record."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not out.stdout.strip()
