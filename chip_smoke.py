#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``active_orb_slam2_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises, and so exits nonzero, on failure):

1. device and build: requires CUDA, prints the card's name and power
   limit, builds the kernels from ``active_orb_slam2_tpu_torch/csrc``;
2. K1, the fused pose optimization kernel, against its plain PyTorch
   version on 20 seeded problems at E=1024, one each at E=128, 300 and
   2000 (one for each edges-per-thread instance), E=1 from the true
   pose, and the all-invalid and points-behind cases, each run twice
   (the rerun must give identical bits);
3. K2, the keypoint kernel, against its plain version on all 8 levels of
   a rendered VGA frame in one launch, and on keypoints within 18 px of
   every border of each level, with one level empty;
4. the tracking slice: ``System(cfg, use_mapping=False).track_rgbd``
   over 42 VGA frames of the synthetic orbit (the JAX package's
   ``bench.py`` tracking-window configuration), run and timed by
   ``bench_torch.tracking_window``, checking every frame tracks, that
   the main path launched both kernels, and the ATE against ground
   truth;
4b. the tracking slice's frames with the per-frame step as CUDA graphs
   (``utils/graphs.py``; the port's default on the card) against the
   same segments run eagerly: K1 twice a tracked frame and K2 once a
   frame, the trajectory equal bit for bit, each segment's captures,
   replays and eager runs, and each capture's host-clock ms logged;
5. the mapping slice: ``System(cfg_map).track_rgbd`` with local mapping
   on the same frames (``bench.py``'s full-pipeline configuration
   without loop closing: default 512-keyframe arena, a keyframe at
   least every 8 frames), with its launch counts, ATE, keyframe count,
   ms/frame, peak device memory, and host syncs counted on a second run;
5b. the distorted camera: the mapping slice's configuration with TUM
   fr1's calibration and radtan distortion (the undistorted image bounds
   applied) over the 42 orbit frames seen by that camera, gray and depth
   warped into it in a process pool: every frame OK, rigid ATE <= 0.06
   m, a run with the distortion left unmodelled more than twice that
   ATE, K2 once a frame and K1 twice a tracked frame, host syncs
   counted on a second run, peak memory, ms/frame; the undistorted
   keypoints of one frame on the card against the CPU within 1e-4 px;
   then ``tests/test_undistort.py``'s own radtan profile on the same
   intrinsics and frames, held to the same two ATE bars;
6. one keyframe-mapping call on the card against the same call on the
   CPU, from the final arena of the mapping slice, and its time
   (``bench_torch.mapping_timing``);
7. an arena-full run (8 keyframes, a keyframe every 2 frames), where
   keyframe culling, forced eviction and slot recycling run, with its
   launch counts, and the card-vs-CPU check on the arena of its first
   keyframe-mapping call that culled a keyframe;
8. the card-vs-CPU check on three aligned keyframes, where point
   creation acts at full rate (on the orbit it creates a few points or
   none; ROADMAP queue 3, item h);
9. K1 over a problem axis (the relocalizer's candidates): 8 noisy
   problems at E=1024 in one launch, and an all-invalid problem beside
   an exact one at E=1, against the plain version and bit for bit
   against one launch per problem;
10. relocalization after a blackout: the mapping slice's configuration
    over frames 0-29, 3 black frames (LOST), then frames 30-41, the
    first of which must relocalize; K1 launches per attempt counted;
11. map reuse: the mapping slice's final map saved, loaded into a fresh
    ``System`` in localization-only mode and tracked over frames 0-41
    (frame 0 relocalizes, no keyframe is inserted), host syncs counted
    on a second run; then one relocalizer call on the card against the
    CPU on that map, with the same frame and noise;
12. stereo at the KITTI shape of ``bench.py::stereo_kitti_shape``
    (1226x370, 2000 features, 8 levels, baseline 0.12 m, default arena,
    mapping on) over the first 30 of its 150 pairs (all 150 rendered in
    a process pool), loop closing off; launch counts, ATE, ms/frame, peak
    memory, host syncs on a second run, the stereo matching of one pair
    on the card against the CPU, and K2 against its plain version on
    all 8 levels of that pair's left image;
12b. stereo with loop closing: the same configuration with loop closing
    on over all 150 pairs, one run: every pair OK, rigid ATE <= 0.20 m,
    peak memory, K1 twice a tracked pair (and per relocalization
    attempt), K2 twice a pair, host syncs outside the loop closer's
    waits counted from pair 6 to pair 119, pairs 120-149 timed, the
    loop closer's verifications and corrections reported;
13. the full pipeline with loop closing: ``System(cfg_map,
    use_loop_closing=True).track_rgbd`` (``bench.py::full_pipeline_window``'s
    configuration) over the 150 VGA frames of the loop circle
    (``loop_trajectory(150, radius=2.5)``, no boxes; rendered in a
    process pool) and frames 0-39 again: every frame tracks, the
    vocabulary is trained, at least one loop closes (the revisit; the
    chi2 gate accepts the correction), ATE, peak memory, launch counts
    (K1 twice a frame, K2 once), ms/frame; host syncs counted on a
    second run outside the three waits the loop closer makes (vocabulary
    training, a verification's verdict, a correction's gate); per-stage
    loop times on a third run;
14. a constructed closure at the same width: arcs 0-54 and 95-149 +
    0-19 tracked by two ``System``s on the card, arc B's map moved by a
    known drift and merged into arc A's, the loop closer over the last 8
    arc-B keyframes: the loop closes within ``tests/test_loop_closing.py``'s
    bars, the loop closer launches neither kernel, its verifications,
    correction and a GBA slice are timed; then the card against the CPU
    on that arena: ``compute_sim3`` with the same noise, ``correct`` with
    the same Sim3 and one ``gba_slice``; that correction recorded on each
    device (``dump_correction``) and replayed by
    ``scripts/dissect_torch_closure.py``'s ``dissect`` at the gate's 16 CG
    steps: the CPU's replay equals its gate's chi2 before and after bit for
    bit, the card's its gate's chi2 before bit for bit and after within
    1e-3 relative (the card's global BA sums by atomics), each with its
    gate's verdict; card and CPU stages within 1e-3 relative, the replay's
    ms on the card logged;
14b. the long-run retrain: ``scripts/run_torch_endurance.py``'s tour
    (320x240, 1024 features, default arena, loop closing on; its 1,000
    unique poses rendered in its process pool) until 8 keyframe events
    after the vocabulary's retrain at 48 live keyframes (10,000 words,
    sparse BoW rows), one run with host syncs counted after frame 6
    outside the loop closer's waits: the retrain happened and rebuilt
    every live keyframe's sparse row, every later scoring took the
    sparse path, every frame OK, K1 twice a tracked frame (and per
    relocalization attempt), K2 once a frame, peak memory, the retrain
    stall; then the card against the CPU on the final arena with the
    retrained vocabulary: sparse word ids equal, weights within 1e-6, L1
    scores within 1e-5, DetectLoop's candidates and decision equal;
15. monocular SLAM at full width: ``System(SlamConfig(sensor="mono"),
    use_loop_closing=True).track_mono`` (VGA, 1024 features, 8 levels,
    default arena) over 60 VGA frames of ``tests/test_e2e_mono.py``'s
    orbit (``orbit_trajectory(60, radius=2.0, step_deg=2.0)`` on
    ``default_world()``, rendered in a process pool): it initializes and
    tracks every later frame, at least 2 keyframes and more than 100
    points, Sim3 ATE <= 0.05 m, K2 once a frame and K1 twice a tracked
    frame (and per relocalization attempt), peak memory, ms/frame and
    the initialization attempt's ms; host syncs counted on a second run
    apart from the initialization attempts and the one retirement wait a
    mono frame makes; the initializer and the initial map on the card
    against the CPU from the same inputs and noise;
16. active exploration: ``examples/run_exploration.py``'s configuration
    (320x240, 512 features, loop closing on, a 32x32 grid over
    ``default_world(n_boxes=4)``) for its 15 steps through
    ``active.explorer.run_exploration``: ``tests/test_active.py``'s
    bars, peak memory, K2 once a fed frame and K1 twice a track step
    and per relocalization attempt, the run's waits counted by kind and
    no other host sync, each stage's time, tracking ms/frame without
    the render, ATE against the rendered poses; one planning step of
    the final map on the card against the CPU; the grid and the scorer
    timed on the mapping slice's arena (512 keyframes, 65,536 slots);
17. the sharded global BA at KITTI-00 scale (``bench.py::ba_roofline``:
    512 keyframes, 65,536 points, 8 observations each, from
    ``scripts/bench_torch_ba_scaling.py::build_problem``, anchor-block
    ordered; 3 LM iterations of 48 CG steps): (a) ``global_ba`` by PCG
    and by the dense solve, ms per LM iteration and peak memory, each
    more than halving the pose error; (b) ``build_distributed_ba`` over
    an in-process NCCL world of one rank, bit for bit (a)'s PCG (both in
    deterministic mode), timed; (c) two spawned gloo ranks sharing the
    card (NCCL refuses two ranks on one device) against (a): poses,
    points, chi2, ms per LM iteration, collectives and bytes reduced per
    LM iteration; (d) the sharded matcher on those ranks (M = 65,536, N =
    4,096) against ``match_mutual`` on the card; neither kernel runs;
17b. ``bench_torch.ba_op_floor_evidence`` once (a chained [3072]
    matvec, a [3072, 3072] float32 matmul chain, ``global_ba``'s marginal
    ms and ops per CG step), before the profiler of phase 18 runs;
18. timing: each kernel's device time and its plain version's, last, so
    that the profiler's overhead cannot reach the runs before; K1 also at
    E=128 (the fixed cost of its 44 passes), at E=2000 and over 8
    problems of E=1024 in one launch, K2 also on one KITTI-shape image.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launch counts in the tracking slice, the mapping slice, the distorted
camera's run, the arena-full run, the relocalization run, the map-reuse
run, the stereo run, the stereo run with loop closing, the full
pipeline with loop closing, the constructed closure, the retrain run,
the mono run and the exploration run (``launches``,
``mapping_launches``, ``distorted_launches``, ``full_launches``,
``reloc_launches``, ``reuse_launches``, ``stereo_launches``,
``stereo_loop_launches``, ``loop_launches``, ``closure_launches``,
``retrain_launches``, ``mono_launches``, ``explore_launches``), its
device time (``ms``) beside its plain version's (``plain_ms``), its
bound (``bound_ms``: the larger of its FLOP over the float32 peak and
its bytes over the memory rate, from this run's inputs; ``bound_by``),
``library_ms`` (null: no single PyTorch call computes either function)
and the extra timings with their bounds (K1 ``ms_p8`` /
``bound_ms_p8``, K2 ``ms_kitti`` / ``bound_ms_kitti``); the last line
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

import bench_torch
from bench_torch import render_pairs, stereo_config

ATE_BOUND_M = 0.010          # slice ATE against ground truth
K1_POSE_ATOL = 1e-3          # kernel vs plain, every pose component
K1_INLIER_AGREE = 0.99
K2_ANGLE_ATOL = 1e-4         # rad
K2_BIT_AGREE = 0.999
N_FRAMES = 42
WARMUP = 6
MAP_MIN_KEYFRAMES = 5        # mapping slice: keyframes inserted
MAP_MIN_INLIERS = 200        # mapping slice: fewest local-stage inliers
CARD_CPU_KF_POINT_AGREE = 0.999
CARD_CPU_POSE_ATOL = 1e-4
CARD_CPU_POINT_ATOL_M = 1e-3
# on the arena-full run's arenas a CPU call against itself, with the
# keyframe poses moved by 1e-7 relative, moves single poorly constrained
# points (depth far beyond their stereo baseline) by up to 1.4e-2 m, so
# that check holds every point to this and the discrete results exactly
CULL_EVENT_POINT_ATOL_M = 0.05
# phase 5b, the distorted camera: TUM fr1's calibration and radtan
# coefficients (tests/test_undistort.py:20-23), that test's two bars
# (the rigid ATE, and the unmodelled run's ATE over twice it) and the
# card against the CPU on the undistorted keypoints.  TUM fr1's
# coefficients bend the frames less than the test's own profile (the
# unmodelled run read 2.61 times the modelled one on an H100 at VGA,
# 1.15-1.85 on the CPU at 320x240), so the bars are also held on the
# test's profile, on the same intrinsics and frames
TUM_FR1_CAM = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0,
                   width=640, height=480)
TUM_FR1_DIST = (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)
E2E_TEST_DIST = (0.25, -0.3, 0.0, 0.0, 0.0)   # tests/test_undistort.py:132
DISTORTED_ATE_BOUND_M = 0.06
DISTORTED_UNMODELLED_GAIN = 2.0
DISTORTED_UV_ATOL = 1e-4     # px
FULL_MIN_CULLS = 5           # arena-full run: keyframes culled
CREATE_MIN_POINTS = 256      # aligned keyframes: points created (cap 512)
K1_BATCH = 8                 # relocalization candidates, one K1 launch
N_MAPPED = 30                # blackout run: frames tracked before it
N_BLACK = 3
RELOC_MIN_INLIERS = 50       # the reference's acceptance
RELOC_CARD_CPU_INLIERS = 2   # relocalizer, card vs CPU: |n_inliers| diff
RELOC_CARD_CPU_ASSOC_AGREE = 0.99
RELOC_CARD_CPU_POSE_ATOL = 1e-3
RELOC_CARD_CPU_SEEDS = tuple(range(1, 9))
N_STEREO = 30                # KITTI-shape pairs of phase 12 (of 150)
N_STEREO_LOOP = bench_torch.N_STEREO  # bench.py::stereo_kitti_shape's circuit
N_STEREO_TIMED = 30          # its last pairs, timed
# the circuit with loop closing: twice the JAX package's 0.183 m on it
# (BENCH_r05.json, which closes no loop there)
STEREO_LOOP_ATE_BOUND_M = 0.20
# twice the JAX package's ATE on these 30 pairs on the CPU, 0.00990 m
# (tests/test_torch_stereo.py::test_stereo_kitti_shape_ate_beside_jax)
STEREO_ATE_BOUND_M = 0.020
STEREO_OK_AGREE = 0.999      # stereo matching, card vs CPU
STEREO_UR_ATOL = 1e-3        # px
N_LOOP = 150                 # frames of bench.py's loop circle
N_REVISIT = 20               # closure arc B: frames 0-19 after 95-149
# phase 13: frames 0-39 tracked again after the circle, the shortest
# revisit of 20, 40 and 60 frames on which the port closes the loop on
# the card (ROADMAP queue 3, item q)
N_LOOP_REVISIT = 40
LOOP_ATE_BOUND_M = 0.15      # tests/test_e2e_full_pipeline.py's bound
LOOP_PEAK_BYTES = 2 ** 30
# tests/test_loop_closing.py: arcs, the drift of arc B's world (twist),
# the closure's bars (error after < 0.15 x before, and < 0.5)
ARC_A, ARC_B = (0, 55), (95, N_LOOP)
DRIFT_TWIST = [0.0, 0.06, 0.0, 0.25, 0.1, -0.15]
CLOSURE_GAIN, CLOSURE_MAX_ERR = 0.15, 0.5
CLOSURE_EVENTS = 8
LC_CARD_CPU_MATCHES = 2      # compute_sim3: |guided matches| difference
LC_CARD_CPU_SIM3_ATOL = 1e-3
LC_CARD_CPU_POSE_ATOL = 1e-3
LC_CARD_CPU_POINT_ATOL_M = 0.05
REPLAY_CARD_CPU_RTOL = 1e-3  # replayed chi2s: card vs CPU, card vs its gate
N_MONO = 60                  # frames of tests/test_e2e_mono.py's orbit at VGA
MONO_ATE_BOUND_M = 0.05      # tests/test_e2e_mono.py's bound (Sim3)
MONO_MIN_POINTS = 100
MONO_PEAK_BYTES = 2 ** 30
INIT_CARD_CPU_ROT_RAD = 1e-3   # initializer, card vs CPU
INIT_CARD_CPU_DIR = 1e-3       # translation direction (unit vectors)
INIT_CARD_CPU_POINT_OK = 0.99
INIT_MAP_CARD_CPU_ATOL = 1e-3  # initial map: points and pose, after gauge
EXPLORE_STEPS = 15           # examples/run_exploration.py's default
EXPLORE_MIN_POSITIONS = 3    # tests/test_active.py::test_exploration_loop
EXPLORE_PEAK_BYTES = 2 ** 30
EXPLORE_GRID_AGREE = 0.995   # card vs CPU, as tests/test_torch_active.py
EXPLORE_SCORE_AGREE = 0.99
EXPLORE_SCORE_ATOL = 2
# the long-run retrain: scripts/run_torch_endurance.py's tour (320x240,
# 1024 features, default arena, 1,000 unique poses), run until 8 keyframe
# events after the vocabulary's 48-keyframe retrain (10,000 words), at
# most RETRAIN_MAX_FRAMES frames (the retrain came at frame 810 on the
# CPU and at 736 on an H100: the card's sums move keyframe decisions)
RETRAIN_EVENTS_AFTER = 8
RETRAIN_MAX_FRAMES = 1400
RETRAIN_WORDS = 10_000
RETRAIN_SCORE_ATOL = 1e-5
# a row's tf-idf weights, normalized over its features: the card sums
# them in another order than the CPU (measured 1.79e-7 on the scores)
RETRAIN_WEIGHT_ATOL = 1e-6
# phase 17, the sharded global BA: bench.py::ba_roofline's KITTI-00 scale
# (:258-262), 3 LM iterations of 48 CG steps; two ranks share the card
SHARDED = dict(K=512, P=65_536, O=8, iters=3, cg=48, ranks=2,
               M=65_536, N=4_096)    # matcher: the default arena's points
SHARDED_POSE_ATOL = 5e-4
SHARDED_POINT_ATOL_M = 5e-3
SHARDED_CHI2_RTOL = 1e-4
SHARDED_ERR_SHRINK = 0.5     # pose error after / before, at most
# FLOP counted from active/occupancy.py: a ray sample's x and z (4), its
# cell (2 subtractions, 2 divisions, 2 floors), the in-grid test (4
# compares, 3 ands), the clamps and the flat index (6), its weight and
# its add (2); an endpoint the same without its coordinates, and the
# ray's two differences
GRID_FLOP_SAMPLE = 25
GRID_FLOP_END = 23
# FLOP per (pose, point) counted from geometry/projection.py::in_frustum:
# se3_apply (two cross products, the quaternion terms, the translation:
# 36), the projection (10), the viewing vector, its length and cosine
# (16), the tests and their ands (18), the valid mask and the sum (2)
SCORE_FLOP_PAIR = 82
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): float32 outside the
# tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# K1 FLOP per edge, counted from csrc/pose_opt.cu: a Gauss-Newton pass
# rotates and projects (47), forms chi2, the gate and the Huber weight
# (15) and d r / d pc (12), and adds the normal-equation terms in the
# form H_tt = M, H_rt = P M, H_rr = -P M P, b (M 18, P M 23, H_rr 18,
# 20 H sums, b 27); an acceptance pass projects and forms chi2 (56).
# The serial 6x6 solve and retract of each pass (~400) count once.
K1_FLOP_GN_EDGE = 180
K1_FLOP_CHI2_EDGE = 56
K1_FLOP_SOLVE = 400
K1_BYTES_EDGE = 12 + 12 + 4 + 1 + 1 + 1     # pw, obs, level, flags; mask
# K2 FLOP per keypoint, counted from csrc/keypoints.cu: moments over the
# 717-pixel disc (4 each), the 31x37 vertical and 31x31 horizontal 7-tap
# blurs (14 each), 256 compares
K2_FLOP_KEYPOINT = 717 * 4 + (31 * 37 + 31 * 31) * 14 + 256


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=50):
    """Median span (ms) between two CUDA events around one call of
    ``fn``, over ``reps`` calls after a warm-up call.  For small kernels
    the span is set by the host's enqueue, not by the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_ms(fn, reps=20, hold_cycles=50_000_000):
    """Device time (ms) per call of ``fn``, whose launches are few and
    short: a spin kernel holds the device while the host queues ``reps``
    calls between two CUDA events, so the span between the events holds
    no host time.  Raises if the device reached the first event before
    the host had queued every call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    held = not a.query()
    b.synchronize()
    if not held:
        raise RuntimeError("the spin kernel ended before the launches "
                           "were queued; the timing would hold host time")
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=10):
    """Device time (ms) per call of ``fn``, whose launches are too many
    to queue behind a spin kernel: the intervals of the CUDA kernels and
    copies it launches, summed from ``torch.profiler`` over ``reps``
    calls after a warm-up call.  The profiler can miss some short
    launches, so this may read low."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        raise RuntimeError("the profiler recorded no device time")
    return sum(e.time_range.end - e.time_range.start for e in ev) / 1e3 / reps


def vga_config(kind="tracking"):
    """VGA, 1024 features, 8 levels.  ``tracking``: ``bench.py``'s
    tracking window; ``mapping``: its full-pipeline window without loop
    closing (default arena); ``full``: an 8-keyframe arena with a
    keyframe at least every 2 frames."""
    from active_orb_slam2_tpu_torch.config import MapConfig, TrackingConfig
    if kind == "tracking":
        return bench_torch.tracking_config()
    if kind == "mapping":
        return bench_torch.full_pipeline_config()
    return dataclasses.replace(
        bench_torch.tracking_config(),
        tracking=TrackingConfig(th_depth=8.0, kf_max_interval=2),
        map=MapConfig(max_keyframes=8, max_points=16384,
                      local_ba_keyframes=8, local_ba_points=2048))


def render_frames():
    """``make_sequence``'s 42 noise-free frames of the 0.8-degree VGA
    orbit, rendered in a pool of fresh processes, and the true centres."""
    return bench_torch.render_orbit(N_FRAMES)


def k1_problem(rng, cam, E, device, kind="noisy"):
    """One seeded motion-only BA problem: pw [E, 3], obs [E, 3] with
    noise and 10% gross outliers, mixed mono/stereo, levels 0-7.
    ``exact``: noise-free observations and the true pose as the start
    (for E=1, whose 3 residuals leave 6 unknowns underdetermined, so
    that from a noisy start the damped steps amplify float rounding:
    two correct implementations, the JAX package and the plain version,
    differ there by up to 1e-3 on the CPU)."""
    import torch
    from active_orb_slam2_tpu_torch.geometry.se3 import quat_to_mat
    pw = rng.uniform([-2.0, -1.5, 2.0], [2.0, 1.5, 8.0], (E, 3))
    ang = rng.normal(0.0, 0.05, 3)
    th = np.linalg.norm(ang)
    q_true = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * ang / th])
    t_true = rng.normal(0.0, 0.1, 3)
    R = quat_to_mat(torch.from_numpy(q_true)).numpy()
    pc = pw @ R.T + t_true
    if kind == "behind":
        pc[: E // 3, 2] *= -1.0             # a third of the points behind
        pw = (pc - t_true) @ R
    z = pc[:, 2]
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    obs = np.stack([u, v, u - cam.bf / z], -1)
    exact = kind == "exact"
    if not exact:
        obs += rng.normal(0, 0.5, (E, 3))
        out = rng.random(E) < 0.1
        obs[out] += rng.uniform(20, 80, (int(out.sum()), 3))
    level = rng.integers(0, 8, E)
    stereo = rng.random(E) < 0.5
    valid = np.zeros(E, bool) if kind == "invalid" else \
        (rng.random(E) < 0.95) | exact
    pose0 = np.concatenate([q_true, t_true if exact
                            else t_true + rng.normal(0, 0.03, 3)])

    def t(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device)
    return (t(pose0, torch.float32), t(pw, torch.float32),
            t(obs, torch.float32), t(level, torch.int32),
            t(stereo, torch.bool), t(valid, torch.bool))


def k1_bound(args, rounds=4, iters=10):
    """(bound ms, what sets it) of one K1 call on ``args`` (one problem
    or a leading axis of P): its FLOP on the valid edges over the float32
    peak against its bytes (each input read once, each output written
    once) over the memory rate."""
    P, E = args[0].numel() // 7, args[1].shape[-2]
    n_valid = int(args[5].sum())
    flops = n_valid * (rounds * iters * K1_FLOP_GN_EDGE
                       + rounds * K1_FLOP_CHI2_EDGE) \
        + P * rounds * (iters + 1) * K1_FLOP_SOLVE
    nbytes = P * (E * K1_BYTES_EDGE + 4 * (7 + 32 + 8 + 1))
    return bound(flops, nbytes)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_k1(device, cam):
    import torch
    from active_orb_slam2_tpu_torch.kernels.pose_opt import pose_opt_cuda
    from active_orb_slam2_tpu_torch.ops.pose_opt_kernel import (
        pose_optimization_fused, pose_optimization_fused_torch,
        w_info_table)
    rng = np.random.default_rng(1)
    cases = [("noisy", 1024)] * 20 + [("exact", 1), ("noisy", 128),
                                      ("noisy", 300), ("noisy", 2000),
                                      ("invalid", 1024), ("behind", 1024)]
    worst_pose, worst_agree = 0.0, 1.0
    for i, (kind, E) in enumerate(cases):
        args = k1_problem(rng, cam, E, device, kind)
        res_k = pose_optimization_fused(cam, *args)
        rerun = pose_optimization_fused(cam, *args)
        res_p = pose_optimization_fused_torch(cam, *args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(res_k, rerun))
        err = float((res_k.pose - res_p.pose).abs().max())
        agree = float((res_k.inliers == res_p.inliers).float().mean())
        log(f"  K1 problem {i:2d} {kind:7s} E={E:4d}: pose err {err:.3e} "
            f"inlier agreement {agree:.4f} inliers {int(res_k.n_inliers)}"
            f"/{int(res_p.n_inliers)} chi2 {float(res_k.chi2):.3f}"
            f"/{float(res_p.chi2):.3f} rerun identical {same}")
        if not torch.isfinite(res_k.pose).all():
            raise RuntimeError(f"K1 problem {i} ({kind}): non-finite pose")
        if not same:
            raise RuntimeError(f"K1 problem {i} ({kind}): a rerun on the "
                               f"same inputs gave other bits")
        if res_k.inliers.dtype != torch.bool \
                or res_k.n_inliers.dtype != torch.int32 \
                or int(res_k.n_inliers) != int(res_k.inliers.sum()):
            raise RuntimeError(f"K1 problem {i} ({kind}): malformed result")
        worst_pose = max(worst_pose, err)
        worst_agree = min(worst_agree, agree)
    if worst_pose > K1_POSE_ATOL or worst_agree < K1_INLIER_AGREE:
        raise RuntimeError(f"K1 disagrees with its plain version: pose err "
                           f"{worst_pose:.3e}, inlier agreement {worst_agree}")
    log(f"K1 ok: max pose err {worst_pose:.3e}, min inlier agreement "
        f"{worst_agree:.4f}, every rerun bit-identical")
    trng = np.random.default_rng(2)
    args = k1_problem(trng, cam, 1024, device)
    table = w_info_table(device)

    def raw(a):
        return lambda: pose_opt_cuda(cam, *a, table, 4, 10)
    # E=128: the fixed cost of the 44 passes
    variants = {"ms_e128": raw(k1_problem(trng, cam, 128, device)),
                "ms_e2000": raw(k1_problem(trng, cam, 2000, device))}
    bound_ms, bound_by = k1_bound(args)
    return {"max_abs_err": worst_pose, "what": "E=1024",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel": raw(args), "variants": variants, "extra": {},
            "call": lambda: pose_optimization_fused(cam, *args),
            "plain": lambda: pose_optimization_fused_torch(cam, *args)}


def phase_k1_batched(device, cam):
    """K1 over a leading axis of problems, as the relocalizer calls it:
    against the plain version, against one launch per problem (bit for
    bit: each block runs the single problem's code) and against a rerun.
    Returns the P=8 timing and its bound for the timing phase."""
    import torch
    from active_orb_slam2_tpu_torch.kernels.pose_opt import pose_opt_cuda
    from active_orb_slam2_tpu_torch.ops.pose_opt_kernel import (
        pose_optimization_fused, pose_optimization_fused_torch,
        w_info_table)
    rng = np.random.default_rng(5)
    batches = {
        f"P={K1_BATCH} noisy E=1024": [k1_problem(rng, cam, 1024, device)
                                       for _ in range(K1_BATCH)],
        "P=2 all-invalid + exact E=1": [
            k1_problem(rng, cam, 1, device, "invalid"),
            k1_problem(rng, cam, 1, device, "exact")],
    }
    for what, problems in batches.items():
        args = [torch.stack(a) for a in zip(*problems)]
        res_k = pose_optimization_fused(cam, *args)
        rerun = pose_optimization_fused(cam, *args)
        singles = [pose_optimization_fused(cam, *p) for p in problems]
        res_p = pose_optimization_fused_torch(cam, *args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(res_k, rerun))
        as_single = all(torch.equal(f[i], g)
                        for i, one in enumerate(singles)
                        for f, g in zip(res_k, one))
        err = float((res_k.pose - res_p.pose).abs().max())
        agree = float((res_k.inliers == res_p.inliers).float().mean())
        log(f"  K1 batch {what}: pose err {err:.3e} inlier agreement "
            f"{agree:.4f} inliers {res_k.n_inliers.tolist()}/"
            f"{res_p.n_inliers.tolist()}, rerun identical {same}, "
            f"bit-identical to single launches {as_single}")
        if not torch.isfinite(res_k.pose).all() or not same or not as_single \
                or res_k.n_inliers.tolist() != res_k.inliers.sum(1).tolist():
            raise RuntimeError(f"K1 batch {what}: non-finite, not "
                               f"reproducible or unlike single launches")
        if err > K1_POSE_ATOL or agree < K1_INLIER_AGREE:
            raise RuntimeError(f"K1 batch {what} disagrees with its plain "
                               f"version: pose err {err:.3e}, inlier "
                               f"agreement {agree}")
    args = [torch.stack(a) for a in zip(*batches[f"P={K1_BATCH} noisy "
                                                 f"E=1024"])]
    table = w_info_table(device)
    bound_ms, _ = k1_bound(args)
    log(f"K1 batched ok; bound at P={K1_BATCH}, E=1024: {bound_ms:.6f} ms")
    return (lambda: pose_opt_cuda(cam, *args, table, 4, 10)), bound_ms


def detect_frame(device, cfg, gray):
    """The level images of ``gray`` and their detected keypoints, as the
    extractor makes them: (levels, ys, xs, counts)."""
    import torch
    from active_orb_slam2_tpu_torch.ops import orb
    from active_orb_slam2_tpu_torch.ops.fast import fast_score_map, nms3x3
    from active_orb_slam2_tpu_torch.ops.image import resize_bilinear
    ocfg = cfg.orb
    img = torch.tensor(gray, dtype=torch.float32, device=device)
    levels, ys, xs = [], [], []
    counts = orb.features_per_level(ocfg)
    for (h, w), n in zip(orb.level_sizes(*gray.shape, ocfg), counts):
        li = resize_bilinear(img, h, w)
        score = orb.threshold_fallback(nms3x3(fast_score_map(li)), ocfg)
        y, x, _ = orb.detect_level(score, n, ocfg)
        levels.append(li)
        ys.append(y)
        xs.append(x)
    return levels, torch.cat(ys), torch.cat(xs), counts


def border_keypoints(levels, device, seed=3, empty=3):
    """Keypoints within 18 px of every border of each level (both ends of
    each axis, and the corners), with level ``empty`` left without any:
    (ys, xs, counts)."""
    import torch
    rng = np.random.default_rng(seed)
    ys, xs, counts = [], [], []
    for lvl, img in enumerate(levels):
        if lvl == empty:
            counts.append(0)
            continue
        h, w = img.shape
        near = [np.concatenate([rng.integers(0, 18, 8),
                                rng.integers(n - 18, n, 8)]) for n in (h, w)]
        y = np.concatenate([near[0], rng.integers(0, h, 16), [0, 0, h - 1,
                                                              h - 1]])
        x = np.concatenate([rng.integers(0, w, 16), near[1], [0, w - 1, 0,
                                                              w - 1]])
        ys.append(y)
        xs.append(x)
        counts.append(len(y))

    def t(a):
        return torch.tensor(np.concatenate(a), dtype=torch.int32,
                            device=device)
    return t(ys), t(xs), counts


def k2_bound(levels, ys, xs, counts, pad):
    """(bound ms, what sets it) of one K2 launch: its FLOP over the
    float32 peak against its bytes over the memory rate, counting the
    level pixels that the patches cover (each read once), the keypoints,
    the tap table and the outputs."""
    import torch
    from active_orb_slam2_tpu_torch.ops.patches import patch_index
    pixels, start = 0, 0
    for img, n in zip(levels, counts):
        h, w = img.shape
        rows = patch_index(ys[start:start + n], h, pad)
        cols = patch_index(xs[start:start + n], w, pad)
        flat = rows[:, :, None] * w + cols[:, None, :]
        pixels += int(torch.unique(flat).numel())
        start += n
    K = ys.shape[0]
    nbytes = 4 * pixels + 8 * K + 4 * (30 * 512 + 7) + 4 * K + 32 * K
    return bound(K * K2_FLOP_KEYPOINT, nbytes)


def k2_compare(what, levels, ys, xs, counts, pad, taps, gauss):
    """K2 against its plain version on one set of keypoints; returns (max
    angle error, equal bits, all bits)."""
    import torch
    from active_orb_slam2_tpu_torch.kernels.keypoints import (
        keypoint_stage_cuda)
    from active_orb_slam2_tpu_torch.ops import orb
    ang_k, desc_k = keypoint_stage_cuda(levels, ys, xs, counts, pad, taps,
                                        gauss)
    ang_p, desc_p = orb.keypoint_stage_torch(levels, ys, xs, counts, pad)
    torch.cuda.synchronize()
    d = torch.remainder(ang_k - ang_p + np.pi, 2 * np.pi) - np.pi
    err = float(d.abs().max())
    diff = desc_k.cpu().numpy().view(np.uint32) \
        ^ desc_p.cpu().numpy().view(np.uint32)
    nbad = int(np.unpackbits(diff.view(np.uint8)).sum())
    log(f"  K2 {what}: K={ys.shape[0]} over levels {list(counts)}, angle err "
        f"{err:.3e}, differing bits {nbad}/{diff.size * 32}")
    return err, diff.size * 32 - nbad, diff.size * 32


def phase_k2(device, cfg, gray):
    from active_orb_slam2_tpu_torch.kernels.keypoints import (
        keypoint_stage_cuda)
    from active_orb_slam2_tpu_torch.ops import orb
    pad = cfg.orb.pad
    _, _, taps, gauss = orb.device_constants(device)
    levels, ys, xs, counts = detect_frame(device, cfg, gray)
    by, bx, bcounts = border_keypoints(levels, device)
    worst_ang, bits_eq, bits_all = 0.0, 0, 0
    for what, args in (("VGA frame", (ys, xs, counts)),
                       ("border keypoints", (by, bx, bcounts))):
        err, eq, n = k2_compare(what, levels, *args, pad, taps, gauss)
        worst_ang = max(worst_ang, err)
        bits_eq += eq
        bits_all += n
    agree = bits_eq / bits_all
    if worst_ang > K2_ANGLE_ATOL or agree < K2_BIT_AGREE:
        raise RuntimeError(f"K2 disagrees with its plain version: angle err "
                           f"{worst_ang:.3e}, bit agreement {agree:.6f}")
    log(f"K2 ok: max angle err {worst_ang:.3e}, bit agreement {agree:.6f}")

    def kernel():
        return keypoint_stage_cuda(levels, ys, xs, counts, pad, taps, gauss)
    bound_ms, bound_by = k2_bound(levels, ys, xs, counts, pad)
    return {"max_abs_err": worst_ang,
            "what": "all 8 levels of one VGA frame, one launch",
            "bound_ms": bound_ms, "bound_by": bound_by, "variants": {},
            "extra": {}, "kernel": kernel, "call": kernel,
            "plain": lambda: orb.keypoint_stage_torch(levels, ys, xs, counts,
                                                      pad)}


def phase_timing(checks):
    """Each kernel's device time beside its plain version's and its
    bound, and the span of one call of each.  The plain versions' device
    times come last: ``torch.profiler`` leaves per-launch overhead
    behind it."""
    for name, c in checks.items():
        c["ms"] = kernel_ms(c["kernel"])
        c["variant_ms"] = {k: kernel_ms(fn) for k, fn in c["variants"].items()}
        c["spans"] = (time_ms(c["call"]), time_ms(c["plain"]))
    for name, c in checks.items():
        c["plain_ms"] = device_ms(c["plain"])
        log(f"{name} ({c['what']}): device time {c['ms']:.4f} ms kernel "
            f"(bound {c['bound_ms']:.6f} ms by {c['bound_by']}), "
            f"{c['plain_ms']:.4f} ms plain; call span "
            f"(median of 50) {c['spans'][0]:.4f} ms kernel call, "
            f"{c['spans'][1]:.4f} ms plain")
        for k, ms in c["variant_ms"].items():
            log(f"{name} {k}: {ms:.4f} ms device time")
        for k, ms in c["extra"].items():
            log(f"{name} {k}: {ms:.6f} ms")
    return {name: {"max_abs_err": c["max_abs_err"], "ms": c["ms"],
                   "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                   "bound_by": c["bound_by"], "library_ms": None,
                   **c["variant_ms"], **c["extra"]}
            for name, c in checks.items()}


LAUNCH_COUNTERS = {"pose_opt": "k1.launches", "keypoints": "k2.launches"}
_launch_base = {}


def kernel_launches():
    """K1's and K2's launches (the tracer's counters) since the last
    ``reset_launches``."""
    from active_orb_slam2_tpu_torch.utils import trace
    now = trace.counters()
    return {k: now.get(c, 0) - _launch_base.get(c, 0)
            for k, c in LAUNCH_COUNTERS.items()}


def reset_launches():
    from active_orb_slam2_tpu_torch.utils import trace
    _launch_base.update(trace.counters())


def count_host_syncs(slam, frames, track="track_rgbd"):
    """Synchronizing CUDA calls made by a second run of a slice (on the
    fresh ``System`` ``slam``) after its warm-up frames, and the first
    few places that made them.  The sync debug mode slows every
    operation, so it stays out of the timed run."""
    n, where, _ = track_counting_syncs(slam, frames, track, 1 / 30.0)
    slam.flush()
    return n, where


def phase_slice(device, cfg, frames, gt):
    """The tracking slice, timed by ``bench_torch.tracking_window``."""
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models.system import OK, System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment

    reset_launches()
    ms_frame, window_ms, slam = bench_torch.tracking_window(frames, cfg,
                                                            device)
    launches = kernel_launches()
    n_sync_warnings, _ = count_host_syncs(
        System(cfg, use_mapping=False, device=device), frames)

    states = [m["state"] for m in slam.metrics]
    final_state = slam.state
    ts, poses = slam.frame_trajectory()
    if poses.shape != (N_FRAMES, 7) or not np.isfinite(poses).all():
        raise RuntimeError(f"trajectory malformed: {poses.shape}")
    est = camera_centers(poses)
    ate = umeyama_alignment(est, gt, fix_scale=True)[4]
    inliers = [m["n_inliers"] for m in slam.metrics]
    log(f"slice: {len(slam.metrics)} tracked frames, states {set(states)}, "
        f"final state {final_state}, keyframes {slam.kf_seq}")
    log(f"slice: inliers first {inliers[0]} min {min(inliers)} "
        f"final {inliers[-1]}")
    log(f"slice: {ms_frame:.3f} ms/frame over frames {WARMUP}-{N_FRAMES - 1} "
        f"(host clock, with the final drain; windows "
        f"{', '.join(f'{w:.3f}' for w in window_ms)} ms/frame), ATE "
        f"{ate:.5f} m, sync warnings in steady state {n_sync_warnings}")
    log(f"slice: launches {launches}")
    tracked = N_FRAMES - 1
    if len(states) != tracked or any(s != OK for s in states) \
            or final_state != OK:
        raise RuntimeError("not every tracked frame retired OK")
    if launches["pose_opt"] != 2 * tracked:
        raise RuntimeError(f"K1 launched {launches['pose_opt']} times, "
                           f"expected {2 * tracked}")
    if launches["keypoints"] != N_FRAMES:
        raise RuntimeError(f"K2 launched {launches['keypoints']} times, "
                           f"expected {N_FRAMES}")
    if not ate <= ATE_BOUND_M:
        raise RuntimeError(f"ATE {ate:.5f} m above {ATE_BOUND_M} m")
    return launches


class eager_segments:
    """Inside: the per-frame step's graph segments run eagerly on the
    card too (``utils/graphs.py``'s choice of backend swapped)."""

    def __enter__(self):
        from active_orb_slam2_tpu_torch.utils import graphs
        self._saved = graphs._backend
        graphs._backend = lambda device: None

    def __exit__(self, *exc):
        from active_orb_slam2_tpu_torch.utils import graphs
        graphs._backend = self._saved


def phase_graphs(device, cfg, frames):
    """The tracking slice's frames with the step's CUDA graphs against
    the same segments run eagerly: launches, the trajectory bit for bit,
    the counters and each capture's time."""
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.utils import graphs, trace

    def track():
        slam = System(cfg, use_mapping=False, device=device)
        run_frames(slam, frames)
        return slam.frame_trajectory()[1]

    with eager_segments():
        eager = track()
    backend = graphs._backend(device)
    capture, capture_ms = backend.capture, []

    def timed(fn):
        t0 = time.perf_counter()
        out = capture(fn)
        capture_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    backend.capture = timed
    before = trace.counters()
    reset_launches()
    try:
        graphed = track()
    finally:
        del backend.capture
    launches = kernel_launches()
    now = trace.counters()
    counts = {k[len("graph."):]: now[k] - before.get(k, 0) for k in sorted(now)
              if k.startswith("graph.") and now[k] != before.get(k, 0)}
    log(f"graphs: counters {counts}; {len(capture_ms)} captures, ms "
        f"{', '.join(f'{t:.1f}' for t in capture_ms)} (host clock, each "
        f"with its segment's Python run and the graph's instantiation); "
        f"launches {launches}")
    if launches != {"pose_opt": 2 * (N_FRAMES - 1), "keypoints": N_FRAMES}:
        raise RuntimeError(f"graphs: launches {launches}")
    if not np.array_equal(eager, graphed):
        raise RuntimeError(
            f"graphs: the trajectory parts from the eager run's by "
            f"{np.abs(eager - graphed).max():.3g}")
    if counts.get("replays.T3", 0) < N_FRAMES - 4 \
            or counts.get("replays.F2", 0) < N_FRAMES - 2:
        raise RuntimeError(f"graphs: too few replays: {counts}")


def run_frames(slam, frames, timed=False, track="track_rgbd"):
    """Track every frame (RGB-D, or stereo pairs with ``track``
    ``track_stereo``, or 1-tuples of gray images with ``track_mono``);
    returns (ms/frame over frames WARMUP.. on the
    host clock, synchronized at both ends, or None; keyframe-mapping
    calls made)."""
    import torch
    calls = []
    run = slam.keyframe_mapping

    def counted(m, k, seq):
        calls.append(k)
        return run(m, k, seq)

    slam.keyframe_mapping = counted
    t0 = None
    for i, images in enumerate(frames):
        if timed and i == WARMUP:
            slam.flush()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        getattr(slam, track)(*images, i / 30.0)
    slam.flush()
    torch.cuda.synchronize()
    ms = None if t0 is None else \
        (time.perf_counter() - t0) / (len(frames) - WARMUP) * 1e3
    return ms, calls


def trajectory_ate(slam, gt, keep=None):
    """ATE (rigid, scale 1) of the frame trajectory against ``gt``, over
    the trajectory's rows ``keep`` (every row by default)."""
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    _, poses = slam.frame_trajectory()
    keep = np.arange(len(gt)) if keep is None else np.asarray(keep)
    if poses.shape != (keep[-1] + 1, 7) or not np.isfinite(poses).all():
        raise RuntimeError(f"trajectory malformed: {poses.shape}")
    return umeyama_alignment(camera_centers(poses[keep]), gt,
                             fix_scale=True)[4]


def check_all_ok(slam, what, n_tracked=N_FRAMES - 1):
    from active_orb_slam2_tpu_torch.models.system import OK
    states = [m["state"] for m in slam.metrics]
    if len(states) != n_tracked or any(s != OK for s in states) \
            or slam.state != OK:
        raise RuntimeError(f"{what}: not every tracked frame retired OK")


def phase_mapping_slice(device, frames, gt):
    """``System(cfg_map).track_rgbd`` with local mapping on."""
    import torch
    from active_orb_slam2_tpu_torch.models.system import System
    cfg = vga_config("mapping")
    slam = System(cfg, use_mapping=True, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms_frame, calls = run_frames(slam, frames, timed=True)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    inliers = [m["n_inliers"] for m in slam.metrics]
    ate = trajectory_ate(slam, gt)
    n_sync, where = count_host_syncs(System(cfg, device=device), frames)
    log(f"mapping slice: {len(slam.metrics)} tracked frames, keyframes "
        f"inserted {slam.kf_seq}, live {slam.n_live_kf}, keyframe events "
        f"{len(calls)}, points {int(slam.map.pt_valid.sum())}")
    log(f"mapping slice: inliers first {inliers[0]} min {min(inliers)} "
        f"final {inliers[-1]}, ATE {ate:.5f} m")
    log(f"mapping slice: {ms_frame:.3f} ms/frame over frames "
        f"{WARMUP}-{N_FRAMES - 1} (host clock, synchronized), peak device "
        f"memory {peak / 2**20:.1f} MiB, sync warnings in steady state "
        f"{n_sync} {where}")
    log(f"mapping slice: launches {launches}")
    check_all_ok(slam, "mapping slice")
    tracked = N_FRAMES - 1
    if launches["pose_opt"] != 2 * tracked:
        raise RuntimeError(f"mapping slice: K1 launched "
                           f"{launches['pose_opt']} times, expected "
                           f"{2 * tracked}")
    if launches["keypoints"] != N_FRAMES:
        raise RuntimeError(f"mapping slice: K2 launched "
                           f"{launches['keypoints']} times, expected "
                           f"{N_FRAMES}")
    if slam.kf_seq < MAP_MIN_KEYFRAMES or len(calls) != slam.kf_seq - 1:
        raise RuntimeError(f"mapping slice: {slam.kf_seq} keyframes, "
                           f"{len(calls)} mapping calls")
    if not ate <= ATE_BOUND_M:
        raise RuntimeError(f"mapping slice: ATE {ate:.5f} m above "
                           f"{ATE_BOUND_M} m")
    if min(inliers) < MAP_MIN_INLIERS:
        raise RuntimeError(f"mapping slice: min inliers {min(inliers)}")
    if n_sync:
        raise RuntimeError(f"mapping slice: {n_sync} synchronizing calls "
                           f"in the steady state: {where}")
    return slam, launches


def card_vs_cpu(cfg, base, k, seq, what, point_atol=CARD_CPU_POINT_ATOL_M):
    """One keyframe-mapping call on the card and on the CPU from the same
    arena ``base`` and slot; raises unless the victim, the masks and the
    spanning tree are equal, ``kf_point`` agrees on 99.9% of its cells,
    live poses within 1e-4 and valid points within ``point_atol`` m.
    Returns (points created, victim)."""
    import torch
    from active_orb_slam2_tpu_torch.models.local_mapping import (
        build_keyframe_mapping)
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    step = build_keyframe_mapping(cfg)
    card = MapState(*[t.clone() for t in base])
    t0 = time.perf_counter()
    _, v_card, *_ = step(card, k, seq)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = MapState(*[t.to("cpu", copy=True) for t in base])
    t0 = time.perf_counter()
    _, v_cpu, *_ = step(cpu, k, seq)
    cpu_s = time.perf_counter() - t0
    c = MapState(*[t.cpu() for t in card])
    created = int((cpu.pt_valid & ~base.pt_valid.cpu()).sum())
    kfp_agree = float((c.kf_point == cpu.kf_point).float().mean())
    live, pts = cpu.kf_valid, cpu.pt_valid
    pose_err = float((c.kf_pose - cpu.kf_pose)[live].abs().max())
    d = (c.pt_xyz - cpu.pt_xyz)[pts].abs().max(1).values
    point_err = float(d.max()) if d.numel() else 0.0
    log(f"{what} (slot {k}, {int(live.sum())} live keyframes, "
        f"{int(pts.sum())} points): card vs CPU victim {int(v_card)}/"
        f"{int(v_cpu)}, points created {created}, kf_point agreement "
        f"{kfp_agree:.6f}, pose err {pose_err:.3e}, point err "
        f"{point_err:.3e} m ({int((d > CARD_CPU_POINT_ATOL_M).sum())} "
        f"points beyond {CARD_CPU_POINT_ATOL_M} m); first call "
        f"{card_s * 1e3:.1f} ms on the card, {cpu_s * 1e3:.0f} ms on the CPU")
    same = {f: torch.equal(getattr(c, f), getattr(cpu, f))
            for f in ("pt_valid", "kf_valid", "kf_parent")}
    if int(v_card) != int(v_cpu) or not all(same.values()):
        raise RuntimeError(f"{what}: card and CPU differ: victim "
                           f"{int(v_card)}/{int(v_cpu)}, equal {same}")
    if kfp_agree < CARD_CPU_KF_POINT_AGREE or pose_err > CARD_CPU_POSE_ATOL \
            or point_err > point_atol:
        raise RuntimeError(f"{what}: card and CPU disagree")
    return created, int(v_cpu)


def phase_mapping_step(slam):
    """The card-vs-CPU check on the final arena of the mapping slice, then
    the call's time on the card (``bench_torch.mapping_timing``: median
    of 5 calls, each on a fresh copy of the arena, synchronized)."""
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    base = MapState(*[t.clone() for t in slam.map])
    card_vs_cpu(slam.cfg, base, slam.last_kf_slot, slam.kf_seq,
                "mapping step, final arena")
    ms = bench_torch.mapping_timing(slam)
    log(f"mapping step: {ms:.2f} ms per call on the card (median of 5, "
        f"synchronized)")
    return ms


def tum_fr1_config(dist=TUM_FR1_DIST):
    """The mapping slice's configuration with TUM fr1's intrinsics and
    the radtan coefficients ``dist`` with the undistorted image bounds
    (``compute_image_bounds``, as ``tests/test_undistort.py`` applies
    them); ``dist`` None leaves the distortion unmodelled."""
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch.ops.undistort import compute_image_bounds
    cam = CameraParams(**TUM_FR1_CAM)
    if dist is None:
        return dataclasses.replace(vga_config("mapping"), camera=cam)
    x0, x1, y0, y1 = compute_image_bounds(cam, dist)
    return dataclasses.replace(
        vga_config("mapping"), distortion=dist,
        camera=cam._replace(min_x=x0, max_x=x1, min_y=y0, max_y=y1))


def _render_distorted_frame(i):
    """Frame i of the 42-frame orbit seen by an ideal camera with TUM fr1's
    intrinsics, gray and depth warped as ``tests/test_undistort.py``
    warps them, into TUM fr1's distorted camera and into the test's
    (runs in a worker process)."""
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, orbit_trajectory, render_rgbd)
    from active_orb_slam2_tpu_torch.ops.undistort import distort_warp_image
    cam = CameraParams(**TUM_FR1_CAM)
    Twc = orbit_trajectory(N_FRAMES, step_deg=bench_torch.ORBIT_STEP_DEG)[i]
    g, d = render_rgbd(default_world(), cam, Twc)
    return tuple((np.clip(distort_warp_image(cam, dist, g), 0,
                          255).astype(np.uint8),
                  np.clip(distort_warp_image(cam, dist, d) * 1e3, 0,
                          65535).astype(np.uint16))
                 for dist in (TUM_FR1_DIST, E2E_TEST_DIST))


def render_distorted_frames():
    """The 42 frames in TUM fr1's distorted camera and in the test's,
    rendered and warped in a pool of fresh processes (the true centres
    are the orbit's)."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        both = pool.map(_render_distorted_frame, range(N_FRAMES))
    return [f for f, _ in both], [f for _, f in both]


def phase_distorted(device, frames, test_frames, gt):
    """The mapping slice through TUM fr1's distorted camera: a timed run
    (launch counts, peak memory, ATE), a second run with host syncs
    counted, a run with the distortion left unmodelled, the undistorted
    keypoints of frame 0 on the card against the CPU (the card's
    detections, undistorted on both); then the test's radtan profile
    modelled and unmodelled on ``test_frames``.  Each profile's
    unmodelled run must read more than twice its modelled ATE."""
    import torch
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.ops.orb import build_extractor
    from active_orb_slam2_tpu_torch.ops.undistort import undistort_points

    def ate_of(cfg, frames):
        slam = System(cfg, device=device)
        run_frames(slam, frames)
        return trajectory_ate(slam, gt), \
            sorted(set(m["state"] for m in slam.metrics))

    cfg = tum_fr1_config()
    slam = System(cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms_frame, calls = run_frames(slam, frames, timed=True)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    ate = trajectory_ate(slam, gt)
    n_sync, where = count_host_syncs(System(cfg, device=device), frames)
    tum_off = ate_of(tum_fr1_config(None), frames)
    test_on = ate_of(tum_fr1_config(E2E_TEST_DIST), test_frames)
    test_off = ate_of(tum_fr1_config(None), test_frames)
    cam = cfg.camera
    feats = build_extractor(cfg.orb, cam.height, cam.width)(
        torch.from_numpy(frames[0][0]).to(device).to(torch.float32))
    und = undistort_points(cam, TUM_FR1_DIST, feats.uv).cpu()
    und_cpu = undistort_points(cam, TUM_FR1_DIST, feats.uv.cpu())
    valid = feats.valid.cpu()
    uv_err = float((und - und_cpu)[valid].abs().max())
    log(f"distorted camera (TUM fr1): {len(slam.metrics)} tracked frames, "
        f"keyframes {slam.kf_seq}, keyframe events {len(calls)}, bounds "
        f"{tuple(round(b, 3) for b in cam.bounds())}, rigid ATE {ate:.5f} m;"
        f" unmodelled {tum_off[0]:.5f} m (states {tum_off[1]}); the test's "
        f"profile {E2E_TEST_DIST}: modelled {test_on[0]:.5f} m (states "
        f"{test_on[1]}), unmodelled {test_off[0]:.5f} m (states "
        f"{test_off[1]})")
    log(f"distorted camera: {ms_frame:.3f} ms/frame over frames "
        f"{WARMUP}-{N_FRAMES - 1} (host clock, synchronized), peak device "
        f"memory {peak / 2**20:.1f} MiB, sync warnings in steady state "
        f"{n_sync} {where}, launches {launches}; undistorted keypoints of "
        f"frame 0, card vs CPU: {int(valid.sum())} valid, max |uv| diff "
        f"{uv_err:.3e} px")
    check_all_ok(slam, "distorted camera")
    if launches != {"pose_opt": 2 * (N_FRAMES - 1), "keypoints": N_FRAMES}:
        raise RuntimeError(f"distorted camera: launches {launches}")
    for what, on, off in (("TUM fr1", ate, tum_off[0]),
                          ("the test's profile", test_on[0], test_off[0])):
        if not on <= DISTORTED_ATE_BOUND_M:
            raise RuntimeError(f"distorted camera, {what}: ATE {on:.5f} m "
                               f"above {DISTORTED_ATE_BOUND_M} m")
        if not off > DISTORTED_UNMODELLED_GAIN * on:
            raise RuntimeError(f"distorted camera, {what}: the unmodelled "
                               f"run's ATE {off:.5f} m is not above "
                               f"{DISTORTED_UNMODELLED_GAIN} x {on:.5f} m")
    if n_sync:
        raise RuntimeError(f"distorted camera: {n_sync} synchronizing calls "
                           f"in the steady state: {where}")
    if peak > LOOP_PEAK_BYTES:
        raise RuntimeError(f"distorted camera: peak memory "
                           f"{peak / 2**20:.1f} MiB above 1 GiB")
    if not uv_err <= DISTORTED_UV_ATOL:
        raise RuntimeError(f"distorted camera: undistorted keypoints differ "
                           f"by {uv_err:.3e} px between card and CPU")
    return launches


def aligned_map(cfg, seed):
    """Three keyframes 0.15 m apart in an arena of ``cfg``'s shapes whose
    feature i is the projection of 3D point i in each (descriptors equal
    up to a few flipped bits), so the reference's epipolar gate, which
    reads the line of feature j against feature i of the neighbour,
    holds for the true pairs and point creation acts.  Features 0-23
    already track points (the covisibility); the rest are free."""
    import torch
    from active_orb_slam2_tpu_torch.geometry.se3 import se3_apply, se3_exp
    from active_orb_slam2_tpu_torch.models.map_state import empty_map
    rng = np.random.default_rng(seed)
    cam, F = cfg.camera, cfg.orb.n_features
    m = empty_map(cfg.map, cfg.orb)
    pw = torch.from_numpy(rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0],
                                      (F, 3)).astype(np.float32))
    desc = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32)
    for k in range(3):
        pose = se3_exp(torch.tensor([0, 0.02 * k, 0, 0.15 * k, 0.01 * k, 0]))
        pc = se3_apply(pose, pw)
        uv = torch.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                          cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
        m.kf_pose[k] = pose
        m.kf_uv[k] = uv + torch.from_numpy(
            rng.normal(0.0, 0.2, (F, 2)).astype(np.float32))
        flip = np.bitwise_and.reduce(
            rng.integers(0, 2 ** 32, (3, F, 8), dtype=np.uint32)) \
            & np.uint32(0x01010101)
        m.kf_desc[k] = torch.from_numpy((desc ^ flip).view(np.int32))
        m.kf_level[k] = torch.from_numpy(rng.integers(0, 3, F).astype(
            np.int32))
        m.kf_frame_id[k] = 10 * k
    m.kf_valid[:3] = True
    m.kf_feat_valid[:3] = True
    m.kf_point[:3, :24] = torch.arange(24, dtype=torch.int32)
    m.kf_parent[1:3] = torch.tensor([0, 1], dtype=torch.int32)
    m.pt_valid[:24] = True
    m.pt_xyz[:24] = pw[:24]
    return m


def phase_create_points(device):
    """The card-vs-CPU check on an arena where point creation acts: the
    aligned keyframes at the arena-full run's shapes (VGA, 1024
    features)."""
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    cfg = vga_config("full")
    base = MapState(*[t.to(device) for t in aligned_map(cfg, 0)])
    created, _ = card_vs_cpu(cfg, base, 2, 3, "aligned keyframes")
    if created < CREATE_MIN_POINTS:
        raise RuntimeError(f"aligned keyframes: {created} points created")


def phase_arena_full(device, frames, gt):
    """An 8-keyframe arena filled at a keyframe every 2 frames, with its
    launch counts; then the card-vs-CPU check on the arena of its first
    keyframe-mapping call that culled a keyframe."""
    import torch
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    from active_orb_slam2_tpu_torch.models.system import System
    cfg = vga_config("full")
    slam = System(cfg, use_mapping=True, device=device)
    events = []             # (arena before the call, slot, seq, victim)
    run = slam.keyframe_mapping

    def snapshot(m, k, seq):
        before = MapState(*[t.clone() for t in m])
        out = run(m, k, seq)
        events.append((before, k, seq, out[1]))
        return out

    slam.keyframe_mapping = snapshot
    reset_launches()
    _, calls = run_frames(slam, frames)
    launches = kernel_launches()
    ate = trajectory_ate(slam, gt)
    culled = slam.kf_seq - slam.n_live_kf
    log(f"arena-full run: keyframes inserted {slam.kf_seq}, culled "
        f"{culled}, live {slam.n_live_kf}, mapping calls {len(calls)}, "
        f"forced evictions (each waits on the card) {slam.n_forced_culls}, "
        f"ATE {ate:.5f} m")
    log(f"arena-full run: launches {launches}")
    check_all_ok(slam, "arena-full run")
    tracked = N_FRAMES - 1
    if launches["pose_opt"] != 2 * tracked:
        raise RuntimeError(f"arena-full run: K1 launched "
                           f"{launches['pose_opt']} times, expected "
                           f"{2 * tracked}")
    if launches["keypoints"] != N_FRAMES:
        raise RuntimeError(f"arena-full run: K2 launched "
                           f"{launches['keypoints']} times, expected "
                           f"{N_FRAMES}")
    if culled < FULL_MIN_CULLS:
        raise RuntimeError(f"arena-full run: {culled} keyframes culled")
    if not ate <= ATE_BOUND_M:
        raise RuntimeError(f"arena-full run: ATE {ate:.5f} m above "
                           f"{ATE_BOUND_M} m")
    del slam
    culls = [e for e in events if int(e[3]) >= 0]
    if not culls:
        raise RuntimeError("arena-full run: no keyframe-mapping call culled")
    base, k, seq, _ = culls[0]
    _, victim = card_vs_cpu(cfg, base, k, seq,
                               "arena-full run, first culling call",
                               point_atol=CULL_EVENT_POINT_ATOL_M)
    if victim < 0:
        raise RuntimeError("arena-full run: the culling call culled "
                           "nothing when run again")
    return launches


class recorded_relocalizers:
    """Inside the ``with``, a ``System`` builds relocalizers that record
    each call: its verdict, inliers, kernel launches and its time on the
    host clock, synchronized at both ends (``self.calls``).  A call (a
    wait the port allows) runs with the sync debug mode off."""

    def __enter__(self):
        import torch
        from active_orb_slam2_tpu_torch.models import system
        self.calls, self._plain = [], system.build_relocalizer

        def build(cfg, n_candidates):
            relocalize = self._plain(cfg, n_candidates=n_candidates)

            def recorded(*args):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(0)
                try:
                    before = kernel_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = relocalize(*args)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    after = kernel_launches()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                self.calls.append({
                    "ok": bool(res.ok), "n_inliers": int(res.n_inliers),
                    "ms": ms, **{k: after[k] - before[k] for k in after}})
                return res
            return recorded

        system.build_relocalizer = build
        return self

    def __exit__(self, *exc):
        from active_orb_slam2_tpu_torch.models import system
        system.build_relocalizer = self._plain


def check_attempts(what, attempts):
    """Each relocalization attempt launched K1 twice (one batched launch
    per refinement, whatever the candidate count) and no K2."""
    for a in attempts:
        if a["pose_opt"] != 2 or a["keypoints"] != 0:
            raise RuntimeError(f"{what}: a relocalization attempt launched "
                               f"K1 {a['pose_opt']} and K2 {a['keypoints']} "
                               f"times, expected 2 and 0")


def phase_relocalization(device, frames, gt):
    """Frames 0-29 with the mapping slice's configuration, 3 black frames
    (LOST), then frames 30-41: frame 30 must relocalize and every frame
    after it track; then the relocalizer's time on the final arena."""
    import torch
    from active_orb_slam2_tpu_torch.models.relocalization import (
        gumbel_noise)
    from active_orb_slam2_tpu_torch.models.system import LOST, OK, System
    cfg = vga_config("mapping")
    black = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    inputs = frames[:N_MAPPED] + [black] * N_BLACK + frames[N_MAPPED:]
    with recorded_relocalizers() as rec:
        slam = System(cfg, device=device)
        reset_launches()
        for i, images in enumerate(inputs):
            slam.track_rgbd(*images, i / 30.0)
            if i == N_MAPPED + N_BLACK - 1 and slam.state != LOST:
                raise RuntimeError("relocalization run: not LOST after the "
                                   "blackout")
        slam.flush()
        launches = kernel_launches()
        attempts = list(rec.calls)
        # the relocalizer alone on the final arena, frame 30
        frame, _ = slam.make_rgbd(*slam._upload(*frames[N_MAPPED]))
        cands, = slam._upload(slam._reloc_candidates())
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        noise = gumbel_noise(len(cands), cfg.orb.n_features, gen, device)
        for _ in range(5):
            slam.relocalizer(slam.map, frame, cands, noise)
        final = rec.calls[len(attempts):]
    # a metrics row holds the state before its frame retired, as in the
    # JAX package: the rows after the first black frame read LOST
    states = {m["frame"]: m["state"] for m in slam.metrics}
    blackout = range(N_MAPPED, N_MAPPED + N_BLACK)
    lost_rows = range(N_MAPPED + 1, N_MAPPED + N_BLACK)
    tracked = [i for i in range(len(inputs)) if i not in blackout]
    ate = trajectory_ate(slam, gt, keep=tracked)
    n_failed = sum(not a["ok"] for a in attempts)
    log(f"relocalization run: attempts {[(a['ok'], a['n_inliers']) for a in attempts]}"
        f", {[round(a['ms'], 2) for a in attempts]} ms (synchronized host "
        f"clock), ATE {ate:.5f} m over the "
        f"{len(tracked)} tracked frames, launches {launches}")
    log(f"relocalization run: relocalizer on the final arena "
        f"{np.median([a['ms'] for a in final]):.2f} ms per call (median of "
        f"5, synchronized), {final[-1]['n_inliers']} inliers")
    check_attempts("relocalization run", attempts + final)
    if sorted(states) != list(range(1, len(inputs))) \
            or any((states[i] == LOST) != (i in lost_rows) for i in states) \
            or slam.state != OK:
        raise RuntimeError(f"relocalization run: states {states}")
    if not attempts or not attempts[-1]["ok"] or n_failed != len(attempts) - 1 \
            or attempts[-1]["n_inliers"] <= RELOC_MIN_INLIERS:
        raise RuntimeError(f"relocalization run: attempts {attempts}")
    if launches["keypoints"] != len(inputs) or launches["pose_opt"] != \
            2 * (len(inputs) - 1 - n_failed) + 2 * len(attempts):
        raise RuntimeError(f"relocalization run: launches {launches}")
    if not ate <= ATE_BOUND_M:
        raise RuntimeError(f"relocalization run: ATE {ate:.5f} m above "
                           f"{ATE_BOUND_M} m")
    return launches


def phase_map_reuse(device, path, frames, gt):
    """The mapping slice's map loaded into a fresh ``System`` in
    localization-only mode, over frames 0-41: frame 0 relocalizes, every
    frame tracks, no keyframe is inserted; host syncs counted on a
    second run.  Returns the System."""
    import torch
    from active_orb_slam2_tpu_torch.models.system import System
    cfg = vga_config("mapping")

    def loaded():
        slam = System(cfg, device=device)
        slam.load_map(path)
        slam.activate_localization_mode()
        return slam
    with recorded_relocalizers() as rec:
        slam = loaded()
        before = (slam.kf_seq, slam.n_live_kf)
        reset_launches()
        ms_frame, calls = run_frames(slam, frames, timed=True)
        launches = kernel_launches()
        attempts = list(rec.calls)
        n_sync, where = count_host_syncs(loaded(), frames)
    ate = trajectory_ate(slam, gt)
    log(f"map reuse: attempts {[(a['ok'], a['n_inliers']) for a in attempts]}"
        f" ({attempts[0]['ms']:.2f} ms), keyframes {before} -> "
        f"{(slam.kf_seq, slam.n_live_kf)}, mapping calls {len(calls)}, ATE "
        f"{ate:.5f} m, {ms_frame:.3f} ms/frame over frames "
        f"{WARMUP}-{N_FRAMES - 1} (host clock, synchronized), sync warnings "
        f"in steady state {n_sync} {where}, launches {launches}")
    check_attempts("map reuse", attempts)
    check_all_ok(slam, "map reuse", n_tracked=N_FRAMES)
    if len(attempts) != 1 or not attempts[0]["ok"] \
            or attempts[0]["n_inliers"] <= RELOC_MIN_INLIERS:
        raise RuntimeError(f"map reuse: attempts {attempts}")
    if (slam.kf_seq, slam.n_live_kf) != before or calls:
        raise RuntimeError("map reuse: a keyframe was inserted")
    if launches != {"pose_opt": 2 * N_FRAMES + 2, "keypoints": N_FRAMES}:
        raise RuntimeError(f"map reuse: launches {launches}")
    if not ate <= ATE_BOUND_M:
        raise RuntimeError(f"map reuse: ATE {ate:.5f} m above {ATE_BOUND_M} m")
    if n_sync:
        raise RuntimeError(f"map reuse: {n_sync} synchronizing calls in the "
                           f"steady state: {where}")
    torch.cuda.synchronize()
    return slam, launches


def phase_reloc_card_vs_cpu(slam, frames):
    """The relocalizer on the map-reuse arena, on the card and on the
    CPU, with frame 0 and the same noise, for each of the noise seeds
    ``RELOC_CARD_CPU_SEEDS``."""
    import torch
    from active_orb_slam2_tpu_torch.models.frame import FrameData
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    from active_orb_slam2_tpu_torch.models.relocalization import (
        build_relocalizer, gumbel_noise)
    relocalize = build_relocalizer(slam.cfg, n_candidates=8)
    frame, _ = slam.make_rgbd(*slam._upload(*frames[0]))
    cands, = slam._upload(slam._reloc_candidates())
    cpu_map = MapState(*[t.cpu() for t in slam.map])
    cpu_frame = FrameData(*[t.cpu() for t in frame])
    bad = []
    for seed in RELOC_CARD_CPU_SEEDS:
        gen = torch.Generator(device=slam.device)
        gen.manual_seed(seed)
        noise = gumbel_noise(8, slam.cfg.orb.n_features, gen, slam.device)
        card = relocalize(slam.map, frame, cands, noise)
        cpu = relocalize(cpu_map, cpu_frame, cands.cpu(), noise.cpu())
        card = type(card)(*[t.cpu() for t in card])
        pose_err = float((card.pose - cpu.pose).abs().max())
        assoc_agree = float((card.assoc == cpu.assoc).float().mean())
        log(f"relocalizer card vs CPU, noise seed {seed}: ok "
            f"{bool(card.ok)}/{bool(cpu.ok)}, inliers {int(card.n_inliers)}/"
            f"{int(cpu.n_inliers)}, assoc agreement {assoc_agree:.4f}, pose "
            f"err {pose_err:.3e}")
        if bool(card.ok) != bool(cpu.ok) or not bool(cpu.ok) \
                or abs(int(card.n_inliers) - int(cpu.n_inliers)) \
                > RELOC_CARD_CPU_INLIERS \
                or assoc_agree < RELOC_CARD_CPU_ASSOC_AGREE \
                or pose_err > RELOC_CARD_CPU_POSE_ATOL:
            bad.append(seed)
    if bad:
        raise RuntimeError(f"relocalizer: card and CPU disagree for noise "
                           f"seeds {bad}")


def phase_stereo(device, pairs, gt):
    """``System(cfg).track_stereo`` at the KITTI shape over the first
    ``N_STEREO`` pairs, then the stereo matching of the first pair on the
    card against the CPU, and K2 against its plain version on the first
    left image.  Returns the launch counts, K2's timing on that image
    with its bound, and K2's angle error there."""
    import torch
    from active_orb_slam2_tpu_torch.kernels.keypoints import (
        keypoint_stage_cuda)
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.ops import orb
    from active_orb_slam2_tpu_torch.ops.stereo import compute_stereo_matches
    cfg = stereo_config()
    cam = cfg.camera
    pairs, gt = pairs[:N_STEREO], gt[:N_STEREO]
    slam = System(cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms_frame, calls = run_frames(slam, pairs, timed=True, track="track_stereo")
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    ate = trajectory_ate(slam, gt)
    inliers = [m["n_inliers"] for m in slam.metrics]
    n_sync, where = count_host_syncs(System(cfg, device=device), pairs,
                                     track="track_stereo")
    log(f"stereo: {len(slam.metrics)} tracked frames, keyframes "
        f"{slam.kf_seq}, mapping calls {len(calls)}, inliers first "
        f"{inliers[0]} min {min(inliers)} final {inliers[-1]}, ATE "
        f"{ate:.5f} m")
    log(f"stereo: {ms_frame:.3f} ms/frame over frames {WARMUP}-"
        f"{N_STEREO - 1} (host clock, synchronized), peak device memory "
        f"{peak / 2**20:.1f} MiB, sync warnings in steady state {n_sync} "
        f"{where}, launches {launches}")
    check_all_ok(slam, "stereo", n_tracked=N_STEREO - 1)
    if launches != {"pose_opt": 2 * (N_STEREO - 1), "keypoints": 2 * N_STEREO}:
        raise RuntimeError(f"stereo: launches {launches}")
    if not ate <= STEREO_ATE_BOUND_M:
        raise RuntimeError(f"stereo: ATE {ate:.5f} m above "
                           f"{STEREO_ATE_BOUND_M} m")
    if n_sync:
        raise RuntimeError(f"stereo: {n_sync} synchronizing calls in the "
                           f"steady state: {where}")
    del slam

    # the stereo matching of pair 0 from the same features
    extract = orb.build_extractor(cfg.orb, cam.height, cam.width)
    il, ir = (torch.tensor(a, dtype=torch.float32, device=device)
              for a in pairs[0])
    fl, fr = extract(il), extract(ir)
    ur_card, _ = compute_stereo_matches(cam, fl, fr, il, ir)
    ur_cpu, _ = compute_stereo_matches(
        cam, *(type(f)(*[t.cpu() for t in f]) for f in (fl, fr)), il.cpu(),
        ir.cpu())
    ur_card = ur_card.cpu()
    ok_card, ok_cpu = ur_card >= 0, ur_cpu >= 0
    agree = float((ok_card == ok_cpu).float().mean())
    both = ok_card & ok_cpu
    ur_err = float((ur_card - ur_cpu)[both].abs().max())
    log(f"stereo matching card vs CPU: {int(ok_cpu.sum())} of "
        f"{int(fl.valid.sum())} matched, ok agreement {agree:.4f}, ur err "
        f"{ur_err:.3e} px")
    if agree < STEREO_OK_AGREE or ur_err > STEREO_UR_ATOL:
        raise RuntimeError("stereo matching: card and CPU disagree")

    # K2 on one KITTI-shape image against its plain version, and for the
    # timing phase
    pad = cfg.orb.pad
    _, _, taps, gauss = orb.device_constants(device)
    levels, ys, xs, counts = detect_frame(device, cfg, pairs[0][0])
    err, eq, n = k2_compare("KITTI-shape image", levels, ys, xs, counts, pad,
                            taps, gauss)
    if err > K2_ANGLE_ATOL or eq / n < K2_BIT_AGREE:
        raise RuntimeError(f"K2 disagrees with its plain version on the "
                           f"KITTI-shape image: angle err {err:.3e}, bit "
                           f"agreement {eq / n:.6f}")
    bound_ms, _ = k2_bound(levels, ys, xs, counts, pad)

    def kernel():
        return keypoint_stage_cuda(levels, ys, xs, counts, pad, taps, gauss)
    return launches, kernel, bound_ms, err


def phase_stereo_loop(device, pairs, gt):
    """``bench.py::stereo_kitti_shape``'s whole window on the port:
    ``System(cfg, use_loop_closing=True).track_stereo`` over the 150
    KITTI-shape pairs, mapping and loop closing on.  One run: host syncs
    counted with the sync debug mode on from pair ``WARMUP`` to the last
    ``N_STEREO_TIMED`` pairs (outside the loop closer's waits), those
    pairs timed; every pair OK, the rigid ATE, peak memory, the loop
    closer's verifications and corrections, K1 twice a tracked pair (and
    per relocalization attempt), K2 twice a pair."""
    import torch
    from active_orb_slam2_tpu_torch.models.system import System
    cfg = stereo_config()
    slam = System(cfg, use_loop_closing=True, device=device)
    lc = slam.loop_closer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    first = N_STEREO_LOOP - N_STEREO_TIMED
    with recorded_relocalizers() as rec, \
            timed_loop_waits(lc, quiet=True) as waits:
        n_sync, where, _ = track_counting_syncs(slam, pairs[:first],
                                                "track_stereo", 0.1)
        slam.flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(first, N_STEREO_LOOP):
            slam.track_stereo(*pairs[i], i * 0.1)
        slam.flush()
        torch.cuda.synchronize()
        ms_frame = (time.perf_counter() - t0) / N_STEREO_TIMED * 1e3
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    ate = trajectory_ate(slam, gt)
    attempts = rec.calls
    verify = [(round(ms, 1), bool(out[0])) for n, ms, _, out in waits.calls
              if n == "compute_sim3"]
    correct = [(round(ms, 1), bool(out[1])) for n, ms, _, out in waits.calls
               if n == "correct"]
    log(f"stereo with loop closing: {len(slam.metrics)} tracked pairs, "
        f"keyframes {slam.kf_seq}, live {slam.n_live_kf}, vocabulary "
        f"{lc.vocab is not None and lc.vocab.n_words} words, loops closed "
        f"{slam.n_loops_closed}, candidates {lc.n_candidates}, verification "
        f"failures {lc.n_verify_fail}, rejected {lc.n_rejected}, "
        f"relocalization attempts {len(attempts)}, rigid ATE {ate:.5f} m")
    log(f"stereo with loop closing: {ms_frame:.3f} ms/frame over pairs "
        f"{first}-{N_STEREO_LOOP - 1} (host clock, synchronized), peak "
        f"device memory {peak / 2**20:.1f} MiB, sync warnings outside the "
        f"loop closer's waits (pairs {WARMUP}-{first - 1}) {n_sync} {where}, "
        f"launches {launches}; verifications (ms, ok) {verify}, corrections "
        f"(ms, accepted) {correct}")
    check_all_ok(slam, "stereo with loop closing",
                 n_tracked=N_STEREO_LOOP - 1)
    if launches != {"pose_opt": 2 * (N_STEREO_LOOP - 1) + 2 * len(attempts),
                    "keypoints": 2 * N_STEREO_LOOP}:
        raise RuntimeError(f"stereo with loop closing: launches {launches}")
    if not ate <= STEREO_LOOP_ATE_BOUND_M:
        raise RuntimeError(f"stereo with loop closing: ATE {ate:.5f} m above "
                           f"{STEREO_LOOP_ATE_BOUND_M} m")
    if peak > LOOP_PEAK_BYTES:
        raise RuntimeError(f"stereo with loop closing: peak memory "
                           f"{peak / 2**20:.1f} MiB above 1 GiB")
    if n_sync:
        raise RuntimeError(f"stereo with loop closing: {n_sync} synchronizing "
                           f"calls outside the loop closer's waits: {where}")
    return launches


def retrain_frames():
    """``scripts/run_torch_endurance.py``'s tour at 320x240: its
    configuration and the 1,000 unique poses, rendered in its process
    pool."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import run_torch_endurance as endurance
    cache = endurance.render_cache("tour", 1000, 0, 320, 240)
    return endurance.camera_config(320, 240), cache


def phase_retrain(device, cfg, cache):
    """The endurance tour on the card until ``RETRAIN_EVENTS_AFTER``
    keyframe events after the loop closer's 48-keyframe retrain, in one
    run with the sync debug mode on after ``WARMUP`` frames (the loop
    closer's waits, vocabulary training among them, quiet and timed).
    Checks the retrain (stage 2, 10,000 words), that every later scoring
    took the sparse path, that the sparse rows of every live keyframe
    were rebuilt, every frame OK, no other host sync, the peak, K1 twice
    a tracked frame (and per relocalization attempt) and K2 once a frame;
    then the card against the CPU on the final arena with the retrained
    vocabulary: word ids of every live row equal and its weights within
    ``RETRAIN_WEIGHT_ATOL``, each live keyframe's L1 scores against the
    live keyframes within
    ``RETRAIN_SCORE_ATOL`` and its DetectLoop candidates and decision
    equal."""
    import torch
    from active_orb_slam2_tpu_torch.models.loop_closing import LoopCloser
    from active_orb_slam2_tpu_torch.models.map_state import (
        MapState, covisibility_weights)
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.utils import trace
    t_phase = time.perf_counter()
    slam = System(cfg, use_loop_closing=True, device=device)
    lc = slam.loop_closer
    frames = [(g, d) for g, d, _ in cache]
    retrain = {}

    def until(i):
        if lc._vocab_stage == 2 and not retrain:
            # the retraining event's detection rebuilt every live row
            hf = lc._host_fid
            retrain.update(frame=i, kf_seq=slam.kf_seq, live=slam.n_live_kf,
                           rebuilt=bool(np.array_equal(lc._bow_fid[hf >= 0],
                                                       hf[hf >= 0])))
        return bool(retrain) and \
            slam.kf_seq >= retrain["kf_seq"] + RETRAIN_EVENTS_AFTER
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    inputs = (frames[i % len(frames)] for i in range(RETRAIN_MAX_FRAMES))
    trace.reset()
    trace.enable()             # unsynchronized: for the training's span
    with recorded_relocalizers() as rec, scoring_paths(lc) as paths, \
            timed_loop_waits(lc, quiet=True) as waits:
        n_sync, where, n = track_counting_syncs(slam, inputs, "track_rgbd",
                                                1 / 30.0, until=until)
        slam.flush()
    trace.disable()
    retrain_ms = trace.durations_ms(("loop.retrain",)).get(
        "loop.retrain", [0.0])[-1]
    trace.reset()
    torch.cuda.synchronize()
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    gt = np.stack([cache[i % len(cache)][2].astype(np.float64)
                   for i in range(n)])
    ate = trajectory_ate(slam, gt)
    attempts = rec.calls
    trainings = [(round(ms, 1), out.n_words) for name, ms, _, out in
                 waits.calls if name == "ensure_vocabulary" and out is not None]
    words = sorted(set(w for _, w in trainings))
    verify = [round(ms, 1) for name, ms, _, _ in waits.calls
              if name == "compute_sim3"]
    after = {k: [s for s in v if s == 2] for k, v in paths.calls.items()}
    log(f"retrain: {n} frames of the tour, keyframes {slam.kf_seq}, live "
        f"{slam.n_live_kf}, retrain at frame {retrain.get('frame')} "
        f"(keyframe {retrain.get('kf_seq')}, {retrain.get('live')} live), "
        f"vocabulary stage {lc._vocab_stage}, {lc.vocab.n_words} words; "
        f"retrain stall (descriptor read, training, cache drop) "
        f"{retrain_ms:.1f} ms; ensure_vocabulary calls that trained "
        f"(ms synchronized, words) "
        f"{[t for t in trainings if t[0] > 50.0]}; scorings after the "
        f"retrain: sparse {len(after['sparse'])}, dense {len(after['dense'])}")
    log(f"retrain: loops closed {slam.n_loops_closed}, candidates "
        f"{lc.n_candidates}, verification failures {lc.n_verify_fail}, "
        f"rejected {lc.n_rejected}, verifications {len(verify)} "
        f"(median {np.median(verify) if verify else 0:.1f} ms, sum "
        f"{sum(verify) / 1e3:.1f} s), relocalization attempts "
        f"{len(attempts)}, rigid ATE {ate:.5f} m, peak {peak / 2**20:.1f} "
        f"MiB, sync warnings outside the loop closer's waits {n_sync} "
        f"{where}, launches {launches}")
    check_all_ok(slam, "retrain", n_tracked=n - 1)
    if lc._vocab_stage != 2 or lc.vocab.n_words != RETRAIN_WORDS \
            or RETRAIN_WORDS not in words:
        raise RuntimeError(f"retrain: no {RETRAIN_WORDS}-word retrain in "
                           f"{n} frames (stage {lc._vocab_stage})")
    if slam.kf_seq < retrain["kf_seq"] + RETRAIN_EVENTS_AFTER:
        raise RuntimeError("retrain: fewer than 8 keyframe events after it")
    if not after["sparse"] or after["dense"]:
        raise RuntimeError(f"retrain: scorings after it {after}")
    if not retrain["rebuilt"]:
        raise RuntimeError("retrain: a live keyframe's sparse row was not "
                           "rebuilt at the retrain")
    if launches != {"pose_opt": 2 * (n - 1) + 2 * len(attempts),
                    "keypoints": n}:
        raise RuntimeError(f"retrain: launches {launches}")
    if peak > LOOP_PEAK_BYTES:
        raise RuntimeError(f"retrain: peak memory {peak / 2**20:.1f} MiB "
                           f"above 1 GiB")
    if n_sync:
        raise RuntimeError(f"retrain: {n_sync} synchronizing calls outside "
                           f"the loop closer's waits: {where}")

    # the card against the CPU on the final arena, retrained vocabulary
    # (the card's rows of keyframes inserted since the last detection are
    # brought up to date, as the next event would)
    m = slam.map
    live = np.array(sorted(slam._live_slots))
    lc.refresh_bows(m)
    m_cpu = MapState(*[t.cpu() for t in m])
    cpu = LoopCloser(cfg, recent_frames_guard=lc.recent_frames_guard)
    cpu.vocab, cpu._vocab_stage = lc.vocab.to("cpu"), lc._vocab_stage
    cpu._host_fid = lc._host_fid.copy()
    cpu.refresh_bows(m_cpu)
    words_eq = torch.equal(lc._bow_words[live].cpu(),
                           cpu._bow_words[live])
    weight_err = float((lc._bow_weights[live].cpu()
                        - cpu._bow_weights[live]).abs().max())
    W, W_cpu = covisibility_weights(m), covisibility_weights(m_cpu)
    C1 = max(lc.consistency_th - 1, 0)
    score_err, same_det = 0.0, 0
    for k in live:
        s_card = lc.score_kf(m, int(k))
        s_cpu = cpu.score_kf(m_cpu, int(k))
        # live slots only: a culled slot keeps its last row until it is
        # re-tenanted, and detection masks it
        score_err = max(score_err, float(
            (s_card.cpu() - s_cpu)[live].abs().max()))
        # earlier groups that accepted everything: the decision is the
        # best candidate this group accepts
        every = torch.ones((C1, m.max_keyframes), dtype=torch.bool)
        c_card, ok_card, buf_card = lc._detect(m, int(k), W, s_card,
                                               every.to(device))
        c_cpu, ok_cpu, buf_cpu = cpu._detect(m_cpu, int(k), W_cpu, s_cpu,
                                             every)
        same_det += int(int(c_card) == int(c_cpu)
                        and bool(ok_card) == bool(ok_cpu)
                        and torch.equal(buf_card.cpu(), buf_cpu))
    log(f"retrain card vs CPU on the final arena ({len(live)} live "
        f"keyframes): sparse word ids equal {words_eq}, weight err "
        f"{weight_err:.3g}, L1 score err {score_err:.3g}, DetectLoop candidates "
        f"and decision equal for {same_det} of {len(live)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not words_eq or weight_err > RETRAIN_WEIGHT_ATOL \
            or score_err > RETRAIN_SCORE_ATOL \
            or same_det != len(live):
        raise RuntimeError("retrain: card and CPU disagree")
    return launches


def _render_loop_frame(i):
    """Frame i of the loop circle at VGA (runs in a worker process)."""
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, loop_trajectory, render_rgbd)
    Twc = loop_trajectory(N_LOOP, radius=2.5)[i]
    g, d = render_rgbd(default_world(n_boxes=0), vga_config().camera, Twc)
    return (np.clip(g, 0, 255).astype(np.uint8),
            np.clip(d * 1e3, 0, 65535).astype(np.uint16))


def render_loop_frames():
    """The 150 frames of the loop circle, rendered in a pool of fresh
    processes (closed before it returns), and the trajectory."""
    from active_orb_slam2_tpu_torch.io.synthetic import loop_trajectory
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        frames = pool.map(_render_loop_frame, range(N_LOOP))
    return frames, loop_trajectory(N_LOOP, radius=2.5)


class wrapped_methods:
    """Inside the ``with``, the methods ``names`` of ``obj`` are
    ``wrap(name, method)`` (instance attributes, removed on exit)."""

    def __init__(self, obj, names, wrap):
        self.obj, self.names, self.wrap = obj, names, wrap

    def __enter__(self):
        for name in self.names:
            setattr(self.obj, name, self.wrap(name, getattr(self.obj, name)))
        return self

    def __exit__(self, *exc):
        for name in self.names:
            delattr(self.obj, name)


def sync_waits_allowed(lc):
    """The loop closer's three waits on the card (vocabulary training, a
    verification's verdict, a correction's gate) run with the sync debug
    mode off, so that only other syncs count."""
    import torch

    def quiet(name, fn):
        def call(*args, **kw):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call
    return wrapped_methods(lc, ("ensure_vocabulary", "compute_sim3",
                                "correct"), quiet)


def timed_loop_waits(lc, quiet=False):
    """Each ``compute_sim3`` and ``correct`` call of the loop closer is
    timed on the host clock, synchronized at both ends, with the kernel
    launches it made: the context's ``calls`` holds (name, ms, launches,
    result).  With ``quiet`` the vocabulary training is timed too, and
    each call (its synchronizations included) runs with the sync debug
    mode off, as in ``sync_waits_allowed``."""
    import torch
    calls = []

    def timed(name, fn):
        def call(*args, **kw):
            mode = torch.cuda.get_sync_debug_mode()
            if quiet:
                torch.cuda.set_sync_debug_mode(0)
            try:
                before = kernel_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                after = kernel_launches()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            calls.append((name, ms, {k: after[k] - before[k] for k in after},
                          out))
            return out
        return call
    names = ("compute_sim3", "correct") + (("ensure_vocabulary",)
                                           if quiet else ())
    ctx = wrapped_methods(lc, names, timed)
    ctx.calls = calls
    return ctx


class scoring_paths:
    """Inside the ``with``, the loop closer's L1 scorings are recorded by
    path (``dense``, ``sparse``) with the vocabulary stage of ``lc`` at
    the call."""

    def __init__(self, lc):
        self.lc, self.calls = lc, {"dense": [], "sparse": []}

    def __enter__(self):
        from active_orb_slam2_tpu_torch.models import loop_closing
        self._plain = {}
        for name, kind in (("l1_score", "dense"),
                           ("l1_score_sparse", "sparse")):
            fn = self._plain[name] = getattr(loop_closing, name)

            def counted(*a, _fn=fn, _kind=kind, **kw):
                self.calls[_kind].append(self.lc._vocab_stage)
                return _fn(*a, **kw)
            setattr(loop_closing, name, counted)
        return self

    def __exit__(self, *exc):
        from active_orb_slam2_tpu_torch.models import loop_closing
        for name, fn in self._plain.items():
            setattr(loop_closing, name, fn)


def track_counting_syncs(slam, frames, track, dt, start=WARMUP, stop=None,
                         until=None):
    """Track ``frames`` with the sync debug mode on for frames
    ``start``.. ``stop`` - 1 (every later frame from ``start`` when
    ``stop`` is None); ``until(i)`` ends the run after frame i.  Returns
    (synchronizing calls counted, the first places that made them,
    frames tracked)."""
    import torch
    n, where, i = 0, [], -1
    for i, images in enumerate(frames):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if i >= start and (stop is None or i < stop):
                torch.cuda.set_sync_debug_mode("warn")
            try:
                getattr(slam, track)(*images, i * dt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        for w in caught:
            if "called a synchronizing CUDA operation" in str(w.message):
                n += 1
                if len(where) < 8:
                    where.append(f"frame {i} {w.filename}:{w.lineno}")
        if until is not None and until(i):
            break
    return n, where, i + 1


def loop_inputs(frames, traj):
    """Frames 0-149 and 0-39 again, with their ground-truth centres."""
    order = list(range(N_LOOP)) + list(range(N_LOOP_REVISIT))
    return [frames[i] for i in order], np.stack(
        [traj[i][:3, 3].astype(np.float64) for i in order])


def phase_loop_pipeline(device, frames, traj):
    """``System(cfg_map, use_loop_closing=True).track_rgbd`` over the
    loop circle and its first 40 frames again: timed run with launch
    counts, ATE, peak memory and at least one loop closed (the closure
    accepted by the chi2 gate); a second run counting host syncs outside
    the loop closer's waits; a third with the keyframe stages' spans,
    synchronized (``trace.enable(sync=True)``)."""
    import torch
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.utils import trace
    cfg = vga_config("mapping")
    inputs, gt = loop_inputs(frames, traj)
    t0 = time.perf_counter()
    slam = System(cfg, use_loop_closing=True, device=device)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trace.reset()
    trace.enable()             # unsynchronized: for the training's span
    with recorded_relocalizers() as rec, \
            timed_loop_waits(slam.loop_closer) as waits:
        ms_frame, calls = run_frames(slam, inputs, timed=True)
    trace.disable()
    retrain_ms = trace.durations_ms(("loop.retrain",)).get(
        "loop.retrain", [0.0])[-1]
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    ate = trajectory_ate(slam, gt)
    lc = slam.loop_closer
    attempts = rec.calls

    second = System(cfg, use_loop_closing=True, device=device)
    with sync_waits_allowed(second.loop_closer):
        n_sync, where = count_host_syncs(second, inputs)
    del second

    third = System(cfg, use_loop_closing=True, device=device)
    trace.reset()
    trace.enable(sync=True)
    for i, images in enumerate(inputs):
        third.track_rgbd(*images, i / 30.0)
    third.flush()
    trace.disable()
    del third
    stages = {k: (round(float(np.median(v)), 3), len(v)) for k, v in
              trace.durations_ms(trace.KEYFRAME_STAGES).items()}
    trace.reset()
    log(f"loop pipeline: {len(slam.metrics)} tracked frames, keyframes "
        f"{slam.kf_seq}, live {slam.n_live_kf}, mapping calls {len(calls)}, "
        f"vocabulary {lc.vocab is not None and lc.vocab.n_words} words, "
        f"loops closed {slam.n_loops_closed}, candidates {lc.n_candidates}, "
        f"verification failures {lc.n_verify_fail}, rejected "
        f"{lc.n_rejected}, relocalization attempts {len(attempts)}; the "
        f"System took {build_ms:.1f} ms to build (solver warm-ups included)")
    log(f"loop pipeline: {ms_frame:.3f} ms/frame over frames {WARMUP}-"
        f"{len(inputs) - 1} (host clock, synchronized), ATE {ate:.5f} m, "
        f"peak device memory {peak / 2**20:.1f} MiB, sync warnings in steady "
        f"state outside the loop closer's waits {n_sync} {where}, launches "
        f"{launches}")
    log(f"loop pipeline: verifications and corrections (ms, synchronized): "
        f"{[(n, round(ms, 2), bool(out[0]) if n == 'compute_sim3' else bool(out[1])) for n, ms, _, out in waits.calls]}")
    log(f"loop pipeline: stage ms (median, count; traced run, "
        f"synchronized): {stages}; vocabulary training in the timed run "
        f"{retrain_ms:.1f} ms (the later runs reuse the trained tree)")
    check_all_ok(slam, "loop pipeline", n_tracked=len(inputs) - 1)
    if lc.vocab is None:
        raise RuntimeError("loop pipeline: no vocabulary was trained")
    gated = [bool(out[1]) for n, _, _, out in waits.calls if n == "correct"]
    if slam.n_loops_closed < 1 or not any(gated):
        raise RuntimeError(f"loop pipeline: no loop closed (corrections "
                           f"accepted by the gate: {gated})")
    if launches != {"pose_opt": 2 * (len(inputs) - 1) + 2 * len(attempts),
                    "keypoints": len(inputs)}:
        raise RuntimeError(f"loop pipeline: launches {launches}")
    if not ate <= LOOP_ATE_BOUND_M:
        raise RuntimeError(f"loop pipeline: ATE {ate:.5f} m above "
                           f"{LOOP_ATE_BOUND_M} m")
    if peak > LOOP_PEAK_BYTES:
        raise RuntimeError(f"loop pipeline: peak memory {peak / 2**20:.1f} "
                           f"MiB above 1 GiB")
    if n_sync:
        raise RuntimeError(f"loop pipeline: {n_sync} synchronizing calls in "
                           f"the steady state: {where}")
    return launches


def merge_with_drift(ckpt_a, ckpt_b, drift):
    """``tests/test_loop_closing.py::_merge_with_drift`` on checkpoints:
    arc B's keyframes and points appended after arc A's used slots, its
    world moved by ``drift`` (SE3 [7]).  Returns (arena dict, Ka, Kb)."""
    from active_orb_slam2_tpu_torch.utils import np_se3
    a = {k: v.copy() for k, v in ckpt_a.items()}
    b = ckpt_b
    Ka = int(np.flatnonzero(a["kf_valid"]).max()) + 1
    Pa = int(np.flatnonzero(a["pt_valid"]).max()) + 1
    Kb = int(np.flatnonzero(b["kf_valid"]).max()) + 1
    Pb = int(np.flatnonzero(b["pt_valid"]).max()) + 1
    drift = np.asarray(drift, np.float64)
    d_inv = np_se3.se3_inverse(drift)
    kf, pt = slice(Ka, Ka + Kb), slice(Pa, Pa + Pb)
    for f in ("kf_valid", "kf_frame_id", "kf_uv", "kf_ur", "kf_level",
              "kf_angle", "kf_desc", "kf_feat_valid", "kf_depth"):
        a[f][kf] = b[f][:Kb]
    a["kf_pose"][kf] = np.stack([np_se3.se3_compose(p, d_inv)
                                 for p in b["kf_pose"][:Kb]])
    a["kf_point"][kf] = np.where(b["kf_point"][:Kb] >= 0,
                                 b["kf_point"][:Kb] + Pa, -1)
    a["kf_parent"][kf] = np.where(b["kf_parent"][:Kb] >= 0,
                                  b["kf_parent"][:Kb] + Ka, -1)
    for f in ("pt_desc", "pt_min_dist", "pt_max_dist", "pt_valid",
              "pt_visible", "pt_found"):
        a[f][pt] = b[f][:Pb]
    a["pt_xyz"][pt] = np_se3.quat_rotate(drift[:4], b["pt_xyz"][:Pb]) \
        + drift[4:7]
    a["pt_normal"][pt] = np_se3.quat_rotate(drift[:4], b["pt_normal"][:Pb])
    a["pt_first_kf"][pt] = b["pt_first_kf"][:Pb] + 100
    return a, Ka, Kb


def closure_error(pose0, pose, drift, A):
    """The error of ``tests/test_loop_closing.py``: |log(pose truth^-1)|
    with truth = (pose0 drift) A^-1, poses as SE3 [7]."""
    import torch
    from active_orb_slam2_tpu_torch.geometry.se3 import (
        se3_compose, se3_inverse, se3_log)
    t = [torch.as_tensor(np.asarray(x, np.float32)) for x in
         (pose0, pose, drift, A)]
    truth = se3_compose(se3_compose(t[0], t[2]), se3_inverse(t[3]))
    return float(se3_log(se3_compose(t[1], se3_inverse(truth))).norm())


def closure_arena(device, frames, traj, cfg):
    """Arcs A and B of the loop circle tracked by two ``System``s on
    ``device``, arc B's map moved by the drift and merged into arc A's.
    Returns (arena dict, Ka, Kb, drift [7], A [7]: arc B's first camera in
    arc A's world)."""
    import torch
    from active_orb_slam2_tpu_torch.geometry.se3 import (
        mat44_to_se3, se3_exp)
    from active_orb_slam2_tpu_torch.models.system import System
    arcs = []
    for lo, hi, extra in ((*ARC_A, 0), (*ARC_B, N_REVISIT)):
        slam = System(cfg, device=device)
        arc = frames[lo:hi] + frames[:extra]
        run_frames(slam, arc)
        check_all_ok(slam, f"closure arc {lo}-{hi - 1}", n_tracked=len(arc) - 1)
        arcs.append(slam.checkpoint())
        del slam
    drift = se3_exp(torch.tensor(DRIFT_TWIST)).numpy()
    arrays, Ka, Kb = merge_with_drift(arcs[0], arcs[1], drift)
    A = mat44_to_se3(torch.from_numpy(
        (np.linalg.inv(traj[ARC_A[0]]) @ traj[ARC_B[0]]).astype(
            np.float32))).numpy()
    return arrays, Ka, Kb, drift, A


def close_loop(lc, m, Ka, Kb):
    """The loop closer over the last arc-B keyframes until it closes.
    Returns (m, events, the arena before the closing event, that event's
    keyframe slot); the last two are None if it never closes."""
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    events = []
    for n, k in enumerate(range(Ka + Kb - CLOSURE_EVENTS, Ka + Kb)):
        snap = MapState(*[x.clone() for x in m])
        m, closed = lc.process_keyframe(m, k, kf_seq=20 + n)
        events.append((n, closed, lc.n_candidates, lc.n_verify_fail,
                       lc.n_rejected))
        if closed:
            return m, events, snap, k
    return m, events, None, None


def replay_at_gate(dev, dump, cam):
    """``scripts/dissect_torch_closure.py``'s replay of ``dump`` on
    ``dev`` at the gate's 16 CG steps."""
    from scripts.dissect_torch_closure import dissect
    return dissect(dump, cam, dev, gba_iters=1, cg_iters=16,
                   log=lambda *a: None)


def check_replay(side, r, gate, accepted, post_rtol=0.0):
    """The replay's chi2 before equals the gate's (``last_closure``) bit
    for bit, its chi2 after is within ``post_rtol`` relative of the
    gate's (bit for bit at 0), and its verdict is the gate's."""
    post_rel = abs(r["post_gba"][0] - gate["chi2_post"]) / max(
        abs(gate["chi2_post"]), 1e-12)
    if r["pre"] != gate["chi2_pre"] or r["accepted"] != accepted \
            or post_rel > post_rtol:
        raise RuntimeError(
            f"closure replay ({side}): chi2 {r['pre']!r} -> "
            f"{r['post_gba'][0]!r} {r['accepted']}, the gate's "
            f"{gate['chi2_pre']!r} -> {gate['chi2_post']!r} {accepted}")
    return post_rel


def phase_closure(device, frames, traj):
    """The constructed closure at VGA width, then the loop closer's card
    against CPU checks on its arena, and its corrections recorded and
    replayed stage by stage."""
    with tempfile.TemporaryDirectory() as tmp:
        return _phase_closure(device, frames, traj, tmp)


def _phase_closure(device, frames, traj, tmp):
    import torch
    from active_orb_slam2_tpu_torch.models import convert
    from active_orb_slam2_tpu_torch.models.loop_closing import (
        LoopCloser, dump_correction)
    from active_orb_slam2_tpu_torch.models.map_state import (
        MapState, covisibility_weights)
    from active_orb_slam2_tpu_torch.models.sim3_solver import (
        N_HYPOTHESES, gumbel_noise)
    cfg = vga_config("mapping")
    reset_launches()
    arrays, Ka, Kb, drift, A = closure_arena(device, frames, traj, cfg)
    launches = kernel_launches()
    m = convert.map_from_jax_numpy(arrays, device)
    lc = LoopCloser(cfg, recent_frames_guard=0)
    with timed_loop_waits(lc) as waits:
        m, events, before_closure, cur = close_loop(lc, m, Ka, Kb)
    in_lc = kernel_launches()
    verify_ms = [round(ms, 2) for n, ms, _, _ in waits.calls
                 if n == "compute_sim3"]
    correct_ms = [round(ms, 2) for n, ms, _, _ in waits.calls
                  if n == "correct"]
    log(f"closure: arcs of {ARC_A[1] - ARC_A[0]} and "
        f"{ARC_B[1] - ARC_B[0] + N_REVISIT} frames, Ka {Ka} Kb {Kb}, "
        f"events (n, closed, candidates, verify failures, rejected) {events}")
    log(f"closure: verifications {verify_ms} ms, corrections {correct_ms} ms "
        f"(synchronized; the first verification of a process includes the "
        f"batched eigh's setup)")
    if cur is None:
        raise RuntimeError("closure: the loop was never closed")
    pose0 = arrays["kf_pose"][cur]
    err0 = closure_error(pose0, pose0, drift, A)
    err1 = closure_error(pose0, m.kf_pose[cur].cpu().numpy(), drift, A)
    log(f"closure: keyframe {lc.last_closure['cur_kf']} on "
        f"{lc.last_closure['loop_kf']}, chi2 {lc.last_closure['chi2_pre']:.4f}"
        f" -> {lc.last_closure['chi2_post']:.4f}, pose error {err0:.4f} -> "
        f"{err1:.4f}")
    if not (err1 < CLOSURE_GAIN * err0 and err1 < CLOSURE_MAX_ERR):
        raise RuntimeError(f"closure: error {err0:.4f} -> {err1:.4f}")
    if in_lc != launches:
        raise RuntimeError(f"closure: the loop closer launched kernels: "
                           f"{launches} -> {in_lc}")
    # one deferred GBA slice, synchronized
    times = []
    for _ in range(3):
        m2 = MapState(*[x.clone() for x in m])
        lc.gba_remaining = 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc.gba_slice(m2)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"closure: GBA slice (2 LM iterations, 24 CG steps) {[round(x, 2) for x in times]} ms (synchronized)")

    # the card against the CPU on the closing event's arena
    pair = (lc.last_closure["cur_kf"], lc.last_closure["loop_kf"])
    gen = torch.Generator().manual_seed(3)
    noise = gumbel_noise(N_HYPOTHESES, cfg.orb.n_features, gen, "cpu")
    s_cm = torch.from_numpy(lc.last_closure["s_cm"])
    out = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        base = MapState(*[x.to(dev, copy=True) for x in before_closure])
        W = covisibility_weights(base)
        side_lc = LoopCloser(cfg, recent_frames_guard=0)
        side_lc._noise = lambda h, n, d: noise.to(d)
        ok, s, nm = side_lc.compute_sim3(base, *pair)
        dump = os.path.join(tmp, f"closure_{side}.npz")
        t0 = time.perf_counter()
        dump_correction(dump, base, *pair, s_cm,
                        *side_lc.next_loop_window(*pair), W)
        dump_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        base, accepted = side_lc.correct(base, *pair, s_cm.to(dev), W=W)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        correct_s = time.perf_counter() - t0
        out[side] = {"ok": ok, "s": None if s is None else s.cpu(), "n": nm,
                     "accepted": accepted, "map": MapState(*[
                         x.cpu() for x in base]), "s_correct": correct_s,
                     "dump": dump, "s_dump": dump_s,
                     "gate": side_lc.last_closure}
    card, cpu = out["card"], out["cpu"]
    s_err = float((card["s"] - cpu["s"]).abs().max()) \
        if card["ok"] and cpu["ok"] else 0.0
    live, pts = cpu["map"].kf_valid, cpu["map"].pt_valid
    pose_err = float((card["map"].kf_pose - cpu["map"].kf_pose)[live]
                     .abs().max())
    pt_err = float((card["map"].pt_xyz - cpu["map"].pt_xyz)[pts].abs().max())
    # one GBA slice from the card's corrected arena, on both
    g = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        mm = MapState(*[x.to(dev, copy=True) for x in card["map"]])
        side_lc = LoopCloser(cfg, recent_frames_guard=0)
        side_lc.gba_remaining = 2
        side_lc._gba_fixed = (pair[1], None)
        side_lc.gba_slice(mm)
        g[side] = mm.kf_pose.cpu()
    gba_err = float((g["card"] - g["cpu"])[live].abs().max())
    log(f"closure card vs CPU: compute_sim3 ok {card['ok']}/{cpu['ok']}, "
        f"guided matches {card['n']}/{cpu['n']}, S_cm err {s_err:.3e}; "
        f"correct accepted {card['accepted']}/{cpu['accepted']} "
        f"({card['s_correct'] * 1e3:.1f} / {cpu['s_correct'] * 1e3:.0f} ms), "
        f"pose err {pose_err:.3e}, point err {pt_err:.3e} m; GBA slice pose "
        f"err {gba_err:.3e}")
    if card["ok"] != cpu["ok"] or not cpu["ok"] \
            or abs(card["n"] - cpu["n"]) > LC_CARD_CPU_MATCHES \
            or s_err > LC_CARD_CPU_SIM3_ATOL:
        raise RuntimeError("closure: compute_sim3 card and CPU disagree")
    if card["accepted"] != cpu["accepted"] or not cpu["accepted"] \
            or pose_err > LC_CARD_CPU_POSE_ATOL \
            or pt_err > LC_CARD_CPU_POINT_ATOL_M:
        raise RuntimeError("closure: correct card and CPU disagree")
    if gba_err > LC_CARD_CPU_POSE_ATOL:
        raise RuntimeError("closure: gba_slice card and CPU disagree")
    closure_replays(device, cfg.camera, out)
    return launches


def closure_replays(device, cam, out):
    """The closing correction's records (``out[side]["dump"]``) replayed
    on their own device, each against that device's gate: on the CPU bit
    for bit; on the card, whose gate sums its global BA by atomics, the
    chi2 before bit for bit and after within ``REPLAY_CARD_CPU_RTOL``.
    Card against CPU on every stage."""
    import torch
    t0 = time.perf_counter()
    rep = {side: replay_at_gate(dev, out[side]["dump"], cam)
           for side, dev in (("card", device), ("cpu", torch.device("cpu")))}
    check_replay("cpu", rep["cpu"], out["cpu"]["gate"], out["cpu"]["accepted"])
    card_post = check_replay("card", rep["card"], out["card"]["gate"],
                             out["card"]["accepted"], REPLAY_CARD_CPU_RTOL)
    stages = [(k, rep["card"][k], rep["cpu"][k])
              for k in ("pre", "post_stage1", "post_pg")]
    stages.append(("post_gba1", rep["card"]["post_gba"][0],
                   rep["cpu"]["post_gba"][0]))
    rel = {k: abs(a - b) / max(abs(b), 1e-12) for k, a, b in stages}
    card, cpu = rep["card"], rep["cpu"]
    log(f"closure replay (dissect_torch_closure, 1 GBA iteration of 16 CG "
        f"steps): CPU = its gate bit for bit ({cpu['pre']!r} -> "
        f"{cpu['post_gba'][0]!r}, accepted); card: chi2 before = its gate "
        f"bit for bit, after {card['post_gba'][0]!r} against the gate's "
        f"{out['card']['gate']['chi2_post']!r} (relative {card_post:.3g}), "
        f"accepted; stages card vs CPU relative {rel}; replay "
        f"{card['ms']:.1f} ms on the card, {cpu['ms']:.0f} ms on the CPU")
    if max(rel.values()) > REPLAY_CARD_CPU_RTOL:
        raise RuntimeError(f"closure replay: card and CPU stages disagree "
                           f"{rel}")
    log(f"closure records: written in {out['card']['s_dump']:.2f} s (card) "
        f"+ {out['cpu']['s_dump']:.2f} s (CPU), replayed in "
        f"{time.perf_counter() - t0:.1f} s")


def _render_mono_frame(i):
    """Frame i of the mono orbit at VGA (runs in a worker process)."""
    from active_orb_slam2_tpu_torch.config import SlamConfig
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, orbit_trajectory, render_rgbd)
    Twc = orbit_trajectory(N_MONO, radius=2.0, step_deg=2.0)[i]
    g, _ = render_rgbd(default_world(), SlamConfig(sensor="mono").camera, Twc)
    return np.clip(g, 0, 255).astype(np.uint8)


def render_mono_frames():
    """``tests/test_e2e_mono.py``'s scene at VGA: 60 frames of
    ``orbit_trajectory(60, radius=2.0, step_deg=2.0)`` on
    ``default_world()``, rendered in a pool of fresh processes; (gray
    frames, ground-truth centres)."""
    from active_orb_slam2_tpu_torch.io.synthetic import orbit_trajectory
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        frames = pool.map(_render_mono_frame, range(N_MONO))
    traj = orbit_trajectory(N_MONO, radius=2.0, step_deg=2.0)
    return frames, np.stack([T[:3, 3].astype(np.float64) for T in traj])


class mono_waits:
    """Inside the ``with``, the ``System``'s monocular initialization
    attempts run with the sync debug mode off and are timed on the host
    clock, synchronized at both ends (``calls``: (ms, initialized)), and
    its retirements are counted (``retirements``): the two places a mono
    frame may wait on the card."""

    def __init__(self, slam):
        self.slam, self.calls, self.retirements = slam, [], 0

    def __enter__(self):
        import torch
        init, fetch = self.slam._initialize_mono, self.slam._fetch_stats

        def initialize(frame, timestamp):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = init(frame, timestamp)
                torch.cuda.synchronize()
                self.calls.append(((time.perf_counter() - t0) * 1e3,
                                   self.slam._state == 1))
                return out
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        def fetch_stats(entries):
            self.retirements += 1
            return fetch(entries)

        self.slam._initialize_mono = initialize
        self.slam._fetch_stats = fetch_stats
        return self

    def __exit__(self, *exc):
        del self.slam._initialize_mono, self.slam._fetch_stats


def rotation_angle(qa, qb):
    """Angle (rad) between two unit quaternions [4] (numpy)."""
    return 2.0 * float(np.arccos(np.clip(abs(np.dot(qa, qb)), 0.0, 1.0)))


def init_card_vs_cpu(cfg, frames, device):
    """The initializer and the initial map on the card against the CPU
    from the same inputs: frames 0 and 1 built and matched on the card,
    the noise of the ``System``'s first draw (a generator seeded 3)."""
    import torch
    from active_orb_slam2_tpu_torch.models.frame import build_frame_pipeline
    from active_orb_slam2_tpu_torch.models.initializer import (
        N_HYPOTHESES, build_initializer)
    from active_orb_slam2_tpu_torch.models.map_state import empty_map
    from active_orb_slam2_tpu_torch.models.mono_init import (
        build_create_initial_map, build_mono_matcher)
    from active_orb_slam2_tpu_torch.models.sim3_solver import gumbel_noise
    from active_orb_slam2_tpu_torch.models.system import INIT_SEED
    _, make_mono = build_frame_pipeline(cfg)
    f0, f1 = (make_mono(torch.from_numpy(g).to(device))[0]
              for g in frames[:2])
    idx, _ = build_mono_matcher(cfg)(f0, f1)
    gen = torch.Generator(device=device)
    gen.manual_seed(INIT_SEED)
    noise = gumbel_noise(N_HYPOTHESES, idx.shape[0], gen, device)
    args = (noise, f0.uv, f1.uv[torch.clamp(idx, min=0).long()], idx >= 0)
    init = build_initializer(cfg.camera)
    card = init(*args)
    cpu = init(*(a.cpu() for a in args))
    for name, a, b in (("ok", card.ok, cpu.ok), ("used_h", card.used_h,
                                                 cpu.used_h)):
        if bool(a) != bool(b):
            raise RuntimeError(f"initializer card vs CPU: {name} "
                               f"{bool(a)} vs {bool(b)}")
    if not bool(card.ok):
        raise RuntimeError("initializer: frames 0 and 1 do not initialize")
    pa, pb = card.pose2.cpu().numpy(), cpu.pose2.numpy()
    rot = rotation_angle(pa[:4], pb[:4])
    ta, tb = (t / np.linalg.norm(t) for t in (pa[4:], pb[4:]))
    tdir = float(np.linalg.norm(ta - tb))
    ok_agree = float((card.point_ok.cpu() == cpu.point_ok).float().mean())
    create = build_create_initial_map(cfg)
    outs = []
    for dev in (device, torch.device("cpu")):
        m = empty_map(cfg.map, cfg.orb, dev)
        fr = [type(f0)(*(t.to(dev) for t in f)) for f in (f0, f1)]
        outs.append(create(m, *fr, card.pose2.to(dev), card.points.to(dev),
                           card.point_ok.to(dev), idx.to(dev)))
    (mc, kc, pc, nc), (mh, kh, ph, nh) = outs
    pts = float((mc.pt_xyz.cpu() - mh.pt_xyz).abs().max())
    pose = float((pc.cpu() - ph).abs().max())
    log(f"mono init card vs CPU: ok {bool(card.ok)}, homography "
        f"{bool(card.used_h)}, rotation {rot:.3e} rad, translation "
        f"direction {tdir:.3e}, point flags equal {ok_agree:.4f}; initial "
        f"map: points {int(nc)} / {int(nh)}, kf_point equal "
        f"{bool((kc.cpu() == kh).all())}, max point difference {pts:.3e}, "
        f"pose {pose:.3e}")
    if rot > INIT_CARD_CPU_ROT_RAD or tdir > INIT_CARD_CPU_DIR \
            or ok_agree < INIT_CARD_CPU_POINT_OK:
        raise RuntimeError("initializer: card and CPU disagree")
    if int(nc) != int(nh) or pts > INIT_MAP_CARD_CPU_ATOL \
            or pose > INIT_MAP_CARD_CPU_ATOL:
        raise RuntimeError("initial map: card and CPU disagree")


def phase_mono(device, frames, gt):
    """``System(SlamConfig(sensor="mono"), use_loop_closing=True)
    .track_mono`` over the 60 VGA frames (timed, launches counted), a
    second run counting host syncs outside the initialization and the
    per-frame retirement, then the initializer and the initial map card
    against CPU."""
    import torch
    from active_orb_slam2_tpu_torch.config import SlamConfig
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models.system import OK, System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    cfg = SlamConfig(sensor="mono")
    t0 = time.perf_counter()
    slam = System(cfg, use_loop_closing=True, device=device)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with recorded_relocalizers() as rec, mono_waits(slam) as waits:
        ms_frame, calls = run_frames(slam, [(g,) for g in frames], timed=True,
                                     track="track_mono")
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    attempts = rec.calls
    tracked = len(slam.metrics)
    states = [m["state"] for m in slam.metrics]
    _, poses = slam.frame_trajectory()
    est = camera_centers(poses)
    moved = np.linalg.norm(est, axis=1) > 1e-6
    ate = umeyama_alignment(est[moved], gt[moved], fix_scale=False)[4] \
        if moved.sum() >= 3 else float("inf")
    n_points = int(slam.map.pt_valid.sum())

    second = System(cfg, use_loop_closing=True, device=device)
    with sync_waits_allowed(second.loop_closer), \
            mono_waits(second) as waits2:
        n_sync, where = count_host_syncs(second, [(g,) for g in frames],
                                         track="track_mono")
    del second
    init_ms = [round(ms, 2) for ms, _ in waits.calls]
    log(f"mono: {tracked} tracked frames after {len(waits.calls)} "
        f"initialization attempts ({init_ms} ms, synchronized; the "
        f"successful one {[round(ms, 2) for ms, ok in waits.calls if ok]} "
        f"ms), keyframes {slam.kf_seq}, live {slam.n_live_kf}, points "
        f"{n_points}, mapping calls {len(calls)}, vocabulary "
        f"{slam.loop_closer.vocab is not None and slam.loop_closer.vocab.n_words}"
        f" words, loop candidates {slam.loop_closer.n_candidates} (free "
        f"scale: {not slam.loop_closer.fix_scale}), loops closed "
        f"{slam.n_loops_closed}, relocalization attempts {len(attempts)}; "
        f"the System took {build_ms:.1f} ms to build (solver warm-ups "
        f"included)")
    log(f"mono: {ms_frame:.3f} ms/frame over frames {WARMUP}-{N_MONO - 1} "
        f"(host clock, synchronized; a 30 Hz camera gives 33.3), Sim3 ATE "
        f"{ate:.5f} m over {int(moved.sum())} frames after initialization, "
        f"peak device memory {peak / 2**20:.1f} MiB, launches {launches}")
    log(f"mono: second run: {len(waits2.calls)} initialization attempts and "
        f"{waits2.retirements} retirements waited (allowed), sync warnings "
        f"elsewhere {n_sync} {where}")
    if not any(ok for _, ok in waits.calls) or slam.state != OK \
            or any(s != OK for s in states[1:]):
        raise RuntimeError(f"mono: did not initialize or lost track: "
                           f"states {states}")
    if tracked + len(waits.calls) != N_MONO:
        raise RuntimeError(f"mono: {tracked} tracked + {len(waits.calls)} "
                           f"initialization frames, expected {N_MONO}")
    if slam.loop_closer.fix_scale:
        raise RuntimeError("mono: the loop closer fixes the scale")
    if slam.kf_seq < 2 or n_points <= MONO_MIN_POINTS:
        raise RuntimeError(f"mono: {slam.kf_seq} keyframes, {n_points} "
                           f"points")
    if not ate <= MONO_ATE_BOUND_M:
        raise RuntimeError(f"mono: ATE {ate:.5f} m above {MONO_ATE_BOUND_M}")
    if launches != {"pose_opt": 2 * (tracked + len(attempts)),
                    "keypoints": N_MONO}:
        raise RuntimeError(f"mono: launches {launches}")
    if peak > MONO_PEAK_BYTES:
        raise RuntimeError(f"mono: peak memory {peak / 2**20:.1f} MiB above "
                           f"1 GiB")
    if n_sync or waits2.retirements > N_MONO:
        raise RuntimeError(f"mono: {n_sync} synchronizing calls outside the "
                           f"allowed waits: {where}")
    init_card_vs_cpu(cfg, frames, device)
    return launches


class explore_probes:
    """Inside the ``with``, the exploration run is instrumented without
    changing what it computes: the renderer records each fed pose and
    its host time; ``slam.track_rgbd`` its host time and the track steps
    it runs; the waits the run may make (the first ``WARMUP`` frames, as
    every phase's sync count leaves them out: the first initializes the
    map, and the first frames make the per-device constants of the
    320x240 pyramid; each state read's flush, each step's one copy
    ``explorer.read_step``, each LOST frame with its relocalization
    attempt, the loop closer's vocabulary training, verifications and
    corrections) run with the sync debug mode off, timed and counted by
    kind; ``astar_plan`` and ``goals_from_mask`` are timed."""

    KINDS = ("warm_up", "state_read", "step_copy", "lost_frame",
             "vocabulary", "verification", "correction")

    def __init__(self, slam, explorer):
        self.slam, self.explorer = slam, explorer
        self.poses, self.render_s, self.track_s = [], 0.0, 0.0
        self.track_steps, self.read_s, self._in_track = 0, 0.0, False
        self.waits = {k: 0 for k in self.KINDS}
        self.wait_s = {k: 0.0 for k in self.KINDS}
        self.plan_s = {"goals": 0.0, "astar": 0.0}

    def _quiet(self, kind, fn, when=None):
        import torch

        def call(*args, **kw):
            if when is not None and not when():
                return fn(*args, **kw)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                self.wait_s[kind] += dt
                self.waits[kind] += 1
                if kind == "state_read" and not self._in_track:
                    self.read_s += dt
                torch.cuda.set_sync_debug_mode(mode)
        return call

    def _timed(self, key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.plan_s[key] += time.perf_counter() - t0
        return call

    def __enter__(self):
        from active_orb_slam2_tpu_torch.models.system import LOST
        slam, ex, lc = self.slam, self.explorer, self.slam.loop_closer
        self._saved = {n: getattr(ex, n) for n in
                       ("render_rgbd", "read_step", "astar_plan",
                        "goals_from_mask")}
        render, track, step = ex.render_rgbd, slam.track_rgbd, \
            slam.track_step

        def recorded_render(world, cam, Twc, *a, **kw):
            self.poses.append(np.array(Twc, np.float64))
            t0 = time.perf_counter()
            out = render(world, cam, Twc, *a, **kw)
            self.render_s += time.perf_counter() - t0
            return out

        def timed_track(*args):
            t0 = time.perf_counter()
            self._in_track = True
            try:
                return track(*args)
            finally:
                self._in_track = False
                self.track_s += time.perf_counter() - t0

        def counted_step(*args):
            self.track_steps += 1
            return step(*args)

        ex.render_rgbd = recorded_render
        ex.read_step = self._quiet("step_copy", ex.read_step)
        ex.astar_plan = self._timed("astar", ex.astar_plan)
        ex.goals_from_mask = self._timed("goals", ex.goals_from_mask)
        slam.track_rgbd = self._quiet(
            "warm_up", timed_track, when=lambda: len(self.poses) <= WARMUP)
        slam.track_step = counted_step
        slam.flush = self._quiet("state_read", slam.flush)
        slam._dispatch_track = self._quiet(
            "lost_frame", slam._dispatch_track,
            when=lambda: slam._state == LOST)
        lc.ensure_vocabulary = self._quiet("vocabulary", lc.ensure_vocabulary)
        lc.compute_sim3 = self._quiet("verification", lc.compute_sim3)
        lc.correct = self._quiet("correction", lc.correct)
        self._track_step = step
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self.explorer, n, fn)
        for n in ("track_rgbd", "flush", "_dispatch_track"):
            delattr(self.slam, n)
        self.slam.track_step = self._track_step
        for n in ("ensure_vocabulary", "compute_sim3", "correct"):
            delattr(self.slam.loop_closer, n)


def synced_ms(fn, reps=5):
    """Median host time (ms) of ``fn`` synchronized at both ends, after a
    warm-up call; and the peak device memory one call allocates above
    what was allocated before it."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return float(np.median(times)), torch.cuda.max_memory_allocated() - base


def explore_bounds(m, spec, n_poses, n_ray_samples=48):
    """Bounds (ms, by) of the occupancy grid and of the scorer of
    ``n_poses`` poses on arena ``m``, from this map's data: the observed
    (keyframe, point) rays and the valid points (what the work needs)."""
    K, F = m.kf_point.shape
    pt = m.kf_point.clamp(min=0).long()
    n_obs = int(((m.kf_point >= 0) & m.kf_valid[:, None]
                 & m.pt_valid[pt]).sum())
    n_pts = int(m.pt_valid.sum())
    cells = spec.width * spec.height
    grid = bound(n_obs * (GRID_FLOP_SAMPLE * n_ray_samples
                          + GRID_FLOP_END),
                 K * F * 4 + K * (28 + 1) + n_obs * (1 + 8) + cells)
    scorer = bound(n_poses * n_pts * SCORE_FLOP_PAIR,
                   n_poses * (28 + 4) + n_pts * (12 + 12 + 4 + 4 + 1))
    return grid, scorer, n_obs, n_pts


def planning_step(m, spec, cam, start_cell, min_features=30):
    """One planning step of ``run_exploration`` on map ``m`` (its
    device): (grid, localizability [H', W', 8], goals, path)."""
    from active_orb_slam2_tpu_torch.active import (
        build_occupancy_grid, build_visibility_scorer)
    from active_orb_slam2_tpu_torch.active.explorer import (
        plan_step, read_step)
    _, grid, fm, loc = read_step(build_occupancy_grid(spec),
                                 build_visibility_scorer(cam), m, spec)
    goals, _, path = plan_step(grid, fm, loc, spec, start_cell,
                               min_features)
    return grid, loc, goals, path


def phase_explore(device, arena):
    """The active-exploration layer: ``examples/run_exploration.py``'s
    configuration on the card for all its steps (bars, launches, waits
    by kind, other host syncs, times, ATE), one planning step of its
    final map on the card against the CPU, and the grid and the scorer
    timed on ``arena`` (the mapping slice's saved map)."""
    import torch
    from active_orb_slam2_tpu_torch.active import (
        build_occupancy_grid, build_visibility_scorer, explorer,
        frontier_mask, score_grid_localizability)
    from active_orb_slam2_tpu_torch.examples.run_exploration import (
        N_BOXES, START_XZ, exploration_config)
    from active_orb_slam2_tpu_torch.io.synthetic import default_world
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models import convert
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    from active_orb_slam2_tpu_torch.models.system import OK, System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    cfg, spec = exploration_config()
    t0 = time.perf_counter()
    slam = System(cfg, use_loop_closing=True, device=device)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    n_sync, where = 0, []
    with recorded_relocalizers() as rec, \
            explore_probes(slam, explorer) as probe, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            xlog = explorer.run_exploration(
                slam, default_world(n_boxes=N_BOXES), spec,
                n_steps=EXPLORE_STEPS, start_xz=START_XZ)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        slam.flush()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            n_sync += 1
            if len(where) < 8:
                where.append(f"{w.filename}:{w.lineno}")
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated()
    attempts = rec.calls
    fed = len(probe.poses)
    tracked = len(slam.metrics)
    states = [r["state"] for r in slam.metrics]
    ok_frames = [0] + [r["frame"] for r in slam.metrics if r["state"] == OK]
    _, poses = slam.frame_trajectory()
    gt = np.stack([T[:3, 3] for T in probe.poses])
    if poses.shape != (fed, 7) or not np.isfinite(poses).all():
        raise RuntimeError(f"explore: trajectory malformed: {poses.shape}")
    ate = umeyama_alignment(camera_centers(poses[ok_frames]), gt[ok_frames],
                            fix_scale=True)[4]
    steps = len(xlog.positions)
    lc = slam.loop_closer
    track_ms = (probe.track_s + probe.read_s) / fed * 1e3
    log(f"explore: {steps} steps, {xlog.replans} replans, {fed} frames fed, "
        f"{probe.track_steps} track steps, {tracked} retired "
        f"({states.count(OK)} OK), keyframes {slam.kf_seq}"
        f" (live {slam.n_live_kf}), loops closed {slam.n_loops_closed} "
        f"(candidates {lc.n_candidates}, vocabulary trainings "
        f"{lc._vocab_stage}), relocalization attempts "
        f"{len(attempts)} ({[(a['ok'], a['n_inliers']) for a in attempts]})"
        f"; the System took {build_ms:.1f} ms to build")
    log(f"explore: coverage {[round(c, 4) for c in xlog.coverage]}, points "
        f"{xlog.n_points}, positions {[(round(x, 3), round(z, 3)) for x, z in xlog.positions]}")
    log(f"explore: run {wall_s:.2f} s, of which render {probe.render_s:.2f} s"
        f" (host numpy), tracking {track_ms:.3f} ms/frame (track_rgbd and "
        f"the state read after it, render kept out), step copy "
        f"{probe.wait_s['step_copy'] / max(steps, 1) * 1e3:.3f} ms/step "
        f"(grid, frontier mask and scorer enqueued and read in one copy), "
        f"goals {probe.plan_s['goals'] / max(steps, 1) * 1e3:.3f} ms/step, "
        f"A* {probe.plan_s['astar'] / max(xlog.replans, 1) * 1e3:.3f} "
        f"ms/step; ATE {ate:.5f} m (rigid, {len(ok_frames)} tracked "
        f"frames); peak device memory {peak / 2**20:.1f} MiB; launches "
        f"{launches}")
    log(f"explore: waits (allowed; calls by kind) {probe.waits}, their "
        f"host seconds {({k: round(v, 3) for k, v in probe.wait_s.items()})}"
        f"; sync warnings elsewhere {n_sync} {where}")
    if steps < EXPLORE_MIN_POSITIONS or xlog.replans < 1:
        raise RuntimeError(f"explore: {steps} positions, {xlog.replans} "
                           f"replans")
    if not (xlog.coverage[-1] > xlog.coverage[0]
            and xlog.n_points[-1] >= xlog.n_points[0]):
        raise RuntimeError("explore: coverage or points did not grow")
    if peak > EXPLORE_PEAK_BYTES:
        raise RuntimeError(f"explore: peak memory {peak / 2**20:.1f} MiB "
                           f"above 1 GiB")
    if launches != {"pose_opt": 2 * (probe.track_steps + len(attempts)),
                    "keypoints": fed}:
        raise RuntimeError(f"explore: launches {launches}, expected K1 "
                           f"2 x ({probe.track_steps} + {len(attempts)}), "
                           f"K2 {fed}")
    if n_sync:
        raise RuntimeError(f"explore: {n_sync} synchronizing calls outside "
                           f"the allowed waits: {where}")
    if probe.waits["step_copy"] != steps:
        raise RuntimeError(f"explore: {probe.waits['step_copy']} step "
                           f"copies for {steps} steps")

    # each step's device stages on the final map, synchronized
    occupancy = build_occupancy_grid(spec)
    scorer = build_visibility_scorer(cfg.camera)
    m = slam.map
    grid = occupancy(m)
    step_stages = {
        "grid": synced_ms(lambda: occupancy(m))[0],
        "scorer": synced_ms(lambda: score_grid_localizability(
            scorer, m, spec, headings=8, cell_stride=2))[0],
        "frontier_mask": synced_ms(lambda: frontier_mask(grid))[0],
        "step_copy": synced_ms(lambda: explorer.read_step(
            occupancy, scorer, m, spec))[0]}
    log(f"explore: on the final map, ms per call (median of 5, "
        f"synchronized): {step_stages}")

    # one planning step of the final map, card against CPU
    x, z = xlog.positions[-1]
    start = (int((z - spec.origin_z) / spec.resolution),
             int((x - spec.origin_x) / spec.resolution))
    card = planning_step(m, spec, cfg.camera, start)
    cpu = planning_step(MapState(*[t.cpu() for t in m]), spec, cfg.camera,
                        start)
    grid_agree = float((card[0] == cpu[0]).mean())
    diff = np.abs(card[1].astype(np.int64) - cpu[1])
    score_agree = float((diff == 0).mean())
    log(f"explore card vs CPU: grid cells equal {grid_agree:.5f}, scores "
        f"equal {score_agree:.5f} of {diff.size} (max diff "
        f"{int(diff.max())}), goals {len(card[2])}/{len(cpu[2])} equal "
        f"{card[2] == cpu[2]}, path {card[3]} / equal {card[3] == cpu[3]}")
    if grid_agree < EXPLORE_GRID_AGREE or score_agree < EXPLORE_SCORE_AGREE \
            or diff.max() > EXPLORE_SCORE_ATOL:
        raise RuntimeError("explore: grid or scores, card and CPU disagree")
    if card[2] != cpu[2] or card[3] != cpu[3]:
        raise RuntimeError("explore: goals or path, card and CPU disagree")
    del slam, m

    # the grid and the scorer on the mapping slice's arena
    big = convert.map_from_jax_numpy(arena, device)
    grid_b, scorer_b, n_obs, n_pts = explore_bounds(
        big, spec, spec.width * spec.height * 2)
    big_ms = {"grid": synced_ms(lambda: occupancy(big)),
              "scorer": synced_ms(lambda: score_grid_localizability(
                  scorer, big, spec, headings=8, cell_stride=2))}
    for name, b in (("grid", grid_b), ("scorer", scorer_b)):
        ms, mem = big_ms[name]
        log(f"explore full arena ({big.kf_point.shape[0]} keyframes x "
            f"{big.kf_point.shape[1]} features, {big.pt_xyz.shape[0]} point "
            f"slots; {n_obs} observed rays, {n_pts} valid points): {name} "
            f"{ms:.3f} ms (median of 5, synchronized), peak {mem / 2**20:.1f}"
            f" MiB above the arena, bound {b[0]:.6f} ms by {b[1]}")
        if mem > EXPLORE_PEAK_BYTES:
            raise RuntimeError(f"explore: full-arena {name} peak "
                               f"{mem / 2**20:.1f} MiB above 1 GiB")
    return launches


def sharded_match_inputs(M, N, device, seed=5):
    """Random descriptors [M, 8] and [N, 8] (int32 bits) with validity;
    half the targets copy a query with 0-15% of its bits flipped."""
    import torch
    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    dt = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    flip = rng.random((N // 2, 256)) < rng.uniform(0, 0.15, (N // 2, 1))
    dt[:N // 2] = dq[rng.choice(M, N // 2, replace=False)] ^ np.packbits(
        flip, axis=1, bitorder="little").view(np.uint32)
    vq, vt = rng.random(M) > 0.01, rng.random(N) > 0.01
    return tuple(torch.from_numpy(a).to(device) for a in (
        dq.view(np.int32), vq, dt.view(np.int32), vt))


def sharded_bytes(size):
    """Bytes one rank reduces in a sharded global BA call (float32 and
    int32): the inlier count [K], then per LM iteration Hcc, g, D and chi2
    packed [78 K + 1], a [K, 6] vector per CG step and the trial chi2."""
    K = size["K"]
    return 4 * K + size["iters"] * 4 * (78 * K + 1 + size["cg"] * 6 * K + 1)


def sharded_problem(size, device):
    from scripts.bench_torch_ba_scaling import anchor_ordered, build_problem
    return anchor_ordered(build_problem(size["K"], size["P"], size["O"],
                                        device=device))


def _sharded_rank(rank, device_type, size):
    """One of the ranks of phase 17 (spawned; gloo): the sharded global BA
    and the sharded matcher on this problem, each called once to warm up
    and once timed.  Returns numpy results and the times."""
    import torch
    from active_orb_slam2_tpu_torch.parallel import (
        build_distributed_ba, build_sharded_matcher, make_mesh)
    from scripts.bench_torch_ba_scaling import CAM
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    mesh = make_mesh()
    prob = sharded_problem(size, device)
    fn = build_distributed_ba(mesh, CAM, iters=size["iters"],
                              cg_iters=size["cg"])
    out = {"mesh": str(mesh)}
    for what, call, args in (
            ("ba", fn, prob),
            ("match", build_sharded_matcher(mesh, max_dist=50.0, ratio=1.0),
             sharded_match_inputs(size["M"], size["N"], device))):
        call(*args)
        call.shards.calls = call.shards.bytes = 0
        sync()
        t0 = time.perf_counter()
        res = call(*args)
        sync()
        out[what] = [a.cpu().numpy() for a in res]
        out[what + "_ms"] = (time.perf_counter() - t0) * 1e3
        out[what + "_calls"] = (call.shards.calls, call.shards.bytes)
    out["peak"] = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    return out


def phase_sharded_gba(device, size=SHARDED):
    """Phase 17: the sharded global BA at KITTI-00 scale, anchor-block
    ordered: (a) ``global_ba`` by PCG and by the dense solve (ms per LM
    iteration, peak memory, the error against the poses the observations
    fit); (b) ``build_distributed_ba`` over an in-process NCCL world of one
    rank, bit for bit (a)'s PCG with both in deterministic mode, and timed;
    (c) two spawned gloo ranks sharing the card, held against (a); (d) the
    sharded matcher on those ranks against ``match_mutual`` on the card."""
    import torch
    import torch.distributed as dist
    from active_orb_slam2_tpu_torch.ops.matching import (
        _best_two, hamming_matrix, match_mutual)
    from active_orb_slam2_tpu_torch.parallel import (
        build_distributed_ba, global_ba, make_mesh)
    from active_orb_slam2_tpu_torch.parallel.mesh import (
        join_group, spawn_ranks)
    from scripts.bench_torch_ba_scaling import CAM, fitted_poses
    it, cg = size["iters"], size["cg"]
    reset_launches()
    t_phase = time.perf_counter()
    prob = sharded_problem(size, device)
    fit = fitted_poses(prob[0])
    err0 = float(torch.linalg.vector_norm(prob[0][1:] - fit[1:]))
    what = (f"K={size['K']}, P={size['P']}, O={size['O']}, {it} LM "
            f"iterations of {cg} CG steps")
    a = {}
    for solve in ("pcg", "dense"):
        def call():
            a[solve] = global_ba(CAM, *prob, iters=it, cg_iters=cg,
                                 dense=solve == "dense")
        ms, peak = synced_ms(call, reps=3)
        err = float(torch.linalg.vector_norm(a[solve][0][1:] - fit[1:]))
        log(f"sharded GBA (a) global_ba {solve} ({what}): "
            f"{ms / it:.3f} ms per LM iteration (median of 3 calls, "
            f"synchronized), peak {peak / 2**20:.1f} MiB above the inputs, "
            f"chi2 {float(a[solve][2]):.1f}, pose error {err0:.4f} -> "
            f"{err:.4f}")
        if not all(bool(torch.isfinite(x).all()) for x in a[solve]) \
                or err >= SHARDED_ERR_SHRINK * err0:
            raise RuntimeError(f"sharded GBA (a): {solve} did not cut the "
                               f"pose error by half ({err0} -> {err})")

    with tempfile.TemporaryDirectory() as tmp:
        join_group("nccl", "file://" + os.path.join(tmp, "store"), 1, 0,
                   device.index or 0)
        try:
            fn = build_distributed_ba(make_mesh(), CAM, iters=it,
                                      cg_iters=cg)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                det = global_ba(CAM, *prob, iters=it, cg_iters=cg)
                b = fn(*prob)
            finally:
                torch.use_deterministic_algorithms(False)
            same = all(torch.equal(x, y) for x, y in zip(det, b))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*prob)
            torch.cuda.synchronize()
            b_ms = (time.perf_counter() - t0) * 1e3 / it
        finally:
            dist.destroy_process_group()
    drift = [float((x - y).abs().max()) for x, y in zip(det, a["pcg"])]
    log(f"sharded GBA (b) build_distributed_ba over NCCL, world 1: "
        f"{b_ms:.3f} ms per LM iteration (one call, synchronized); "
        f"bit-identical to global_ba (both deterministic): {same}; the "
        f"deterministic run against (a)'s: poses {drift[0]:.3g}, points "
        f"{drift[1]:.3g} m, chi2 {drift[2] / float(det[2]):.3g} relative")
    if not same:
        raise RuntimeError("sharded GBA (b): the NCCL world-1 result is not "
                           "global_ba's bit for bit")

    t0 = time.perf_counter()
    ranks = spawn_ranks(_sharded_rank, size["ranks"], "gloo",
                        args=(device.type, size), timeout=600)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks[1:]:
        for key in ("ba", "match"):
            if not all(np.array_equal(x, y) for x, y in zip(r[key], r0[key])):
                raise RuntimeError(f"sharded GBA: the ranks' {key} results "
                                   f"differ")
    poses, pts, chi2 = (torch.from_numpy(x).to(device) for x in r0["ba"])
    ref = a["pcg"]
    dp = float((poses - ref[0]).abs().max())
    dx = float((pts - ref[1]).abs().max())
    dc = abs(float(chi2) - float(ref[2])) / abs(float(ref[2]))
    err = float(torch.linalg.vector_norm(poses[1:] - fit[1:]))
    calls, nbytes = r0["ba_calls"]
    log(f"sharded GBA (c) {size['ranks']} gloo ranks on one card "
        f"({r0['mesh']}; spawned, run and joined in {spawn_s:.1f} s): "
        + ", ".join(f"rank {i} {r['ba_ms'] / it:.3f}" for i, r in
                    enumerate(ranks))
        + f" ms per LM iteration (one call, synchronized); "
        f"{(calls - 1) / it:g} collectives and "
        f"{(nbytes - 4 * size['K']) / it:g} bytes reduced per LM iteration (after one of the inlier counts, "
        f"{4 * size['K']} B); peak {r0['peak'] / 2**20:.1f} MiB a rank; "
        f"against (a) pcg: poses {dp:.3g}, points {dx:.3g} m, chi2 "
        f"{dc:.3g} relative; pose error {err0:.4f} -> {err:.4f}")
    if dp > SHARDED_POSE_ATOL or dx > SHARDED_POINT_ATOL_M \
            or dc > SHARDED_CHI2_RTOL or err >= SHARDED_ERR_SHRINK * err0 \
            or calls != 1 + it * (cg + 2) or nbytes != sharded_bytes(size):
        raise RuntimeError("sharded GBA (c): the two ranks part from "
                           "global_ba beyond the bars")

    dq, vq, dt, vt = sharded_match_inputs(size["M"], size["N"], device)
    d = hamming_matrix(dq, dt, vq, vt)
    ref_idx, ref_dist = match_mutual(d, max_dist=50.0, ratio=1.0)
    jbest = _best_two(d)[2]
    tied = ((d == d.amin(0)).sum(0) > 1)[jbest]
    del d
    idx, dist_ = (torch.from_numpy(x).to(device) for x in r0["match"])
    differ = idx != ref_idx
    bad = int((differ & ~tied).sum())
    log(f"sharded GBA (d) sharded matcher, M={size['M']}, N={size['N']}, "
        f"{size['ranks']} ranks: {r0['match_ms']:.3f} ms a call "
        f"(synchronized, rank 0), {int((ref_idx >= 0).sum())} reference "
        f"matches, {int((idx >= 0).sum())} sharded; {int(differ.sum())} "
        f"rows differ, {bad} of them outside the {int(tied.sum())} rows "
        f"whose best column's minimum is tied; "
        f"distances equal: {bool(torch.equal(dist_, ref_dist))}")
    if bad or not torch.equal(dist_, ref_dist) or r0["match_calls"][0] != 1:
        raise RuntimeError("sharded GBA (d): the sharded matcher parts from "
                           "match_mutual")
    launches = kernel_launches()
    if any(launches.values()):
        raise RuntimeError(f"sharded GBA: the path launched a kernel "
                           f"({launches})")
    log(f"sharded GBA: neither kernel launched; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_op_floor(device):
    """``bench_torch.ba_op_floor_evidence`` once, before the profiler of
    phase 18 can slow it: the chained matvec's ms a link, the float32
    matmul's TFLOP/s, ``global_ba``'s marginal ms and ops per CG step."""
    t0 = time.perf_counter()
    ev = bench_torch.ba_op_floor_evidence(device)
    log(f"op floor: {ev}; phase {time.perf_counter() - t0:.1f} s")
    if not all(np.isfinite(v) and v > 0 for v in ev.values()):
        raise RuntimeError(f"op floor: {ev}")
    return ev


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from active_orb_slam2_tpu_torch.kernels import build
    from active_orb_slam2_tpu_torch.utils import trace

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
        else f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on; the port needs full float32")

    trace.enable()
    build.library()
    trace.disable()
    build_ms, = trace.durations_ms(("setup.kernels",))["setup.kernels"]
    trace.reset()
    log(f"build: {build_ms / 1e3:.2f} s (the setup.kernels span: nvcc, one "
        f"per source, side by side, or the cached libraries loaded) -> "
        f"{build.build_info['paths']}")
    for line in build.build_info["ptxas"].splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            log(f"  ptxas: {line.strip()}")

    cfg = vga_config()
    t0 = time.perf_counter()
    frames, gt = render_frames()
    log(f"rendered {N_FRAMES} VGA frames in {time.perf_counter() - t0:.1f} s "
        f"(process pool)")
    t0 = time.perf_counter()
    distorted, test_distorted = render_distorted_frames()
    log(f"rendered and warped {N_FRAMES} distorted VGA frames in "
        f"{time.perf_counter() - t0:.1f} s (process pool)")
    t0 = time.perf_counter()
    loop_frames, loop_traj = render_loop_frames()
    log(f"rendered {N_LOOP} VGA frames of the loop circle in "
        f"{time.perf_counter() - t0:.1f} s (process pool)")
    t0 = time.perf_counter()
    mono_frames, mono_gt = render_mono_frames()
    log(f"rendered {N_MONO} VGA frames of the mono orbit in "
        f"{time.perf_counter() - t0:.1f} s (process pool)")
    t0 = time.perf_counter()
    pairs, pairs_gt = render_pairs()
    log(f"rendered {N_STEREO_LOOP} KITTI-shape stereo pairs in "
        f"{time.perf_counter() - t0:.1f} s (process pool)")
    t0 = time.perf_counter()
    retrain_cfg, retrain_cache = retrain_frames()
    log(f"rendered the tour's {len(retrain_cache)} unique poses at 320x240 "
        f"in {time.perf_counter() - t0:.1f} s (process pool)")

    checks = {"pose_opt": phase_k1(device, cfg.camera),
              "keypoints": phase_k2(device, cfg, frames[0][0])}
    p8, checks["pose_opt"]["extra"]["bound_ms_p8"] = phase_k1_batched(
        device, cfg.camera)
    checks["pose_opt"]["variants"]["ms_p8"] = p8
    runs = {"launches": phase_slice(device, cfg, frames, gt)}
    phase_graphs(device, cfg, frames)
    map_slam, runs["mapping_launches"] = phase_mapping_slice(device, frames,
                                                             gt)
    phase_mapping_step(map_slam)
    arena = map_slam.checkpoint()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        map_slam.save_map(path)
        del map_slam
        runs["distorted_launches"] = phase_distorted(
            device, distorted, test_distorted, gt)
        del distorted, test_distorted
        runs["full_launches"] = phase_arena_full(device, frames, gt)
        phase_create_points(device)
        runs["reloc_launches"] = phase_relocalization(device, frames, gt)
        reuse_slam, runs["reuse_launches"] = phase_map_reuse(
            device, path, frames, gt)
    phase_reloc_card_vs_cpu(reuse_slam, frames)
    del reuse_slam
    runs["stereo_launches"], k2_kitti, \
        checks["keypoints"]["extra"]["bound_ms_kitti"], k2_err = phase_stereo(
            device, pairs, pairs_gt)
    checks["keypoints"]["variants"]["ms_kitti"] = k2_kitti
    checks["keypoints"]["max_abs_err"] = max(
        checks["keypoints"]["max_abs_err"], k2_err)
    runs["stereo_loop_launches"] = phase_stereo_loop(device, pairs, pairs_gt)
    del pairs
    runs["loop_launches"] = phase_loop_pipeline(device, loop_frames,
                                                loop_traj)
    runs["closure_launches"] = phase_closure(device, loop_frames, loop_traj)
    runs["retrain_launches"] = phase_retrain(device, retrain_cfg,
                                             retrain_cache)
    del retrain_cache
    runs["mono_launches"] = phase_mono(device, mono_frames, mono_gt)
    runs["explore_launches"] = phase_explore(device, arena)
    del arena
    phase_sharded_gba(device)
    phase_op_floor(device)
    times = phase_timing(checks)

    kernels = [
        dict(name="pose_opt", route="cuda",
             source="active_orb_slam2_tpu_torch/csrc/pose_opt.cu",
             replaces="active_orb_slam2_tpu/ops/pose_opt_kernel.py:227",
             **{k: v["pose_opt"] for k, v in runs.items()},
             **times["pose_opt"]),
        dict(name="keypoints", route="cuda",
             source="active_orb_slam2_tpu_torch/csrc/keypoints.cu",
             replaces="active_orb_slam2_tpu/ops/patches.py:57",
             **{k: v["keypoints"] for k, v in runs.items()},
             **times["keypoints"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
