#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one card: the counterpart of the
JAX package's ``bench.py``, window for window.  Run from the root of a
checkout on a machine with a CUDA card:

    python3 bench_torch.py              # on cuda:0; raises without a card
    python3 bench_torch.py --device cpu # a rehearsal of the code paths

Prints one JSON line with the keys of ``bench.py``'s record (the
``parsed`` object of ``BENCH_r05.json``), in the same units, and a
``device`` object: the card's ``name``, ``power_limit_w`` and ``count``
from ``nvidia-smi``, or ``{"name": "cpu"}`` for a rehearsal, whose times
are the CPU's and no device metric.  Progress and extra diagnostics
(peak device memory per window, the construction of each ``System``)
go to stderr as ``[bench ...]`` lines.

The windows, as in ``bench.py``:

* ``tracking_window``: 42 VGA orbit frames, 1024 features, mapping off,
  a 64 / 16,384 arena; 6 warm-up frames, then three windows of one
  continuous run and one final drain (``System.flush`` and
  ``torch.cuda.synchronize``), host clock;
* ``mapping_timing``: ms per keyframe-mapping call on the tracking
  window's arena, each call on a fresh copy, synchronized, median of 5;
* ``full_pipeline_window``: the default 512 / 65,536 arena, mapping and
  loop closing on, 72 frames, the last third timed; stage medians with
  ``System.profile_stages`` over the last third of the warm-up;
* ``stereo_kitti_shape``: 1226x370, 2000 features, 150 pairs of a
  closed circuit (rendered in a process pool), mapping and loop closing
  on, the last 30 timed: frames/s, rigid ATE, keyframes, loops closed;
* ``ba_roofline``: ``global_ba`` LM iterations/s at 48 / 8,192 / 8 by
  PCG and at 512 / 65,536 / 8 by the dense Schur solve and by PCG, with
  ``ba_flops_per_iter``'s FLOP per iteration;
* ``ba_op_floor_evidence``: a [3072] matvec chained 20 times (the
  per-op floor), a [3072, 3072] float32 matmul chain (TF32 off) in
  TFLOP/s, both between CUDA events, and ``global_ba``'s marginal ms
  per CG step (``cg_iters`` 40 against 8, 4 LM iterations) with the
  PyTorch operations a CG step dispatches;
* ``mesh_scaling_efficiency``: ``scripts/bench_torch_ba_scaling.py mesh``
  with 8 gloo ranks on the CPU (the counterpart of the JAX virtual
  8-device CPU mesh): efficiency at 8 ranks and T1 / T8.

Unlike ``bench.py``, which records a failed window as ``None`` and goes
on, a window that fails here ends the run with a nonzero exit after the
laps before it were printed.  Imports nothing of JAX.
"""

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.abspath(__file__))
_T0 = time.time()

BASELINE_MS = 30.0         # the reference tracks a VGA frame in ~30 ms
MAPPING_BUDGET_MS = 400.0  # bench.py's keyframe-mapping budget
# H100 SXM, float32 outside the tensor cores (NVIDIA's data sheet, at
# 700 W); bench.py assumed 45 TFLOP/s for the TPU
PEAK_F32_TFLOPS = 67.0
N_TRACK_FRAMES = 42
N_PIPELINE_FRAMES = 72
WARMUP = 6
ORBIT_STEP_DEG = 0.8
STEREO_BASELINE_M = 0.12
N_STEREO = 150
N_STEREO_TIMED = 30
MESH_RANKS = 8


def _lap(msg):
    print(f"[bench {time.time() - _T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)


def _lap_peak(what, device):
    if torch.device(device).type == "cuda":
        _lap(f"{what}: peak device memory "
             f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")


# ------------------------------------------------------------ configurations

def vga_camera():
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    return CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                        width=640, height=480)


def tracking_config(cam=None):
    """``bench.py:381-396``: VGA, 1024 features, 8 levels, ThDepth 8, a
    64 / 16,384 arena."""
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    return SlamConfig(
        camera=cam or vga_camera(),
        orb=OrbConfig(n_features=1024, n_levels=8),
        tracking=TrackingConfig(th_depth=8.0),
        map=MapConfig(max_keyframes=64, max_points=16384,
                      local_ba_keyframes=8, local_ba_points=2048))


def full_pipeline_config(cam=None):
    """``bench.py:113-118``: a keyframe at least every 8 frames and the
    default 512 / 65,536 arena."""
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    return SlamConfig(
        camera=cam or vga_camera(),
        orb=OrbConfig(n_features=1024, n_levels=8),
        tracking=TrackingConfig(th_depth=8.0, kf_max_interval=8),
        map=MapConfig())


def stereo_config():
    """``bench.py::stereo_kitti_shape``: 1226x370, f=707, baseline 0.12 m,
    2000 features, 8 levels, ThDepth 35 baselines, a keyframe at least
    every 8 frames, the default arena."""
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    w, h, f = 1226, 370, 707.0
    cam = CameraParams(fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
                       bf=f * STEREO_BASELINE_M, width=w, height=h)
    return SlamConfig(
        camera=cam, orb=OrbConfig(n_features=2000, n_levels=8),
        tracking=TrackingConfig(th_depth=35.0 * STEREO_BASELINE_M,
                                kf_max_interval=8),
        map=MapConfig())


# ----------------------------------------------------------------- rendering

def _pool():
    return multiprocessing.get_context("spawn").Pool(
        min(8, os.cpu_count() or 1))


def _render_orbit_frame(i):
    """Frame i of the 0.8-degree VGA orbit (runs in a worker process)."""
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, orbit_trajectory, render_rgbd)
    Twc = orbit_trajectory(i + 1, step_deg=ORBIT_STEP_DEG)[i]
    g, d = render_rgbd(default_world(), vga_camera(), Twc)
    return (np.clip(g, 0, 255).astype(np.uint8),
            np.clip(d * 1e3, 0, 65535).astype(np.uint16))


def render_orbit(n_frames):
    """``make_sequence``'s first ``n_frames`` noise-free frames of the
    0.8-degree VGA orbit, rendered in a pool of fresh processes, and the
    true centres."""
    from active_orb_slam2_tpu_torch.io.synthetic import orbit_trajectory
    with _pool() as pool:
        frames = pool.map(_render_orbit_frame, range(n_frames))
    return frames, np.stack([T[:3, 3].astype(np.float64) for T in
                             orbit_trajectory(n_frames,
                                              step_deg=ORBIT_STEP_DEG)])


def _render_pair(i):
    """Pair i of the KITTI-shape circuit (runs in a worker process): the
    right eye is the left pose moved by the baseline along its x axis;
    one ray a pixel."""
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, loop_trajectory, render_rgbd)
    Twc = loop_trajectory(N_STEREO, radius=2.5)[i]
    right = Twc.copy()
    right[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array(
        [STEREO_BASELINE_M, 0.0, 0.0], np.float32)
    cam = stereo_config().camera
    return tuple(np.clip(render_rgbd(default_world(n_boxes=0), cam, T,
                                     supersample=1)[0], 0,
                         255).astype(np.uint8) for T in (Twc, right))


def render_pairs():
    """The 150 pairs of ``bench.py``'s circuit (no boxes, radius 2.5 m),
    rendered in a pool of fresh processes, and the true centres."""
    from active_orb_slam2_tpu_torch.io.synthetic import loop_trajectory
    with _pool() as pool:
        pairs = pool.map(_render_pair, range(N_STEREO))
    return pairs, np.stack([T[:3, 3].astype(np.float64) for T in
                            loop_trajectory(N_STEREO, radius=2.5)])


# ------------------------------------------------------------------- windows

def _system(cfg, device, **kw):
    from active_orb_slam2_tpu_torch.models.system import System
    t0 = time.perf_counter()
    slam = System(cfg, device=device, **kw)
    _lap(f"System({', '.join(f'{k}={v}' for k, v in kw.items())}) built in "
         f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return slam


def tracking_window(frames, cfg, device="cuda"):
    """Tracking-path ms/frame with mapping off: 6 warm-up frames, then
    three windows of one continuous run and one final drain.  Returns
    (ms/frame over the three windows with the drain, the three windows'
    ms/frame, the ``System``)."""
    slam = _system(cfg, device, use_mapping=False)
    for i in range(WARMUP):
        slam.track_rgbd(*frames[i], i / 30.0)
    slam.flush()
    sync(device)
    _reset_peak(device)
    _lap("measuring tracking path")
    per_window = (len(frames) - WARMUP) // 3
    marks = [time.perf_counter()]
    for w in range(3):
        for i in range(WARMUP + w * per_window, WARMUP + (w + 1) * per_window):
            slam.track_rgbd(*frames[i], i / 30.0)
        marks.append(time.perf_counter())
    slam.flush()                    # retires every frame
    sync(device)                   # and waits for the work after them
    t_end = time.perf_counter()
    window_ms = [(marks[w + 1] - marks[w]) / per_window * 1e3
                 for w in range(3)]
    total_ms = (t_end - marks[0]) / (3 * per_window) * 1e3
    for w, ms in enumerate(window_ms):
        _lap(f"window {w}: {ms:.2f} ms/frame")
    _lap(f"steady state incl. final drain: {total_ms:.2f} ms/frame")
    _lap_peak("tracking window", device)
    return total_ms, window_ms, slam


def mapping_timing(slam, reps=5):
    """ms per keyframe-mapping call (triangulation, fusion, point culling,
    local BA, keyframe culling) on ``slam``'s arena and newest keyframe:
    each call on a fresh copy of the arena, synchronized, median of
    ``reps`` after one untimed call."""
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    _lap("mapping-step timing")
    base = MapState(*[t.clone() for t in slam.map])
    k, seq = max(slam.last_kf_slot, 0), slam.kf_seq
    device = base.kf_valid.device
    times = []
    for r in range(reps + 1):
        m = MapState(*[t.clone() for t in base])
        sync(device)
        t0 = time.perf_counter()
        slam.keyframe_mapping(m, k, seq)
        sync(device)
        if r:
            times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    _lap(f"mapping step: {ms:.2f} ms per call (median of {reps})")
    return ms


def full_pipeline_window(frames, device="cuda", cfg=None):
    """Deployment-shape window: mapping and loop closing on, the default
    arena; the last third of the frames (at least 12) timed after a
    drain, stage medians (each stage's first sample dropped) taken with
    ``profile_stages`` over the last third of the warm-up.  Returns
    (ms/frame, keyframes inserted, stage medians in ms)."""
    slam = _system(cfg or full_pipeline_config(), device,
                   use_mapping=True, use_loop_closing=True)
    _reset_peak(device)
    n = len(frames)
    measure = max(n // 3, 12)
    warm = n - measure
    stage_hist = {}
    for i in range(warm):
        slam.profile_stages = i >= (2 * warm) // 3
        slam.track_rgbd(*frames[i], i / 30.0)
        for k, v in slam.stage_ms.items():
            stage_hist.setdefault(k, []).append(v)
        slam.stage_ms = {}
        if i % 16 == 0:
            _lap(f"full-pipeline warmup {i} (kf={slam.kf_seq})")
    slam.profile_stages = False
    slam.flush()
    sync(device)
    _lap(f"measuring full pipeline ({slam.kf_seq} KFs after warmup)")
    t0 = time.perf_counter()
    for i in range(warm, n):
        slam.track_rgbd(*frames[i], i / 30.0)
    slam.flush()
    sync(device)
    ms = (time.perf_counter() - t0) / measure * 1e3
    stage_ms = {k: float(np.median(v[1:] if len(v) > 1 else v))
                for k, v in stage_hist.items()}
    _lap(f"full pipeline: {ms:.2f} ms/frame ({slam.kf_seq} KFs) "
         f"stages={stage_ms}")
    _lap_peak("full pipeline", device)
    return ms, slam.kf_seq, stage_ms


def stereo_kitti_shape(device="cuda", cfg=None, pairs=None, gt=None,
                       n_timed=N_STEREO_TIMED):
    """``System.track_stereo`` with mapping and loop closing on over the
    pairs (by default ``render_pairs()`` at ``stereo_config()``), the last
    ``n_timed`` timed after a drain.  Returns (frames/s, rigid ATE in m,
    keyframes inserted, loops closed)."""
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.geometry.horn import umeyama_alignment
    if pairs is None:
        _lap(f"stereo KITTI-shape: rendering {N_STEREO} stereo pairs")
        pairs, gt = render_pairs()
    slam = _system(cfg or stereo_config(), device, use_mapping=True,
                   use_loop_closing=True)
    _reset_peak(device)
    n = len(pairs)
    warm = n - n_timed
    for i in range(warm):
        slam.track_stereo(*pairs[i], i / 10.0)
        if i % 24 == 0:
            _lap(f"stereo warmup {i} (kf={slam.kf_seq})")
    slam.flush()
    sync(device)
    t0 = time.perf_counter()
    for i in range(warm, n):
        slam.track_stereo(*pairs[i], i / 10.0)
    slam.flush()
    sync(device)
    fps = n_timed / (time.perf_counter() - t0)
    _, poses = slam.frame_trajectory()
    ate = umeyama_alignment(camera_centers(poses), gt, fix_scale=True)[4]
    _lap(f"stereo KITTI-shape: {fps:.2f} fps ate={ate:.4f} "
         f"kf={slam.kf_seq} loops={slam.n_loops_closed}")
    _lap_peak("stereo KITTI-shape", device)
    return fps, ate, slam.kf_seq, slam.n_loops_closed


def _ba_script():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import bench_torch_ba_scaling
    return bench_torch_ba_scaling


def ba_roofline(device="cuda", small=(48, 8192, 8), big=(512, 65_536, 8),
                iters=10):
    """``global_ba`` LM iterations/s and achieved FLOP/s: ``small`` by PCG
    (5 timed calls), ``big`` by the dense Schur solve (3) and by PCG (2).
    Returns (small iters/s, small FLOP/s, big dense iters/s, big dense
    FLOP/s, big PCG iters/s)."""
    from active_orb_slam2_tpu_torch.parallel.dist_ba import global_ba
    bs = _ba_script()

    def measure(K, Pn, O, reps, dense):
        prob = bs.build_problem(K=K, Pn=Pn, O=O, device=device)
        global_ba(bs.CAM, *prob, iters=iters, dense=dense)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            global_ba(bs.CAM, *prob, iters=iters, dense=dense)
        sync(device)
        its = iters * reps / (time.perf_counter() - t0)
        return its, bs.ba_flops_per_iter(K=K, Pn=Pn, O=O) * its

    _reset_peak(device)
    s_its, s_fl = measure(*small, reps=5, dense=False)
    _lap(f"BA small (pcg): {s_its:.1f} iters/s")
    b_its, b_fl = measure(*big, reps=3, dense=True)
    _lap(f"BA big (dense): {b_its:.1f} iters/s")
    p_its, _ = measure(*big, reps=2, dense=False)
    _lap(f"BA big (pcg): {p_its:.1f} iters/s")
    _lap_peak("BA roofline", device)
    return s_its, s_fl, b_its, b_fl, p_its


def chained_ms(fn, reps, device):
    """(span, host enqueue) in ms a call of ``fn`` over ``reps`` queued
    calls after one warm-up call: the span between two CUDA events on the
    card, the host clock on the CPU (where the two are the same)."""
    fn()
    sync(device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue = (time.perf_counter() - t0) * 1e3 / reps
    if not on_card:
        return enqueue, enqueue
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, enqueue


class _OpCounter(TorchDispatchMode):
    """Counts the PyTorch operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ba_op_floor_evidence(device="cuda", n=3072, problem=(512, 65_536, 8),
                         reps=20):
    """The per-op floor against the arithmetic ceiling: ms per link of a
    chained [n] matvec (``per_op_ms``), the chained [n, n] float32 matmul's
    TFLOP/s (``matmul_3072_tflops``; TF32 must be off), ``global_ba``'s
    marginal ms per CG step at ``problem`` (``cg_iters`` 40 against 8, 4
    LM iterations: ``cg_iter_marginal_ms``) and the PyTorch operations
    one CG step dispatches (``cg_body_ops``)."""
    from active_orb_slam2_tpu_torch.parallel.dist_ba import global_ba
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on; the probe measures float32")
    rng = np.random.default_rng(0)
    A = rng.normal(0, 1, (n, 256)).astype(np.float32)
    M = torch.from_numpy(A @ A.T + np.eye(n, dtype=np.float32) * 10).to(device)
    b = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)).to(device)
    c = [torch.zeros((), device=device)]

    def chained(f):
        def link():
            c[0] = c[0] + f(b + c[0]).sum()
        return link

    per_op = chained_ms(chained(lambda v: M @ v), reps, device)[0]
    mm_ms = chained_ms(chained(lambda v: (M + v[0]) @ M), reps, device)[0]
    mm_tflops = 2 * n ** 3 / (mm_ms * 1e-3) / 1e12

    bs = _ba_script()
    prob = bs.build_problem(*problem, device=device)

    def wall(cg):
        global_ba(bs.CAM, *prob, iters=4, cg_iters=cg)
        sync(device)
        t0 = time.perf_counter()
        global_ba(bs.CAM, *prob, iters=4, cg_iters=cg)
        sync(device)
        return time.perf_counter() - t0

    def ops(cg):
        with _OpCounter() as count:
            global_ba(bs.CAM, *prob, iters=4, cg_iters=cg)
        return count.n

    cg_marginal = (wall(40) - wall(8)) / (4 * 32) * 1e3
    body_ops = (ops(40) - ops(8)) / (4 * 32)
    ev = {"per_op_ms": per_op, "matmul_3072_tflops": mm_tflops,
          "cg_iter_marginal_ms": cg_marginal, "cg_body_ops": body_ops}
    _lap(f"BA op floor: {ev}")
    return ev


def mesh_scaling_efficiency(ranks=MESH_RANKS, timeout=900):
    """``scripts/bench_torch_ba_scaling.py mesh`` with ``ranks`` gloo ranks
    on the CPU, in a subprocess: (efficiency at ``ranks``, T1 / T_ranks).
    The ranks share the host's cores, so the ideal efficiency is
    1 / ranks; T1 / T_ranks isolates the sharding's overhead."""
    out = subprocess.run(
        [sys.executable, os.path.join("scripts", "bench_torch_ba_scaling.py"),
         "mesh", "--ranks", str(ranks), "--backend", "gloo", "--device",
         "cpu"], capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    if out.returncode != 0:
        raise RuntimeError(f"mesh scaling failed ({out.returncode}): "
                           f"{out.stderr[-2000:]}")
    times, eff = {}, None
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if "time_s" in d:
            times[d["ranks"]] = d["time_s"]
            if d["ranks"] == ranks:
                eff = d["efficiency"]
    _lap(f"mesh scaling: seconds by ranks {times}")
    return eff, times[1] / times[ranks]


def device_info(device):
    """The card's name, power limit (W) and count from ``nvidia-smi``, or
    ``{"name": "cpu"}``."""
    if torch.device(device).type != "cuda":
        return {"name": "cpu"}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0]),
            "count": torch.cuda.device_count()}


def make_record(tracking, mapping_ms, full, stereo, ba, floor, mesh,
                device):
    """``bench.py``'s record from the windows' results, with ``device``."""
    total_ms, window_ms = tracking
    fp_ms, fp_kfs, fp_stages = full
    st_fps, st_ate, st_kf, st_loops = stereo
    s_its, s_fl, b_its, b_fl, p_its = ba
    eff, t1_over_t8 = mesh
    return {
        "metric": "rgbd_tracking_throughput_vga_1024feat",
        "value": 1e3 / total_ms,
        "unit": "frames/s",
        "vs_baseline": BASELINE_MS / total_ms,
        "tracking_window_ms": window_ms,
        "mapping_ms_per_kf": mapping_ms,
        "mapping_budget_ok": bool(mapping_ms < MAPPING_BUDGET_MS),
        "full_pipeline_fps": 1e3 / fp_ms,
        "full_pipeline_kfs": int(fp_kfs),
        "full_pipeline_stage_ms": fp_stages,
        "stereo_kitti_shape_fps": st_fps,
        "stereo_kitti_shape_ate_m": st_ate,
        "stereo_kitti_shape_kfs": int(st_kf),
        "stereo_kitti_shape_loops": int(st_loops),
        "ba_iters_per_s": s_its,
        "ba_est_tflops": s_fl / 1e12,
        "ba_global_iters_per_s_512kf_65kpt": p_its,
        "ba_global_iters_per_s_dense": b_its,
        "ba_global_est_tflops": b_fl / 1e12,
        "ba_mfu_estimate": b_fl / (PEAK_F32_TFLOPS * 1e12),
        "ba_peak_tflops_assumed": PEAK_F32_TFLOPS,
        "ba_op_floor_evidence": floor,
        "scaling_efficiency_at_8_virtual": eff,
        "scaling_t1_over_t8_shared_cores": t1_over_t8,
        "device": device,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu rehearses the code paths; its times are the "
                         "CPU's")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device (--device cpu "
                         "rehearses on the CPU)")
    device = torch.device(a.device, 0) if a.device == "cuda" \
        else torch.device("cpu")
    info = device_info(device)
    _lap(f"device {info}")

    _lap("rendering frames")
    frames, _ = render_orbit(N_PIPELINE_FRAMES)
    _lap("frames ready")
    total_ms, window_ms, slam = tracking_window(
        frames[:N_TRACK_FRAMES], tracking_config(), device)
    mapping_ms = mapping_timing(slam)
    del slam
    full = full_pipeline_window(frames, device)
    del frames
    stereo = stereo_kitti_shape(device)
    ba = ba_roofline(device)
    floor = ba_op_floor_evidence(device)
    _lap("mesh scaling (subprocess)")
    mesh = mesh_scaling_efficiency()
    print(json.dumps(make_record((total_ms, window_ms), mapping_ms, full,
                                 stereo, ba, floor, mesh, info)))


if __name__ == "__main__":
    main()
