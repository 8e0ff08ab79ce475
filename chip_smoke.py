#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``active_orb_slam2_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises, and so exits nonzero, on failure):

1. device and build: requires CUDA, prints the card's name and power
   limit, builds the kernels from ``active_orb_slam2_tpu_torch/csrc``;
2. K1, the fused pose optimization kernel, against its plain PyTorch
   version on 20 seeded problems at E=1024 plus edge cases;
3. K2, the keypoint kernel, against its plain version on the 8 levels
   of a rendered VGA frame;
4. the tracking slice: ``System(cfg, use_mapping=False).track_rgbd``
   over 42 VGA frames of the synthetic orbit (the JAX package's
   ``bench.py`` tracking-window configuration), checking every frame
   tracks, that the main path launched both kernels, and the ATE
   against ground truth;
5. the mapping slice: ``System(cfg_map).track_rgbd`` with local mapping
   on the same frames (``bench.py``'s full-pipeline configuration
   without loop closing: default 512-keyframe arena, a keyframe at
   least every 8 frames), with its launch counts, ATE, keyframe count,
   ms/frame, peak device memory, and host syncs counted on a second run;
6. one keyframe-mapping call on the card against the same call on the
   CPU, from the final arena of the mapping slice, and its time;
7. an arena-full run (8 keyframes, a keyframe every 2 frames), where
   keyframe culling, forced eviction and slot recycling run, with its
   launch counts, and the card-vs-CPU check on the arena of its first
   keyframe-mapping call that culled a keyframe;
8. the card-vs-CPU check on three aligned keyframes, where point
   creation acts at full rate (on the orbit it creates a few points or
   none; ROADMAP queue 3, item h);
9. timing: each kernel's device time and its plain version's, last, so
   that the profiler's overhead cannot reach the runs before.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launch counts in the tracking slice, the mapping slice and the
arena-full run (``launches``, ``mapping_launches``, ``full_launches``)
and its device time beside its plain version's; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time
import warnings

import numpy as np

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
FULL_MIN_CULLS = 5           # arena-full run: keyframes culled
CREATE_MIN_POINTS = 256      # aligned keyframes: points created (cap 512)


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
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    cam = CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                       width=640, height=480)
    tracking, arena = {
        "tracking": (TrackingConfig(th_depth=8.0),
                     MapConfig(max_keyframes=64, max_points=16384,
                               local_ba_keyframes=8, local_ba_points=2048)),
        "mapping": (TrackingConfig(th_depth=8.0, kf_max_interval=8),
                    MapConfig()),
        "full": (TrackingConfig(th_depth=8.0, kf_max_interval=2),
                 MapConfig(max_keyframes=8, max_points=16384,
                           local_ba_keyframes=8, local_ba_points=2048)),
    }[kind]
    return SlamConfig(camera=cam, orb=OrbConfig(n_features=1024, n_levels=8),
                      tracking=tracking, map=arena)


def render_frames(cam):
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, make_sequence, orbit_trajectory)
    frames, gt = [], []
    for g, d, Twc in make_sequence(
            N_FRAMES, cam, world=default_world(),
            trajectory=orbit_trajectory(N_FRAMES, step_deg=0.8)):
        frames.append((np.clip(g, 0, 255).astype(np.uint8),
                       np.clip(d * 1e3, 0, 65535).astype(np.uint16)))
        gt.append(Twc[:3, 3].astype(np.float64))
    return frames, np.stack(gt)


def k1_problem(rng, cam, E, device, kind="noisy"):
    """One seeded motion-only BA problem: pw [E, 3], obs [E, 3] with
    noise and 10% gross outliers, mixed mono/stereo, levels 0-7."""
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
    obs = np.stack([u, v, u - cam.bf / z], -1) + rng.normal(0, 0.5, (E, 3))
    out = rng.random(E) < 0.1
    obs[out] += rng.uniform(20, 80, (int(out.sum()), 3))
    level = rng.integers(0, 8, E)
    stereo = rng.random(E) < 0.5
    valid = np.zeros(E, bool) if kind == "invalid" else rng.random(E) < 0.95
    pose0 = np.concatenate([q_true, t_true + rng.normal(0, 0.03, 3)])

    def t(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device)
    return (t(pose0, torch.float32), t(pw, torch.float32),
            t(obs, torch.float32), t(level, torch.int32),
            t(stereo, torch.bool), t(valid, torch.bool))


def phase_k1(device, cam):
    import torch
    from active_orb_slam2_tpu_torch.kernels.pose_opt import pose_opt_cuda
    from active_orb_slam2_tpu_torch.ops.pose_opt_kernel import (
        kernel_inputs, pose_optimization_fused, pose_optimization_fused_torch)
    rng = np.random.default_rng(1)
    kinds = ["noisy"] * 20 + ["invalid", "behind"]
    worst_pose, worst_agree = 0.0, 1.0
    for i, kind in enumerate(kinds):
        args = k1_problem(rng, cam, 1024, device, kind)
        res_k = pose_optimization_fused(cam, *args)
        res_p = pose_optimization_fused_torch(cam, *args)
        torch.cuda.synchronize()
        err = float((res_k.pose - res_p.pose).abs().max())
        agree = float((res_k.inliers == res_p.inliers).float().mean())
        if not torch.isfinite(res_k.pose).all():
            raise RuntimeError(f"K1 problem {i} ({kind}): non-finite pose")
        log(f"  K1 problem {i:2d} {kind:7s}: pose err {err:.3e} "
            f"inlier agreement {agree:.4f} inliers {int(res_k.n_inliers)}"
            f"/{int(res_p.n_inliers)} chi2 {float(res_k.chi2):.3f}"
            f"/{float(res_p.chi2):.3f}")
        worst_pose = max(worst_pose, err)
        worst_agree = min(worst_agree, agree)
    if worst_pose > K1_POSE_ATOL or worst_agree < K1_INLIER_AGREE:
        raise RuntimeError(f"K1 disagrees with its plain version: pose err "
                           f"{worst_pose:.3e}, inlier agreement {worst_agree}")
    log(f"K1 ok: max pose err {worst_pose:.3e}, min inlier agreement "
        f"{worst_agree:.4f}")
    args = k1_problem(np.random.default_rng(2), cam, 1024, device)
    inputs = kernel_inputs(*args)
    return {"max_abs_err": worst_pose, "what": "E=1024",
            "kernel": lambda: pose_opt_cuda(cam, *inputs, 4, 10),
            "call": lambda: pose_optimization_fused(cam, *args),
            "plain": lambda: pose_optimization_fused_torch(cam, *args)}


def phase_k2(device, cfg, gray):
    import torch
    from active_orb_slam2_tpu_torch.kernels.keypoints import (
        keypoint_stage_cuda)
    from active_orb_slam2_tpu_torch.ops import orb
    from active_orb_slam2_tpu_torch.ops.fast import fast_score_map, nms3x3
    from active_orb_slam2_tpu_torch.ops.image import pad_image, resize_bilinear
    ocfg = cfg.orb
    img = torch.tensor(gray, dtype=torch.float32, device=device)
    sizes = orb.level_sizes(*gray.shape, ocfg)
    n_per = orb.features_per_level(ocfg)
    _, _, taps, gauss = orb.device_constants(device)
    levels = []
    for lvl, (h, w) in enumerate(sizes):
        li = resize_bilinear(img, h, w)
        score = orb.threshold_fallback(nms3x3(fast_score_map(li)), ocfg)
        ys, xs, _ = orb.detect_level(score, n_per[lvl], ocfg)
        levels.append((pad_image(li, ocfg.pad), ys, xs))
    worst_ang, bits_eq, bits_all = 0.0, 0, 0
    for lvl, (padded, ys, xs) in enumerate(levels):
        ang_k, desc_k = keypoint_stage_cuda(padded, ys, xs, ocfg.pad, taps,
                                            gauss)
        ang_p, desc_p = orb.keypoint_stage_torch(padded, ys, xs, ocfg.pad)
        torch.cuda.synchronize()
        d = torch.remainder(ang_k - ang_p + np.pi, 2 * np.pi) - np.pi
        err = float(d.abs().max())
        diff = desc_k.cpu().numpy().view(np.uint32) \
            ^ desc_p.cpu().numpy().view(np.uint32)
        nbad = int(np.unpackbits(diff.view(np.uint8)).sum())
        log(f"  K2 level {lvl}: K={ys.shape[0]:4d} {tuple(padded.shape)} "
            f"angle err {err:.3e} differing bits {nbad}/{diff.size * 32}")
        worst_ang = max(worst_ang, err)
        bits_eq += diff.size * 32 - nbad
        bits_all += diff.size * 32
    agree = bits_eq / bits_all
    if worst_ang > K2_ANGLE_ATOL or agree < K2_BIT_AGREE:
        raise RuntimeError(f"K2 disagrees with its plain version: angle err "
                           f"{worst_ang:.3e}, bit agreement {agree:.6f}")

    log(f"K2 ok: max angle err {worst_ang:.3e}, bit agreement {agree:.6f}")

    def kernel():
        return [keypoint_stage_cuda(p, y, x, ocfg.pad, taps, gauss)
                for p, y, x in levels]
    return {"max_abs_err": worst_ang, "what": "all 8 levels of one VGA frame",
            "kernel": kernel, "call": kernel,
            "plain": lambda: [orb.keypoint_stage_torch(p, y, x, ocfg.pad)
                              for p, y, x in levels]}


def phase_timing(checks):
    """Each kernel's device time beside its plain version's, and the
    span of one call of each.  The plain versions' device times come
    last: ``torch.profiler`` leaves per-launch overhead behind it."""
    for c in checks.values():
        c["ms"] = kernel_ms(c["kernel"])
        c["spans"] = (time_ms(c["call"]), time_ms(c["plain"]))
    for name, c in checks.items():
        c["plain_ms"] = device_ms(c["plain"])
        log(f"{name} ({c['what']}): device time {c['ms']:.4f} ms kernel, "
            f"{c['plain_ms']:.4f} ms plain; call span (median of 50) "
            f"{c['spans'][0]:.4f} ms kernel call, {c['spans'][1]:.4f} ms "
            f"plain")
    return {name: {k: c[k] for k in ("max_abs_err", "ms", "plain_ms")}
            for name, c in checks.items()}


def count_host_syncs(cfg, device, frames, use_mapping=False):
    """Synchronizing CUDA calls made by a second run of a slice after
    its warm-up frames, and the first few places that made them.  The
    sync debug mode slows every operation, so it stays out of the timed
    run."""
    import torch
    from active_orb_slam2_tpu_torch.models.system import System
    slam = System(cfg, use_mapping=use_mapping, device=device)
    n, where = 0, []
    for i, (g, d) in enumerate(frames):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if i >= WARMUP:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                slam.track_rgbd(g, d, i / 30.0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        for w in caught:
            if "called a synchronizing CUDA operation" in str(w.message):
                n += 1
                if len(where) < 8:
                    where.append(f"frame {i} {w.filename}:{w.lineno}")
    slam.flush()
    return n, where


def phase_slice(device, cfg, frames, gt):
    import torch
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.kernels.keypoints import (
        keypoint_stage_cuda)
    from active_orb_slam2_tpu_torch.kernels.pose_opt import pose_opt_cuda
    from active_orb_slam2_tpu_torch.models.system import OK, System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment

    slam = System(cfg, use_mapping=False, device=device)
    keypoint_stage_cuda.launches = 0
    pose_opt_cuda.launches = 0
    for i, (g, d) in enumerate(frames):
        if i == WARMUP:
            slam.flush()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        slam.track_rgbd(g, d, i / 30.0)
    slam.flush()
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t0) / (N_FRAMES - WARMUP) * 1e3
    launches = {"pose_opt": pose_opt_cuda.launches,
                "keypoints": keypoint_stage_cuda.launches}
    n_sync_warnings, _ = count_host_syncs(cfg, device, frames)

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
        f"(host clock, synchronized), ATE {ate:.5f} m, "
        f"sync warnings in steady state {n_sync_warnings}")
    log(f"slice: launches {launches}")
    tracked = N_FRAMES - 1
    if len(states) != tracked or any(s != OK for s in states) \
            or final_state != OK:
        raise RuntimeError("not every tracked frame retired OK")
    if launches["pose_opt"] != 2 * tracked:
        raise RuntimeError(f"K1 launched {launches['pose_opt']} times, "
                           f"expected {2 * tracked}")
    if launches["keypoints"] != cfg.orb.n_levels * N_FRAMES:
        raise RuntimeError(f"K2 launched {launches['keypoints']} times, "
                           f"expected {cfg.orb.n_levels * N_FRAMES}")
    if not ate <= ATE_BOUND_M:
        raise RuntimeError(f"ATE {ate:.5f} m above {ATE_BOUND_M} m")
    return launches


def run_frames(slam, frames, timed=False):
    """Track every frame; returns (ms/frame over frames WARMUP.. on the
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
    for i, (g, d) in enumerate(frames):
        if timed and i == WARMUP:
            slam.flush()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        slam.track_rgbd(g, d, i / 30.0)
    slam.flush()
    torch.cuda.synchronize()
    ms = None if t0 is None else \
        (time.perf_counter() - t0) / (len(frames) - WARMUP) * 1e3
    return ms, calls


def trajectory_ate(slam, gt):
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    _, poses = slam.frame_trajectory()
    if poses.shape != (N_FRAMES, 7) or not np.isfinite(poses).all():
        raise RuntimeError(f"trajectory malformed: {poses.shape}")
    return umeyama_alignment(camera_centers(poses), gt, fix_scale=True)[4]


def check_all_ok(slam, what):
    from active_orb_slam2_tpu_torch.models.system import OK
    states = [m["state"] for m in slam.metrics]
    if len(states) != N_FRAMES - 1 or any(s != OK for s in states) \
            or slam.state != OK:
        raise RuntimeError(f"{what}: not every tracked frame retired OK")


def phase_mapping_slice(device, frames, gt):
    """``System(cfg_map).track_rgbd`` with local mapping on."""
    import torch
    from active_orb_slam2_tpu_torch.kernels.keypoints import (
        keypoint_stage_cuda)
    from active_orb_slam2_tpu_torch.kernels.pose_opt import pose_opt_cuda
    from active_orb_slam2_tpu_torch.models.system import System
    cfg = vga_config("mapping")
    slam = System(cfg, use_mapping=True, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    keypoint_stage_cuda.launches = 0
    pose_opt_cuda.launches = 0
    ms_frame, calls = run_frames(slam, frames, timed=True)
    launches = {"pose_opt": pose_opt_cuda.launches,
                "keypoints": keypoint_stage_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    inliers = [m["n_inliers"] for m in slam.metrics]
    ate = trajectory_ate(slam, gt)
    n_sync, where = count_host_syncs(cfg, device, frames, use_mapping=True)
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
    if launches["keypoints"] != cfg.orb.n_levels * N_FRAMES:
        raise RuntimeError(f"mapping slice: K2 launched "
                           f"{launches['keypoints']} times, expected "
                           f"{cfg.orb.n_levels * N_FRAMES}")
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
    the call's time on the card (median of 5 calls, each on a fresh copy
    of the arena, synchronized)."""
    import torch
    from active_orb_slam2_tpu_torch.models.local_mapping import (
        build_keyframe_mapping)
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    cfg = slam.cfg
    base = MapState(*[t.clone() for t in slam.map])
    k, seq = slam.last_kf_slot, slam.kf_seq
    card_vs_cpu(cfg, base, k, seq, "mapping step, final arena")
    step = build_keyframe_mapping(cfg)
    times = []
    for _ in range(5):
        m = MapState(*[t.clone() for t in base])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(m, k, seq)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    log(f"mapping step: {ms:.2f} ms per call on the card (median of 5, "
        f"synchronized)")
    return ms


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
    from active_orb_slam2_tpu_torch.kernels.keypoints import (
        keypoint_stage_cuda)
    from active_orb_slam2_tpu_torch.kernels.pose_opt import pose_opt_cuda
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
    keypoint_stage_cuda.launches = 0
    pose_opt_cuda.launches = 0
    _, calls = run_frames(slam, frames)
    launches = {"pose_opt": pose_opt_cuda.launches,
                "keypoints": keypoint_stage_cuda.launches}
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
    if launches["keypoints"] != cfg.orb.n_levels * N_FRAMES:
        raise RuntimeError(f"arena-full run: K2 launched "
                           f"{launches['keypoints']} times, expected "
                           f"{cfg.orb.n_levels * N_FRAMES}")
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from active_orb_slam2_tpu_torch.kernels import build

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

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_info['seconds']:.2f} s) -> {build.build_info['path']}")
    for line in build.build_info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    cfg = vga_config()
    t0 = time.perf_counter()
    frames, gt = render_frames(cfg.camera)
    log(f"rendered {N_FRAMES} VGA frames in {time.perf_counter() - t0:.1f} s")

    checks = {"pose_opt": phase_k1(device, cfg.camera),
              "keypoints": phase_k2(device, cfg, frames[0][0])}
    launches = phase_slice(device, cfg, frames, gt)
    map_slam, map_launches = phase_mapping_slice(device, frames, gt)
    phase_mapping_step(map_slam)
    del map_slam
    full_launches = phase_arena_full(device, frames, gt)
    phase_create_points(device)
    times = phase_timing(checks)

    kernels = [
        dict(name="pose_opt", route="cuda",
             source="active_orb_slam2_tpu_torch/csrc/pose_opt.cu",
             replaces="active_orb_slam2_tpu/ops/pose_opt_kernel.py:227",
             launches=launches["pose_opt"],
             mapping_launches=map_launches["pose_opt"],
             full_launches=full_launches["pose_opt"], **times["pose_opt"]),
        dict(name="keypoints", route="cuda",
             source="active_orb_slam2_tpu_torch/csrc/keypoints.cu",
             replaces="active_orb_slam2_tpu/ops/patches.py:57",
             launches=launches["keypoints"],
             mapping_launches=map_launches["keypoints"],
             full_launches=full_launches["keypoints"],
             **times["keypoints"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
