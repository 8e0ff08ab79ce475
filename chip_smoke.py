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
4. the slice: ``System(cfg, use_mapping=False).track_rgbd`` over 42 VGA
   frames of the synthetic orbit (the JAX package's ``bench.py``
   tracking-window configuration), checking every frame tracks, that
   the main path launched both kernels, and the ATE against ground
   truth;
5. timing: each kernel's device time and its plain version's, after
   the slice so that the profiler's overhead cannot reach the slice.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launch count in the slice and its device time beside its plain
version's; the last line is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
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


def vga_config():
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    cam = CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                       width=640, height=480)
    return SlamConfig(
        camera=cam, orb=OrbConfig(n_features=1024, n_levels=8),
        tracking=TrackingConfig(th_depth=8.0),
        map=MapConfig(max_keyframes=64, max_points=16384,
                      local_ba_keyframes=8, local_ba_points=2048))


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


def count_host_syncs(cfg, device, frames):
    """Synchronizing CUDA calls made by a second run of the slice after
    its warm-up frames.  The sync debug mode slows every operation, so
    it stays out of the timed run."""
    import torch
    from active_orb_slam2_tpu_torch.models.system import System
    slam = System(cfg, use_mapping=False, device=device)
    n = 0
    for i, (g, d) in enumerate(frames):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if i >= WARMUP:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                slam.track_rgbd(g, d, i / 30.0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n += sum("called a synchronizing CUDA operation" in str(w.message)
                 for w in caught)
    slam.flush()
    return n


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
    n_sync_warnings = count_host_syncs(cfg, device, frames)

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
    times = phase_timing(checks)

    kernels = [
        dict(name="pose_opt", route="cuda",
             source="active_orb_slam2_tpu_torch/csrc/pose_opt.cu",
             replaces="active_orb_slam2_tpu/ops/pose_opt_kernel.py:227",
             launches=launches["pose_opt"], **times["pose_opt"]),
        dict(name="keypoints", route="cuda",
             source="active_orb_slam2_tpu_torch/csrc/keypoints.cu",
             replaces="active_orb_slam2_tpu/ops/patches.py:57",
             launches=launches["keypoints"], **times["keypoints"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
