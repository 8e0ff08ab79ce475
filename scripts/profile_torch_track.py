#!/usr/bin/env python3
"""Where the time of the PyTorch port's tracking goes, on one CUDA card:
the counterpart of the JAX package's ``scripts/profile_track.py``,
``profile_track_stages.py``, ``profile_device_stages.py`` and
``profile_r3.py``.  Run from the root of a checkout:

    python3 scripts/profile_torch_track.py [--json PATH]

The configuration is ``bench_torch.py``'s tracking window (VGA, 1024
features, 8 levels, a 64 / 16,384 arena, mapping off) over its 42
orbit frames, rendered in a process pool.

1. The fused step, frames 6-41 after 6 warm-up frames: synchronized per
   frame (``track_rgbd``, ``flush``, ``torch.cuda.synchronize``; median
   ms) and pipelined (``bench_torch.tracking_window``'s steady state,
   ms/frame with the final drain).
2. On the pipelined run's final arena, with frame 41 built and tracked
   once more, each item below timed with CUDA events over 20 chained
   calls after one warm-up call (``bench_torch.chained_ms``: the span a
   call, and the host's enqueue time a call):
   - the bare launch-and-synchronize round trip (one small kernel);
   - the frame's upload (``System._upload``: pinned memory,
     non-blocking copies);
   - the frame pipeline (``System.make_rgbd``), then by stage: the
     bilinear pyramid, the FAST score map with 3x3 NMS and the
     iniTh/minTh fallback, the per-cell top-k, the keypoint stage (K2)
     and the depth sampling (``frame_from_features``), and, apart, the
     undistortion of the frame's keypoints under TUM fr1's distortion;
   - the track step (``build_track_step``, keyframe insertion off as in
     the window), then by stage: ``in_frustum`` over the arena, the
     local-map candidate selection, ``search_by_projection`` of the
     motion stage and of the local-map stage, each of the two K1
     launches (``pose_optimization_fused``), the local-keyframe vote and
     the keyframe decision and insertion (``create_keyframe``, masked).
   The inputs of the stages are the ones the step gave them on this
   frame, captured by wrapping the functions it calls; the vote and the
   candidate selection, which are not functions of their own, repeat
   the step's operations on the previous frame's associations.  The
   sum of the stages is printed beside the synchronized step.
3. Last, since work timed after it reads slow: ``torch.profiler`` over
   12 steady frames of a fresh run (frames 30-41): ops a frame, device
   busy (the union of the kernel, copy and fill intervals), the span
   and the idle share, and the 10 device operations that took longest;
   then each stage's device busy and ops under the profiler (3 calls,
   ``profile_torch_mapping.device_profile``).

Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import profile_torch_mapping  # noqa: E402

REPS = 20
PROFILED_FRAMES = 12
# TUM fr1's radtan coefficients (tests/test_undistort.py:23)
TUM_FR1_DIST = (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)


def roundtrip_ms(device, reps=REPS):
    """Host-clock ms of one small kernel and a synchronize."""
    x = torch.zeros(1, device=device)
    x.add_(1)
    bench_torch.sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        x.add_(1)
        bench_torch.sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def fused_step_runs(frames, cfg, device):
    """Synchronized per-frame ms (median over frames 6-41) and the
    pipelined steady state; returns them and the pipelined run's
    ``System``."""
    from active_orb_slam2_tpu_torch.models.system import System
    slam = System(cfg, use_mapping=False, device=device)
    per_frame = []
    for i, (g, d) in enumerate(frames):
        bench_torch.sync(device)
        t0 = time.perf_counter()
        slam.track_rgbd(g, d, i / 30.0)
        slam.flush()
        bench_torch.sync(device)
        if i >= bench_torch.WARMUP:
            per_frame.append((time.perf_counter() - t0) * 1e3)
    pipelined, windows, slam = bench_torch.tracking_window(frames, cfg,
                                                           device)
    return {"synchronized_ms": float(np.median(per_frame)),
            "pipelined_ms": pipelined, "pipelined_windows_ms": windows}, slam


class captured:
    """Wraps ``names`` of ``module`` so each call's arguments are kept
    (in call order) while inside the ``with`` block."""

    def __init__(self, module, *names):
        self.module, self.names, self.calls = module, names, []

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            def wrap(*a, _fn=fn, _n=n, **kw):
                self.calls.append((_n, _fn, a, kw))
                return _fn(*a, **kw)
            setattr(self.module, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)

    def of(self, name):
        return [(fn, a, kw) for n, fn, a, kw in self.calls if n == name]



def frame_stages(slam, g, d):
    """The frame pipeline on frame (g, d) and its stages as callables,
    and apart the upload and an undistortion of its keypoints."""
    from active_orb_slam2_tpu_torch.models.frame import frame_from_features
    from active_orb_slam2_tpu_torch.ops import orb
    from active_orb_slam2_tpu_torch.ops.fast import fast_score_map, nms3x3
    from active_orb_slam2_tpu_torch.ops.image import resize_bilinear
    from active_orb_slam2_tpu_torch.ops.undistort import undistort_points
    cfg, cam = slam.cfg, slam.cfg.camera
    g_t, d_t = slam._upload(g, d)
    img = g_t.to(torch.float32)
    depth = d_t.to(torch.float32) * torch.tensor(1e-3, dtype=torch.float32)
    sizes = orb.level_sizes(cam.height, cam.width, cfg.orb)
    n_per_level = orb.features_per_level(cfg.orb)
    extract = orb.build_extractor(cfg.orb, cam.height, cam.width)

    def pyramid():
        return [resize_bilinear(img, h, w) for h, w in sizes]

    levels = pyramid()

    def scores():
        return [orb.threshold_fallback(nms3x3(fast_score_map(lv)), cfg.orb)
                for lv in levels]

    score = scores()

    def topk():
        return [orb.detect_level(s, n, cfg.orb)
                for s, n in zip(score, n_per_level)]

    det = topk()
    ys = torch.cat([y for y, _, _ in det])
    xs = torch.cat([x for _, x, _ in det])
    feats = extract(img)
    stages = {
        "frame pipeline (make_rgbd)": lambda: slam.make_rgbd(g_t, d_t),
        "pyramid": pyramid,
        "FAST score map + NMS + fallback": scores,
        "per-cell top-k": topk,
        "keypoint stage (K2)": lambda: orb.keypoint_stage(
            levels, ys, xs, n_per_level, cfg.orb.pad),
        "depth sampling (frame_from_features)": lambda: frame_from_features(
            feats, cam, depth, cfg.distortion),
    }
    apart = {
        "upload (System._upload)": lambda: slam._upload(g, d),
        "undistortion, TUM fr1 distortion": lambda: undistort_points(
            cam, TUM_FR1_DIST, feats.uv),
    }
    return stages, apart


def track_stages(slam, frame):
    """The track step on ``frame`` against the arena of ``slam`` and its
    stages as callables.  Keyframe insertion is off, so the step and the
    masked insertion write only the visibility counters."""
    from active_orb_slam2_tpu_torch.models import tracking
    from active_orb_slam2_tpu_torch.ops.topk import stable_topk
    cfg, m, st = slam.cfg, slam.map, slam.track
    make_create = tracking.make_create_keyframe_fn
    create = {}

    def capture_create(*a, **kw):
        create["fn"] = make_create(*a, **kw)

        def wrapped(*ca, **ckw):
            create["args"] = (ca, ckw)
            return create["fn"](*ca, **ckw)
        return wrapped

    tracking.make_create_keyframe_fn = capture_create
    try:
        step = tracking.build_track_step(cfg)
    finally:
        tracking.make_create_keyframe_fn = make_create
    with captured(tracking, "in_frustum", "search_by_projection",
                  "pose_optimization_fused") as cap:
        step(m, frame, st, False)
    P = m.max_points
    nloc = min(cfg.tracking.max_local_keyframes, m.max_keyframes)

    def vote():
        vote_mask_p = tracking.scatter_any(P, torch.clamp(st.assoc, min=0),
                                           st.assoc >= 0)
        obs_pt = torch.clamp(m.kf_point, min=0).long()
        votes = ((m.kf_point >= 0) & vote_mask_p[obs_pt]
                 & m.kf_valid[:, None]).to(torch.int32).sum(1)
        w, local_kf = stable_topk(votes, nloc)
        lk_point = m.kf_point[local_kf]
        lk_obs = (lk_point >= 0) & (w > 0)[:, None]
        return tracking.scatter_any(
            P, torch.clamp(lk_point, min=0).reshape(-1),
            lk_obs.reshape(-1)) & m.pt_valid

    local_mask = vote()
    (frustum, fa, fkw), = cap.of("in_frustum")
    vis = frustum(*fa, **fkw)[0]
    matched = tracking.scatter_any(P, torch.clamp(st.assoc, min=0),
                                   st.assoc >= 0)

    def candidates():
        cand_mask = local_mask & vis & ~matched
        return stable_topk(cand_mask.to(torch.int32), 2048)

    (sbp1, a1, kw1), (sbp2, a2, kw2) = cap.of("search_by_projection")
    (k1a, pa1, pkw1), (k1b, pa2, pkw2) = cap.of("pose_optimization_fused")
    ca, ckw = create["args"]
    return {
        "track step (build_track_step)": lambda: step(m, frame, st, False),
        "in_frustum": lambda: frustum(*fa, **fkw),
        "local-map candidate selection": candidates,
        "search_by_projection, motion stage": lambda: sbp1(*a1, **kw1),
        "search_by_projection, local-map stage": lambda: sbp2(*a2, **kw2),
        "K1 launch 1 (motion stage)": lambda: k1a(*pa1, **pkw1),
        "K1 launch 2 (local-map stage)": lambda: k1b(*pa2, **pkw2),
        "local-keyframe vote": vote,
        "keyframe decision + insertion (masked)": lambda: create["fn"](
            *ca, **ckw),
    }


def profile_window(fn, device):
    """(device busy ms, device ops, span ms, device events) of one call of
    ``fn`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        bench_torch.sync(device)
        span = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, -np.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in ev):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(ev), span, ev


def steady_profile(frames, cfg, device):
    """``torch.profiler`` over the last 12 frames of a fresh pipelined
    run, drained at the end."""
    from active_orb_slam2_tpu_torch.models.system import System
    slam = System(cfg, use_mapping=False, device=device)
    first = len(frames) - PROFILED_FRAMES
    for i in range(first):
        slam.track_rgbd(*frames[i], i / 30.0)
    slam.flush()
    bench_torch.sync(device)

    def window():
        for i in range(first, len(frames)):
            slam.track_rgbd(*frames[i], i / 30.0)
        slam.flush()

    busy, ops, span, ev = profile_window(window, device)
    totals = {}
    for e in ev:
        t = totals.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) / 1e3
        t[1] += 1
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:10]
    n = PROFILED_FRAMES
    return {"ops_per_frame": ops / n, "device_busy_ms_per_frame": busy / n,
            "span_ms_per_frame": span / n, "idle_share": 1.0 - busy / span,
            "top10": [{"name": k, "ms_per_frame": v[0] / n,
                       "calls_per_frame": v[1] / n} for k, v in top]}


def run(frames, cfg, device):
    """Every measurement of the script, printed as it goes; returns the
    record."""
    rec = {"device": bench_torch.device_info(device)}
    print(f"device {rec['device']}", flush=True)
    rec["fused_step"], slam = fused_step_runs(frames, cfg, device)
    fs = rec["fused_step"]
    print(f"fused step, frames {bench_torch.WARMUP}-{len(frames) - 1}: "
          f"synchronized {fs['synchronized_ms']:.3f} ms/frame (median), "
          f"pipelined {fs['pipelined_ms']:.3f} ms/frame "
          f"(windows {[round(w, 3) for w in fs['pipelined_windows_ms']]})",
          flush=True)
    g, d = frames[-1]
    frame, _ = slam.make_rgbd(*slam._upload(g, d))
    frame_parts, apart = frame_stages(slam, g, d)
    groups = {"frame": frame_parts, "track": track_stages(slam, frame),
              "apart": apart}
    rec["roundtrip_ms"] = roundtrip_ms(device)
    print(f"launch + synchronize round trip: {rec['roundtrip_ms']:.4f} ms",
          flush=True)
    rec["stages"] = {}
    for group, stages in groups.items():
        rows = {}
        for name, fn in stages.items():
            span, enq = bench_torch.chained_ms(fn, REPS, device)
            rows[name] = {"span_ms": span, "enqueue_ms": enq}
            print(f"{group:5s} {name:42s} span {span:8.3f} ms  enqueue "
                  f"{enq:8.3f} ms (a call, {REPS} chained)", flush=True)
        rec["stages"][group] = rows
    sums = {}
    for group in ("frame", "track"):
        whole, *parts = rec["stages"][group]
        sums[group] = sum(rec["stages"][group][p]["span_ms"] for p in parts)
        print(f"{group:5s} sum of stages {sums[group]:.3f} ms against "
              f"{rec['stages'][group][whole]['span_ms']:.3f} ms for the "
              f"whole", flush=True)
    rec["sum_of_stages_ms"] = (
        rec["stages"]["apart"]["upload (System._upload)"]["span_ms"]
        + sums["frame"] + sums["track"])
    print(f"upload + frame stages + track stages {rec['sum_of_stages_ms']:.3f}"
          f" ms against the synchronized fused step "
          f"{fs['synchronized_ms']:.3f} ms", flush=True)
    # the profiler last: work timed after it reads slow
    rec["steady"] = steady_profile(frames, cfg, device)
    s = rec["steady"]
    print(f"profiled frames {len(frames) - PROFILED_FRAMES}-"
          f"{len(frames) - 1}: {s['ops_per_frame']:.1f} device ops a frame, "
          f"device busy {s['device_busy_ms_per_frame']:.3f} ms of "
          f"{s['span_ms_per_frame']:.3f} ms a frame, idle share "
          f"{s['idle_share']:.3f}", flush=True)
    for row in s["top10"]:
        print(f"  {row['ms_per_frame']:8.4f} ms/frame "
              f"{row['calls_per_frame']:6.1f} calls/frame  "
              f"{row['name'][:90]}", flush=True)
    for group, stages in groups.items():
        for name, fn in stages.items():
            busy, ops = profile_torch_mapping.device_profile(fn)
            rec["stages"][group][name].update(device_busy_ms=busy,
                                              device_ops=ops)
            print(f"{group:5s} {name:42s} device busy {busy:8.4f} ms, "
                  f"{ops:7.1f} device ops (profiler, 3 calls)", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the record here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_track: no CUDA device")
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    frames, _ = bench_torch.render_orbit(bench_torch.N_TRACK_FRAMES)
    print(f"rendered {len(frames)} VGA frames in "
          f"{time.perf_counter() - t0:.1f} s (process pool)", flush=True)
    rec = run(frames, bench_torch.tracking_config(), device)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
