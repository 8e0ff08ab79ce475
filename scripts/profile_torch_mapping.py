#!/usr/bin/env python3
"""Where the time of the PyTorch port's local mapping goes, on one CUDA
card.  Run from the root of a checkout:

    python3 scripts/profile_torch_mapping.py [--json PATH]

1. Renders ``chip_smoke.py``'s 42 VGA frames and runs its mapping slice
   (``System(cfg_map).track_rgbd``, default arena) and the same frames
   with mapping off, alternating on, off, on, off; prints each run's
   ms/frame over frames 6-41 (host clock, synchronized).
2. On the final arena of the last mapping run, breaks one
   keyframe-mapping call into its stages and prints, for each stage and
   for the whole call: the span of one synchronized call (median of 5),
   the host's enqueue time (the call without the closing synchronize,
   median of 5), and then, every time taken, under ``torch.profiler``
   (3 calls) the device busy time (union of kernel and copy intervals)
   and the device operations per call.

Stages that cannot run alone on the arena are fed the map the stage
before them produced; ``update_point_stats`` is timed on the map after
point culling (its shapes, and so its work, do not depend on the
values).  Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def median_ms(fn, synchronized, reps=5):
    fn()
    sync()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        if synchronized:
            sync()
        times.append((time.perf_counter() - t0) * 1e3)
        sync()
    return float(np.median(times))


def device_profile(fn, reps=3):
    """(device busy ms, device operations) per call of ``fn``: the union
    of the intervals of its CUDA kernels, copies and fills, and their
    count, from ``torch.profiler`` over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / reps, len(spans) / reps


def slice_runs(frames, device):
    """ms/frame of the mapping slice and of the same frames with mapping
    off, alternating; returns (rows, System of the last mapping run)."""
    import chip_smoke as cs
    from active_orb_slam2_tpu_torch.models.system import System
    cfg = cs.vga_config("mapping")
    rows, last = [], None
    for use_mapping in (True, False, True, False):
        slam = System(cfg, use_mapping=use_mapping, device=device)
        ms, calls = cs.run_frames(slam, frames, timed=True)
        rows.append({"mapping": use_mapping, "ms_per_frame": ms,
                     "keyframe_events": len(calls)})
        print(f"slice, mapping {'on ' if use_mapping else 'off'}: "
              f"{ms:.2f} ms/frame over frames {cs.WARMUP}-{len(frames) - 1}"
              f", keyframe events {len(calls)}", flush=True)
        if use_mapping:
            last = slam
    return rows, last


def stage_rows(slam):
    """The stages of one keyframe-mapping call on the arena of ``slam``."""
    from active_orb_slam2_tpu_torch.models import local_mapping as lm
    from active_orb_slam2_tpu_torch.models.map_state import (
        MapState, covisibility_weights, update_point_stats)
    from active_orb_slam2_tpu_torch.models.optimizer import bundle_adjustment
    cfg, cam = slam.cfg, slam.cfg.camera
    base = MapState(*[t.clone() for t in slam.map])
    k, seq = slam.last_kf_slot, slam.kf_seq
    create = lm.make_create_points_body(cfg)
    fuse = lm.make_fuse_body(cfg)
    mapping = lm.make_mapping_body(cfg)
    cull = lm.make_cull_body(cfg)
    step = lm.build_keyframe_mapping(cfg)

    W = covisibility_weights(base)
    m1 = create(base, k, seq, W)
    m2 = fuse(m1, k, W)
    m3 = lm.cull_map_points(m2, seq)
    cams, cams_ok, fixed, pt_sel, pt_sel_ok, edges = lm.local_ba_window(
        cfg, m3, k, W)
    m4 = mapping(m2, k, seq, W)

    def ba():
        return bundle_adjustment(cam, m3.kf_pose[cams], m3.pt_xyz[pt_sel],
                                 edges, fixed_cam=fixed | ~cams_ok,
                                 iters_a=4, iters_b=8)

    copies = []

    def whole():
        return step(copies.pop() if copies else
                    MapState(*[t.clone() for t in base]), k, seq)

    stages = [
        ("covisibility W", lambda: covisibility_weights(base)),
        ("create points", lambda: create(base, k, seq, W)),
        ("fuse", lambda: fuse(m1, k, W)),
        ("point culling", lambda: lm.cull_map_points(m2, seq)),
        ("BA window", lambda: lm.local_ba_window(cfg, m3, k, W)),
        ("bundle adjustment 4+8", ba),
        ("update_point_stats", lambda: update_point_stats(m3)),
        ("keyframe culling", lambda: cull(m4, k, W)),
        ("whole call", whole),
    ]
    sync()
    n_edges = int(edges.valid.sum())
    print(f"arena: slot {k}, {int(base.kf_valid.sum())} live keyframes, "
          f"{int(base.pt_valid.sum())} points, {n_edges} valid BA edges of "
          f"{edges.valid.shape[0]}, Lt={cams.shape[0]} cameras, "
          f"Pl={pt_sel.shape[0]} points", flush=True)

    def fresh():
        # the whole call updates the arena in place: a copy per call, made
        # outside what is timed
        copies[:] = [MapState(*[t.clone() for t in base]) for _ in range(8)]
        sync()

    # every host-clock time first: work timed after torch.profiler has
    # run reads slow
    rows = []
    for name, fn in stages:
        fresh()
        span = median_ms(fn, synchronized=True)
        fresh()
        enqueue = median_ms(fn, synchronized=False)
        rows.append({"stage": name, "span_ms": span, "enqueue_ms": enqueue})
    for row, (name, fn) in zip(rows, stages):
        fresh()
        row["device_busy_ms"], row["device_ops"] = device_profile(fn)
        print(f"{name:24s} span {row['span_ms']:8.2f} ms  enqueue "
              f"{row['enqueue_ms']:8.2f} ms  device busy "
              f"{row['device_busy_ms']:7.2f} ms  device ops "
              f"{row['device_ops']:8.1f}", flush=True)
    return rows


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the rows to this file as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mapping: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi gave nothing")
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    frames, _ = cs.render_frames()
    print(f"rendered {len(frames)} VGA frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs, slam = slice_runs(frames, device)
    stages = stage_rows(slam)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "slice_runs": runs, "stages": stages}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
