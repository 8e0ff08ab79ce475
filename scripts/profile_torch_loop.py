#!/usr/bin/env python3
"""Where the time of the PyTorch port's loop closing goes, on one CUDA
card.  Run from the root of a checkout:

    python3 scripts/profile_torch_loop.py [--json PATH]

First, in the fresh process, times the first and the second call
(synchronized) of each solver the loop closer calls at its shapes: a
first call pays one-time setup.  Then builds ``chip_smoke.py``'s
constructed closure at VGA width (the loop
circle's arcs 0-54 and 95-149 + 0-19 tracked on the card, arc B moved by
a known drift and merged), runs the loop closer until it closes, and on
the arena of the closing event breaks one loop event into its stages:
the detection of a keyframe, the verification (``compute_sim3``) of the
closing pair, the correction (``correct``) and its parts, and one
deferred global-BA slice.  For each it prints the span of one
synchronized call (median of 3), the host's enqueue time (the call
without the closing synchronize, median of 3; the verification and the
correction read the card inside, so theirs is their span), and then,
all spans taken, under ``torch.profiler`` (1 call) the device busy time
(union of kernel and copy intervals) and the device operations per call.
Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_torch_mapping import device_profile, median_ms, sync  # noqa: E402


def stage_rows(cfg, base, pair, s_cm, device):
    """The stages of a loop event on the arena ``base`` (before the
    closure) for the closing pair, with its verified ``s_cm``."""
    import torch
    from active_orb_slam2_tpu_torch.models import loop_closing as lcm
    from active_orb_slam2_tpu_torch.models.map_state import (
        MapState, covisibility_weights)
    from active_orb_slam2_tpu_torch.models.pose_graph import (
        build_essential_edges, optimize_essential_graph)
    from active_orb_slam2_tpu_torch.geometry.se3 import (
        sim3_compose, sim3_from_se3)
    from active_orb_slam2_tpu_torch.parallel.dist_ba import (
        build_point_major_edges, global_ba)
    cam = cfg.camera
    cur, loop = pair
    K = base.max_keyframes
    ar = torch.arange(K, device=device)
    W = covisibility_weights(base)
    lc = lcm.LoopCloser(cfg, recent_frames_guard=0)
    lc.ensure_vocabulary(base)
    lc.refresh_bows(base)
    lc._ensure_buffer(K, device)

    def fresh():
        return MapState(*[t.clone() for t in base])

    def detect():
        lc._n_groups = 0
        return lc.detect_async(base, cur, W=W)

    def correct():
        # a loop closer of its own: each accepted correction keeps its loop
        # edge, which would pin the next one's essential graph
        return lcm.LoopCloser(cfg, recent_frames_guard=0).correct(
            fresh(), cur, loop, s_cm, W=W)

    def gba_slice():
        lc.gba_remaining = 2
        lc._gba_fixed = (loop, None)
        return lc.gba_slice(fresh())

    pre = sim3_from_se3(base.kf_pose)
    scur = sim3_compose(s_cm, pre[loop])
    group = ((W[cur] >= cfg.map.covis_min_weight) | (ar == cur)) \
        & base.kf_valid
    moved, anchor = lcm._apply_sim3_correction(base, pre, scur, cur, group)
    fused = lcm._fuse(cam, moved, cur, loop, W)
    li = torch.full((lcm.MAX_LOOP_EDGES,), -1, dtype=torch.int32,
                    device=device)
    li[0] = cur
    lj = torch.full_like(li, -1)
    lj[0] = loop
    edges = build_essential_edges(pre, fused.kf_valid, fused.kf_parent, W,
                                  li, lj)
    cur_sim3 = sim3_from_se3(fused.kf_pose)
    fixed = (ar == loop) | ~fused.kf_valid
    opt, _ = optimize_essential_graph(cur_sim3, edges, fixed)
    graphed = lcm._apply_posegraph_result(fused, cur_sim3, opt, anchor)
    pedges = build_point_major_edges(graphed)
    stages = [
        ("detect (BoW score + DetectLoop)", detect),
        ("verify: compute_sim3", lambda: lc.compute_sim3(base, cur, loop)),
        ("correct: map mean chi2", lambda: lcm._map_mean_chi2(cam, base)),
        ("correct: Sim3 propagation", lambda: lcm._apply_sim3_correction(
            base, pre, scur, cur, group)),
        ("correct: fuse", lambda: lcm._fuse(cam, moved, cur, loop, W)),
        ("correct: essential edges", lambda: build_essential_edges(
            pre, fused.kf_valid, fused.kf_parent, W, li, lj)),
        ("correct: essential graph 20 LM",
         lambda: optimize_essential_graph(cur_sim3, edges, fixed)),
        ("correct: pose-graph write-back", lambda: lcm._apply_posegraph_result(
            fused, cur_sim3, opt, anchor)),
        ("correct: point-major edges",
         lambda: build_point_major_edges(graphed)),
        ("correct: global BA 1 LM, 16 CG", lambda: global_ba(
            cam, graphed.kf_pose, graphed.kf_valid, graphed.pt_xyz,
            graphed.pt_valid, pedges, ar == loop, iters=1, cg_iters=16)),
        ("correct: whole call (gate included)", correct),
        ("GBA slice 2 LM, 24 CG", gba_slice),
    ]
    rows = []
    for name, fn in stages:
        rows.append({"stage": name,
                     "span_ms": median_ms(fn, synchronized=True, reps=3),
                     "enqueue_ms": median_ms(fn, synchronized=False, reps=3)})
    for row, (name, fn) in zip(rows, stages):
        row["device_busy_ms"], row["device_ops"] = device_profile(fn, reps=1)
        print(f"{name:38s} span {row['span_ms']:8.2f} ms  enqueue "
              f"{row['enqueue_ms']:8.2f} ms  device busy "
              f"{row['device_busy_ms']:7.2f} ms  device ops "
              f"{row['device_ops']:8.1f}", flush=True)
    return rows


def first_calls(device):
    """(name, first ms, second ms) of the solvers at the loop closer's
    shapes, each call synchronized, in a process that has run none."""
    import torch
    from active_orb_slam2_tpu_torch.geometry.se3 import sim3_exp, sim3_log
    g = torch.Generator(device=device).manual_seed(0)

    def spd(*shape):
        a = torch.randn(*shape, generator=g, device=device)
        return a @ a.transpose(-1, -2) + shape[-1] * torch.eye(
            shape[-1], device=device)
    spd(2, 2)           # the context, the generator and cuBLAS, untimed
    sync()
    calls = [
        ("eigh [256, 4, 4] (Horn RANSAC)",
         lambda: torch.linalg.eigh(spd(256, 4, 4))),
        ("solve_ex [7, 7] (OptimizeSim3)",
         lambda: torch.linalg.solve_ex(spd(7, 7), torch.ones(7, 1,
                                                             device=device))),
        ("jacfwd of sim3_log o sim3_exp [1056, 7, 14]",
         lambda: torch.func.jacfwd(lambda d: sim3_log(sim3_exp(
             d.expand(1056, 14)[:, :7])))(torch.zeros(14, device=device))),
        ("cholesky_ex + cholesky_solve [3584, 3584] (essential graph)",
         lambda: torch.cholesky_solve(torch.ones(3584, 1, device=device),
                                      torch.linalg.cholesky_ex(
                                          spd(3584, 3584))[0])),
        ("inv_ex [512, 6, 6] (GBA preconditioner)",
         lambda: torch.linalg.inv_ex(spd(512, 6, 6))),
    ]
    rows = []
    for name, fn in calls:
        ms = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        rows.append({"call": name, "first_ms": ms[0], "second_ms": ms[1]})
        print(f"first call {name}: {ms[0]:.2f} ms, second {ms[1]:.2f} ms",
              flush=True)
    return rows


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write the rows to this file as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_loop: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from active_orb_slam2_tpu_torch.models import convert
    from active_orb_slam2_tpu_torch.models.loop_closing import LoopCloser
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi gave nothing")
    device = torch.device("cuda", 0)
    firsts = first_calls(device)
    cfg = cs.vga_config("mapping")
    t0 = time.perf_counter()
    frames, traj = cs.render_loop_frames()
    print(f"rendered {len(frames)} VGA frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    arrays, Ka, Kb, _, _ = cs.closure_arena(device, frames, traj, cfg)
    lc = LoopCloser(cfg, recent_frames_guard=0)
    _, events, base, _ = cs.close_loop(
        lc, convert.map_from_jax_numpy(arrays, device), Ka, Kb)
    print(f"arena: Ka {Ka} Kb {Kb}, events {events}", flush=True)
    if base is None:
        print("profile_torch_loop: the loop did not close", file=sys.stderr)
        return 1
    pair = (lc.last_closure["cur_kf"], lc.last_closure["loop_kf"])
    s_cm = torch.from_numpy(lc.last_closure["s_cm"]).to(device)
    sync()
    rows = stage_rows(cfg, base, pair, s_cm, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "first_calls": firsts, "events": events,
                       "stages": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
