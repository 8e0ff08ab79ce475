#!/usr/bin/env python3
"""Replay a recorded loop correction stage by stage through the PyTorch
port and print the map's mean chi2 after each stage: the port of
``scripts/dissect_closure.py``, the closure postmortem.

    python3 scripts/dissect_torch_closure.py DUMP.npz [--device cuda|cpu]
        [--gba-iters 3] [--cg-iters 24] [--deterministic]
        [--width 320 --height 240 --f 260] [--json PATH]

A dump is written by ``LoopCloser(dump_path=...)`` for a rejected
correction, by ``scripts/run_torch_endurance.py --dump-closures DIR`` for
every correction, or by the JAX package's loop closer.  The stages are
those of the loop closer's correction, called as they are: the Sim3
propagated to the current keyframe's covisible group (``post stage1``),
the loop fuse, the essential graph (``post-pg``, with the graph's own
final chi2), then ``--gba-iters`` global-BA iterations of ``--cg-iters``
CG steps each (``post-gbaN``).  The correction's gate runs one iteration
of 16 CG steps: with ``--cg-iters 16``, ``pre`` and ``post-gba1`` are the
gate's two numbers, and the verdict printed is the gate's.  The JAX
script runs 24.

The covisibility matrix is the dump's ``W`` (the matrix the correction
was given) where the dump has one, else it is recomputed from the arena,
as the JAX script does; the script says which.  The camera is the one
the flags give (default: the endurance tour's, which the JAX script
fixes), with cx = (w - 1) / 2, cy = (h - 1) / 2 and bf = 0.08 f.
``--deterministic`` runs under ``torch.use_deterministic_algorithms``
(new tensors not NaN-filled), so that two replays on the card (and a
correction run the same way) sum in one order.  Runs on the card unless
``--device cpu`` is given; imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def camera(width: int = 320, height: int = 240, f: float = 260.0):
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    return CameraParams(fx=f, fy=f, cx=(width - 1) / 2.0,
                        cy=(height - 1) / 2.0, bf=f * 0.08, width=width,
                        height=height)


def load_dump(path, device):
    """(map, cur_kf, loop_kf, s_cm, li, lj, new_n, W or None) on
    ``device``."""
    from active_orb_slam2_tpu_torch.models.convert import (
        map_from_jax_numpy, to_torch)
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    m = map_from_jax_numpy(arrays, device)
    W = to_torch(arrays["W"], device) if "W" in arrays else None
    return (m, int(arrays["cur_kf"]), int(arrays["loop_kf"]),
            to_torch(arrays["s_cm"], device), to_torch(arrays["li"], device),
            to_torch(arrays["lj"], device), int(arrays["new_n"]), W)


def dissect(path, cam, device, gba_iters: int = 3, cg_iters: int = 24,
            log=print):
    """Replay the dump at ``path`` on ``device``; prints the JAX script's
    lines through ``log`` and returns the numbers as a dict."""
    import torch
    from active_orb_slam2_tpu_torch.config import MapConfig
    from active_orb_slam2_tpu_torch.geometry.se3 import (
        sim3_compose, sim3_from_se3, sim3_inverse)
    from active_orb_slam2_tpu_torch.models import loop_closing as L
    from active_orb_slam2_tpu_torch.models.map_state import (
        covisibility_weights)
    from active_orb_slam2_tpu_torch.models.pose_graph import (
        build_essential_edges, optimize_essential_graph)
    from active_orb_slam2_tpu_torch.parallel.dist_ba import (
        build_point_major_edges, global_ba)
    from active_orb_slam2_tpu_torch.utils.transfer import synchronize

    m, cur, loop, s_cm, li, lj, new_n, W = load_dump(path, device)
    w_from = "dump"
    if W is None:
        W, w_from = covisibility_weights(m), "recomputed"
    log(f"W: {w_from}")

    def chi2(mm):
        return float(L._map_mean_chi2(cam, mm))

    synchronize(device)
    t0 = time.perf_counter()
    K = m.max_keyframes
    ar = torch.arange(K, device=device)
    max_loop = li.shape[0]
    out = {"dump": str(path), "device": str(device), "W": w_from,
           "cur_kf": cur, "loop_kf": loop, "new_n": new_n,
           "gba_iters": gba_iters, "cg_iters": cg_iters}
    out["pre"] = chi2(m)
    log("pre chi2:", round(out["pre"], 3))
    pre_sim3 = sim3_from_se3(m.kf_pose)
    corrected_scur = sim3_compose(s_cm, sim3_from_se3(m.kf_pose[loop]))
    group = ((W[cur] >= MapConfig().covis_min_weight) | (ar == cur)) \
        & m.kf_valid
    m1, anchor = L._apply_sim3_correction(m, pre_sim3, corrected_scur, cur,
                                          group)
    out["post_stage1"] = chi2(m1)
    log("post stage1 chi2:", round(out["post_stage1"], 3))
    m2 = L._fuse(cam, m1, cur, loop, W)
    edges = build_essential_edges(pre_sim3, m2.kf_valid, m2.kf_parent, W, li,
                                  lj, max_loop=max_loop)
    edges = L._with_newest_loop(edges, sim3_compose(
        corrected_scur, sim3_inverse(pre_sim3[loop])), new_n, max_loop)
    cur_sim3 = sim3_from_se3(m2.kf_pose)
    opt_sim3, pgc = optimize_essential_graph(cur_sim3, edges,
                                             (ar == loop) | ~m2.kf_valid)
    m3 = L._apply_posegraph_result(m2, cur_sim3, opt_sim3,
                                   preferred_anchor=anchor)
    out["post_pg"], out["pg_internal"] = chi2(m3), float(pgc)
    log("post-pg chi2:", round(out["post_pg"], 3),
        " pg internal:", round(out["pg_internal"], 4))
    pedges = build_point_major_edges(m3)
    mm, out["post_gba"] = m3, []
    for it in range(gba_iters):
        poses, pts, _ = global_ba(cam, mm.kf_pose, mm.kf_valid, mm.pt_xyz,
                                  mm.pt_valid, pedges, ar == loop, iters=1,
                                  cg_iters=cg_iters)
        mm = mm._replace(kf_pose=poses, pt_xyz=pts)
        out["post_gba"].append(chi2(mm))
        log(f"post-gba{it + 1} chi2:", round(out["post_gba"][-1], 3))
        if it == 0:
            out["finite"] = bool(torch.isfinite(poses).all()
                                 and torch.isfinite(pts).all())
    synchronize(device)
    out["ms"] = (time.perf_counter() - t0) * 1e3
    if gba_iters:
        # the gate, on python floats as LoopCloser.correct takes it
        limit = L.CHI2_GATE * out["pre"] + L.CHI2_GATE_OFFSET
        post = out["post_gba"][0]
        out["gate_limit"] = limit
        out["accepted"] = bool(out["finite"] and np.isfinite(post)
                               and post <= limit)
        log(f"gate (cg {cg_iters}): post-gba1 {post:.6g} against "
            f"{L.CHI2_GATE} x pre + {L.CHI2_GATE_OFFSET} = {limit:.6g}: "
            f"{'accepted' if out['accepted'] else 'rejected'}"
            + ("" if cg_iters == 16 else " (the gate runs 16 CG steps)"))
    log(f"replay {out['ms']:.1f} ms on {device}")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dump")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--gba-iters", type=int, default=3)
    ap.add_argument("--cg-iters", type=int, default=24,
                    help="CG steps a global-BA iteration (the gate's: 16)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--f", type=float, default=260.0)
    ap.add_argument("--json", default=None, help="write the numbers here")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dissect_torch_closure: no CUDA device (--device "
                         "cpu replays on the CPU)")
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    out = dissect(args.dump, camera(args.width, args.height, args.f), device,
                  gba_iters=args.gba_iters, cg_iters=args.cg_iters)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
