#!/usr/bin/env python3
"""Where the card's runs part from the CPU's: the exploration example and
the 60-frame monocular run, each recorded frame by frame on one device,
on the card optionally with its sums in a fixed order.

    python3 scripts/trace_torch_determinism.py --run explore|mono
        [--device cuda|cpu] [--deterministic] [--json PATH]
    python3 scripts/trace_torch_determinism.py --run explore|mono
        --lockstep N [--deterministic] [--json PATH]

``explore`` is ``examples/run_exploration.py``'s 15 steps (320x240, 512
features, loop closing on, ``default_world(n_boxes=4)``); ``mono`` is
``chip_smoke.py``'s mono phase (``SlamConfig(sensor="mono")``, loop
closing on, the 60 VGA frames of ``tests/test_e2e_mono.py``'s orbit,
rendered in a process pool).  Each tracked frame gives a row: keyframes
inserted and live map points after it (the ``System``'s state is read
after every frame; both runs retire every frame before the next
anyway).  ``explore`` also records the positions, coverage and replans.
``--lockstep N`` runs a card ``System`` and a CPU one side by side on
the same images for the first N frames (the CPU's exploration chooses
the path) and reports, after each frame, the arena fields where the two
differ: before each keyframe-mapping call (the frame pipeline, the track
step and the keyframe insertion), after it, and after the card's mapping
call run on the CPU's arena (the mapping call alone, from one input).
Each lockstep row also takes the frame's image apart (``stages``): the
level images of the two devices (``resize_bilinear``), their FAST
keypoints, the angles and descriptors of the two keypoint stages (the
card's kernel against the CPU's plain version), and the same two from
one input, the CPU's level images and keypoints (``same_input_*``: the
kernel on the card, and the plain version on the card, each against
the plain version on the CPU), and the card's level images and
keypoints through the plain version on the CPU against the card's
kernel (``card_input_plain_cpu``), so a frame that parts is traced down
to the op where it first parts.
``--deterministic`` runs under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` (``chip_smoke.py`` phase 17's switch): the card's
``index_add_`` and scatters then sum in one order, so a run that still
parts from the CPU parts for another reason than summation order.
Runs on the card unless ``--device cpu`` is given; imports nothing of
JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def recording(slam, rows):
    """Wrap ``slam``'s track calls (from outside) to append (keyframes,
    live points) after each frame."""
    for name in ("track_rgbd", "track_mono"):
        run = getattr(slam, name)

        def call(*a, _run=run, **kw):
            out = _run(*a, **kw)
            slam.state
            rows.append((slam.kf_seq, int(slam.map.pt_valid.sum())))
            return out
        setattr(slam, name, call)


def explore(device):
    from active_orb_slam2_tpu_torch.active.explorer import run_exploration
    from active_orb_slam2_tpu_torch.examples.run_exploration import (
        N_BOXES, START_XZ, exploration_config)
    from active_orb_slam2_tpu_torch.io.synthetic import default_world
    from active_orb_slam2_tpu_torch.models.system import System
    cfg, spec = exploration_config()
    slam = System(cfg, use_loop_closing=True, device=device)
    rows = []
    recording(slam, rows)
    log = run_exploration(slam, default_world(n_boxes=N_BOXES), spec,
                          n_steps=15, start_xz=START_XZ)
    return {"rows": rows, "positions": [list(map(float, p))
                                        for p in log.positions],
            "coverage": [float(c) for c in log.coverage],
            "replans": log.replans, "loops": slam.n_loops_closed}


def mono(device):
    import chip_smoke
    from active_orb_slam2_tpu_torch.config import SlamConfig
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models.system import System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    frames, gt = chip_smoke.render_mono_frames()
    slam = System(SlamConfig(sensor="mono"), use_loop_closing=True,
                  device=device)
    rows = []
    recording(slam, rows)
    for i, g in enumerate(frames):
        slam.track_mono(g, i / 30.0)
    est = camera_centers(slam.frame_trajectory()[1])
    moved = np.linalg.norm(est, axis=1) > 1e-6
    return {"rows": rows, "loops": slam.n_loops_closed,
            "ate_sim3": float(umeyama_alignment(est[moved], gt[moved])[4])}


def arena_diff(a, b):
    """{field: (cells that differ, max abs difference)} of two arenas
    (MapState on any devices)."""
    import torch
    out = {}
    for f, x, y in zip(a._fields, a, b):
        x, y = x.cpu(), y.cpu()
        ne = x != y
        if x.is_floating_point():
            ne = ne & ~(torch.isnan(x) & torch.isnan(y))
        if ne.any():
            d = (x.double() - y.double()).abs()[ne]
            out[f] = (int(ne.sum()), float(d.nan_to_num(float("inf")).max()))
    return out


def _count(a, b):
    """(entries that differ, max abs difference) of two tensors."""
    a, b = a.cpu(), b.cpu()
    ne = a != b
    if not ne.any():
        return (0, 0.0)
    return (int(ne.sum()), float((a.double() - b.double()).abs()[ne].max()))


def frame_diff(gray, cfg, device):
    """The ORB extractor's stages on ``gray`` (the uint8 image a System
    is handed) on the card and the CPU, compared stage by stage (module
    docstring)."""
    import torch
    from active_orb_slam2_tpu_torch.ops import orb
    from active_orb_slam2_tpu_torch.ops.fast import fast_score_map, nms3x3
    from active_orb_slam2_tpu_torch.ops.image import resize_bilinear
    g = np.asarray(gray)
    if g.dtype != np.uint8:
        g = np.clip(g, 0, 255).astype(np.uint8)
    oc, cam = cfg.orb, cfg.camera
    sizes = orb.level_sizes(cam.height, cam.width, oc)
    n_per = orb.features_per_level(oc)
    side = {}
    for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
        img = torch.from_numpy(g).to(dev).to(torch.float32)
        levels, ys, xs = [], [], []
        for (h, w), n in zip(sizes, n_per):
            lv = resize_bilinear(img, h, w)
            score = orb.threshold_fallback(nms3x3(fast_score_map(lv)), oc)
            y, x, _ = orb.detect_level(score, n, oc)
            levels.append(lv)
            ys.append(y)
            xs.append(x)
        ys, xs = torch.cat(ys), torch.cat(xs)
        ang, desc = orb.keypoint_stage(levels, ys, xs, n_per, oc.pad)
        side[name] = (levels, ys, xs, ang, desc)
    (lc, yc, xc, ac, dc), (lp, yp, xp, ap, dp) = side["card"], side["cpu"]
    out = {"levels": [_count(a, b) for a, b in zip(lc, lp)],
           "keypoints": int(((yc.cpu() != yp) | (xc.cpu() != xp)).sum()),
           "angle": _count(ac, ap),
           "desc": int((dc.cpu() != dp).any(1).sum())}
    # one input, the CPU's levels and keypoints, on the card
    on = [x.to(device) for x in lp], yp.to(device), xp.to(device)
    for name, stage in (("kernel", orb.keypoint_stage),
                        ("plain", orb.keypoint_stage_torch)):
        a, d = stage(*on, n_per, oc.pad)
        out[f"same_input_{name}"] = {
            "angle": _count(a, ap), "desc": int((d.cpu() != dp).any(1).sum())}
    # the card's levels and keypoints through the plain version on the CPU
    a, d = orb.keypoint_stage_torch([x.cpu() for x in lc], yc.cpu(),
                                    xc.cpu(), n_per, oc.pad)
    out["card_input_plain_cpu"] = {
        "angle": _count(a, ac), "desc": int((d != dc.cpu()).any(1).sum())}
    return out


class _Stop(Exception):
    pass


def lockstep(run, n_frames, device):
    """The first ``n_frames`` of ``run`` on the card and the CPU at once,
    compared after every frame (module docstring)."""
    import torch
    from active_orb_slam2_tpu_torch.models.local_mapping import (
        build_keyframe_mapping)
    from active_orb_slam2_tpu_torch.models.map_state import MapState
    from active_orb_slam2_tpu_torch.models.system import System
    cpu = torch.device("cpu")
    events = {}

    def watch(slam, side):
        run_map = slam.keyframe_mapping

        def mapping(m, kf_slot, kf_seq):
            ev = events.setdefault(int(kf_seq), {})
            ev[side + "_in"] = MapState(*[x.to(cpu, copy=True) for x in m])
            out = run_map(m, kf_slot, kf_seq)
            ev[side + "_out"] = MapState(*[x.to(cpu, copy=True) for x in m])
            ev["slot"] = int(kf_slot)
            return out
        slam.keyframe_mapping = mapping

    if run == "explore":
        from active_orb_slam2_tpu_torch.active.explorer import (
            run_exploration)
        from active_orb_slam2_tpu_torch.examples.run_exploration import (
            N_BOXES, START_XZ, exploration_config)
        from active_orb_slam2_tpu_torch.io.synthetic import default_world
        cfg, spec = exploration_config()
    else:
        import chip_smoke
        from active_orb_slam2_tpu_torch.config import SlamConfig
        cfg = SlamConfig(sensor="mono")
        frames, _ = chip_smoke.render_mono_frames()
    sides = {"card": System(cfg, use_loop_closing=True, device=device),
             "cpu": System(cfg, use_loop_closing=True, device=cpu)}
    for side, slam in sides.items():
        watch(slam, side)
    rows = []
    name = "track_rgbd" if run == "explore" else "track_mono"
    card_track = getattr(sides["card"], name)
    cpu_track = getattr(sides["cpu"], name)

    def both(*a, **kw):
        parted = frame_diff(a[0], cfg, device)
        out = cpu_track(*a, **kw)
        card_track(*a, **kw)
        for slam in sides.values():
            slam.state
        i = len(rows)
        row = {"frame": i, "kf_seq": [sides[k].kf_seq for k in sides],
               "points": [int(sides[k].map.pt_valid.sum()) for k in sides],
               "arena": arena_diff(sides["card"].map, sides["cpu"].map),
               "stages": parted}
        for seq, ev in sorted(events.items()):
            if "compared" in ev or "card_out" not in ev \
                    or "cpu_out" not in ev:
                continue
            ev["compared"] = True
            m = MapState(*[x.to(device, copy=True) for x in ev["cpu_in"]])
            build_keyframe_mapping(cfg)(m, ev["slot"], seq)
            row.setdefault("mapping", []).append({
                "kf_seq": seq,
                "before": arena_diff(ev["card_in"], ev["cpu_in"]),
                "after": arena_diff(ev["card_out"], ev["cpu_out"]),
                "same_input": arena_diff(m, ev["cpu_out"])})
        rows.append(row)
        print(json.dumps(row), flush=True)
        if len(rows) >= n_frames:
            raise _Stop
        return out
    setattr(sides["cpu"], name, both)
    try:
        if run == "explore":
            run_exploration(sides["cpu"], default_world(n_boxes=N_BOXES),
                            spec, n_steps=15, start_xz=START_XZ)
        else:
            for i, g in enumerate(frames):
                sides["cpu"].track_mono(g, i / 30.0)
    except _Stop:
        pass
    return {"rows": rows}


def first_parted(a, b):
    """Index of the first row where two records differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", choices=("explore", "mono"), required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--lockstep", type=int, default=0, metavar="N",
                    help="card and CPU side by side over the first N frames")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("trace_torch_determinism: no CUDA device")
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    t0 = time.perf_counter()
    if args.lockstep:
        out = lockstep(args.run, args.lockstep, device)
    else:
        out = (explore if args.run == "explore" else mono)(device)
    out.update(run=args.run, device=args.device,
               deterministic=args.deterministic,
               seconds=time.perf_counter() - t0)
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
