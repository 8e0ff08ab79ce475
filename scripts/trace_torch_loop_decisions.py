#!/usr/bin/env python3
"""The loop closer's decisions, one row per keyframe event, on the port's
full pipeline over ``chip_smoke.py``'s loop circle (phase 13: VGA, 1024
features, 8 levels, default arena, a keyframe at least every 8 frames,
mapping and loop closing on; the 150 frames of
``loop_trajectory(150, radius=2.5)`` and frames 0-19 again).  Run from the
root of a checkout:

    python3 scripts/trace_torch_loop_decisions.py [--device cuda|cpu]
        [--pipeline default|eager] [--frames-file NPZ] [--revisit N]
        [--json PATH]

Each keyframe event gives a row: the keyframe sequence number, its slot
and frame, the live keyframes and map points after the event, and the
loop closer's counters.  Each verification the event ran gives the
candidate pair, the SearchByBoW matches, the Sim3 RANSAC inliers, the
inliers of each OptimizeSim3 (the first, then the guided one), the
guided re-matches and the verdict.  Each loop detection gives what it
was given (the live keyframes' frame ids, covisibility weights and BoW
scores against the current keyframe, the consistency buffer) and what it
decided (the minimum score, the keyframes accepted by the group rule,
the consistent candidate).  ``--pipeline eager`` retires every
frame before the next (as the CPU tests run both packages); ``default``
runs the ``System``'s own pipeline (as ``chip_smoke.py`` does).
``tests/test_torch_loop_circle_decisions.py`` holds the same rows against
the JAX package's.  The counts are read from the card as they are made,
so the run waits on it; nothing it records changes a result.  Imports
nothing of JAX.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_LOOP = 150
N_REVISIT = 20


class patched:
    """Inside the ``with``, ``module.name`` is ``wrap(original)`` for each
    name; restored on exit."""

    def __init__(self, module, wraps):
        self.module, self.wraps, self.saved = module, wraps, {}

    def __enter__(self):
        for name, wrap in self.wraps.items():
            self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, wrap(self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def verification_recorder(lcm, rows):
    """Wrappers of the port loop closer's verification stages that append
    their counts to ``rows[-1]`` (a dict opened per ``compute_sim3``)."""
    def rec(key, value):
        rows[-1].setdefault(key, []).append(int(value))

    def match_data(fn):
        def call(*a):
            out = fn(*a)
            rec("bow_matches", out[-1].sum())
            return out
        return call

    def ransac(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            rec("ransac_inliers", out.n_inliers)
            return out
        return call

    def lm(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            rec("lm_inliers", out[2])
            return out
        return call

    def guided(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            rec("guided_matches", out[1])
            return out
        return call

    return patched(lcm, {"_sim3_match_data": match_data,
                         "sim3_ransac": ransac, "optimize_sim3": lm,
                         "_sim3_guided_refine": guided})


def trace_port(cfg, frames, device, eager=True):
    """Track ``frames`` ((gray, depth) pairs) with the port's full
    pipeline; returns (event rows, verification rows, System)."""
    from active_orb_slam2_tpu_torch.models import loop_closing as lcm
    from active_orb_slam2_tpu_torch.models.system import System
    slam = System(cfg, use_loop_closing=True, device=device,
                  **({"pipeline_depth": 0, "retire_batch": 1} if eager
                     else {}))
    lc = slam.loop_closer
    events, verifs, detects = [], [], []
    run_lc, run_sim3, run_detect = (lc.process_keyframe, lc.compute_sim3,
                                    lc._detect)

    def process_keyframe(m, k, kf_seq, **kw):
        out = run_lc(m, k, kf_seq, **kw)
        events.append(event_row(slam, lc, k, kf_seq, out[1]))
        return out

    def compute_sim3(m, cur, loop):
        verifs.append({"kf_seq": slam.kf_seq, "cur": int(cur),
                       "loop": int(loop)})
        ok, s, n = run_sim3(m, cur, loop)
        verifs[-1]["verdict"] = bool(ok)
        return ok, s, n

    def detect(m, cur_kf, W, scores, prev_accept):
        out = run_detect(m, cur_kf, W, scores, prev_accept)
        detects.append(detect_row(slam.kf_seq, m, cur_kf, W, scores,
                                  prev_accept, out))
        return out

    lc.process_keyframe, lc.compute_sim3 = process_keyframe, compute_sim3
    lc._detect = detect
    with verification_recorder(lcm, verifs):
        for i, (g, d) in enumerate(frames):
            slam.track_rgbd(g, d, i / 30.0)
            if eager:
                slam.flush()
        slam.flush()
    return events, verifs, detects, slam


def _host(a):
    import torch
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def detect_row(kf_seq, m, cur_kf, W, scores, prev_accept, out):
    """One DetectLoop call, with what it was given: the keyframe slots in
    play (live, or with covisibility weights), their frame ids, their
    covisibility weights and L1 scores against the current keyframe, the
    consistency buffer; and what it decided: the minimum score (the
    lowest score of a covisible neighbour), the keyframes the group rule
    accepted and the consistent candidate (-1 for none)."""
    cur = int(cur_kf)
    w, sc, prev = _host(W), _host(scores), _host(prev_accept)
    valid = _host(m.kf_valid)
    cand, ok, buf = (_host(a) for a in out)
    slots = np.flatnonzero(valid | (w != 0).any(0) | (w != 0).any(1))
    nb = w[cur] > 0
    return {"kf_seq": int(kf_seq), "cur": cur, "K": int(w.shape[0]),
            "slots": slots.tolist(), "valid": valid[slots].tolist(),
            "fid": _host(m.kf_frame_id)[slots].tolist(),
            "W": w[np.ix_(slots, slots)].tolist(),
            "covis": {str(j): int(w[cur, j]) for j in np.flatnonzero(nb)},
            "scores": {str(j): float(sc[j]) for j in slots},
            "prev": [np.flatnonzero(p).tolist() for p in prev],
            "min_score": float(max(sc[nb].min(), 0.02)) if nb.any()
            else 0.05,
            "accept": np.flatnonzero(buf[-1]).tolist()
            if buf.shape[0] else [],
            "cand": int(cand) if bool(ok) else -1}


def event_row(slam, lc, k, kf_seq, closed):
    m = slam.map
    return {"kf_seq": int(kf_seq), "slot": int(k),
            "frame": int(slam._slot_fid.get(int(k), -1)),
            "live_kf": int(m.kf_valid.sum()), "points": int(m.pt_valid.sum()),
            "candidates": lc.n_candidates, "verify_fail": lc.n_verify_fail,
            "rejected": lc.n_rejected, "closed": bool(closed)}


def loop_config():
    """``chip_smoke.py::vga_config("mapping")``."""
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    cam = CameraParams(fx=525.0, fy=525.0, cx=319.5, cy=239.5, bf=40.0,
                       width=640, height=480)
    return SlamConfig(camera=cam, orb=OrbConfig(n_features=1024, n_levels=8),
                      tracking=TrackingConfig(th_depth=8.0, kf_max_interval=8),
                      map=MapConfig())


def _render(i):
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, loop_trajectory, render_rgbd)
    Twc = loop_trajectory(N_LOOP, radius=2.5)[i]
    g, d = render_rgbd(default_world(n_boxes=0), loop_config().camera, Twc)
    return (np.clip(g, 0, 255).astype(np.uint8),
            np.clip(d * 1e3, 0, 65535).astype(np.uint16))


def loop_frames(workers=8, revisit=N_REVISIT):
    """The frames of the loop circle and its first ``revisit`` frames
    again, rendered in a pool of fresh processes (closed before it
    returns)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, os.cpu_count() or 1)) as pool:
        frames = pool.map(_render, range(N_LOOP))
    return frames + frames[:revisit]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pipeline", choices=("default", "eager"),
                    default="default")
    ap.add_argument("--frames-file", default=None,
                    help="frames saved as arrays gray, depth in an .npz "
                         "(tests/test_torch_loop_circle_decisions.py "
                         "--render) instead of rendering them")
    ap.add_argument("--revisit", type=int, default=N_REVISIT,
                    help="frames of the circle tracked again after it "
                         "(when the frames are rendered here)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("trace: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if args.frames_file:
        with np.load(args.frames_file) as f:
            frames = list(zip(f["gray"], f["depth"]))
    else:
        frames = loop_frames(revisit=args.revisit)
    t1 = time.perf_counter()
    events, verifs, detects, slam = trace_port(
        loop_config(), frames, torch.device(args.device),
        eager=args.pipeline == "eager")
    out = {"device": args.device, "pipeline": args.pipeline,
           "frames": len(frames), "render_s": t1 - t0,
           "run_s": time.perf_counter() - t1, "events": events,
           "verifications": verifs, "detections": detects,
           "loops_closed": slam.n_loops_closed}
    for v in verifs:
        print(json.dumps(v))
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("events", "verifications", "detections")}))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
