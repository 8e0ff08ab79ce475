"""Endurance run of the PyTorch port: thousands of frames through the
full pipeline (local mapping and loop closing on) at the default arena
(512 keyframes, 65,536 points), with a timeline, sampled stage profiles
and bisection switches.  The port of ``scripts/run_endurance.py``: the
same configuration, world, trajectories, render cache, record keys and
pass rule.

  python scripts/run_torch_endurance.py [--frames 4000]
      [--trajectory tour|circle] [--width 320 --height 240]
      [--device cuda|cpu] [--out ENDURANCE_TORCH.json]
      [--timeline FILE.jsonl] [--profile-every 8]
      [--no-loop] [--gba-iters N] [--no-cull] [--no-fuse] [--no-local-ba]
      [--dump-closures DIR]

The camera drives a closed circuit of the synthetic box world, lap
after lap: ``tour``, a room-covering Lissajous figure (arena growth,
the 48-keyframe vocabulary retrain), or ``circle`` (keyframe culling and
slot recycling).  The ``--unique`` poses of one lap are rendered once,
in a pool of processes; every lap runs the full per-frame work.

Besides the JAX script's keys the record has the rigid ATE (RGB-D has
no free scale), the device memory at each 250-frame checkpoint, the
kernels' launches, the vocabulary trainings and the card's name and
power limit.  It runs on the card unless ``--device cpu`` is given.

``--dump-closures DIR`` records every loop correction's inputs, accepted
or rejected, as ``DIR/closure_<n>_{accepted|rejected}.npz`` (the loop
closer's ``dump_correction``; replay one with
``scripts/dissect_torch_closure.py``) and lists them in the record with
each closure's Sim3 against ground truth.  It changes no result; each
correction then waits on the card once more, to copy the arena out.
"""
import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHECKPOINT_EVERY = 250


def pct(xs, q):
    a = np.asarray(xs)
    return round(float(np.percentile(a, q)), 3) if a.size else None


def np_umeyama_ate(est, gt, fix_scale: bool = False):
    """ATE RMSE after a similarity alignment (rigid with ``fix_scale``)."""
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    return umeyama_alignment(est, gt, fix_scale=fix_scale)[4]


def aligned_errors(est, gt):
    """Each frame's centre error under the similarity alignment."""
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    aligned = umeyama_alignment(est, gt)[0]
    return np.linalg.norm(aligned - np.asarray(gt, np.float64), axis=1)


def camera_config(width: int, height: int):
    """The JAX script's camera and configuration: 1024 features, 8
    levels, ThDepth 8, a keyframe at least every 8 frames, the default
    arena."""
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    f = 260.0 * width / 320.0
    cam = CameraParams(fx=f, fy=f, cx=(width - 1) / 2.0,
                       cy=(height - 1) / 2.0, bf=f * 0.08, width=width,
                       height=height)
    return SlamConfig(camera=cam, orb=OrbConfig(n_features=1024, n_levels=8),
                      tracking=TrackingConfig(th_depth=8.0, kf_max_interval=8),
                      map=MapConfig())


def world_and_trajectory(trajectory: str, unique: int, seed: int):
    """The tour sweeps the room, so its world has no interior boxes."""
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, loop_trajectory, tour_trajectory)
    world = default_world(n_boxes=0 if trajectory == "tour" else 8,
                          seed=seed)
    traj = (loop_trajectory(unique, radius=1.2) if trajectory == "circle"
            else tour_trajectory(unique))
    return world, traj


_worker = {}


def _init_worker(trajectory, unique, seed, width, height):
    _worker["world"], _worker["traj"] = world_and_trajectory(
        trajectory, unique, seed)
    _worker["cam"] = camera_config(width, height).camera


def _render(i):
    from active_orb_slam2_tpu_torch.io.synthetic import render_rgbd
    Twc = _worker["traj"][i]
    g, d = render_rgbd(_worker["world"], _worker["cam"], Twc)
    return (np.clip(g, 0, 255).astype(np.uint8),
            np.clip(d * 1e3, 0, 65535).astype(np.uint16),
            Twc[:3, 3].copy())


def render_cache(trajectory, unique, seed, width, height):
    """(gray uint8, depth mm uint16, true centre) of each unique pose,
    rendered in a pool of spawned processes (closed before it returns)."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1), initializer=_init_worker,
                  initargs=(trajectory, unique, seed, width, height)) as pool:
        return pool.map(_render, range(unique), chunksize=8)


def card_name_and_limit():
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


# the keyframe stages' spans sampled by --profile-every -> record keys
STAGE_KEYS = {"mapping": "mapping", "loop.detect": "loop_detect",
              "loop.verify": "loop_verify", "loop.correct": "loop_correct",
              "loop.gba_slice": "gba_slice"}


def kernel_launches():
    """K1's and K2's launches so far (the tracer's counters)."""
    from active_orb_slam2_tpu_torch.utils import trace
    now = trace.counters()
    return {"pose_opt": now.get("k1.launches", 0),
            "keypoints": now.get("k2.launches", 0)}


def memory_checkpoint(device, frame):
    """Device memory (MiB): allocated now and the peak since the run
    started, and the pinned host memory in use where PyTorch reports
    it."""
    import torch
    row = {"frame": frame}
    if device.type != "cuda":
        return row
    row["allocated_mib"] = round(torch.cuda.memory_allocated(device) / 2**20, 1)
    row["peak_mib"] = round(torch.cuda.max_memory_allocated(device) / 2**20, 1)
    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    if host_stats is not None:
        try:
            st = host_stats()
            row["pinned_in_use_mib"] = round(
                st.get("allocated_bytes.current", 0) / 2**20, 3)
        except RuntimeError:
            pass
    return row


def sim3_check(lcd, traj, unique):
    """The verified Sim3 of a closure against ground truth: ``s_cm`` maps
    loop-keyframe camera coordinates to current-keyframe ones."""
    def qmat(q):
        w, x, y, z = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    Twc_c = np.asarray(traj[lcd["cur_fid"] % unique], np.float64)
    Twc_l = np.asarray(traj[lcd["loop_fid"] % unique], np.float64)
    T_rel = np.linalg.inv(Twc_c) @ Twc_l
    s = np.asarray(lcd["s_cm"], np.float64)
    R = qmat(s[:4] / np.linalg.norm(s[:4]))
    cosang = (np.trace(R.T @ T_rel[:3, :3]) - 1) / 2
    return {"sim3_t_err": round(float(np.linalg.norm(s[4:7] - T_rel[:3, 3])), 4),
            "sim3_rot_err_deg": round(float(np.degrees(np.arccos(
                np.clip(cosang, -1, 1)))), 3),
            "sim3_scale": round(float(s[7]), 5)}


def record_closures(lc, out_dir):
    """Wrap ``lc.correct`` (from outside) so that each call's inputs are
    written to ``out_dir/closure_<n>_{accepted|rejected}.npz``: the arena
    is copied to the host before the call (an accepted correction writes
    it in place) and (li, lj, new_n) computed as the call will.  Returns
    the list that receives a row per correction."""
    from active_orb_slam2_tpu_torch.models.loop_closing import (
        MAX_LOOP_EDGES, dump_correction)
    from active_orb_slam2_tpu_torch.models.map_state import (
        MapState, covisibility_weights)
    os.makedirs(out_dir, exist_ok=True)
    rows, run_correct = [], lc.correct

    def correct(m, cur_kf, loop_kf, s_cm, W=None, max_loop=MAX_LOOP_EDGES):
        before = MapState(*[x.to("cpu", copy=True) for x in m])
        W_in = covisibility_weights(m) if W is None else W
        li, lj, new_n = lc.next_loop_window(cur_kf, loop_kf, max_loop)
        m, accepted = run_correct(m, cur_kf, loop_kf, s_cm, W=W,
                                  max_loop=max_loop)
        path = os.path.join(out_dir, f"closure_{len(rows)}_"
                            f"{'accepted' if accepted else 'rejected'}.npz")
        dump_correction(path, before, cur_kf, loop_kf, s_cm, li, lj, new_n,
                        W_in.to("cpu"))
        diag = lc.last_closure if accepted else lc.last_rejection
        rows.append({"file": path, "accepted": accepted,
                     **{k: v for k, v in diag.items() if k != "s_cm"},
                     "s_cm": np.asarray(diag["s_cm"]).tolist()})
        return m, accepted

    lc.correct = correct
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4000)
    ap.add_argument("--unique", type=int, default=1000,
                    help="unique poses on the circuit (render cache)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default="ENDURANCE_TORCH.json")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--trajectory", choices=("circle", "tour"),
                    default="tour")
    ap.add_argument("--timeline", default=None,
                    help="JSONL path for per-event keyframe-ATE records")
    ap.add_argument("--profile-every", type=int, default=8,
                    help="synchronized stage times on every Nth keyframe "
                    "event (0 = never)")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--gba-iters", type=int, default=None,
                    help="the loop closer's global-BA iterations per closure "
                    "(the prompt one runs even at 0)")
    ap.add_argument("--no-cull", action="store_true")
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--no-local-ba", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dump-closures", default=None, metavar="DIR",
                    help="record every loop correction's inputs in DIR")
    return ap.parse_args(argv)


def run(args, cache=None, log=None):
    """The endurance run; returns the record.  ``cache`` may hold the
    rendered unique poses (``render_cache``)."""
    import torch
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models.local_mapping import (
        build_keyframe_mapping)
    from active_orb_slam2_tpu_torch.models.system import OK, System
    from active_orb_slam2_tpu_torch.utils import trace

    device = torch.device(args.device)
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    w, h = args.width, args.height
    cfg = camera_config(w, h)
    assert cfg.map.max_keyframes == 512 and cfg.map.max_points == 65536
    t0 = time.time()
    _, traj = world_and_trajectory(args.trajectory, args.unique, args.seed)
    if cache is None:
        log(f"[{time.time() - t0:6.1f}s] rendering {args.unique} unique "
            f"poses at {w}x{h}")
        cache = render_cache(args.trajectory, args.unique, args.seed, w, h)
        log(f"[{time.time() - t0:6.1f}s] frames ready")

    slam = System(cfg, use_mapping=True, use_loop_closing=not args.no_loop,
                  device=device)
    lc = slam.loop_closer
    if args.gba_iters is not None and lc is not None:
        lc.gba_iters = args.gba_iters
    closures = record_closures(lc, args.dump_closures) \
        if args.dump_closures and lc is not None else None
    if args.no_cull or args.no_fuse or args.no_local_ba:
        slam.keyframe_mapping = build_keyframe_mapping(
            cfg, triangulate=True, fuse=not args.no_fuse,
            local_ba=not args.no_local_ba, cull=not args.no_cull)

    stage_hist = {key: [] for key in STAGE_KEYS.values()}
    trainings = []
    retrain_ms = 0.0
    timeline_f = open(args.timeline, "w") if args.timeline else None

    def kf_ate_now(fix_scale=False):
        """Keyframe-trajectory ATE from the latest dispatched map."""
        if len(slam.kf_records) < 4:
            return None
        poses = slam.map.kf_pose.cpu().numpy()
        slots = np.array([s for _, s in slam.kf_records])
        g = np.stack([cache[int(round(t * 30)) % args.unique][2]
                      for t, _ in slam.kf_records])
        return np_umeyama_ate(camera_centers(poses[slots]), g, fix_scale)

    gt, checkpoints = [], []
    lost_frames = peak_live_kf = peak_live_pt = 0
    n = args.frames
    prev_kf_seq = prev_loops = 0
    stage = lc._vocab_stage if lc is not None else 0
    launches0 = kernel_launches()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_run = time.perf_counter()
    for i in range(n):
        g, d, c = cache[i % args.unique]
        # every frame traced (the vocabulary training's span, also in a
        # checkpoint's flush); the sampled keyframe events synchronized
        # for their stages' spans
        sampled = (args.profile_every > 0
                   and slam.kf_seq % args.profile_every == 0)
        trace.enable(sync=sampled)
        slam.track_rgbd(g, d, i / 30.0)
        gt.append(c)
        spans = trace.durations_ms(tuple(STAGE_KEYS) + ("loop.retrain",))
        trace.reset()
        if sampled:
            for name, key in STAGE_KEYS.items():
                stage_hist[key] += spans.get(name, [])
        if lc is not None and lc._vocab_stage != stage:
            stage = lc._vocab_stage
            retrain_ms = spans.get("loop.retrain", [0.0])[-1]
            trainings.append({"frame": i, "stage": stage,
                              "kf_seq": slam.kf_seq,
                              "live_kf": slam.n_live_kf,
                              "n_words": lc.vocab.n_words,
                              "ms": round(retrain_ms, 1)})
            log(f"[{time.time() - t0:6.1f}s] vocabulary training "
                f"{stage}: {lc.vocab.n_words} words at frame {i}, "
                f"{slam.n_live_kf} live keyframes, {retrain_ms:.1f} ms")
        if timeline_f is not None and (slam.kf_seq != prev_kf_seq
                                       or slam.n_loops_closed != prev_loops):
            ate = kf_ate_now()
            row = {"frame": i, "kf_seq": slam.kf_seq,
                   "live_kf": slam.n_live_kf, "loops": slam.n_loops_closed,
                   "event": ("loop" if slam.n_loops_closed != prev_loops
                             else "kf"),
                   "kf_ate": None if ate is None else round(ate, 4)}
            if slam.n_loops_closed != prev_loops and lc.last_closure:
                lcd = lc.last_closure
                row.update(cur_fid=lcd["cur_fid"], loop_fid=lcd["loop_fid"])
                try:
                    row.update(sim3_check(lcd, traj, args.unique))
                except (TypeError, ValueError, np.linalg.LinAlgError) as ex:
                    row["sim3_err"] = repr(ex)
            timeline_f.write(json.dumps(row) + "\n")
            timeline_f.flush()
            prev_kf_seq, prev_loops = slam.kf_seq, slam.n_loops_closed
        if i % CHECKPOINT_EVERY == CHECKPOINT_EVERY - 1:
            slam.flush()
            live_kf = slam.n_live_kf
            live_pt = int(slam.map.pt_valid.sum())
            peak_live_kf = max(peak_live_kf, live_kf)
            peak_live_pt = max(peak_live_pt, live_pt)
            lost_frames += int(slam._state != OK)
            mem = memory_checkpoint(device, i + 1)
            # the cull-redirect lineage stays pruned over slot turnover
            mem["redirects"] = len(slam._cull_redirect)
            checkpoints.append(mem)
            log(f"[{time.time() - t0:6.1f}s] [{i + 1}/{n}] "
                f"kf_seq={slam.kf_seq} live_kf={live_kf} pts={live_pt} "
                f"loops={slam.n_loops_closed} "
                f"cand={getattr(lc, 'n_candidates', 0)} "
                f"vfail={getattr(lc, 'n_verify_fail', 0)} "
                f"rej={getattr(lc, 'n_rejected', 0)} state={slam._state} "
                f"mem={mem}")
    slam.flush()
    trace.disable()
    trace.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t_run
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    if timeline_f is not None:
        timeline_f.close()
    peak_live_kf = max(peak_live_kf, slam.n_live_kf)
    peak_live_pt = max(peak_live_pt, int(slam.map.pt_valid.sum()))

    _, poses = slam.frame_trajectory()
    est = camera_centers(poses)
    gt_np = np.stack(gt)
    ate = np_umeyama_ate(est, gt_np)
    ate_rigid = np_umeyama_ate(est, gt_np, fix_scale=True)
    aligned_err = aligned_errors(est, gt_np)
    kf_ate = kf_ate_now()
    kf_ate_rigid = kf_ate_now(fix_scale=True)
    n_degraded = sum(1 for (_, r, _) in slam.rel_records if r < 0)
    live_final = int(slam.map.kf_valid.sum())
    per_frame_wall = [m["wall_ms"] for m in slam.metrics
                      if m.get("wall_ms") is not None]
    peaks = [c["peak_mib"] for c in checkpoints
             if "peak_mib" in c and c["frame"] >= 1000]
    allocs = [c["allocated_mib"] for c in checkpoints
              if "allocated_mib" in c and c["frame"] >= 1000]
    mem_flat = (None if not peaks else bool(
        max(peaks) <= 1.05 * min(peaks)
        and max(allocs) <= 1.05 * min(allocs)))
    record = {
        "metric": "endurance_full_pipeline_default_arena",
        "frames": n,
        "trajectory": args.trajectory,
        "unique_poses": args.unique,
        "image": [w, h],
        "arena": [cfg.map.max_keyframes, cfg.map.max_points],
        "backend": device.type,
        "card": card_name_and_limit() if device.type == "cuda" else None,
        "bisect": {"loop": not args.no_loop,
                   "gba_iters": lc.gba_iters if lc is not None else None,
                   "cull": not args.no_cull,
                   "fuse": not args.no_fuse,
                   "local_ba": not args.no_local_ba},
        "fps_sustained": round(n / wall, 2),
        "wall_s": round(wall, 1),
        "kf_inserted_total": slam.kf_seq,
        "kf_live_final": live_final,
        "kf_recycled": slam.kf_seq - live_final,
        "peak_live_kf": peak_live_kf,
        "peak_live_points": peak_live_pt,
        "loops_closed": slam.n_loops_closed,
        "loops_rejected": getattr(lc, "n_rejected", 0) if lc else 0,
        "loop_candidates": getattr(lc, "n_candidates", 0) if lc else 0,
        "loop_verify_failures": getattr(lc, "n_verify_fail", 0) if lc else 0,
        "ate_rmse_m": round(ate, 4),
        "ate_rigid_rmse_m": round(ate_rigid, 4),
        "kf_ate_rmse_m": None if kf_ate is None else round(kf_ate, 4),
        "kf_ate_rigid_rmse_m": (None if kf_ate_rigid is None
                                else round(kf_ate_rigid, 4)),
        "frame_err_p50": pct(aligned_err, 50),
        "frame_err_p95": pct(aligned_err, 95),
        "frame_err_max": round(float(aligned_err.max()), 3),
        "degraded_records": n_degraded,
        "checkpoints_lost": lost_frames,
        "track_wall_ms_p50": pct(per_frame_wall, 50),
        "track_wall_ms_p95": pct(per_frame_wall, 95),
        "mapping_ms_p50": pct(stage_hist["mapping"], 50),
        "mapping_ms_p95": pct(stage_hist["mapping"], 95),
        "loop_detect_ms_p50": pct(stage_hist["loop_detect"], 50),
        "loop_verify_ms_p50": pct(stage_hist["loop_verify"], 50),
        "loop_verify_count": len(stage_hist["loop_verify"]),
        "loop_correct_ms_p50": pct(stage_hist["loop_correct"], 50),
        "loop_correct_count": len(stage_hist["loop_correct"]),
        "gba_slice_ms_p50": pct(stage_hist["gba_slice"], 50),
        "vocab_retrain_ms": round(retrain_ms, 1),
        "vocab_trainings": trainings,
        "profile_sampled_every": args.profile_every,
        "launches": launches,
        "memory_checkpoints": checkpoints,
        "memory_flat_from_1000": mem_flat,
        "forced_evictions": slam.n_forced_culls,
        **({} if closures is None else {"closure_dumps": [
            {**row, **sim3_check(row, traj, args.unique)}
            for row in closures]}),
        "ok": bool(lost_frames == 0
                   and (slam.n_loops_closed >= 1 or args.no_loop)
                   and ate < 0.15 and slam.kf_seq > 64),
    }
    return record


def main(argv=None):
    args = parse_args(argv)
    record = run(args)
    print(json.dumps(record))
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), args.out)
    with open(out, "w") as fp:
        json.dump(record, fp, indent=1)
    print(f"wrote {out}", file=sys.stderr)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
