"""Long-sequence run of the PyTorch port: 1,200 synthetic RGB-D frames
through ``System`` against a 24-keyframe arena, so keyframe culling and
slot recycling must keep tracking healthy and memory flat for the whole
run.  The port of ``scripts/run_long_sequence.py``: the same
configuration, orbit, JSON line and pass rule.

  python scripts/run_torch_long_sequence.py [--frames 1200]
      [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given.  The frames are
rendered in a pool of processes before the run.  Prints one JSON line,
with the card's name and power limit and the kernels' launches beside
the JAX script's keys.
"""
import argparse
import json
import multiprocessing
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

STEP_DEG = 0.2     # slow sweep: heavy keyframe overlap


def long_config():
    from active_orb_slam2_tpu_torch.config import (
        MapConfig, OrbConfig, SlamConfig, TrackingConfig)
    from active_orb_slam2_tpu_torch.geometry.projection import CameraParams
    cam = CameraParams(fx=260.0, fy=260.0, cx=159.5, cy=119.5, bf=20.8,
                       width=320, height=240)
    return SlamConfig(
        camera=cam, orb=OrbConfig(n_features=512, n_levels=4),
        tracking=TrackingConfig(th_depth=10.0, kf_max_interval=8),
        map=MapConfig(max_keyframes=24, max_points=8192,
                      local_ba_keyframes=6, local_ba_points=1024))


_worker = {}


def _init_worker(n):
    from active_orb_slam2_tpu_torch.io.synthetic import (
        default_world, orbit_trajectory)
    _worker["world"] = default_world()
    _worker["traj"] = orbit_trajectory(n, step_deg=STEP_DEG)
    _worker["cam"] = long_config().camera


def _render(i):
    from active_orb_slam2_tpu_torch.io.synthetic import render_rgbd
    Twc = _worker["traj"][i]
    g, d = render_rgbd(_worker["world"], _worker["cam"], Twc)
    return g, d, Twc[:3, 3].copy()


def render_frames(n):
    """``make_sequence``'s frames of the orbit (noise-free), rendered in
    a pool of spawned processes."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1),
                  initializer=_init_worker, initargs=(n,)) as pool:
        return pool.map(_render, range(n), chunksize=8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from active_orb_slam2_tpu_torch.io.trajectory import camera_centers
    from active_orb_slam2_tpu_torch.models.system import OK, System
    from active_orb_slam2_tpu_torch.utils.evaluate import umeyama_alignment
    from run_torch_endurance import card_name_and_limit, kernel_launches

    device = torch.device(args.device)
    cfg = long_config()
    n = args.frames
    t0 = time.perf_counter()
    frames = render_frames(n)
    print(f"rendered {n} frames in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    slam = System(cfg, device=device)
    launches0 = kernel_launches()
    lost, mem = 0, []
    t0 = time.perf_counter()
    gt = []
    for i, (g, d, c) in enumerate(frames):
        slam.track_rgbd(g, d, i / 30.0)
        gt.append(c)
        if i % 100 == 99:
            slam.flush()
            lost += int(slam._state != OK)
            if device.type == "cuda":
                mem.append(round(torch.cuda.memory_allocated(device)
                                 / 2**20, 1))
            print(f"[{i + 1}/{n}] kf_seq={slam.kf_seq} "
                  f"live={slam.n_live_kf} state={slam._state} "
                  f"pts={int(slam.map.pt_valid.sum())}", file=sys.stderr,
                  flush=True)
    slam.flush()
    wall = time.perf_counter() - t0
    _, poses = slam.frame_trajectory()
    rmse = umeyama_alignment(camera_centers(poses), np.stack(gt),
                             fix_scale=True)[4]
    live = int(slam.map.kf_valid.sum())
    launches = {k: v - launches0[k] for k, v in kernel_launches().items()}
    print(json.dumps({
        "metric": "long_sequence_endurance",
        "frames": n,
        "kf_inserted_total": slam.kf_seq,
        "kf_live_final": live,
        "kf_arena": cfg.map.max_keyframes,
        "recycled": slam.kf_seq - live,
        "ate_rmse_m": round(float(rmse), 4),
        "checkpoints_lost": lost,
        "fps": round(n / wall, 2),
        "backend": device.type,
        "card": card_name_and_limit() if device.type == "cuda" else None,
        "launches": launches,
        "allocated_mib_every_100": mem,
        "forced_evictions": slam.n_forced_culls,
        "ok": bool(lost == 0 and slam.kf_seq > 2 * cfg.map.max_keyframes
                   and float(rmse) < 0.15),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
