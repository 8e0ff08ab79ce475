"""What the entry points share: the common options, the configuration,
the tracking loop with its timing, and the closing report."""

import argparse
import sys
import time

import numpy as np


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the options every entry point takes."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--settings", default=None,
                    help="reference-format settings YAML (TUM1.yaml etc.)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device the System runs on (default cuda)")
    return ap


def config(args, sensor: str):
    from active_orb_slam2_tpu_torch.config import SlamConfig, load_settings
    return load_settings(args.settings, sensor=sensor) if args.settings \
        else SlamConfig(sensor=sensor)


def track_all(slam, frames, track, max_frames=None, every: int = 50):
    """Call ``track(slam, *frame_without_t, t)`` for each ``(t, ...)`` of
    ``frames``; returns the per-frame host times in seconds."""
    times = []
    for i, (t, *images) in enumerate(frames):
        if max_frames and i >= max_frames:
            break
        t0 = time.perf_counter()
        track(*images, t)
        times.append(time.perf_counter() - t0)
        if i % every == 0:
            print(f"frame {i} state={slam.state} kfs={slam.kf_seq}",
                  file=sys.stderr)
    slam.flush()
    return times


def report(slam, times):
    ts = np.array(times[2:] if len(times) > 2 else times)
    print(f"frames: {len(times)}  median track: {np.median(ts) * 1e3:.1f} ms"
          f"  mean: {ts.mean() * 1e3:.1f} ms  keyframes: {slam.kf_seq}"
          f"  loops: {slam.n_loops_closed}")
