"""One run of one cell: set-up (traffic on the device, the ``System``,
the warm-up frames one at a time, then the mix's mode, if it names
one), the paced window, the traced stretch, the check.

A traced run also turns the program's own tracer on before the
``System`` is built, ties it to the profiler's clock when the stretch's
profiler starts, and hands its spans to the metric readers as
``run.program`` (``benchmark/harness/program_trace.py``).

The window is paced as ORB-SLAM2's dataset runners pace it
(``rgbd_tum.cc``, ``stereo_kitti.cc``): one client hands in frame k once
the call for frame k-1 has returned, and not before its timestamp k /
rate (the mix's ``rate_hz``, else the settings file's Camera.fps); it
never drops a frame.  A frame's pose time runs from
handing it in to the completion on the device of a CUDA event recorded
when its call returned; the device clock is tied to the host's by one
event taken after a synchronize at the window's start.
"""

import dataclasses
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import check, definitions, program_trace, spans, trace
from benchmark.reference import settings as ref_settings
from benchmark.traffic import generate

OK = 1           # the program's tracking state OK


def process_age_s():
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def host_cpu():
    """This process's CPU seconds so far (``os.times``)."""
    t = os.times()
    return t.user + t.system


def thread_cpu():
    """CPU seconds of each of this process's threads so far, by thread
    id: (name, seconds), from ``/proc/self/task``."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                head, tail = f.read().rsplit(")", 1)
        except OSError:
            continue
        fields = tail.split()
        name = "main" if tid == str(os.getpid()) else head.split("(", 1)[1]
        out[tid] = (name,
                    (int(fields[11]) + int(fields[12])) / tick)
    return out


def host_share(cpu0, cpu1, wall_s, threads0, threads1):
    """Log lines: the CPU seconds this process took in the window, per
    second of it, and the threads that took most; with the work fixed, a
    host whose cores run slower or are shared shows as more."""
    used = sorted(((s - threads0.get(t, (n, 0.0))[1], n, t)
                   for t, (n, s) in threads1.items()), reverse=True)
    top = ", ".join(f"{n}[{t}] {s:.2f}" for s, n, t in used[:6])
    return (f"host: {cpu1 - cpu0:.2f} cpu-s in the window's {wall_s:.2f} s "
            f"({(cpu1 - cpu0) / wall_s:.3f} cores); threads: {top}")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Completion times of frames on the host clock: CUDA events tied to
    the host at the start, or, on the CPU, the host clock itself."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        sync(device)
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
            self.e0.synchronize()
        self.h0 = time.perf_counter()
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def done_s(self):
        if not self.cuda:
            return np.array(self.marks)
        return np.array([self.h0 + self.e0.elapsed_time(e) / 1e3
                         for e in self.marks])


def port_config(cj, yaml_path, shrink=None):
    """The program's configuration: its own reader of the settings file,
    the data's image size, ORB-SLAM2's keyframe interval (mMaxFrames =
    Camera.fps) and the arena of the configuration file."""
    from active_orb_slam2_tpu_torch.config import MapConfig, load_settings
    w, h = cj["image_size"]
    cfg = load_settings(yaml_path, sensor=cj["sensor"], width=w, height=h)
    cam = cfg.camera._replace(width=w, height=h)
    cfg = dataclasses.replace(
        cfg, camera=cam, map=MapConfig(**cj["arena"]),
        tracking=dataclasses.replace(cfg.tracking,
                                     kf_max_interval=int(round(cfg.fps))))
    if shrink:
        cfg = shrink_config(cfg, shrink)
    return cfg


def shrink_config(cfg, shrink):
    """A small copy for tests on the CPU: the image scaled by
    ``shrink["factor"]`` (intrinsics with it), fewer features, a smaller
    arena."""
    from active_orb_slam2_tpu_torch.config import MapConfig
    from active_orb_slam2_tpu_torch.ops.undistort import compute_image_bounds
    s = shrink["factor"]
    c = cfg.camera
    cam = c._replace(fx=c.fx * s, fy=c.fy * s, cx=c.cx * s, cy=c.cy * s,
                     bf=c.bf * s, width=int(c.width * s),
                     height=int(c.height * s), min_x=0.0, max_x=-1.0,
                     min_y=0.0, max_y=-1.0)
    if any(v != 0.0 for v in cfg.distortion):
        x0, x1, y0, y1 = compute_image_bounds(cam, cfg.distortion)
        cam = cam._replace(min_x=x0, max_x=x1, min_y=y0, max_y=y1)
    return dataclasses.replace(
        cfg, camera=cam,
        orb=dataclasses.replace(cfg.orb, n_features=shrink["n_features"],
                                n_levels=shrink.get("n_levels",
                                                    cfg.orb.n_levels)),
        map=MapConfig(max_keyframes=shrink["max_keyframes"],
                      max_points=shrink["max_points"],
                      local_ba_keyframes=8, local_ba_points=1024))


def reference_config(cj, yaml_path, cfg):
    """The reference's camera and extractor, read from the settings file
    by the reference's own reader (at the program's size when shrunk)."""
    cam, orb, fps = ref_settings.load(yaml_path, *cj["image_size"])
    if cfg.camera.width != cam.width:
        c = cfg.camera
        cam = cam._replace(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf,
                           width=c.width, height=c.height)
        orb = orb._replace(n_features=cfg.orb.n_features,
                           n_levels=cfg.orb.n_levels)
    return cam, orb, fps


class Reservoir:
    """A uniform sample of ``k`` of the items offered (Algorithm R)."""

    def __init__(self, k, rng):
        self.k, self.rng, self.items, self.seen = k, rng, {}, []

    def offer(self, key, value):
        n = len(self.seen)
        self.seen.append(key)
        if n < self.k:
            self.items[key] = value
            return
        j = int(self.rng.integers(n + 1))
        if j < self.k:
            del self.items[sorted(self.items)[j]]
            self.items[key] = value


def hand_in(slam, sensor, traffic, i):
    a, b = traffic.images[0][i], traffic.images[1][i]
    if sensor == "stereo":
        slam.track_stereo(a, b, float(traffic.timestamps[i]))
    else:
        slam.track_rgbd(a, b, float(traffic.timestamps[i]))


def frame_outcomes(slam, first_fid, n):
    """Whether each of frames first_fid .. first_fid + n - 1 ended OK: a
    metrics row holds the state before its frame retired, so a frame's
    own outcome is the next row's state (the last frame's is the
    System's)."""
    rows = {r["frame"]: r for r in slam.metrics}
    out = []
    for f in range(first_fid, first_fid + n):
        r = rows.get(f)
        if r is not None and r.get("wall_ms") is None:
            out.append(False)              # relocalization failed
            continue
        nxt = rows.get(f + 1)
        state = nxt["state"] if nxt is not None else slam._state
        out.append(state == OK)
    return out


def events(slam):
    """The running counts of keyframe events: keyframes, loop candidates
    (each verified), failed verifications, loops closed."""
    lc = slam.loop_closer
    return np.array([slam.kf_seq, lc.n_candidates if lc else 0,
                     lc.n_verify_fail if lc else 0, slam.n_loops_closed])


def events_line(counts):
    kf, cand, fail, closed = (int(c) for c in counts)
    return (f"{kf} keyframes, {cand} loop candidates, {fail} failed "
            f"verification, {closed} loops closed")


def run(cell_name, seed, seconds, trace_on, device, hooks=(), shrink=None,
        mix_overrides=None, log=print):
    """Everything of one run but the printing; returns a namespace that
    the metric readers read (``run.*``) and the check's numbers."""
    from active_orb_slam2_tpu_torch.models.system import System
    cell = definitions.cell(cell_name)
    cj, yaml_path = definitions.config(cell["config"])
    mix = definitions.mix(cell["traffic"])
    for k, v in (mix_overrides or {}).items():
        mix[k] = v
    cfg = port_config(cj, yaml_path, shrink)
    rcam, rorb, fps = reference_config(cj, yaml_path, cfg)
    # the camera's rate: the mix's, else the settings file's Camera.fps
    fps = float(mix.get("rate_hz", fps))
    sensor = cj["sensor"]
    n_total = generate.frames_needed(mix, fps, seconds)
    t0 = time.perf_counter()
    traffic = generate.make(mix, rcam, fps, sensor, seed, n_total, device)
    sync(device)
    log(f"traffic: {n_total} frames from path index {traffic.start} in "
        f"{time.perf_counter() - t0:.2f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace_on:
        from active_orb_slam2_tpu_torch.utils import trace as program
        program.reset()
        program.enable()
    slam = System(cfg, use_mapping=True,
                  use_loop_closing=bool(cj["loop_closing"]), device=device,
                  vocab_path=definitions.resolve(cj["vocabulary"]))
    for hook in hooks:
        hook(slam)
    n_warm = int(mix["warmup"]["frames"])
    # one warm-up frame at a time: each retires, and its keyframe is
    # mapped, before the next is tracked, so the host's timing does not
    # decide which frames a keyframe's mapping has seen
    for i in range(n_warm):
        hand_in(slam, sensor, traffic, i)
        slam.flush()
    sync(device)
    log(f"warm-up: {n_warm} frames, {events_line(events(slam))}")
    if mix.get("mode") == "localization":
        slam.activate_localization_mode()

    # what the check compares: a uniform sample, drawn from the seed, of
    # the window's frames as built and of its pose solves with their
    # inputs (reservoir samples: the counts are known only at the end)
    n_max = int(np.ceil(fps * seconds))
    rng = np.random.default_rng(int(seed) % (2 ** 63) + 1)
    frames = Reservoir(int(mix["check"]["sample_frames"]), rng)
    solves = Reservoir(int(mix["check"]["sample_solves"]), rng)
    current = [None]
    attr = "_make_stereo" if sensor == "stereo" else "make_rgbd"
    built = getattr(slam, attr)

    def keep(*a, **kw):
        out = built(*a, **kw)
        if current[0] is not None:
            frames.offer(current[0], out[0])
        return out

    from active_orb_slam2_tpu_torch.models import tracking
    solve = tracking.pose_optimization_fused

    def keep_solve(*a, **kw):
        out = solve(*a, **kw)
        if current[0] is not None:
            solves.offer((current[0], len(solves.seen)), (a, kw, out))
        return out

    setattr(slam, attr, keep)
    tracking.pose_optimization_fused = keep_solve

    setup_s = process_age_s()
    host0, threads0 = host_cpu(), thread_cpu()
    clock = Clock(device)
    t_start = clock.h0
    hand, i = [], n_warm
    first_fid = slam.frame_id
    # keyframe events a window frame's call ran (its retirement maps a
    # keyframe and verifies a loop candidate inline)
    ev0 = ev = events(slam)
    carried = []
    while i - n_warm < n_max:
        due = t_start + (i - n_warm) / fps
        now = time.perf_counter()
        if now - t_start >= seconds:
            break
        if now < due:
            time.sleep(due - now)
        current[0] = i
        h = time.perf_counter()
        hand_in(slam, sensor, traffic, i)
        clock.mark()
        hand.append(h)
        ev, ev_before = events(slam), ev
        carried.append(ev > ev_before)
        i += 1
    current[0] = None
    slam.flush()
    sync(device)
    t_end = time.perf_counter()
    n_win = len(hand)
    latency_ms = (clock.done_s() - np.array(hand)) * 1e3
    outcomes = frame_outcomes(slam, first_fid, n_win)
    log(f"window: {n_win} frames in {t_end - t_start:.3f} s, "
        f"{n_win - sum(outcomes)} not OK; in the window "
        f"{events_line(events(slam) - ev0)}")
    log(host_share(host0, host_cpu(), t_end - t_start, threads0,
                   thread_cpu()))
    if n_win:
        q = np.percentile(latency_ms, [50, 90, 95, 99])
        share = np.mean(carried, axis=0)
        log(f"pose ms: mean {latency_ms.mean():.3f}, p50 {q[0]:.3f}, "
            f"p90 {q[1]:.3f}, p95 {q[2]:.3f}, p99 {q[3]:.3f}, "
            f"max {latency_ms.max():.3f}; frames carrying a keyframe's "
            f"mapping {share[0]:.4f}, a loop verification {share[1]:.4f}")

    prof = handed = None
    if trace_on:
        prof = profile_stretch(slam, sensor, traffic, i,
                               int(mix["profile_frames"]), device)
        i += int(mix["profile_frames"])
        program.disable()
        offset, idle = (prof["offset_ns"], prof["idle_by_span"]) if prof \
            else (None, None)
        handed = program_trace.handover(program.records(), (t_start, t_end),
                                        offset, idle)
        log("set-up spans: " + ", ".join(
            f"{k} {s:.3f} s ({n})" for k, s, n in
            program_trace.setup_totals(handed.records, handed.first_frame)))
        log("idle by program span: " + ", ".join(
            f"{k} {s:.3f} s" for k, s in list(handed.idle.items())[:10]))
    setattr(slam, attr, built)
    tracking.pose_optimization_fused = solve
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    # the program's answers to the host, then its state freed
    ts, tcw = slam.frame_trajectory()
    est_idx = np.rint(np.asarray(ts) * fps).astype(np.int64)
    m = slam.map
    pts = m.pt_xyz[m.pt_valid].cpu().numpy()
    cap = {k: check.host_frame(f) for k, f in frames.items.items()}
    del slam, m, frames, built, keep
    if device.type == "cuda":
        torch.cuda.empty_cache()

    win = (est_idx >= n_warm) & (est_idx < n_warm + n_win)
    r = SimpleNamespace(
        cell=cell_name, seed=seed, fps_camera=fps, setup_s=setup_s,
        window_s=t_end - t_start, window_bounds=(t_start, t_end),
        n_window=n_win, latency_ms=latency_ms,
        failed=n_win - sum(outcomes),
        gt_twc_window=traffic.twc[est_idx[win]].astype(np.float64),
        est_tcw_window=np.asarray(tcw)[win], profile=prof,
        program=handed, memory_peak_bytes=int(peak))
    numbers = check.frames_numbers(cap, traffic, rcam, rorb, sensor, device)
    numbers.update(check.solve_numbers(solves.items))
    numbers.update(check.trajectory_numbers(est_idx, tcw, pts, traffic))
    return r, numbers


def profile_stretch(slam, sensor, traffic, start, n, device):
    """``torch.profiler`` over ``n`` whole frames handed in back to back
    after the window, ending with a flush and a synchronize; the kernel
    entries' arguments kept for counting.  The program's tracer, on in a
    traced run, is anchored to the profiler's clock as the profiler
    starts, and the device's idle gaps are placed in its spans
    (``idle_by_span``, seconds; ``idle_gaps``, its ten largest)."""
    from torch.profiler import ProfilerActivity, profile
    from active_orb_slam2_tpu_torch.kernels import keypoints, pose_opt
    from active_orb_slam2_tpu_torch.utils import trace as program
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with spans.KernelArgs(pose_opt, ["pose_opt_cuda"]) as k1, \
            spans.KernelArgs(keypoints, ["keypoint_stage_cuda"]) as k2:
        with profile(activities=acts) as prof:
            program.anchor()
            t0 = time.perf_counter()
            for i in range(start, start + n):
                hand_in(slam, sensor, traffic, i)
            slam.flush()
            sync(device)
            stretch_us = (time.perf_counter() - t0) * 1e6
    if device.type != "cuda":
        return None
    t0 = time.perf_counter()
    ev = trace.raw_events(prof)
    out = trace.read(ev, stretch_us)
    offset = program.profiler_offset_ns(
        [(name, int(a * 1e3)) for name, on_dev, a, _ in ev if not on_dev])
    idle = program_trace.idle_by_span(program.records(), offset, ev)
    out.update(frames=n, k1_args=k1.calls["pose_opt_cuda"],
               k2_args=k2.calls["keypoint_stage_cuda"], offset_ns=offset,
               idle_by_span=idle, idle_gaps=list(idle.items())[:10])
    print(f"trace: {n} frames profiled in {stretch_us / 1e6:.2f} s, read in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    return out
