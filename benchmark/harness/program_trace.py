"""Reading the program's own spans (``utils/trace.py`` of the port) for
a traced run: per-layer metrics of the frame pipeline, the track step,
``System``, local mapping, loop closing and set-up, and of the stages
inside them, the set-up's stage totals, and the device's idle gaps
placed in the innermost program span they fall in.

What a run hands over is ``run.program``: ``records`` (the tracer's
spans: name, frame id, parent row, start and end in
``perf_counter_ns``), ``first_frame`` (the window's first frame id) and
``offset_ns`` (the anchor's offset onto the profiler's clock, or None)
and ``idle`` (``idle_by_span`` of the traced stretch).
A per-frame metric sums its spans over the window's frames, by frame id,
and divides by the number of those frames; a per-call metric divides
the sum by the number of spans.  Without spans either is None.  A
keyframe event's spans (``mapping*``, ``loop*``) carry the keyframe's
frame id.
"""

import collections
from types import SimpleNamespace

import numpy as np

from benchmark.harness import trace as device_trace

# the per-frame metrics on program spans: metric -> span
PER_FRAME_MS = {
    "frame.host_ms": "frame",
    "frame.fast.host_ms": "frame.fast",
    "frame.topk.host_ms": "frame.topk",
    "track.host_ms": "track",
    "track.motion.host_ms": "track.motion",
    "track.local_map.host_ms": "track.local_map",
    "system.upload.host_ms": "system.upload",
    "system.wait_ms": "system.wait",
}
# the per-call metrics: metric -> span (a keyframe event's)
PER_CALL_MS = {
    "mapping.host_ms_per_kf": "mapping",
    "loop.host_ms_per_kf": "loop",
}
# the layers that ``system.self_host_ms`` takes out of a frame's root span
LAYERS = ("frame", "track", "mapping", "loop")
TRACK_STAGES = ("track.motion", "track.local_map", "track.keyframe")


def handover(records, window_bounds, offset_ns=None, idle=None):
    """``run.program`` from the tracer's records: the window's first
    frame is the first ``system.track`` root that began inside the
    window (``window_bounds`` in ``perf_counter`` seconds)."""
    a, b = (int(t * 1e9) for t in window_bounds)
    roots = [r.frame for r in records
             if r.name == "system.track" and a <= r.t0_ns <= b]
    return SimpleNamespace(records=records,
                           first_frame=min(roots) if roots else None,
                           offset_ns=offset_ns, idle=idle or {})


def _program(run):
    p = getattr(run, "program", None)
    if p is None or p.first_frame is None or not run.n_window:
        return None
    return p


def window_spans(run, match):
    """Closed spans of the window's frames whose name ``match`` accepts."""
    p = _program(run)
    if p is None:
        return []
    lo, hi = p.first_frame, p.first_frame + run.n_window
    return [r for r in p.records if r.t1_ns is not None and match(r.name)
            and r.frame is not None and lo <= r.frame < hi]


def per_frame_ms(run, match):
    spans = window_spans(run, match)
    if not spans:
        return None
    return sum(r.t1_ns - r.t0_ns for r in spans) / 1e6 / run.n_window


def per_call_ms(run, span):
    spans = window_spans(run, lambda n: n == span)
    if not spans:
        return None
    return sum(r.t1_ns - r.t0_ns for r in spans) / 1e6 / len(spans)


def system_self_ms(run):
    """Host ms a window frame inside its ``system.track`` root, less the
    outermost spans of the layers (``LAYERS``) inside it.  A keyframe
    event's spans carry the keyframe's frame id, but count against the
    root they ran in."""
    p = _program(run)
    if p is None:
        return None
    lo, hi = p.first_frame, p.first_frame + run.n_window
    root, in_layer, self_ns = {}, set(), {}
    for i, r in enumerate(p.records):
        if r.parent is None:
            if r.name == "system.track" and r.t1_ns is not None \
                    and r.frame is not None and lo <= r.frame < hi:
                root[i] = i
                self_ns[i] = r.t1_ns - r.t0_ns
            continue
        if r.parent not in root:
            continue
        k = root[i] = root[r.parent]
        if r.parent in in_layer:
            in_layer.add(i)
        elif r.name in LAYERS:
            in_layer.add(i)
            if r.t1_ns is not None:
                self_ns[k] -= r.t1_ns - r.t0_ns
    if not self_ns:
        return None
    return sum(self_ns.values()) / 1e6 / run.n_window


def setup_system_s(run):
    p = getattr(run, "program", None)
    if p is None:
        return None
    spans = [r for r in p.records
             if r.name == "setup.system" and r.t1_ns is not None]
    return sum(r.t1_ns - r.t0_ns for r in spans) / 1e9 if spans else None


def _reader(span):
    return lambda run: per_frame_ms(run, lambda n: n == span)


def _call_reader(span):
    return lambda run: per_call_ms(run, span)


READERS = {name: _reader(span) for name, span in PER_FRAME_MS.items()}
READERS.update({name: _call_reader(span)
                for name, span in PER_CALL_MS.items()})
READERS["system.self_host_ms"] = system_self_ms
READERS["setup.system_s"] = setup_system_s
UNITS = dict({name: "ms" for name in READERS}, **{"setup.system_s": "s"})


def stage_sums(run):
    """ms a frame of the frame pipeline's stage spans (``frame.*``) and
    of the track step's three stages, beside each other for a check
    against the layers' own spans."""
    return {
        "frame_stages_ms": per_frame_ms(
            run, lambda n: n.startswith("frame.")),
        "track_stages_ms": per_frame_ms(run, lambda n: n in TRACK_STAGES),
    }


def setup_totals(records, first_frame):
    """(name, seconds, count) of every span outside the window's frames
    that set-up or the warm-up's keyframe events made (``setup.*``,
    ``mapping*``, ``loop*``), longest first."""
    tot, n = collections.defaultdict(float), collections.Counter()
    for r in records:
        if r.t1_ns is None or not r.name.startswith(("setup.", "mapping",
                                                     "loop")):
            continue
        if first_frame is not None and r.frame is not None \
                and r.frame >= first_frame:
            continue
        tot[r.name] += (r.t1_ns - r.t0_ns) / 1e9
        n[r.name] += 1
    return sorted(((k, v, n[k]) for k, v in tot.items()),
                  key=lambda x: -x[1])


def innermost(records, t_lo_ns, t_hi_ns):
    """The innermost program span at each time of [t_lo_ns, t_hi_ns]: a
    step function (start times, names; None outside every span), from
    the spans that overlap the interval (they nest: one host thread)."""
    spans = [r for r in records if r.t1_ns is not None
             and r.t1_ns >= t_lo_ns and r.t0_ns <= t_hi_ns]
    edges = sorted([(r.t0_ns, 1, i) for i, r in enumerate(spans)]
                   + [(r.t1_ns, 0, i) for i, r in enumerate(spans)])
    stack, starts, names = [], [], []
    for t, opening, i in edges:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        starts.append(t)
        names.append(spans[stack[-1]].name if stack else None)
    return np.array(starts, dtype=np.int64), names


def idle_by_span(records, offset_ns, events):
    """Seconds of device idle time by the innermost program span that
    holds each gap's midpoint; ``events`` are the profiler's raw events
    (``benchmark/harness/trace.py::raw_events``), ``offset_ns`` the
    anchor's.  Gaps in no span go under "(none)"."""
    dev = [(a, b) for _, on_dev, a, b in events if on_dev]
    gaps = np.array(device_trace.gaps_us(dev)).reshape(-1, 2)
    if not len(gaps) or offset_ns is None:
        return {}
    mids = (gaps.mean(1) * 1e3 - offset_ns).astype(np.int64)
    starts, names = innermost(records, int(mids.min()), int(mids.max()))
    j = np.searchsorted(starts, mids, side="right") - 1
    out = collections.defaultdict(float)
    for k, (a, b) in zip(j, gaps):
        name = names[k] if k >= 0 else None
        out[name or "(none)"] += (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def stage_idle_share(idle):
    """Of the idle time inside the frame pipeline and the track step, the
    share that falls in their stage spans (``frame.*``, ``track.*``)
    rather than in the layer spans ``frame`` and ``track`` themselves."""
    stages = sum(v for k, v in idle.items()
                 if k.startswith(("frame.", "track.")))
    layers = idle.get("frame", 0.0) + idle.get("track", 0.0)
    return stages / (stages + layers) if stages + layers > 0 else None


def entry(run, metrics):
    """The traced line's ``program`` entry: the stage sums beside the
    layers' times in ``metrics`` (the line's), the spans a frame,
    and the stages' share of the layers' idle time."""
    p = run.program
    sums = stage_sums(run)
    out = dict(sums, spans_per_frame=len(window_spans(run, lambda n: True))
               / run.n_window if run.n_window else None,
               first_frame=p.first_frame, anchored=p.offset_ns is not None,
               stage_idle_share=stage_idle_share(p.idle))
    for key, layer in (("frame_stages_ms", "frame.host_ms"),
                       ("track_stages_ms", "track.host_ms")):
        if sums[key] is not None and layer in metrics:
            out[key.replace("_ms", "_over_layer")] = \
                sums[key] / metrics[layer]["value"]
    return out
