"""The program's tracer: host spans at the stage boundaries of the hot
path, and host counters, kept in this process.

One tracer per process (module state), because the stages live in
modules that have no handle on the ``System`` (``ops/orb.py``).

* ``span(name, frame=None)`` is a context manager.  Off, the default, it
  returns one shared object that does nothing: no clock is read, nothing
  is allocated, the device is not touched.  On, it appends one row to a
  list: the name, a frame id, the index of the enclosing span's row, and
  start and end from ``time.perf_counter_ns()``.  A span without a frame
  id takes its enclosing span's (``System.track_*`` opens the root of a
  frame with ``System.frame_id``).
* ``count(name, n=1)`` adds to a host integer counter, on or off (the
  kernels' launches: ``k1.launches``, ``k2.launches``).  Counters only
  grow: a reader takes the difference of two ``counters()``.
* ``KEYFRAME_STAGES`` are the spans of a keyframe event (local mapping
  and loop closing), which the offline profiles read with
  ``durations_ms``.
* Nothing here reads a device value.  ``enable(sync=True)`` makes every
  span wait for the card before it closes, so that a span holds its
  stage's device time; for offline profiles only, since it serializes
  the host with the card.  A span inside a CUDA graph's capture does
  not wait.
* ``anchor()``, called inside ``torch.profiler.profile``, ties this
  clock to the profiler's: see ``profiler_offset_ns``.
* ``write_chrome(path)`` writes the spans and counters as Chrome
  trace-event JSON (Perfetto opens it).
"""

import functools
import json
import os
from collections import namedtuple
from time import perf_counter_ns

Span = namedtuple("Span", "name frame parent t0_ns t1_ns")

ANCHOR = "trace.anchor"
KEYFRAME_STAGES = ("mapping", "loop.detect", "loop.verify", "loop.correct",
                   "loop.gba_slice", "loop.retrain")

_on = False
_sync = False
_rows = []          # [name, frame, parent, t0_ns, t1_ns]
_stack = []         # indices of the open spans' rows
_counters = {}
_anchor_ns = None


class _Off:
    """The span returned while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "frame", "row")

    def __init__(self, name, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        frame = self.frame
        if frame is None and parent is not None:
            frame = _rows[parent][1]
        self.row = [self.name, frame, parent, perf_counter_ns(), None]
        _stack.append(len(_rows))
        _rows.append(self.row)
        return self

    def __exit__(self, *exc):
        if _sync:
            _synchronize()
        self.row[4] = perf_counter_ns()
        if _stack:
            _stack.pop()
        return False


def _synchronize():
    import torch
    # a span inside a CUDA graph's capture (utils/graphs.py) has no
    # device work to wait for, and a capture may not synchronize
    if torch.cuda.is_available() and torch.cuda.is_initialized() \
            and not torch.cuda.is_current_stream_capturing():
        torch.cuda.synchronize()


def span(name, frame=None):
    """A context manager that records ``name`` while tracing is on."""
    if not _on:
        return _OFF
    return _On(name, frame)


def traced(name):
    """Decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            if not _on:
                return fn(*a, **kw)
            with _On(name, None):
                return fn(*a, **kw)
        return inner
    return wrap


def count(name, n=1):
    """Add ``n`` to the host counter ``name`` (on or off)."""
    _counters[name] = _counters.get(name, 0) + n


def counters():
    return dict(_counters)


def enable(sync=False):
    """Turn the spans on; with ``sync`` every span waits for the card
    before it closes."""
    global _on, _sync
    _on, _sync = True, bool(sync)


def disable():
    global _on, _sync
    _on = _sync = False


def reset():
    """Drop the recorded spans and the anchor (the counters run on)."""
    global _anchor_ns
    _rows.clear()
    _stack.clear()
    _anchor_ns = None


def records():
    """The spans recorded so far as ``Span`` tuples (``t1_ns`` is None
    for a span still open); ``parent`` is a row index."""
    return [Span(*r) for r in _rows]


def durations_ms(names):
    """{name: [ms of each closed span]} of the recorded spans named in
    ``names``, in the order they opened."""
    out = {}
    for name, _, _, t0, t1 in _rows:
        if name in names and t1 is not None:
            out.setdefault(name, []).append((t1 - t0) / 1e6)
    return out


def anchor():
    """Emit one zero-length ``torch.profiler`` range named ``ANCHOR``
    and keep the ``perf_counter_ns()`` read just before it.  Call it
    while a profiler is recording."""
    global _anchor_ns
    import torch
    t = perf_counter_ns()
    with torch.profiler.record_function(ANCHOR):
        pass
    _anchor_ns = t


def profiler_offset_ns(events):
    """ns to add to a span's time to place it on the profiler's clock:
    the anchor event's profiler start less the reading ``anchor()``
    kept.  ``events`` are (name, start_ns) of the profiler's host
    events; None without an anchor."""
    if _anchor_ns is None:
        return None
    starts = [t for name, t in events if name == ANCHOR]
    if not starts:
        return None
    return min(starts) - _anchor_ns


def write_chrome(path):
    """The spans and counters as Chrome trace-event JSON: one complete
    event a span (microseconds from the first span), its frame id and
    parent in ``args``; the counters at the end of the trace."""
    rows = [r for r in _rows if r[4] is not None]
    t_base = min((r[3] for r in rows), default=0)
    pid = os.getpid()
    events = [{"name": name, "ph": "X", "pid": pid, "tid": 0,
               "ts": (t0 - t_base) / 1e3, "dur": (t1 - t0) / 1e3,
               "args": {"frame": frame, "parent": parent}}
              for name, frame, parent, t0, t1 in rows]
    t_end = max((r[4] for r in rows), default=t_base)
    events += [{"name": name, "ph": "C", "pid": pid, "tid": 0,
                "ts": (t_end - t_base) / 1e3, "args": {name: value}}
               for name, value in sorted(_counters.items())]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
