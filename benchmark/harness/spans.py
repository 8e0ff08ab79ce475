"""Host spans around the calls into each layer, recorded from outside
the program by wrapping the ``System`` instance's attributes (the way
``scripts/profile_torch_track.py`` captures stages), and the kernel
entries' arguments, kept for counting after the window.

A span is (layer, start, end) on the host clock; nothing here waits on
the device.  With ``label`` each span is also a ``torch.profiler``
range, so the trace can say what the host was doing in a device gap.
"""

import contextlib
import time

import torch

# the layers' entry points on a System: attribute -> layer
LAYERS = {"make_rgbd": "frame", "_make_stereo": "frame",
          "track_step": "track", "keyframe_mapping": "mapping"}


class Spans:
    def __init__(self, label=False):
        self.rows = []            # (layer, t0, t1)
        self.label = label
        self._undo = []

    def span(self, layer):
        if not self.label:
            return contextlib.nullcontext()
        return torch.profiler.record_function(layer)

    def wrap(self, obj, attr, layer):
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            with self.span(layer):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.rows.append((layer, t0, time.perf_counter()))
            return out

        setattr(obj, attr, wrapped)
        self._undo.append((obj, attr, fn))

    def attach(self, slam):
        for attr, layer in LAYERS.items():
            if getattr(slam, attr, None) is not None:
                self.wrap(slam, attr, layer)
        if slam.loop_closer is not None:
            self.wrap(slam.loop_closer, "process_keyframe", "loop")

    def detach(self):
        for obj, attr, fn in reversed(self._undo):
            setattr(obj, attr, fn)
        self._undo = []

    def of(self, layer):
        return [(a, b) for name, a, b in self.rows if name == layer]


class KernelArgs:
    """Keeps each call's arguments of the named functions of a module
    (the kernel entries of ``kernels/``) while attached; the functions
    keep their ``launches`` counters."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.calls = {n: [] for n in names}
        self._saved = {}

    def __enter__(self):
        for n in self.names:
            fn = getattr(self.module, n)
            self._saved[n] = fn

            def wrapped(*a, _fn=fn, _n=n, **kw):
                self.calls[_n].append(a)
                return _fn(*a, **kw)

            wrapped.launches = getattr(fn, "launches", 0)
            setattr(self.module, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            fn.launches = getattr(getattr(self.module, n), "launches",
                                  getattr(fn, "launches", 0))
            setattr(self.module, n, fn)


def in_window(run, layer):
    """(start, end) of a layer's calls that began inside the window."""
    a, b = run.window_bounds
    return [(t0, t1) for t0, t1 in run.spans.of(layer) if a <= t0 <= b]


def total_ms(run, layer):
    return sum(t1 - t0 for t0, t1 in in_window(run, layer)) * 1e3


def self_ms(run, parent, children):
    """ms of a layer's window calls less the child spans inside them."""
    kids = sorted(s for c in children for s in in_window(run, c))
    total = 0.0
    for a, b in in_window(run, parent):
        inner = sum(min(y, b) - max(x, a) for x, y in kids
                    if x >= a and y <= b)
        total += (b - a) - inner
    return total * 1e3
