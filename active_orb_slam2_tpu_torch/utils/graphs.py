"""Per-frame device work replayed as CUDA graphs, in segments around
eager calls.

A per-frame step (the RGB-D frame pipeline, the track step) issues
hundreds of small PyTorch operations, split by a few eager calls: the
hand-written kernels K1 and K2, which stay ordinary calls through their
module entries so that whatever wraps those entries sees every launch
and its arguments.  :class:`Chain` runs such a step as a chain of
segments:

* CUDA tensors take graphs: each segment is captured once as a
  ``torch.cuda.CUDAGraph`` and replayed on later calls.  CPU tensors run
  the segments eagerly, in the same order.
* A chain's graphs are keyed by what the caller gives :meth:`Chain.start`:
  the layout of the step's inputs (:func:`layout`) and every value the
  segments' code branches on or reads by address (Python flags, the
  addresses of the map arena's tensors, :func:`addresses`).  The first
  call with a key runs eagerly and is its warm-up; the next call with
  the same key captures the chain and replays it.  Capture runs no
  kernel, so an in-place update of the map is applied once, by the
  replay.  A key that changes from call to call keeps the chain eager.
* A segment's tensor arguments (``fed``) are copied into the graph's
  static input buffers before each replay.  Everything else a segment
  reads must keep its address while the graph lives: tensors whose
  addresses are in the key, constants made once, and what earlier
  segments of the same call returned (their graphs' outputs).  A segment
  must never close over a tensor made outside the chain in this call,
  such as an eager kernel's result: pass it as ``fed``.
* What a segment returns is its graph's static outputs, rewritten by
  the next replay.  What leaves the chain for a caller goes through
  :meth:`Run.own`, which copies it into tensors of the call's own, or,
  for state the caller hands back to the next call, :meth:`Run.carry`,
  which leaves it in the static input buffers that call's replay reads.

Counters (``utils/trace.py``, on or off): ``graph.replays.<segment>``,
``graph.captures.<segment>`` and ``graph.eager.<segment>``, one per
segment run.
"""

import collections
import contextlib
import functools
import gc
import operator

import torch

from active_orb_slam2_tpu_torch.utils import trace

KEEP = 2        # keys whose graphs a chain keeps (e.g. both tracking modes)


def leaves(tree, out=None):
    """The leaves of nested tuples and lists (NamedTuples too), in
    order."""
    if out is None:
        out = []
    if isinstance(tree, (tuple, list)):
        for x in tree:
            leaves(x, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    """``tree`` with each leaf replaced by the next item of ``it``."""
    if isinstance(tree, list):
        return [_rebuild(x, it) for x in tree]
    if isinstance(tree, tuple):
        items = [_rebuild(x, it) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return next(it)


_shape_dtype = operator.attrgetter("shape", "dtype")


def layout(*trees):
    """Shapes and dtypes of the tensors of ``trees``, and the values of
    their other leaves: a hashable part of a chain's key."""
    return tuple(_shape_dtype(t) if isinstance(t, torch.Tensor) else t
                 for t in leaves(trees))


def addresses(tree):
    """The device addresses of the tensors of ``tree`` (a part of a
    chain's key for tensors its segments read and write in place)."""
    return tuple(t.data_ptr() for t in leaves(tree))


# dtypes the foreach copy has no kernel for
_NO_FOREACH = (torch.uint16, torch.uint32, torch.uint64)


def _copy(dst, src):
    """dst[i] <- src[i], one ``_foreach_copy_`` per source dtype (the
    foreach kernel takes one dtype a launch); pairs that are already the
    same tensor are skipped."""
    groups = collections.defaultdict(lambda: ([], []))
    for d, s in zip(dst, src):
        if isinstance(s, torch.Tensor) and d is not s:
            g = groups[s.dtype]
            g[0].append(d)
            g[1].append(s)
    for dtype, (d, s) in groups.items():
        if len(d) == 1 or dtype in _NO_FOREACH:
            for a, b in zip(d, s):
                a.copy_(b)
        else:
            torch._foreach_copy_(d, s)


class Chain:
    """The graphs of one per-frame step, by key; one chain per step
    function (its closure), so each ``System`` has its own."""

    def __init__(self):
        self._graphs = collections.OrderedDict()   # key -> {name: graph}
        self._last_key = None
        self._retired = []      # (event, graphs) evicted, maybe in flight

    def start(self, device, key):
        """The :class:`Run` of one call of the step on ``device``."""
        backend = _backend(device)
        if backend is None:
            return Run(self, None, None, None)
        self._release()
        graphs = self._graphs.get(key)
        if graphs is not None:
            self._graphs.move_to_end(key)
        elif key == self._last_key:
            graphs = self._graphs[key] = {}
            while len(self._graphs) > KEEP:
                self._retired.append(
                    (backend.event(), self._graphs.popitem(last=False)[1]))
        self._last_key = key
        return Run(self, backend, key, graphs)

    def _release(self):
        """Drop evicted graphs once their last replay has run."""
        self._retired = [(e, g) for e, g in self._retired
                         if e is not None and not e.query()]


class Run:
    """One call's pass through a chain: every segment eager, or every
    segment replayed (and captured first where the call's key is new)."""

    def __init__(self, chain, backend, key, graphs):
        self._chain, self._backend, self._key = chain, backend, key
        self._graphs = graphs
        self.graphed = graphs is not None

    def __call__(self, name, fn, *fed):
        """``fn(*fed)``, eagerly or as the graph of segment ``name``;
        returns its outputs (the graph's static outputs)."""
        if not self.graphed:
            trace.count("graph.eager." + name)
            return fn(*fed)
        seg = self._graphs.get(name)
        if seg is None:
            try:
                seg = _Segment(self._backend, fn, fed)
            except BaseException:
                # a chain is captured whole or not at all
                self._chain._graphs.pop(self._key, None)
                raise
            self._graphs[name] = seg
            trace.count("graph.captures." + name)
        else:
            seg.feed(fed)
        seg.graph.replay()
        trace.count("graph.replays." + name)
        return seg.graph.out

    def own(self, tree):
        """``tree`` with each tensor copied into a new tensor, where the
        call replayed: outputs that the next replay must not overwrite
        (a kernel's arguments, what the step returns)."""
        if not self.graphed:
            return tree
        src = leaves(tree)
        dst = [torch.empty_like(t) if isinstance(t, torch.Tensor) else t
               for t in src]
        _copy(dst, src)
        return _rebuild(tree, iter(dst))

    def carry(self, dst, src):
        """Inside a segment: where the call replays, write ``src`` into
        ``dst`` (a fed argument of an earlier segment, so the graph's
        static input buffers) as the segment's last work, and return
        ``dst``; eagerly, return ``src``.  A step that hands its state
        back to its next call thus leaves it in the buffers the next
        replay reads, with no copy in or out; the caller must then read
        only the newest state, as the next replay overwrites it."""
        if not self.graphed:
            return src
        d, s = leaves(dst), leaves(src)
        # a source that is also a destination is read before any write
        s = [t.clone() if any(t is u for u in d) else t for t in s]
        for a, b in zip(d, s):
            if a is not b:
                a.copy_(b)
        return dst

    def span(self, name):
        """The tracer's span ``name`` where the call replays (a graph's
        replay has no stage spans inside it), else nothing."""
        return trace.span(name) if self.graphed else contextlib.nullcontext()


class _Segment:
    """A captured segment: static inputs and its graph."""

    def __init__(self, backend, fn, fed):
        # the static inputs: copies made before the capture, outside the
        # graph's memory pool
        self.static = [t.clone() if isinstance(t, torch.Tensor) else t
                       for t in leaves(fed)]
        args = _rebuild(fed, iter(self.static))
        self.graph = backend.capture(lambda: fn(*args))

    def feed(self, fed):
        _copy(self.static, leaves(fed))


class _CudaGraph:
    """``fn``'s work captured on a side stream; ``out`` is what it
    returned (tensors in the graph's own memory pool)."""

    def __init__(self, fn, device):
        stream = _capture_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        self._graph = torch.cuda.CUDAGraph()
        # a garbage collection inside the capture could free a graph or
        # an event of unreachable objects, a call a capture does not
        # permit; the collection waits until the capture has ended
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                self._graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        self._graph.capture_end()
                    raise
                self._graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(stream)

    def replay(self):
        self._graph.replay()


class _CudaBackend:
    def __init__(self, device):
        self.device = device

    def capture(self, fn):
        return _CudaGraph(fn, self.device)

    def event(self):
        e = torch.cuda.Event()
        e.record(torch.cuda.current_stream(self.device))
        return e


@functools.lru_cache(maxsize=None)
def _capture_stream(device):
    """The side stream captures run on (the legacy default stream cannot
    be captured), with its cuBLAS workspace made by one product outside
    any capture, so that no graph's pool holds it."""
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        a = torch.zeros((8, 8), device=device)
        a @ a
    torch.cuda.current_stream(device).wait_stream(stream)
    return stream


@functools.lru_cache(maxsize=None)
def _cuda_backend(device):
    return _CudaBackend(device)


def _backend(device):
    """What captures a chain's segments on ``device`` (a tensor's
    device): CUDA graphs on a CUDA device, nothing (eager segments)
    elsewhere.  Tests substitute
    another backend here."""
    return _cuda_backend(device) if device.type == "cuda" else None
