"""Reading a ``torch.profiler`` trace of a stretch of whole frames:
device busy time (the union of kernel, copy and fill intervals, the
arithmetic of ``scripts/profile_torch_mapping.py::device_profile``),
device operations, the operations that took most time, and each
hand-written kernel's device time per launch.  The idle gaps are placed
in the program's spans by ``program_trace.idle_by_span``.

The profiler's raw events are read as they are (``kineto_results``):
building its tree of ``FunctionEvent`` objects took minutes for a
stretch of a few thousand launches a frame.
"""

import collections

import numpy as np


def raw_events(prof):
    """(name, on_device, start_us, end_us) of every event, without the
    ranges the profiler mirrors onto the device's timeline for the
    host's labelled ranges."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == DeviceType.CUDA
        if on_dev and e.is_user_annotation():
            continue
        out.append((e.name(), on_dev, e.start_ns() / 1e3, e.end_ns() / 1e3))
    return out


def busy_us(spans):
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps_us(spans):
    """Idle intervals (start, end) between the union of device spans."""
    out, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def read(events, stretch_us):
    """Device numbers of a profiled stretch lasting ``stretch_us``, from
    ``raw_events``."""
    dev = [(n, a, b) for n, on_dev, a, b in events if on_dev]
    spans = [(a, b) for _, a, b in dev]
    per_op = collections.defaultdict(float)
    for n, a, b in dev:
        per_op[n] += b - a
    return {
        "busy_us": busy_us(spans), "ops": len(dev), "stretch_us": stretch_us,
        "device_ops": sorted(per_op.items(), key=lambda kv: -kv[1])[:10],
        "kernels": [(n, b - a) for n, a, b in dev],
    }


def kernel_us(trace, name):
    """Device microseconds of each launch of kernels named ``name``."""
    return [us for n, us in trace["kernels"] if name in n]
