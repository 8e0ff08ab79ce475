"""One traced run of a cell with the program's own tracer on.

    python3 benchmark/program_run.py --workload <cell> --seed <n> \
        --seconds <s> [--trace-out PATH]

runs the cell as ``run.py --trace 1`` does, with the port's tracer
(``active_orb_slam2_tpu_torch/utils/trace.py``) turned on before the
``System`` is built, so that set-up is traced too, and anchored to the
profiler's clock right after the traced stretch's profiler starts.  It
prints ``run.py``'s traced line with the per-layer metrics of the
program's spans added to ``metrics`` (``benchmark/harness/
program_trace.py``) and a ``program`` entry: the frame pipeline's and the
track step's stage sums beside their wrapped layer spans, the spans a
frame, and the share of the stages' idle time.  On standard error it
logs the set-up's span totals and ``idle by program span``.  With
``--trace-out`` the spans go to a Chrome trace-event file.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run as bench  # noqa: E402  (sets the run's env)


class _Capture:
    """Anchors the port's tracer when the harness's profiler starts, and
    keeps the raw events the harness reads."""

    def __init__(self):
        self.events = None

    def __enter__(self):
        import torch.profiler
        from active_orb_slam2_tpu_torch.utils import trace
        from benchmark.harness import trace as device_trace
        self._saved = (torch.profiler.profile, device_trace.raw_events)
        base, read = self._saved
        cap = self

        class Anchored(base):
            def __enter__(self):
                out = super().__enter__()
                trace.anchor()
                return out

        def raw_events(prof):
            cap.events = read(prof)
            return cap.events

        torch.profiler.profile = Anchored
        device_trace.raw_events = raw_events
        return self

    def __exit__(self, *exc):
        import torch.profiler
        from benchmark.harness import trace as device_trace
        torch.profiler.profile, device_trace.raw_events = self._saved


def program_entry(r, line, idle):
    """The ``program`` entry of the line: stage sums against the wrapped
    layers, spans a frame, the stages' share of the layers' idle time."""
    from benchmark.harness import program_trace as pt
    p = r.program
    sums = pt.stage_sums(r)
    m = line["metrics"]
    n_frame = len(pt.window_spans(r, lambda n: True))
    out = dict(sums, spans_per_frame=n_frame / r.n_window if r.n_window
               else None, first_frame=p.first_frame,
               anchored=p.offset_ns is not None,
               stage_idle_share=pt.stage_idle_share(idle))
    for key, layer in (("frame_stages_ms", "frame.host_ms"),
                       ("track_stages_ms", "track.host_ms")):
        if sums[key] is not None and layer in m:
            out[key.replace("_ms", "_over_layer")] = \
                sums[key] / m[layer]["value"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace-out", default=None,
                    help="write the program's spans here (Chrome JSON)")
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    from active_orb_slam2_tpu_torch.utils import trace
    from benchmark.harness import definitions, program_trace, session
    cell = definitions.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        bench.err(f"program_run.py: the cell needs {cell['chips']} CUDA "
                  f"card(s); this machine has {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    bench.err(f"card: {bench.power_limit()}")
    limits = definitions.limits(args.workload)
    trace.reset()
    trace.enable()
    with _Capture() as cap:
        r, numbers = session.run(args.workload, args.seed, args.seconds,
                                 True, device, log=bench.err)
    trace.disable()
    records = trace.records()
    offset = None
    if cap.events is not None:
        offset = trace.profiler_offset_ns(
            [(n, int(a * 1e3)) for n, on_dev, a, _ in cap.events
             if not on_dev])
    r.program = program_trace.handover(records, r.window_bounds, offset)
    line, rows = bench.result(r, numbers, limits, True, device)
    for name, read in program_trace.READERS.items():
        v = read(r)
        if v is not None:
            line["metrics"][name] = {"value": float(v),
                                     "unit": program_trace.UNITS[name]}
    idle = program_trace.idle_by_span(records, offset, cap.events or [])
    line["program"] = program_entry(r, line, idle)
    bench.err("set-up spans: " + ", ".join(
        f"{k} {s:.3f} s ({n})" for k, s, n in
        program_trace.setup_totals(records, r.program.first_frame)))
    bench.err("idle by program span: " + ", ".join(
        f"{k} {s:.3f} s" for k, s in list(idle.items())[:10]))
    if args.trace_out:
        trace.write_chrome(args.trace_out)
    bad = bench.loaded_forbidden()
    if bad:
        bench.err(f"program_run.py: loaded in this process: {', '.join(bad)}")
        return 3
    for k, v, lim in rows:
        bench.err(f"check {k} {v!r} limit {lim!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
