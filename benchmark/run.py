"""The benchmark of ``active_orb_slam2_tpu_torch`` on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: makes
its traffic on the card from the seed, builds the ``System`` and warms
it up (set-up), hands frames in at the camera's rate for ``--seconds``
(the window), with ``--trace 1`` profiles a stretch of whole frames
after it, checks the answers against the plain reference, and prints
one JSON line last: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device`` (and, when traced, ``breakdown`` and ``program``:
the program's stage spans summed against its layer spans), then ``checks``:
each number compared beside its limit, also the last lines on standard
error.  Exits nonzero, printing no result, without a CUDA card, or if
JAX or the JAX package was loaded.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# compile caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
# one intra-op thread: the frames are launched from one host thread, and
# idle workers that spin beside it take cores of a shared host
os.environ["OMP_NUM_THREADS"] = "1"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "active_orb_slam2_tpu")


def err(msg):
    print(msg, file=sys.stderr, flush=True)


def loaded_forbidden():
    """Top-level module names of ``sys.modules`` that are JAX or the JAX
    package, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def read_metrics(r, names):
    from benchmark.harness import definitions
    out = {}
    for m in names:
        v = definitions.metric_reader(m["name"])(r)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result(r, numbers, limits, trace_on, device):
    import torch
    from benchmark.harness import check, definitions, program_trace
    ok, rows = check.verdict(numbers, limits)
    names = definitions.metric_names(r.cell, trace_on)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": r.memory_peak_bytes}
    line = {"correct": bool(ok), "attempted": int(r.n_window),
            "failed": int(r.failed), "metrics": read_metrics(r, names),
            "device": dev}
    if trace_on and r.profile is not None:
        p = r.profile
        dev["busy_s"] = p["busy_us"] / 1e6
        dev["window_s"] = p["stretch_us"] / 1e6
        line["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in p["device_ops"]],
            "idle_gaps": [[n, s] for n, s in p["idle_gaps"]]}
    if trace_on and r.program is not None:
        line["program"] = program_trace.entry(r, line["metrics"])
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    from benchmark.harness import definitions, session
    cell = definitions.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        err(f"run.py: the cell needs {cell['chips']} CUDA card(s); this "
            f"machine has {torch.cuda.device_count()}")
        return 2
    device = torch.device("cuda", 0)
    err(f"card: {power_limit()}")
    limits = definitions.limits(args.workload)
    r, numbers = session.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), device, log=err)
    line, rows = result(r, numbers, limits, bool(args.trace), device)
    bad = loaded_forbidden()
    if bad:
        err(f"run.py: loaded in this process: {', '.join(bad)}")
        return 3
    for k, v, lim in rows:
        err(f"check {k} {v!r} limit {lim!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
