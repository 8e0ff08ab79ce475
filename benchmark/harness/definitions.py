"""Where the benchmark's definitions live, found by name.

* a cell: an entry of ``workloads`` in ``BENCHMARK.json``;
* a configuration: ``benchmark/configs/<config>.json`` with the settings
  file it names beside it;
* a traffic mix: ``benchmark/workloads/<traffic>.json``;
* a cell's correctness limits: ``benchmark/checks/<cell>.json``;
* a metric: ``benchmark/metrics/<metric>.py`` with a ``read(run)``.

Adding a cell, a configuration, a mix or a metric adds files and
entries; no code here names one.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark():
    return _json(ROOT, "BENCHMARK.json")


def cell(name):
    for c in benchmark()["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(name):
    """(the configuration's JSON, the path of its settings file)."""
    d = _json(BENCH_DIR, "configs", f"{name}.json")
    return d, os.path.join(BENCH_DIR, "configs", d["settings"])


def mix(name):
    return _json(BENCH_DIR, "workloads", f"{name}.json")


def limits(cell_name):
    return _json(BENCH_DIR, "checks", f"{cell_name}.json")


def metric_names(cell_name, trace):
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on), in the order of ``BENCHMARK.json``."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in benchmark()[key]
            if "workloads" not in m or cell_name in m["workloads"]]


def metric_reader(name):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(path):
    """A path in a definition, relative to the checkout's root."""
    return path if os.path.isabs(path) else os.path.join(ROOT, path)
