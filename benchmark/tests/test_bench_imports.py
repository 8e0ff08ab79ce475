"""No module of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program either.

Each module is imported in a fresh interpreter, which then lists the
top-level names of ``sys.modules``; names are compared whole, so the
port's package name, which begins with the JAX package's, is not taken
for it.  The run's own check of ``sys.modules`` after the window covers
what the port loads while it runs.
"""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX_NAMES = {"jax", "jaxlib", "flax", "active_orb_slam2_tpu"}
PORT = "active_orb_slam2_tpu_torch"


def modules():
    out = []
    for dirpath, dirnames, files in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames
                       if d not in ("tests", ".cache", "__pycache__")]
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), ROOT))
    return sorted(out)


def loaded_by(path):
    """Top-level module names loaded by importing the file at ``path``
    (relative to the root) in a fresh interpreter."""
    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_is_listed():
    mods = modules()
    assert "benchmark/run.py" in mods
    assert any(m.startswith("benchmark/reference/") for m in mods)
    assert any(m.startswith("benchmark/metrics/") for m in mods)


@pytest.mark.parametrize("path", modules())
def test_no_jax(path):
    names = loaded_by(path)
    assert not names & JAX_NAMES, sorted(names & JAX_NAMES)
    if path.startswith("benchmark/reference/"):
        assert PORT not in names


def test_whole_names_are_compared():
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    saved = dict(sys.modules)
    try:
        sys.modules.setdefault(PORT, sys.modules.get(PORT) or object())
        assert PORT not in run.loaded_forbidden()
        sys.modules["active_orb_slam2_tpu.config"] = object()
        assert "active_orb_slam2_tpu" in run.loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
