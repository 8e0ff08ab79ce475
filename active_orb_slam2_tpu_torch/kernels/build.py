"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface; the compilers run side
by side.  A library lands in ``kernels/_build/`` (ignored by git) under
a name keyed by a hash of its source and the flags, so a changed source
rebuilds and an unchanged one is loaded as it is.  Nothing here runs
when the module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)

# C entry points of each source: name -> argtypes.  Each returns
# cudaGetLastError() or a CUDA error code for arguments it refuses.
SIGNATURES = {
    "keypoints": {
        # imgs, hs, ws, starts (host arrays), n_levels, ys, xs, k_total,
        # pad, taps, gauss, angle_out, desc_out, stream
        "aos2_keypoints": [_PP, _PI, _PI, _PI, _I, _P, _P, _I, _I, _P, _P,
                           _P, _P, _P],
    },
    "pose_opt": {
        # pose0, pw, obs, level, stereo, valid, w_table, n_table, P, E,
        # fx, fy, cx, cy, bf, rounds, iters, out, n_inliers, mask, stream
        "aos2_pose_opt": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                          _F, _F, _F, _I, _I, _P, _P, _P, _P],
    },
}

_lib = None
# of the build this process made: "seconds" (wall clock of the parallel
# nvcc runs), "paths", "ptxas" (the compilers' -v reports)
build_info = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"libaos2_{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; returns {name: library path}."""
    paths = {name: library_path(name) for name in SIGNATURES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    build_info.update(seconds=0.0, paths={k: str(v) for k, v in paths.items()},
                      ptxas="(cached)")
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed, reports = [], []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu ({proc.returncode}):\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, todo[name])
            reports.append(stderr)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    build_info.update(seconds=time.perf_counter() - t0,
                      ptxas="".join(reports))
    return paths


def library():
    """The C entry points of every kernel library, built on first call."""
    global _lib
    if _lib is None:
        fns = {}
        for name, path in build().items():
            lib = ctypes.CDLL(str(path))
            for fname, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[fname] = fn
        _lib = types.SimpleNamespace(**fns)
    return _lib


def check(err: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, shape=None):
    """Check a kernel argument: CUDA, dtype, contiguity, optional shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
