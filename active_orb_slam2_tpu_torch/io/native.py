"""ctypes binding of the native frame IO library (``native/frameio.cpp``).

Port of ``active_orb_slam2_tpu/io/native.py``: a zlib-based PNG / PGM
decoder and a pthread prefetcher that keeps decoded frames ahead of the
SLAM loop, with PIL in their place when the library cannot be built.
The port compiles ``native/frameio.cpp`` with g++ into a directory of
its own, ``active_orb_slam2_tpu_torch/io/_build/`` (git-ignored), keyed
by a hash of the source; it never writes into ``native/``.
"""

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_LIB = None
_NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "frameio.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_build")


def _so_path() -> Optional[str]:
    """The library's path for the current source (None without one)."""
    if not os.path.exists(_NATIVE_SRC):
        return None
    with open(_NATIVE_SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libframeio-{key}.so")


def build_native() -> bool:
    """Compile ``native/frameio.cpp`` into the port's build directory;
    returns success."""
    so = _so_path()
    if so is None:
        return False
    if os.path.exists(so):
        return True
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _NATIVE_SRC,
             "-o", tmp, "-lz", "-lpthread"],
            check=True, capture_output=True)
        os.replace(tmp, so)             # atomic: concurrent builds race safely
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not build_native():
        return None
    lib = ctypes.CDLL(_so_path())
    lib.fio_decode_gray.restype = ctypes.c_int
    lib.fio_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.fio_open.restype = ctypes.c_void_p
    lib.fio_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fio_next.restype = ctypes.c_int
    lib.fio_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.fio_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


MAX_PIXELS = 4096 * 3072


def decode_gray(path: str):
    """Decode an image to (gray uint8 [H, W]) or (depth uint16 [H, W])
    for 16-bit PNGs.  Native path with PIL fallback."""
    lib = _lib()
    if lib is not None:
        out8 = np.empty(MAX_PIXELS, np.uint8)
        out16 = np.empty(MAX_PIXELS, np.uint16)
        w = ctypes.c_int()
        h = ctypes.c_int()
        bd = ctypes.c_int()
        ok = lib.fio_decode_gray(
            path.encode(), out8.ctypes.data_as(ctypes.c_void_p),
            out16.ctypes.data_as(ctypes.c_void_p), MAX_PIXELS,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(bd))
        if ok:
            n = w.value * h.value
            if bd.value == 16:
                return out16[:n].reshape(h.value, w.value).copy()
            return out8[:n].reshape(h.value, w.value).copy()
    from PIL import Image
    im = Image.open(path)
    if im.mode in ("I;16", "I"):
        return np.asarray(im, dtype=np.uint16)
    return np.asarray(im.convert("L"), dtype=np.uint8)


class PrefetchingReader:
    """Read-ahead frame reader over a list of image paths."""

    def __init__(self, paths, prefetch: int = 8, threads: int = 2):
        self.paths = list(paths)
        self._i = 0
        lib = _lib()
        self._lib = lib
        if lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._keepalive = arr
            self._h = lib.fio_open(arr, len(self.paths), prefetch,
                                   threads, 0)
        else:
            self._h = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self.paths):
            raise StopIteration
        path = self.paths[self._i]
        self._i += 1
        if self._h:
            out8 = np.empty(MAX_PIXELS, np.uint8)
            out16 = np.empty(MAX_PIXELS, np.uint16)
            w = ctypes.c_int()
            h = ctypes.c_int()
            bd = ctypes.c_int()
            ok = self._lib.fio_next(
                self._h, out8.ctypes.data_as(ctypes.c_void_p),
                out16.ctypes.data_as(ctypes.c_void_p), MAX_PIXELS,
                ctypes.byref(w), ctypes.byref(h), ctypes.byref(bd))
            if ok:
                n = w.value * h.value
                src = out16 if bd.value == 16 else out8
                return src[:n].reshape(h.value, w.value).copy()
            # decode failure: fall back for this frame
        return decode_gray(path)

    def close(self):
        if self._h:
            self._lib.fio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
