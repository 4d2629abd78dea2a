"""ctypes loader for the native image-ops library.

Builds lazily with the in-tree Makefile (g++) into ``native/build/`` (not
tracked by git) on first use if the shared object is missing; every
consumer has a numpy fallback, so the native path
is a pure acceleration and `available()` gates it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "build", "libastt_image_ops.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("ASTT_NO_NATIVE"):
            return None
        if not os.path.exists(_SO):
            try:
                subprocess.run(["make", "-C", _DIR, "-s"], check=True,
                               capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_SO)
            # AttributeError covers a stale .so predating the ABI export:
            # the native path is a pure acceleration, so ANY load problem
            # must fall back to numpy, never crash available()
            if lib.astt_native_abi_version() != 1:
                return None
        except (OSError, AttributeError):
            return None
        lib.astt_bicubic_resize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int]
        lib.astt_sep_filter_reflect101.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def bicubic_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(h, w, c) float32 -> (out_h, out_w, c) float32."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, dtype=np.float32)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), dtype=np.float32)
    lib.astt_bicubic_resize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w)
    return out


def sep_filter_reflect101(img: np.ndarray, kx: np.ndarray,
                          ky: np.ndarray) -> np.ndarray:
    """(h, w, c) float64 separable correlation with REFLECT_101 borders."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, dtype=np.float64)
    h, w, c = img.shape
    kx = np.ascontiguousarray(kx, dtype=np.float64)
    ky = np.ascontiguousarray(ky, dtype=np.float64)
    out = np.empty_like(img)
    lib.astt_sep_filter_reflect101(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), h, w, c,
        kx.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(kx),
        ky.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ky),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
