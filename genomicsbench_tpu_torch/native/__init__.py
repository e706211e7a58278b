"""The port's host library (C++), built with g++ and loaded with ctypes.

`peaks.cpp` holds the sequential peak state machine of event detection.
At first use it is compiled with `g++ -O2` into `build/genomicsbench_tpu_torch/`
at the repo root, under a name that carries a hash of the source and the
flags.  The build writes a temporary file and moves it into place with
`os.replace`, so a process that loads the library concurrently sees all of
it or nothing.  There is no Python fallback: without g++ the build raises.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "peaks.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "genomicsbench_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgbpeaks-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path.  Raises if
    g++ is missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host library cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)        # atomic: a concurrent loader sees all or nothing
    return lib


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            c_f32p = ctypes.POINTER(ctypes.c_float)
            lib.gb_peak_detector.restype = ctypes.c_int64
            lib.gb_peak_detector.argtypes = [
                c_f32p, c_f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ]
            _lib = lib
        return _lib


def peak_detector(t1: np.ndarray, t2: np.ndarray, w1: int, w2: int,
                  th1: float, th2: float, peak_height: float) -> np.ndarray:
    """The peak positions (int64) of the short/long t-statistics t1, t2."""
    lib = load()
    t1 = np.ascontiguousarray(t1, np.float32)
    t2 = np.ascontiguousarray(t2, np.float32)
    if t1.shape != t2.shape or t1.ndim != 1:
        raise ValueError(f"t1 and t2 must be one-dimensional of one length, got "
                         f"{t1.shape} and {t2.shape}")
    out = np.empty(len(t1) + 1, np.int64)
    c_f32p = ctypes.POINTER(ctypes.c_float)
    n = lib.gb_peak_detector(t1.ctypes.data_as(c_f32p), t2.ctypes.data_as(c_f32p), len(t1),
                             w1, w2, th1, th2, peak_height,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(out))
    if n < 0:
        raise ValueError("peak buffer overflow")
    return out[:n]
