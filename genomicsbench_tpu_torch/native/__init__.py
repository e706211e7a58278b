"""The port's host library (C++), built with g++ and loaded with ctypes.

Five sources, listed in `SOURCES` with their C entry points: `peaks.cpp`,
the sequential peak state machine of event detection; `poa.cpp`, the
partial-order-alignment graph engine (fusion, topological export, path
decoding, consensus); `sais.cpp`, the linear-time suffix array of the
FM-index build; `psr9.cpp`, the PSR9 profile-HMM Viterbi of eventalign's
reference-coordinate realignment; and `ctc.cpp`, the basecaller's CTC
prefix beam search.  At first use each source is
compiled with `g++ -O2 -ffp-contract=off` (no multiply-add contracted into
an FMA, so every float operation rounds as written) into its own library
under `build/genomicsbench_tpu_torch/` at the repo root, named with a hash
of the source and the flags.  The build holds a
module lock, writes a temporary file named by process and thread, and moves
it into place with `os.replace`, so a process that loads the library
concurrently sees all of it or nothing.  There is no Python fallback:
without g++ the build raises.  Nothing is built or loaded when this module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "genomicsbench_tpu_torch"
CXX_FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")

_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
# Each source's C entry points: (return type, argument types).  Every array
# is a c_void_p, passed as an address (numpy's `ctypes.data`).
SOURCES = {
    "peaks": (HERE / "peaks.cpp", {
        "gb_peak_detector": (_I64, [_P, _P, _I64, _I32, _I32, _F32, _F32, _F32, _P, _I64]),
    }),
    "poa": (HERE / "poa.cpp", {
        "gb_poa_fuse": (_I64, [_P] * 12 + [_P, _P, _I64, _I64, _P, _P, _I64, _P, _I32]),
        "gb_poa_export": (_I64, [_P] * 10 + [_I64] * 3 + [_P] * 5),
        "gb_poa_export_packed": (_I64, [_P] * 10 + [_I64] * 3 + [_P] * 3),
        "gb_poa_decode_path": (None, [_P, _I64, _I32, _I32, _P, _I64, _P, _P, _P]),
        "gb_poa_consensus": (_I64, [_P] * 11 + [_I64, _P]),
    }),
    "sais": (HERE / "sais.cpp", {
        "gb_sais": (_I64, [_P, _I64, _I32, _P]),
    }),
    "psr9": (HERE / "psr9.cpp", {
        "gb_psr9_viterbi": (_I64, [ctypes.c_char_p, ctypes.c_char_p, _I64, _P, _I64,
                                   _F32, _F32, _F32, _P, _P, ctypes.c_double]
                            + [_I64] * 5 + [_P, _P, _P, _I64]),
    }),
    "ctc": (HERE / "ctc.cpp", {
        "gb_ctc_beam_search": (_I64, [_P, _I64, _I32, _I32, _F32, _P, _I64]),
    }),
}

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None
_cdlls: list[ctypes.CDLL] = []


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name][0].read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgb{name}-{digest.hexdigest()[:16]}.so"


def _build_one(name: str) -> Path:
    lib = library_path(name)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host library cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    source = SOURCES[name][0]
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)        # atomic: a concurrent loader sees all or nothing
    return lib


def build() -> dict[str, Path]:
    """Compile every source whose library is missing; returns {name: library
    path}.  Raises if g++ is missing or fails."""
    with _lock:
        return {name: _build_one(name) for name in SOURCES}


def load() -> types.SimpleNamespace:
    """Every C entry point of the host library, as attributes (e.g.
    `load().gb_poa_fuse`), built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            fns = {}
            for name, (_, entries) in SOURCES.items():
                lib = ctypes.CDLL(str(_build_one(name)))
                _cdlls.append(lib)      # kept open for the life of the process
                for fn_name, (restype, argtypes) in entries.items():
                    fn = getattr(lib, fn_name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                    fns[fn_name] = fn
            _lib = types.SimpleNamespace(**fns)
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
    n = lib.gb_peak_detector(t1.ctypes.data, t2.ctypes.data, len(t1), w1, w2, th1, th2,
                             peak_height, out.ctypes.data, len(out))
    if n < 0:
        raise ValueError("peak buffer overflow")
    return out[:n]


def suffix_array(codes: np.ndarray, alphabet: int = 5) -> np.ndarray:
    """The suffix array (int32) of codes in [0, alphabet), by SA-IS; on tied
    prefixes the shorter suffix sorts first.  A code at or above `alphabet`
    is refused: SA-IS would index past its buckets."""
    codes = np.ascontiguousarray(codes, np.uint8)
    if len(codes) and int(codes.max()) >= alphabet:
        raise ValueError(f"suffix_array: code {int(codes.max())} is outside [0, {alphabet})")
    out = np.empty(len(codes), np.int32)
    got = load().gb_sais(codes.ctypes.data, len(codes), alphabet, out.ctypes.data)
    if got != len(codes):
        raise ValueError(f"gb_sais failed ({got}) for {len(codes)} symbols")
    return out


def psr9_viterbi(fwd_seq: bytes, rc_seq: bytes, ev_mean, scale, shift, var,
                 model_mean, model_stdv, events_per_base,
                 e_start: int, e_end: int, event_stride: int, rc: bool,
                 k: int = 6):
    """One PSR9 profile-HMM Viterbi segment alignment (gb_psr9_viterbi,
    the inner kernel of f5c eventalign's align_read_to_ref).  Returns
    (event_idx, kmer_idx, state_char) int32/int32/uint8 arrays in forward
    order."""
    lib = load()
    ev_mean = np.ascontiguousarray(ev_mean, np.float32)
    mm = np.ascontiguousarray(model_mean, np.float32)
    ms = np.ascontiguousarray(model_stdv, np.float32)
    n_events = abs(int(e_end) - int(e_start)) + 1
    n_kmers = max(len(fwd_seq) - k + 1, 0)
    cap = (n_events + n_kmers) * 2 + 16
    out_e = np.empty(cap, np.int32)
    out_k = np.empty(cap, np.int32)
    out_s = np.empty(cap, np.uint8)
    n = lib.gb_psr9_viterbi(
        fwd_seq, rc_seq, len(fwd_seq), ev_mean.ctypes.data, len(ev_mean),
        float(scale), float(shift), float(var), mm.ctypes.data, ms.ctypes.data,
        float(events_per_base), int(e_start), int(e_end), int(event_stride), int(bool(rc)),
        int(k), out_e.ctypes.data, out_k.ctypes.data, out_s.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("psr9_viterbi: output capacity exceeded")
    return out_e[:n].copy(), out_k[:n].copy(), out_s[:n].copy()


def ctc_beam_search(probs, beamsize: int = 5, threshold: float = 1e-3) -> np.ndarray:
    """CTC prefix beam search over (T, L) posteriors (gb_ctc_beam_search):
    the decoded class ids (int32, 1-based; blank is class 0)."""
    probs = np.ascontiguousarray(probs, np.float32)
    if probs.ndim != 2 or not 1 <= probs.shape[1] <= 9:
        raise ValueError(f"probs must be (T, L) with 1 to 9 classes, got {probs.shape}")
    if beamsize < 1:
        raise ValueError(f"beamsize must be at least 1, got {beamsize}")
    T, L = probs.shape
    out = np.empty(T + 1, np.int32)
    n = load().gb_ctc_beam_search(probs.ctypes.data, T, L, beamsize, threshold,
                                  out.ctypes.data, len(out))
    if n < 0:
        raise ValueError("ctc_beam_search: decoded sequence overflow")
    return out[:n].copy()
