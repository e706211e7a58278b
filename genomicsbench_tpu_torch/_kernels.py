"""Build and bind the port's hand-written CUDA kernels, `csrc/*.cu`.

Each source has a plain C interface.  At first use every source is compiled
with nvcc for sm_90a into `build/genomicsbench_tpu_torch/` at the repo root,
one nvcc process per source that has no library yet, all started together.
Each library's name carries a hash of its source and the flags (so an edit
rebuilds and an unchanged source is reused), with nvcc's log beside it.  The
libraries are loaded with ctypes.  `build()` and `load()` hold one module
lock, and each nvcc writes a temporary file named by process and thread
that `os.replace` moves into place, so threads and processes that load at
once never run two builds into one file or load half a library.  Nothing is
built or loaded when this module is imported.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "genomicsbench_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# Each source's C entry points with their arguments: every pointer and the
# stream are c_void_p (a plain int argument would be cut to 32 bits)
SOURCES = {
    "bsw": (CSRC / "bsw.cu",
            {"gb_bsw_extend": [_P] * 7 + [_L] * 3 + [_P] * 2 + [_I] * 10 + [_P]}),
    "chain": (CSRC / "chain.cu",
              {"gb_chain_dp": [_P] * 9 + [_L] + [_I] * 5 + [_P] * 6}),
    "pairhmm": (CSRC / "pairhmm.cu",
                {name: [_P] * 13 + [_L, _I, _L, _P, _L, _P] + [_I] * 3 + [_P] * 2
                 for name in ("gb_pairhmm_f32", "gb_pairhmm_f64")}),
    "abea": (CSRC / "abea.cu",
             {"gb_abea_fill": [_P] * 8 + [_L] + [_P] * 6,
              "gb_abea_backtrack": [_P] * 12 + [_L] + [_P] * 3}),
    "poa": (CSRC / "poa.cu",
            {"gb_poa_fill": [_P] * 7 + [_L] + [_I] * 12 + [_P] * 7,
             "gb_poa_fill_occupancy": [_I] * 5 + [_P],
             "gb_poa_backtrack": [_P] * 5 + [_L] + [_I] * 5 + [_P] * 4}),
    "fmi": (CSRC / "fmi.cu",
            {"gb_fmi_smem1": [_P, _P, _I] + [_P] * 4 + [_L] + [_I] * 10 + [_P] * 3,
             "gb_fmi_seed3": [_P, _P, _I, _P, _L] + [_I] * 9 + [_P] * 3,
             "gb_fmi_extend": [_P, _P, _I] + [_P] * 5 + [_L] + [_I] * 6 + [_P] * 2}),
    "meth": (CSRC / "meth.cu",
             {"gb_meth_forward": [_P] * 11 + [_L, _I, _P, _P]}),
    "kmer": (CSRC / "kmer.cu",
             {"gb_kmer_canonical": [_P, _P, _L, _L, _I, _I, _P, _P],
              "gb_kmer_runs": [_P, _L, _P, _P],
              "gb_kmer_freqs": [_P, _P, _L, _P, _P, _P],
              "gb_kmer_minimizers": [_P, _P, _L, _L, _I, _I] + [_P] * 4,
              "gb_kmer_sites": [_P] * 4 + [_L, _L, _I] + [_P] * 4}),
    "basecaller": (CSRC / "basecaller.cu",
                   {"gb_bc_depthwise": [_P, _P, _L] + [_I] * 5 + [_P, _P],
                    "gb_bc_depthwise_layout": [_I, _I, _P],
                    "gb_bc_bn_act": [_P] * 4 + [_L, _I, _I, _P, _P],
                    "gb_bc_head": [_P, _P, _L, _I, _I, _P, _P],
                    "gb_bc_depthwise_wgrad_scratch": [_L, _I, _I, _I, _P],
                    "gb_bc_depthwise_wgrad": [_P, _P, _L, _I, _I, _I, _P, _L, _P, _P],
                    "gb_bc_bn_act_bwd": [_P] * 5 + [_L, _I, _I, _P, _L] + [_P] * 4,
                    "gb_bc_bn_act_bwd_sums": [_P] * 5 + [_L, _I, _I, _P, _L, _P, _P],
                    "gb_bc_bn_act_bwd_apply": [_P] * 5 + [_L, _I, _I, _P, _L] + [_P] * 3}),
    "grm": (CSRC / "grm.cu",
            {"gb_grm_standardize": [_P, _P, _L, _I, _P, _P, _P],
             "gb_grm_finish": [_P, _P, _I, _I, _P, _P]}),
    "longread": (CSRC / "longread.cu",
                 {"gb_longread_nw": [_P, _P] + [_I] * 6 + [_P] * 3}),
}

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None
_cdlls: list[ctypes.CDLL] = []


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    source = SOURCES[name][0]
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build() -> dict[str, str]:
    """Compile every source whose library is missing, one nvcc each, all at
    once.  Returns {name: nvcc's log} (ptxas registers, spills); raises if
    nvcc is missing or any build fails."""
    with _lock:
        return _build()


def _build() -> dict[str, str]:
    procs = {}
    for name, (source, _) in SOURCES.items():
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name][0].name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        lib = library_path(name)
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)    # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in SOURCES}


def load() -> types.SimpleNamespace:
    """Every C entry point of the kernel libraries, as attributes (e.g.
    `load().gb_chain_dp`), built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _build()
            fns = {}
            for name, (_, entries) in SOURCES.items():
                lib = ctypes.CDLL(str(library_path(name)))
                _cdlls.append(lib)      # kept open for the life of the process
                for fn_name, argtypes in entries.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[fn_name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


def launch(dev, fn: str, *args) -> None:
    """Call the C entry point `fn` with `args` and the current stream of
    `dev` appended, on that device; raise if it returns a CUDA error (a
    launch that is refused never runs, and no synchronise reports it)."""
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed with cudaError {rc}")


def check_tensor(name: str, x, dtype, dim: int) -> None:
    """A wrapper's check of one input: its dtype, its rank, contiguity."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{name} must have {dim} dimensions, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_device(dev, *tensors) -> None:
    """Every tensor given (None skipped) lies on `dev`, a cuda or cpu device."""
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"every tensor must be on {dev}, got one on {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu tensors, not {dev}")
