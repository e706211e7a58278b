"""Build and bind the port's hand-written CUDA kernel, `csrc/bsw.cu`.

The source has a plain C interface.  At first use it is compiled with nvcc
for sm_90a into `build/genomicsbench_tpu_torch/` at the repo root, under a
name that carries a hash of the source and the flags (so an edit rebuilds
and an unchanged source is reused), and loaded with ctypes.  Nothing is
built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "bsw.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "genomicsbench_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# gb_bsw_extend's arguments: every pointer and the stream are c_void_p (a
# plain int argument would be cut to 32 bits)
BSW_ARGTYPES = [_P] * 7 + [_L] * 3 + [_P] * 2 + [_I] * 10 + [_P]

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin): "
                       "the CUDA kernel cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbsw-{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the source unless its library exists.  Returns nvcc's log
    (ptxas registers, spills); raises if nvcc is missing or fails."""
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        lib.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, lib)    # atomic: a concurrent loader sees all or nothing
    return lib.with_suffix(".log").read_text()


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.gb_bsw_extend.argtypes = BSW_ARGTYPES
        lib.gb_bsw_extend.restype = ctypes.c_int
        _lib = lib
    return _lib
