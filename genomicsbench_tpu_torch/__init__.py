"""genomicsbench_tpu_torch — the genomics kernel engine in PyTorch and CUDA.

The PyTorch port of `genomicsbench_tpu`, for one NVIDIA H100 (sm_90a).  It
mirrors the JAX package's module names, so each module's counterpart is
easy to find, and imports nothing of it: the host layers it needs (`io/`,
`config.py`, `batching/`, `oracle/`) are its own copies.

Layering:
    cli        — `python -m genomicsbench_tpu_torch <subcommand>`
    io/        — host-side loaders (pair, anchor-call and phmm text formats,
                 FASTA/Q, plink, fast5, signals) and the BAM writer and
                 readers: the whole file, or a region through its .bai
                 (`IndexedBam`), with the FASTA index
    batching/  — length bucketing
    ops/       — device paths: a plain PyTorch version beside each kernel;
                 pileup and dbg are host code over native/ with their
                 device sorts on torch.sort
    csrc/      — the hand-written CUDA kernels, built by `_kernels.py`
    native/    — the host library (C++ with ctypes, built by g++ at first
                 use): peaks, poa, SA-IS, PSR9, CTC, BAM parse, pileup, dbg
    oracle/    — NumPy scalar reference semantics (a second witness)

Every entry point runs on `cuda` unless the caller passes `device="cpu"`;
with no card present and the CPU not asked for, it raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.

    "cuda" (the default) needs a card and raises without one: the port
    never falls back to the CPU on its own.  "cpu" selects the plain
    PyTorch versions of the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch version"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
