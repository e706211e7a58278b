"""Typed parameter groups (the port's own copy of genomicsbench_tpu/config.py).

Defaults mirror the reference benchmark CLIs exactly, because the parameter
values are part of the output-parity contract.  These paths have no learned
weights: what crosses over from the JAX package is this configuration,
as the plain dict of `dataclasses.asdict` (`BswParams(**d)`,
`AbeaRunProfile(**d)`), and numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BswParams:
    """Banded Smith-Waterman seed extension.

    Reference: benchmarks/bsw/main_banded.cpp:49-53 (match/mismatch/open/
    extend/ambig defaults) and :250 (zdrop=100, w=100, end_bonus=5).
    """

    match: int = 1
    mismatch: int = 4          # penalty, stored positive
    ambig: int = -1            # score for any comparison involving base 4
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    zdrop: int = 100
    w: int = 100               # band half-width
    end_bonus: int = 5

    def score_matrix(self) -> np.ndarray:
        """5x5 substitution matrix, bwa_fill_scmat layout (main_banded.cpp:73-81)."""
        mat = np.full((5, 5), self.ambig, dtype=np.int32)
        for i in range(4):
            for j in range(4):
                mat[i, j] = self.match if i == j else -self.mismatch
        return mat


def bsw_params_from_dict(d: dict) -> BswParams:
    """The port's BswParams from `dataclasses.asdict` of the JAX package's
    (same field names and meanings; an unknown field raises TypeError)."""
    return BswParams(**d)


@dataclasses.dataclass(frozen=True)
class PoaParams:
    """spoa partial-order alignment.

    Reference: benchmarks/poa/msa_spoa_omp.cpp:157-162 defaults
    (m=2, x=-4, o1=-4, e1=-2, o2=-24, e2=-1), algorithm 1 = global NW.
    Penalties are stored negative, as the reference's flags give them.
    """

    match: int = 2
    mismatch: int = -4
    gap_open1: int = -4
    gap_ext1: int = -2
    gap_open2: int = -24
    gap_ext2: int = -1


def poa_params_from_dict(d: dict) -> PoaParams:
    """The port's PoaParams from `dataclasses.asdict` of the JAX package's
    (same field names and meanings; an unknown field raises TypeError)."""
    return PoaParams(**d)


@dataclasses.dataclass(frozen=True)
class AbeaRunProfile:
    """f5c --profile equivalent (set_profile/set_opt_profile,
    f5c.c:1795-1844): runtime batching knobs for eventalign, the port's copy
    of the JAX package's (config.py:214-257).  eventalign_reads reads
    batch_size, batch_size_bases and ultra_thresh (reads longer than it go
    into batches of their own); the other fields are f5c's, kept for the
    profile file's format."""

    batch_size: int = 512           # reads per device batch
    batch_size_bases: int = 5_000_000
    num_workers: int = 4            # loader pool (the --iop analog)
    ultra_thresh: int = 100_000     # bases; longer reads batch separately
    max_readlen: float = 5.0        # f5c cuda_max_readlen (x average)
    avg_epk: float = 2.0            # cuda_avg_events_per_kmer
    max_epk: float = 5.0            # cuda_max_avg_events_per_kmer


ABEA_PROFILES = {
    # presets in the spirit of f5c's jetson-* machine table (f5c.c:1797-1803)
    "v5e": AbeaRunProfile(),
    "v5e-lite": AbeaRunProfile(batch_size=128, batch_size_bases=1_000_000,
                               num_workers=2),
    "cpu-test": AbeaRunProfile(batch_size=16, batch_size_bases=100_000,
                               num_workers=1, ultra_thresh=10_000),
}


def load_abea_profile(name_or_path: str) -> AbeaRunProfile:
    """Preset name, else a file in f5c's 7-field profile format
    (f5c.c:1810-1815: max_readlen avg_epk max_epk batch_size
    batch_size_bases num_thread ultra_thresh)."""
    if name_or_path in ABEA_PROFILES:
        return ABEA_PROFILES[name_or_path]
    with open(name_or_path) as f:
        toks = f.read().split()
    if len(toks) < 7:
        raise ValueError("Malformed profile config file.")  # f5c.c:1822
    return AbeaRunProfile(
        max_readlen=float(toks[0]), avg_epk=float(toks[1]),
        max_epk=float(toks[2]), batch_size=int(toks[3]),
        batch_size_bases=int(toks[4]), num_workers=int(toks[5]),
        ultra_thresh=int(toks[6]),
    )


@dataclasses.dataclass(frozen=True)
class KmerParams:
    """Flye k-mer counting / minimizer index.

    Reference: benchmarks/kmer-cnt/config.h + Flye asm_raw_reads.cfg keys;
    hard counter saturation at 15 (4-bit) with overflow table
    (vertex_index.cpp:524-570).
    """

    kmer_size: int = 15
    use_minimizers: bool = True
    minimizer_window: int = 5
    sample_rate: int = 1
    hard_counter_max: int = 15


def kmer_params_from_dict(d: dict) -> KmerParams:
    """The port's KmerParams from `dataclasses.asdict` of the JAX package's
    (same field names and meanings; an unknown field raises TypeError)."""
    return KmerParams(**d)


def load_keyvalue_config(path) -> dict:
    """Flye-style key=value config with %include directives
    (kmer-cnt config.h:35-72).  Values are parsed as int/float/bool when
    possible; later keys override earlier ones; %include paths are
    resolved relative to the including file."""
    import pathlib

    path = pathlib.Path(path)
    out: dict = {}
    for raw in path.read_text().splitlines():
        line = raw.split(";")[0].split("#")[0].strip()
        if not line:
            continue
        if line.startswith("%include"):
            inc = line.split(None, 1)[1].strip().strip('"')
            out.update(load_keyvalue_config(path.parent / inc))
            continue
        if "=" not in line:
            continue
        key, val = (t.strip() for t in line.split("=", 1))
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except (TypeError, ValueError):
                continue
        if val in ("true", "True"):
            val = True
        elif val in ("false", "False"):
            val = False
        out[key] = val
    return out
