"""Base coding and the poa benchmark's window-batched FASTA reader (the
port's copy of genomicsbench_tpu/io/msa_fasta.py).

Reference: benchmarks/poa/msa_spoa_omp.cpp:82-116 (readFile) — a FASTA
stream where a header line whose SECOND character is '0' starts a new
window (headers are ">{member}_{window}"-style; member 0 opens a window).
Each window is one racon-style consensus group of about 10 reads.
"""

from __future__ import annotations

import gzip

import numpy as np

_CODE = np.full(256, 4, dtype=np.int8)
for i, c in enumerate("ACGT"):
    _CODE[ord(c)] = i
    _CODE[ord(c.lower())] = i


def encode_seq(s: str) -> np.ndarray:
    """ASCII -> 2-bit codes (A,C,G,T -> 0..3; others -> 4)."""
    return _CODE[np.frombuffer(s.encode(), dtype=np.uint8)].astype(np.int32)


def decode_seq(codes) -> str:
    return "".join("ACGTN"[int(c)] for c in codes)


def read_msa_windows(path: str):
    """Parse the window-batch FASTA (gzip too, by a .gz suffix); returns a
    list of windows, each a list of int-coded sequences, with the reference
    reader's grouping rule."""
    op = gzip.open if str(path).endswith(".gz") else open
    windows, cur = [], None
    with op(path, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                if len(line) > 1 and line[1] == "0":
                    if cur:
                        windows.append(cur)
                    cur = []
            else:
                if cur is None:  # tolerate files not starting with a '0' header
                    cur = []
                cur.append(encode_seq(line))
    if cur:
        windows.append(cur)
    return windows
