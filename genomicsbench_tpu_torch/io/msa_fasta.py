"""Base coding (the port's copy of encode_seq from
genomicsbench_tpu/io/msa_fasta.py:21)."""

from __future__ import annotations

import numpy as np

_CODE = np.full(256, 4, dtype=np.int8)
for i, c in enumerate("ACGT"):
    _CODE[ord(c)] = i
    _CODE[ord(c.lower())] = i


def encode_seq(s: str) -> np.ndarray:
    """ASCII -> 2-bit codes (A,C,G,T -> 0..3; others -> 4)."""
    return _CODE[np.frombuffer(s.encode(), dtype=np.uint8)].astype(np.int32)
