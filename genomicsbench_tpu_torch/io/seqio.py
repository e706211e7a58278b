"""FASTA/FASTQ loading and code batches (the port's copy of
genomicsbench_tpu/io/seqio.py:18-113).

`read_fastx` parses optionally gzipped, multi-line FASTA or four-line FASTQ
into (name, bytes) pairs; `load_fastx_batch` encodes them into a dense
(n_reads, max_len) uint8 batch (A, C, G, T -> 0..3, anything else -> 4,
padding 0, the width rounded up to `pad_to`) with the lengths, the format
the fmi walk reads (fmi.cpp:62-70, 109-127).  This is the Python path; the
JAX package's native one-pass parser gives the same batch.
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np

# fmi.cpp:109-127 encoding: ACGT -> 0..3, everything else -> 4
BASE_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    BASE_CODE[_b] = _i
    BASE_CODE[ord(chr(_b).lower())] = _i


@dataclasses.dataclass
class ReadBatch:
    codes: np.ndarray     # (n, max_len) uint8 0..4
    lengths: np.ndarray   # (n,) int32
    names: list

    @property
    def n(self) -> int:
        return len(self.lengths)

    def total_bases(self) -> int:
        return int(self.lengths.astype(np.int64).sum())


def _open(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastx(path, max_reads: int | None = None):
    """Parse FASTA or FASTQ (optionally gzipped) into (name, bytes) pairs,
    at most `max_reads` of them when it is given."""
    reads = []
    with _open(path) as f:
        first = f.readline()
        if not first:
            return reads
        if first.startswith(b">"):  # FASTA (multi-line sequences)
            name = first[1:].split()[0].decode()
            chunks = []
            for line in f:
                if line.startswith(b">"):
                    reads.append((name, b"".join(chunks)))
                    if max_reads and len(reads) >= max_reads:
                        return reads
                    name = line[1:].split()[0].decode()
                    chunks = []
                else:
                    chunks.append(line.strip())
            reads.append((name, b"".join(chunks)))
        elif first.startswith(b"@"):  # FASTQ
            name = first[1:].split()[0].decode()
            while True:
                seq = f.readline().strip()
                f.readline()  # +
                f.readline()  # quals
                reads.append((name, seq))
                if max_reads and len(reads) >= max_reads:
                    return reads
                header = f.readline()
                if not header:
                    break
                name = header[1:].split()[0].decode()
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")
    return reads


def encode_reads(reads, max_len: int | None = None, pad_to: int = 128) -> ReadBatch:
    """(name, bytes) pairs -> dense uint8 code batch."""
    names = [n for n, _ in reads]
    lens = np.array([len(s) for _, s in reads], dtype=np.int32)
    if max_len is None:
        max_len = int(lens.max()) if len(lens) else 0
    max_len = -(-max(max_len, 1) // pad_to) * pad_to
    codes = np.zeros((len(reads), max_len), dtype=np.uint8)
    for i, (_, s) in enumerate(reads):
        arr = BASE_CODE[np.frombuffer(s[:max_len], dtype=np.uint8)]
        codes[i, : len(arr)] = arr
        lens[i] = min(lens[i], max_len)
    return ReadBatch(codes=codes, lengths=lens, names=names)


def load_fastx_batch(path, max_reads=None, pad_to=128) -> ReadBatch:
    """The reads of a FASTA/FASTQ file (gzipped too) as one code batch."""
    return encode_reads(read_fastx(path, max_reads), pad_to=pad_to)
