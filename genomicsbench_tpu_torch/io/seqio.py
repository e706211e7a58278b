"""FASTA/FASTQ reading (the port's copy of read_fastx from
genomicsbench_tpu/io/seqio.py:47): optionally gzipped, multi-line FASTA or
four-line FASTQ, into (name, bytes) pairs."""

from __future__ import annotations

import gzip


def _open(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastx(path):
    """Parse FASTA or FASTQ (optionally gzipped) into (name, bytes) pairs."""
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
                header = f.readline()
                if not header:
                    break
                name = header[1:].split()[0].decode()
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")
    return reads
