"""Inputs of the kmer-cnt port's tests and of chip_smoke.py's kmer phases.

Plain numpy: either package takes these (B, L) uint8 code batches and
int32 lengths.

* `genome_reads`: reads sampled from a random genome, either strand, with
  substitutions.  The main batch (`MAIN`) is run-cpu.sh:77's E. coli MAP006
  50x scale (tools/scale_bench.py:275-283): 25,000 reads of 10,000 bases
  from a 5,000,000-base genome (about E. coli's 4.6 Mb) with 5%
  substitutions, so each genomic 15-mer occurs about 50 * 0.95^15 = 23
  times and an error k-mer about once: the counts have runs and the
  frequency filter has something to filter, where bench_kmer's uniform
  random reads give only singletons.  The index builders run at
  scale_bench's subsets (:317-325, :375-386): `build_index_minimizers` over
  the first 5,000 reads with window 5, `build_index_uneven_coverage` over
  the first 2,500 with repeat_kmer_rate 100.
* `edge_batch`: short reads (0, 4-7, 14-18 bases: k - 1, k, k + 1 and
  k + 2 for k = 5, 15 and 16), homopolymer and dinucleotide ties, ambiguous
  codes (4) alone and in runs, garbage past a read's length, full-width
  reads, in one batch.
* `poly_a_batch`: a 70,000-base poly-A read beside a random read and its
  reverse complement: the poly-A read's one canonical k-mer occurs 69,985
  times at k = 15, past the 0xFFFF of the frequency plane.
* `planted_minimizer_case` / `planted_uneven_case`: tests/test_kmer.py's
  planted-repeat inputs of the two index builders.
"""

from __future__ import annotations

import numpy as np

MAIN = dict(n_reads=25_000, read_len=10_000, genome_len=5_000_000, sub_rate=0.05, seed=47)
MAIN_K = 15
MINIMIZER_WINDOW = 5            # Flye's default minimizer window (KmerParams)
INDEX_MINIMIZER_READS = 5_000   # 50 Mb
INDEX_UNEVEN_READS = 2_500      # 25 Mb
UNEVEN_REPEAT_RATE = 100.0
ORACLE_READS = 16               # reads held against yield_minimizers_oracle on the card
KS = (5, 15, 16)
WINDOWS = (1, 2, 5, 10)


def genome_reads(n_reads: int, read_len: int, genome_len: int = 5_000_000,
                 sub_rate: float = 0.05, seed: int = 47, chunk: int = 1000):
    """(codes (n_reads, read_len) uint8, lengths int32): reads of a random
    genome of `genome_len` bases, each from a uniform start on either strand
    (half reverse-complemented), each base substituted with probability
    `sub_rate` by one of the other three."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len + 1, n_reads)
    reverse = rng.random(n_reads) < 0.5
    codes = np.empty((n_reads, read_len), np.uint8)
    cols = np.arange(read_len)
    for r0 in range(0, n_reads, chunk):
        c = genome[starts[r0:r0 + chunk, None] + cols]
        sub = rng.random(c.shape) < sub_rate
        c[sub] = (c[sub] + rng.integers(1, 4, int(sub.sum()), dtype=np.uint8)) % 4
        rv = reverse[r0:r0 + chunk]
        c[rv] = 3 - c[rv, ::-1]
        codes[r0:r0 + chunk] = c
    return codes, np.full(n_reads, read_len, np.int32)


def batch_of(reads, width=None, pad=None, seed=0):
    """Reads (uint8 code arrays) as one (B, width) batch; with `pad`, the
    slots past each read hold random codes 0..pad instead of zeros."""
    lens = np.array([len(r) for r in reads], np.int32)
    width = width or max(1, int(lens.max()))
    rng = np.random.default_rng(seed)
    codes = np.zeros((len(reads), width), np.uint8)
    if pad is not None:
        codes[:] = rng.integers(0, pad + 1, codes.shape)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = r
    return codes, lens


def edge_batch(width: int = 96):
    rng = np.random.default_rng(11)
    rand = lambda n: rng.integers(0, 4, n).astype(np.uint8)      # noqa: E731
    reads = [rand(n) for n in (0, 4, 5, 6, 7, 14, 15, 16, 17, 18)]
    reads += [
        np.zeros(60, np.uint8),                                   # poly-A
        np.full(70, 3, np.uint8),                                 # poly-T: the same canonical k-mers
        np.concatenate([rand(20), np.zeros(30, np.uint8), rand(20)]),
        np.tile(np.array([0, 1], np.uint8), 40),                  # ACAC...
        np.tile(np.array([1, 2], np.uint8), 40),                  # CGCG...: its own reverse complement
        np.tile(np.array([0, 0, 1], np.uint8), 30),
    ]
    amb = rand(width)
    amb[[0, 7, 30, 31, 32, 33, width - 1]] = 4                    # N alone and in a run
    reads += [amb, np.where(rng.random(80) < 0.2, 4, rand(80)).astype(np.uint8), rand(width)]
    return batch_of(reads, width=width, pad=4, seed=12)


def poly_a_batch(n: int = 70_000):
    rng = np.random.default_rng(13)
    read = rng.integers(0, 4, 1000).astype(np.uint8)
    return batch_of([np.zeros(n, np.uint8), read, 3 - read[::-1]])


def planted_minimizer_case():
    """tests/test_kmer.py TestMinimizerIndex's inputs: k 9, window 5,
    repeat_kmer_rate 1.5, a 12-base motif planted twice in every read."""
    rng = np.random.default_rng(0)
    lens = [70, 100, 55, 88]
    seqs = np.zeros((len(lens), 128), np.uint8)
    for i, ln in enumerate(lens):
        seqs[i, :ln] = rng.integers(0, 4, ln)
    motif = rng.integers(0, 4, 12)
    for i in range(len(lens)):
        seqs[i, 10:22] = motif
        seqs[i, 30:42] = motif
    return seqs, np.array(lens, np.int32), dict(k=9, window=5, repeat_kmer_rate=1.5)


def planted_uneven_case():
    """tests/test_kmer.py TestUnevenCoverageIndex's inputs: k 9, a 30-base
    motif in every one of six 256-base reads."""
    rng = np.random.default_rng(1)
    motif = rng.integers(0, 4, 30).astype(np.uint8)
    seqs = np.zeros((6, 256), np.uint8)
    for i in range(6):
        row = rng.integers(0, 4, 256).astype(np.uint8)
        row[40:70] = motif
        seqs[i] = row
    return seqs, np.full(6, 256, np.int32), dict(k=9, global_min_freq=2, select_rate=0.15,
                                                 tandem_freq=10, repeat_kmer_rate=50.0)


def write_fasta(path, codes, lengths):
    """The batch as a FASTA file, codes 0..4 as ACGTN."""
    letters = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        for i, (c, n) in enumerate(zip(codes, lengths)):
            f.write(f">read_{i}\n{letters[c[:n]].tobytes().decode()}\n")
