"""Inputs of the dbg tests and of chip_smoke.py's dbg phases; this file
imports neither JAX nor the JAX package.

* `mk_window(rng, ...)`: tests/test_dbg.py's `_mk_window` (eight 60-base
  reads with two substitutions each, a QC-fail read, a low-quality read;
  optionally three N in the reference);
* `edge_windows()`: named window lists: test_dbg's, an N window, a
  period-4 reference, references and reads shorter than k + 2, reads with
  N, an N on a reference slice's last base (not flagged), QC-fail only,
  no reads, and test_dbg's random windows;
* `soa_case(...)`: a shared read SoA with overlapping 1,500-base windows
  shifted by 750 and one reference-N window (test_dbg's SoA case);
* `bam_reads(...)`: test_dbg's BAM case (QC-fail and low-mapq reads);
* `bench_dbg(region)`: tools/scale_bench.py bench_dbg's workload
  (:419-450, seed 5): a random reference, 150-base reads at 30x with 0.5%
  substitutions and quality 30, windows of 1,500 shifted by 750;
* `bench_windows(bench, n)`: its first n windows as per-window read lists.
"""

from __future__ import annotations

import numpy as np

from genomicsbench_tpu_torch.io import bam as B


def mk_window(rng, ref_len=400, n_reads=8, with_n=False):
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    if with_n:
        ref[rng.integers(0, ref_len, 3)] = 4
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, ref_len - 60))
        seq = ref[s : s + 60].copy()
        seq[rng.integers(0, 60, 2)] = rng.integers(0, 4, 2)
        quals = rng.integers(10, 45, 60).astype(np.uint8)
        reads.append((seq, quals, False))
    # one QC-fail read and one low-quality read
    reads.append((ref[:40].copy(), np.full(40, 40, np.uint8), True))
    reads.append((ref[10:50].copy(), np.full(40, 5, np.uint8), False))
    return (ref, 1000, reads)


def random_windows(seed=77, n=6, n_window=4):
    """test_dbg's random windows (references of 100-299 bases, 2-7 reads of
    30-119 bases, int64 qualities 15..39), window `n_window` with an N."""
    rng = np.random.default_rng(seed)
    windows = []
    for w in range(n):
        ref_len = int(rng.integers(100, 300))
        ref = rng.integers(0, 4, ref_len).astype(np.uint8)
        if w == n_window:
            ref[10] = 4
        reads = []
        for _ in range(int(rng.integers(2, 8))):
            ln = int(rng.integers(30, min(120, ref_len)))
            at = int(rng.integers(0, ref_len - ln + 1))
            seq = ref[at : at + ln].copy()
            seq[seq == 4] = 0
            seq[rng.integers(0, ln, 2)] = rng.integers(0, 4, 2)
            reads.append((seq, rng.integers(15, 40, ln).astype(np.int64), False))
        windows.append((ref, int(rng.integers(0, 5000)), reads))
    return windows


def edge_windows():
    """{name: [window]} (k = 15, min_qual 20)."""
    rng = np.random.default_rng(0)
    out = {"test_dbg": [mk_window(rng) for _ in range(4)]}
    rng = np.random.default_rng(1)
    out["n_window"] = [mk_window(rng, with_n=True), mk_window(rng)]
    ref = np.tile(np.arange(4, dtype=np.uint8), 20)
    out["period_4"] = [(ref, 0, [(ref[:40].copy(), np.full(40, 30, np.uint8), False)])]
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 4, 300).astype(np.uint8)
    out["short"] = [
        (ref[:16], 5, [(ref[:17], np.full(17, 30, np.uint8), False)]),   # no edge at all
        (ref[:17], 5, [(ref[:16], np.full(16, 30, np.uint8), False)]),   # one k-mer, no edge
        (ref[:18], 5, []),                                                # one edge, no read
        (ref, 9, [(ref[100:117], np.full(17, 30, np.uint8), False),
                  (ref[3:3], np.zeros(0, np.uint8), False)]),
    ]
    seqs = [ref[i:i + 80].copy() for i in range(0, 200, 40)]
    for s in seqs[::2]:
        s[rng.integers(0, 80, 3)] = 4
    out["n_in_reads"] = [(ref, 50, [(s, rng.integers(15, 45, 80).astype(np.uint8), False)
                                    for s in seqs])]
    tail = ref.copy()
    tail[-1] = 4
    out["n_on_last_base"] = [(tail, 0, [(ref[200:290], np.full(90, 30, np.uint8), False)])]
    out["qcfail_only"] = [(ref, 0, [(ref[:90], np.full(90, 40, np.uint8), True)])]
    out["random"] = random_windows()
    return out


def soa_case(seed=23, region=20_000, read_len=120, n_reads=800, width=1500, shift=750,
             n_window=2):
    """test_dbg's shared-SoA case: (refs, ref starts, seqs flat, quals flat
    int32, lens, read_lo, read_hi, the same windows as read lists); window
    `n_window` holds an N at 333."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, region).astype(np.uint8)
    starts = np.sort(rng.integers(0, region - read_len, n_reads))
    seqs = ref[starts[:, None] + np.arange(read_len)].copy()
    mut = rng.random((n_reads, read_len)) < 0.01
    seqs[mut] = rng.integers(0, 4, mut.sum())
    quals = rng.integers(10, 40, (n_reads, read_len)).astype(np.int32)
    lens = np.full(n_reads, read_len, np.int64)
    refs, rstarts, lo, hi, windows = [], [], [], [], []
    for wstart in range(0, region - width + 1, shift):
        a = int(np.searchsorted(starts + read_len, wstart, "right"))
        b = int(np.searchsorted(starts, wstart + width, "left"))
        rw = ref[wstart:wstart + width].copy()
        if len(refs) == n_window:
            rw[333] = 4
        refs.append(rw)
        rstarts.append(wstart)
        lo.append(a)
        hi.append(b)
        windows.append((rw, wstart, [(seqs[r], quals[r].astype(np.int64), False)
                                     for r in range(a, b)]))
    return dict(refs=refs, ref_starts=rstarts, seqs=seqs.ravel(), quals=quals.ravel(),
                lens=lens, lo=np.array(lo), hi=np.array(hi), windows=windows)


def bam_reads(seed=31, region=60_000, n_reads=2500):
    """(reference, sorted BamRecords): test_dbg's BAM case: 60-150-base reads
    with two substitutions each, every 37th QC-failed, every 11th at mapq 5."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, region).astype(np.uint8)
    recs = []
    for i in range(n_reads):
        ln = int(rng.integers(60, 151))
        pos = int(rng.integers(0, region - ln))
        seq = ref[pos:pos + ln].copy()
        seq[rng.integers(0, ln, 2)] = rng.integers(0, 4, 2)
        recs.append(B.BamRecord(name=f"r{i}", flag=0x200 if i % 37 == 0 else 0, ref_id=0,
                                pos=pos, mapq=50 if i % 11 else 5, cigar=[("M", ln)], seq=seq,
                                qual=rng.integers(10, 40, ln).astype(np.uint8)))
    recs.sort(key=lambda r: r.pos)
    return ref, recs


class FastaStub:
    """A FastaIndex over one in-memory contig."""

    def __init__(self, codes):
        self.codes = codes

    def length(self, name):
        return len(self.codes)

    def fetch(self, name, s, e):
        return self.codes[s:e]


def bench_dbg(region=2_000_000, coverage=30, read_len=150, seed=5):
    """tools/scale_bench.py bench_dbg's workload (:419-450), drawn in its
    order: dict of ref, wstarts, refs (views), seqs (n_reads, read_len),
    quals_flat (int32, all 30), lens, read_lo, read_hi."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, region).astype(np.uint8)
    n_reads = region * coverage // read_len
    starts = np.sort(rng.integers(0, region - read_len, n_reads))
    seqs = np.empty((n_reads, read_len), np.uint8)
    for s in range(0, n_reads, 100_000):
        e = min(s + 100_000, n_reads)
        blk = ref[starts[s:e, None] + np.arange(read_len)].copy()
        mut = rng.random((e - s, read_len)) < 0.005
        blk[mut] = rng.integers(0, 4, mut.sum())
        seqs[s:e] = blk
    width, shift = 1500, 750
    wstarts = np.arange(0, region - width + 1, shift)
    return dict(ref=ref, wstarts=wstarts, refs=[ref[w:w + width] for w in wstarts], seqs=seqs,
                quals_flat=np.full(n_reads * read_len, 30, np.int32),
                lens=np.full(n_reads, read_len, np.int64),
                read_lo=np.searchsorted(starts + read_len, wstarts, "right"),
                read_hi=np.searchsorted(starts, wstarts + width, "left"))


def bench_windows(bench, n):
    """The first n bench windows as [(ref, start, [(seq, quals int64, False)])]."""
    q = np.full(bench["seqs"].shape[1], 30, np.int64)
    return [(bench["refs"][w], int(bench["wstarts"][w]),
             [(bench["seqs"][r], q, False) for r in range(bench["read_lo"][w],
                                                          bench["read_hi"][w])])
            for w in range(n)]
