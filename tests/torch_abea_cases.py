"""Inputs of the abea (nanopore event alignment) tests and of chip_smoke.py.

Imports neither JAX nor the JAX package, so the card's machine can use it.
Every input is made from a numpy seed and handed to both packages as numpy
arrays:

* `load_align_golden`, `load_events_golden`: tests/golden/abea_{align,events}
  (the reference's float-mode build, 24 reads and 8 raw signals);
* `bench_abea_reads`: the JAX package's abea scale bench
  (tools/scale_bench.py:1013-1047 `bench_abea`, seed 29: 10,000 reads of
  800-1,199 bases at run-gpu.sh:45's 10000-reads scale), copied;
* `edge_cases`: reads of one k-mer, far fewer and ten times more events
  than k-mers, garbage signal that fails QC, and lengths from 10 to 5,000
  bases in one batch (2,000 in the CPU tests, where the plain version's
  host loop over the bands sets the time);
* `synthetic_read`: the raw-signal generator of tests/test_eventalign.py:
  19-26, copied;
* the QC count and pairs digest of the main path's first 512 reads, which
  the tests compute from the port's plain version (held against JAX) and
  chip_smoke.py holds the card to.
"""

from __future__ import annotations

import hashlib
import pathlib

import numpy as np

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
ALPHA = {c: i for i, c in enumerate("ACGT")}
KMER = 6
MAIN_SEED = 29
# The main path's first 512 reads through align_batch: the reads that fail
# QC, and the first 16 hex digits of `pairs_digest` of their pairs, from the
# port's plain version on the CPU, equal to JAX align_batch on the same reads
# (tests/test_torch_abea.py::test_main_path_sample_against_jax)
MAIN_SAMPLE = 512
MAIN_SAMPLE_FAILED = 298
MAIN_SAMPLE_SHA256 = "0b6cb716afda2e05"


def _model():
    """The synthetic 6-mer pore model of both packages (synthetic_model,
    seed 0), copied: level means in [60, 140), stdvs in [1, 4)."""
    rng = np.random.default_rng(0)
    mean = rng.uniform(60.0, 140.0, 4096).astype(np.float32)
    stdv = rng.uniform(1.0, 4.0, 4096).astype(np.float32)
    return mean, stdv


def _ranks(seq):
    n = len(seq) - KMER + 1
    r = np.zeros(max(n, 0), np.int32)
    c = np.asarray(seq).astype(np.int32)
    for j in range(KMER):
        r = (r << 2) | c[j:j + n]
    return r


def load_align_golden():
    """(model mean, model stdv, [(seq u8, event means f32, scale, shift)],
    expected pairs per read: (m, 2) int64, empty for a QC failure)."""
    toks = (GOLDEN / "abea_align.in").read_text().split()
    assert toks[0] == "align"
    n = int(toks[1])
    pos = 2
    mean = np.array(toks[pos:pos + 8192:2], np.float32)
    stdv = np.array(toks[pos + 1:pos + 8192:2], np.float32)
    pos += 8192
    cases = []
    for _ in range(n):
        pos += 1                                    # the sequence's length
        seq = np.array([ALPHA[c] for c in toks[pos]], np.uint8)
        pos += 1
        ne = int(toks[pos])
        pos += 1
        evs = np.array(toks[pos:pos + 2 * ne:2], np.float32)
        pos += 2 * ne
        cases.append((seq, evs, float(toks[pos]), float(toks[pos + 1])))
        pos += 2
    toks = (GOLDEN / "abea_align.gold").read_text().split()
    pos, expected = 0, []
    for _ in range(n):
        m = int(toks[pos])
        pos += 1
        expected.append(np.array(toks[pos:pos + 2 * m], np.int64).reshape(m, 2))
        pos += 2 * m
    return mean, stdv, cases, expected


def load_events_golden():
    """[(raw signal f32, expected (n, 4) rows of start, length, mean, stdv
    as strings)]."""
    toks = (GOLDEN / "abea_events.in").read_text().split()
    assert toks[0] == "events"
    pos, sigs = 2, []
    for _ in range(int(toks[1])):
        ns = int(toks[pos])
        pos += 1
        sigs.append(np.array(toks[pos:pos + ns], np.float32))
        pos += ns
    gold = (GOLDEN / "abea_events.gold").read_text().split()
    pos, out = 0, []
    for sig in sigs:
        ne = int(gold[pos])
        pos += 1
        out.append((sig, np.array(gold[pos:pos + 4 * ne]).reshape(ne, 4)))
        pos += 4 * ne
    return out


def check_events(got, rows, what):
    """tests/test_abea.py:65-93's check of one signal's events against its
    golden rows: starts and lengths exact, means and stdvs within 2e-4."""
    starts, lengths, means, stdvs = got
    if len(starts) != len(rows):
        raise AssertionError(f"{what}: {len(starts)} events, the golden {len(rows)}")
    np.testing.assert_array_equal(starts, rows[:, 0].astype(np.int64), err_msg=what)
    np.testing.assert_array_equal(lengths.astype(np.int64), rows[:, 1].astype(np.int64),
                                  err_msg=what)
    np.testing.assert_allclose(means, rows[:, 2].astype(np.float32), atol=2e-4, err_msg=what)
    np.testing.assert_allclose(stdvs, rows[:, 3].astype(np.float32), atol=2e-4, err_msg=what)


def bench_abea_reads(n_reads=10_000, seed=MAIN_SEED, lo=800, hi=1200):
    """bench_abea's reads (tools/scale_bench.py:1013-1047), copied: a
    uniform sequence of lo..hi-1 bases, then per k-mer a 5% skip and else
    1 event (70%) or 1-3 events, each the model level scaled, shifted and
    with normal noise of half the level's stdv.  The random stream is the
    original's call for call; the float32 event arithmetic is NumPy 2's
    (a Python float meets a float32 scalar as float32), written out so that
    it does not depend on the NumPy version.  Returns (sequences u8, event
    means f32, (n, 2) [scale, shift] f32)."""
    mean, stdv = _model()
    sd_half = (stdv * np.float32(0.5)).astype(np.float64).tolist()
    rng = np.random.default_rng(seed)
    rnd, integers, normal = rng.random, rng.integers, rng.normal
    seqs, evs, scalings = [], [], np.zeros((n_reads, 2), np.float32)
    for b in range(n_reads):
        slen = int(integers(lo, hi))
        seq = integers(0, 4, slen).astype(np.uint8)
        scale = float(rng.uniform(0.9, 1.1))
        shift = float(rng.uniform(-5, 5))
        rs, zs = [], []
        for r in _ranks(seq).tolist():
            if rnd() < 0.05:
                continue
            reps = int(integers(1, 4)) if rnd() > 0.3 else 1
            s = sd_half[r]
            for _ in range(reps):
                rs.append(r)
                zs.append(normal(0, s))
        ri = np.array(rs, np.int64)
        ev = (mean[ri] * np.float32(scale) + np.float32(shift)) + np.array(zs).astype(np.float32)
        seqs.append(seq)
        evs.append(ev.astype(np.float32))
        scalings[b] = (scale, shift)
    return seqs, evs, scalings


def band_cells(seqs, evs) -> int:
    """tools/scale_bench.py:1046's count: (n_kmers + n_events + 2) x 100."""
    return sum((len(s) - KMER + 1 + len(e) + 2) * 100 for s, e in zip(seqs, evs))


def _events_for(rng, seq, mean, stdv, scale, shift, per_kmer):
    """Event means along a sequence: each k-mer's level, scaled and
    shifted, `per_kmer` times on average (a fraction below 1 skips k-mers),
    with noise of half the level's stdv."""
    ranks = _ranks(seq)
    reps = rng.poisson(per_kmer, len(ranks))
    idx = np.repeat(ranks, reps)
    lv = mean[idx] * np.float32(scale) + np.float32(shift)
    return (lv + rng.normal(0, 1, len(idx)).astype(np.float32) * stdv[idx] * np.float32(0.5)
            ).astype(np.float32)


def edge_cases(longest=5000):
    """{label: (sequences, event means, scalings)} for the kernels' edges;
    `longest` is the longest read of the mixed-length batch."""
    mean, stdv = _model()
    rng = np.random.default_rng(41)
    out = {}

    def batch(specs):
        seqs, evs, sc = [], [], []
        for length, per_kmer in specs:
            seq = rng.integers(0, 4, length).astype(np.uint8)
            scale, shift = float(rng.uniform(0.9, 1.1)), float(rng.uniform(-5, 5))
            ev = _events_for(rng, seq, mean, stdv, scale, shift, per_kmer)
            if len(ev) == 0:
                ev = np.array([mean[_ranks(seq)[0]]], np.float32)
            seqs.append(seq)
            evs.append(ev)
            sc.append((scale, shift))
        return seqs, evs, np.array(sc, np.float32)

    # one k-mer: a band of one column, with 1, 2 and 9 events
    seqs, evs, sc = batch([(6, 1.0)] * 3)
    evs = [np.repeat(evs[0][:1], n) for n in (1, 2, 9)]
    out["one_kmer"] = (seqs, evs, sc)
    # far fewer events than k-mers (steered right) and ten times more (down)
    out["few_events"] = batch([(300, 0.1), (600, 0.05), (200, 0.2)])
    out["many_events"] = batch([(120, 10.0), (300, 10.0), (60, 12.0)])
    # garbage signal that fails QC
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (250, 400)]
    evs = [rng.normal(100, 20, n).astype(np.float32) for n in (300, 500)]
    out["garbage"] = (seqs, evs, np.array([(1.0, 0.0), (1.0, 0.0)], np.float32))
    # lengths from 10 to 5,000 bases in one batch
    out["mixed_lengths"] = batch([(n, 1.2) for n in (10, 37, 250, 1000, longest // 2, longest,
                                                     120)])
    return out


def synthetic_read(rng, n_bases, model_mean, samples_per_kmer=8, noise=0.3):
    """tests/test_eventalign.py:19-26's read, copied: a uniform sequence and
    a raw signal of each k-mer's level held for `samples_per_kmer` samples
    with normal noise."""
    seq = rng.integers(0, 4, n_bases).astype(np.uint8)
    levels = model_mean[_ranks(seq)]
    sig = np.repeat(levels, samples_per_kmer) + rng.normal(
        0, noise, len(levels) * samples_per_kmer)
    return seq, sig.astype(np.float32)


def eventalign_reads_case(n_reads, seed, lo=800, hi=1200):
    """(raw signals, sequences) of `n_reads` synthetic reads of lo..hi-1
    bases from `synthetic_read`."""
    mean, _ = _model()
    rng = np.random.default_rng(seed)
    reads = [synthetic_read(rng, int(rng.integers(lo, hi)), mean) for _ in range(n_reads)]
    return [r[1] for r in reads], [r[0] for r in reads]


def pairs_digest(pairs) -> str:
    """The first 16 hex digits of the sha256 of every read's pair count
    (int64) and pairs (int32), in read order."""
    h = hashlib.sha256()
    for p in pairs:
        p = np.ascontiguousarray(p, np.int32).reshape(-1, 2)
        h.update(np.int64(len(p)).tobytes())
        h.update(p.tobytes())
    return h.hexdigest()[:16]


def save_bench_abea_reads(path, n_reads=10_000, seed=MAIN_SEED):
    """Generate `bench_abea_reads` and save them to an .npz, for a caller
    that generates in another process."""
    seqs, evs, sc = bench_abea_reads(n_reads, seed)
    np.savez(path, seqs=np.concatenate(seqs), seq_len=[len(s) for s in seqs],
             evs=np.concatenate(evs), ev_len=[len(e) for e in evs], scalings=sc)


def load_bench_abea_reads(path):
    """The reads `save_bench_abea_reads` wrote: (sequences, event means,
    scalings)."""
    with np.load(path) as z:
        seqs = np.split(z["seqs"], np.cumsum(z["seq_len"])[:-1])
        evs = np.split(z["evs"], np.cumsum(z["ev_len"])[:-1])
        return seqs, evs, z["scalings"]
