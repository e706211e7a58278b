"""Inputs of the fmi (FM-index SMEM seeding) tests and of chip_smoke.py.

Imports neither JAX nor the JAX package, so the card's machine can use it.
Every input is made from a numpy seed and handed to both packages as numpy
arrays:

* `bench_fmi_reference` / `bench_fmi_reads`: the JAX package's fmi scale
  bench (tools/scale_bench.py:914-934 `bench_fmi`: a uniform random 100 Mb
  reference from seed 0, 151-base reads from seed 23 with 0.5%
  substitutions, in batches of 65,536), copied call for call;
* `ssr_reference`: `bench_fmi`'s reference with simple sequence repeats
  at the human genome's share, whose reads over a run take the e-table
  route;
* `edge_cases`: ambiguous bases at the start, middle and end of reads, a
  reverse-complement read, reads of 0, 1, 18, 19 and 20 bases, reads of
  mixed lengths in one padded batch, the poly-A reads whose interval lists
  overflow the walk's caps, a highly repetitive reference, seeds under the
  pass-3 floor, a 1,000-base read, and pass-2 work items with pivots at 0
  and qlen - 1;
* `brute_smems` / `brute_pass2`: SMEMs by plain string search over
  T = ref . revcomp(ref) (tests/test_fmi.py:13-56 and :119-143, copied);
* `write_gold_index` / `write_gold_reads` / `build_fmi_gold` /
  `run_fmi_gold`: the inputs of tools/ref_drivers/fmi_gold.cpp (the layout
  of tools/fmi_gold_check.py:21-35), its build with g++ and its tuples.
"""

from __future__ import annotations

import os
import pathlib
import struct
import subprocess

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
FMI_GOLD_SRC = ROOT / "tools" / "ref_drivers" / "fmi_gold.cpp"
READ_LEN = 151
MAIN_READS = 65_536
MAIN_REF_BASES = 100_000_000
REF_SEED = 0
READ_SEED = 23
MIN_SEED_LEN = 19


def bench_fmi_reference(n_bases=MAIN_REF_BASES, seed=REF_SEED) -> np.ndarray:
    """`bench_fmi`'s reference: uniform random codes 0..3 (uint8)."""
    return np.random.default_rng(seed).integers(0, 4, n_bases).astype(np.uint8)


def bench_fmi_reads(ref, n_reads=MAIN_READS, seed=READ_SEED, length=READ_LEN):
    """`bench_fmi`'s first batch: n_reads slices of `length` bases of ref
    with 0.5% substitutions; returns (codes (n, length) uint8, qlen int32)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(ref) - length, n_reads)
    q = ref[starts[:, None] + np.arange(length)[None, :]].copy()
    mut = rng.random(q.shape) < 0.005
    q[mut] = rng.integers(0, 4, mut.sum())
    return q, np.full(n_reads, length, np.int32)


# Simple sequence repeats (SSRs, tandem repeats of a 1-6 base unit) make up
# about 3% of the human genome (Lander et al. 2001, "Initial sequencing and
# analysis of the human genome", Nature 409:860-921, section "Simple
# sequence repeats").  `ssr_reference` writes runs of 20-100 bases (mean 60)
# at that share, so one run per 2 kb on average.
SSR_SHARE = 0.03
SSR_LEN = (20, 100)
SSR_UNIT = (1, 6)
SSR_SEED = 41


def ssr_reference(n_bases=MAIN_REF_BASES, seed=REF_SEED, ssr_seed=SSR_SEED):
    """`bench_fmi`'s uniform reference with simple sequence repeats written
    over SSR_SHARE of it: runs of a random 1-6 base unit, 20-100 bases
    long, at uniform random places.  Reads over a homopolymer or a
    dinucleotide run collect one interval per base or two, past the smem1
    walk's list cap, and take the e-table route.  Returns (ref, (run starts,
    run lengths, unit lengths))."""
    ref = bench_fmi_reference(n_bases, seed)
    rng = np.random.default_rng(ssr_seed)
    n_runs = int(n_bases * SSR_SHARE / (sum(SSR_LEN) / 2))
    lens = rng.integers(SSR_LEN[0], SSR_LEN[1] + 1, n_runs)
    starts = np.sort(rng.integers(0, n_bases - SSR_LEN[1], n_runs))
    units = rng.integers(SSR_UNIT[0], SSR_UNIT[1] + 1, n_runs)
    bases = rng.integers(0, 4, (n_runs, SSR_UNIT[1])).astype(np.uint8)
    for at, n, u, b in zip(starts.tolist(), lens.tolist(), units.tolist(), bases):
        ref[at:at + n] = np.resize(b[:u], n)
    return ref, (starts, lens, units)


def revcomp(codes) -> np.ndarray:
    return (np.uint8(3) - np.asarray(codes, np.uint8)[::-1]).astype(np.uint8)


def pad_batch(reads, width=None):
    """Reads (code arrays) -> (codes (B, width) uint8, zero-padded; qlen)."""
    lens = np.array([len(r) for r in reads], np.int32)
    width = width or max(int(lens.max()) if len(lens) else 1, 1)
    q = np.zeros((len(reads), width), np.uint8)
    for i, r in enumerate(reads):
        q[i, :len(r)] = r
    return q, lens


def _mutated_slices(rng, ref, n, length, subs=3):
    out = []
    for _ in range(n):
        s = int(rng.integers(0, len(ref) - length))
        r = ref[s:s + length].copy()
        at = rng.integers(0, length, subs)
        r[at] = rng.integers(0, 4, subs)
        out.append(r)
    return out


def edge_cases():
    """label -> dict(ref, query, qlen, min_seed_len, max_mem_intv) and, for
    "pivots", the pass-2 work items (qrow, pivot, min_intv) as int32."""
    cases = {}
    rng = np.random.default_rng(31)
    ref = rng.integers(0, 4, 4000).astype(np.uint8)

    reads = _mutated_slices(rng, ref, 6, 120)
    for r, at in zip(reads[:3], (0, 60, 119)):
        r[at] = 4                                   # N at the start, middle, end
    reads[3][::17] = 4                              # N-riddled
    reads.append(np.full(50, 4, np.uint8))          # all ambiguous
    reads.append(revcomp(ref[1000:1120]))           # the reverse strand
    q, ql = pad_batch(reads)
    cases["ambiguous"] = dict(ref=ref, query=q, qlen=ql)

    short = [ref[2000:2000 + n].copy() for n in (0, 1, 18, 19, 20, 21)]
    q, ql = pad_batch(short, 24)
    cases["short"] = dict(ref=ref, query=q, qlen=ql)

    lens = rng.integers(2, 250, 16)
    mixed = [ref[s:s + n].copy() for s, n in zip(rng.integers(0, 3700, 16), lens)]
    for r in mixed[::3]:
        r[rng.integers(0, len(r))] = int(rng.integers(0, 4))
    q, ql = pad_batch(mixed, 256)
    cases["mixed_lengths"] = dict(ref=ref, query=q, qlen=ql)

    # poly-A: a 600-base homopolymer gives one interval per forward base,
    # past the walk's list cap (tests/test_fmi.py:431-459)
    r44 = np.random.default_rng(44)
    ref_a = r44.integers(0, 4, 4000).astype(np.uint8)
    ref_a[1000:1600] = 0
    q = np.zeros((8, 80), np.uint8)
    for b in range(1, 8):
        at = int(r44.integers(950, 1500))
        q[b] = ref_a[at:at + 80]
    cases["poly_a"] = dict(ref=ref_a, query=q, qlen=np.full(8, 80, np.int32))

    # a highly repetitive reference: large s, long lists, many pass-2 parents
    r13 = np.random.default_rng(13)
    core = r13.integers(0, 4, 4000).astype(np.uint8)
    motif = core[:64]
    ref_r = np.concatenate([core, core[:2000], core, np.tile(motif, 40)])
    rep = _mutated_slices(r13, core, 6, 128, subs=2)
    # across the end of the shared 2,000 bases: a parent of s = 2 whose
    # midpoint may lie in bases that occur 3 times (pass-2 emits)
    rep += [core[s:s + 128].copy() for s in r13.integers(1880, 1990, 5)]
    rep[-1][64] = 4                                 # an N at the midpoint pivot
    rep += [np.tile(motif, 2)[:120], np.tile(motif, 2)[:100].copy()]
    rep[-1][::17] = 4
    q, ql = pad_batch(rep)
    cases["repetitive"] = dict(ref=ref_r, query=q, qlen=ql)

    # pass-3 seeds under the floor: G is rare, so many single-base seeds
    # start below max_mem_intv (tests/test_fmi.py:578-610)
    r55 = np.random.default_rng(55)
    ref_g = r55.choice(np.array([0, 1, 3, 3, 1, 0, 0, 1], np.uint8), 600)
    ref_g[r55.integers(0, 600, 8)] = 2
    sub = []
    for _ in range(24):
        n = int(r55.integers(24, 65))
        at = int(r55.integers(0, len(ref_g) - n))
        r = ref_g[at:at + n].copy()
        r[r55.integers(0, n, 2)] = r55.integers(0, 5, 2)
        sub.append(r)
    q, ql = pad_batch(sub, 64)
    for mmi in (5, 40, 200):
        cases[f"subfloor_{mmi}"] = dict(ref=ref_g, query=q, qlen=ql, min_seed_len=11,
                                        max_mem_intv=mmi)

    # a 1,000-base read beside shorter ones
    r17 = np.random.default_rng(17)
    ref_l = r17.integers(0, 4, 20000).astype(np.uint8)
    long_reads = _mutated_slices(r17, ref_l, 1, 1000, subs=8) \
        + _mutated_slices(r17, ref_l, 3, 151, subs=2)
    q, ql = pad_batch(long_reads, 1000)
    cases["long_read"] = dict(ref=ref_l, query=q, qlen=ql)

    # pass-2 work items on the repetitive reads: pivots at 0 and qlen - 1,
    # and in the middle, with several floors
    rq, rl = cases["repetitive"]["query"], cases["repetitive"]["qlen"]
    qrow, pivot, mintv = [], [], []
    for r in range(len(rl)):
        for p in (0, int(rl[r]) - 1, int(rl[r]) // 2):
            for mi in (1, 2, 3):
                qrow.append(r)
                pivot.append(p)
                mintv.append(mi)
    cases["pivots"] = dict(ref=ref_r, query=rq, qlen=rl,
                           items=tuple(np.asarray(v, np.int32) for v in (qrow, pivot, mintv)))
    for c in cases.values():
        c.setdefault("min_seed_len", MIN_SEED_LEN)
        c.setdefault("max_mem_intv", 20)
    return cases


# --------------------------------------------------------------- brute force
def text_bytes(ref) -> bytes:
    """T = ref . revcomp(ref) as bytes (the index's text)."""
    ref = np.asarray(ref, np.uint8)
    return bytes(np.concatenate([ref, revcomp(ref)]))


def count_occ(text: bytes, pat: bytes) -> int:
    c, i = 0, 0
    while True:
        j = text.find(pat, i)
        if j < 0:
            return c
        c += 1
        i = j + 1


def longest_match_table(text: bytes, q, qlen: int, min_intv: int) -> np.ndarray:
    """e_b: the end of the longest match from b whose count stays >= min_intv."""
    e = np.zeros(qlen, np.int64)
    for b in range(qlen):
        if q[b] > 3:
            e[b] = b
            continue
        j = b
        while j < qlen and q[j] <= 3:
            if count_occ(text, bytes(q[b:j + 1])) >= min_intv:
                j += 1
            else:
                break
        e[b] = j
    return e


def brute_smems(text: bytes, q, qlen: int, min_seed_len: int, min_intv=1):
    """[(m, n, s)] of pass 1 for one read, start-ascending."""
    e = longest_match_table(text, q, qlen, min_intv)
    out, prev = [], 0
    for b in range(qlen):
        if e[b] > prev and e[b] - b >= min_seed_len:
            out.append((b, int(e[b]) - 1, count_occ(text, bytes(q[b:e[b]]))))
        prev = max(prev, e[b])
    return out


def brute_pass2(text: bytes, q, qlen: int, pivot: int, min_intv: int, min_seed_len: int):
    """[(m, n, s)] of one pass-2 work item: the SMEMs covering `pivot` under
    floor min_intv (tests/test_fmi.py:131-143)."""
    e = longest_match_table(text, q, qlen, min_intv)
    out, prev = [], 0
    for b in range(pivot + 1):
        if e[b] > pivot and e[b] > prev and e[b] - b >= min_seed_len:
            out.append((b, int(e[b]) - 1, count_occ(text, bytes(q[b:e[b]]))))
        prev = max(prev, e[b])
    return out


# ------------------------------------------------------------------ fmi_gold
def write_gold_index(path, n_rows: int, sentinel_row: int, C, bwt_clean) -> None:
    """fmi_gold's index.bin: int64 n_rows, sent_row, C[5], then the cleaned
    BWT bytes (tools/fmi_gold_check.py:21-35)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<qq", n_rows, sentinel_row))
        f.write(np.asarray(C, np.int64).tobytes())
        f.write(np.ascontiguousarray(bwt_clean, np.uint8).tobytes())


def write_gold_reads(path, query, min_seed_len=MIN_SEED_LEN) -> None:
    """fmi_gold's reads.bin: int64 n_reads, L, min_seed_len, then the codes
    (every read of length L)."""
    q = np.ascontiguousarray(query, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<qqq", q.shape[0], q.shape[1], min_seed_len))
        f.write(q.tobytes())


def build_fmi_gold(out_dir) -> str:
    """Compile tools/ref_drivers/fmi_gold.cpp with g++ -O2 into out_dir."""
    exe = os.path.join(str(out_dir), "fmi_gold")
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe, str(FMI_GOLD_SRC)], check=True,
                   capture_output=True, timeout=300)
    return exe


def run_fmi_gold(exe, index_path, reads_path):
    """fmi_gold's (rid, pass, m, n+1, k, s) tuples, sorted, and its summary
    line."""
    r = subprocess.run([exe, str(index_path), str(reads_path)], capture_output=True,
                       text=True, check=True, timeout=3600)
    rows = np.array(r.stdout.split(), np.int64).reshape(-1, 6)
    return sorted(map(tuple, rows.tolist())), r.stderr.strip()


def pipeline_tuples(p1, p2, p3):
    """(rid, pass, m, n+1, k, s) of a run's three SmemResults, sorted."""
    out = []
    for pi, p in ((1, p1), (2, p2), (3, p3)):
        out += zip(p.rid.tolist(), [pi] * p.count, p.m.tolist(), (p.n + 1).tolist(),
                   p.k.tolist(), p.s.tolist())
    return sorted(out)
