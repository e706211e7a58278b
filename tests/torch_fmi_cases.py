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
* `cap_cases`: walks that meet the smem1 caps (CP, ME) inside a backward
  column, and columns of CP intervals;
* `brute_smems` / `brute_pass2`: SMEMs by plain string search over
  T = ref . revcomp(ref) (tests/test_fmi.py:13-56 and :119-143, copied);
* `write_gold_index` / `write_gold_reads` / `build_fmi_gold` /
  `run_fmi_gold`: the inputs of tools/ref_drivers/fmi_gold.cpp (the layout
  of tools/fmi_gold_check.py:21-35), its build with g++ and its tuples;
* `lane_group_smem1`: a model of `gb_fmi_smem1`'s schedule (lane groups,
  rounds, ballot compaction, the caps), held against the plain version.
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



def cap_cases():
    """Walks that meet the smem1 caps inside a backward column or fill its
    list: label -> dict(ref, query, qlen, min_seed_len) and, for the
    pass-2 items, items (qrow, pivot, min_intv) as int32.

    * "cp_cap": 30 poly-A runs of 15-35 bases, each flanked by G, in a
      6,000-base reference; 100-base reads from 12 bases before each run,
      with a substitution before it and one after it (pass 1: columns of up
      to 13 intervals, several chunks of a lane group);
    * "cp_cap_items": pass-2 items on those reads with pivots at each run's
      start, middle and end and at 0, floors 1 and 2: a forward collection
      past CP = 24 stops its item, and columns of exactly 24 intervals;
    * "me_cap": 8 random reads of 90-150 bases over a random 24-base
      reference, min_seed_len 1: every read's walk emits past ME = 48, at
      the first interval of a column whose other intervals a lane group
      extends in the same round (the sequential walk stops before them)."""
    out = {}
    r = np.random.default_rng(61)
    ref = r.integers(0, 4, 6000).astype(np.uint8)
    starts = np.sort(r.choice(np.arange(100, 5900, 180), 30, replace=False))
    runs = r.integers(15, 36, 30)
    reads, qrow, pivot, mintv = [], [], [], []
    for s, k in zip(starts.tolist(), runs.tolist()):
        ref[s:s + k] = 0
        ref[s - 1] = ref[s + k] = 2
    for s, k in zip(starts.tolist(), runs.tolist()):
        rd = ref[s - 12:s + 88].copy()
        rd[10] = (rd[10] + 1) % 4
        rd[min(k + 16, 99)] = (rd[min(k + 16, 99)] + 2) % 4
        reads.append(rd)
        for p in (12, 12 + k // 2, 11 + k, 0):
            for f in (1, 2):
                qrow.append(len(reads) - 1)
                pivot.append(p)
                mintv.append(f)
    q, ql = pad_batch(reads)
    out["cp_cap"] = dict(ref=ref, query=q, qlen=ql, min_seed_len=MIN_SEED_LEN)
    out["cp_cap_items"] = dict(ref=ref, query=q, qlen=ql, min_seed_len=MIN_SEED_LEN,
                               items=tuple(np.asarray(v, np.int32)
                                           for v in (qrow, pivot, mintv)))
    r = np.random.default_rng(40)
    ref = r.integers(0, 4, 24).astype(np.uint8)
    reads = [r.integers(0, 4, n).astype(np.uint8) for n in r.integers(90, 151, 8).tolist()]
    q, ql = pad_batch(reads, 150)
    out["me_cap"] = dict(ref=ref, query=q, qlen=ql, min_seed_len=1)
    return out

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


# ------------------------------------------------------- the smem1 schedule
# gb_fmi_smem1's lanes a work item (csrc/fmi.cu kGroup)
SMEM1_GROUP = 4


def _line_ranks(table, sent, row):
    """Counts of each base in BWT[0:row] from the packed line table (a list
    of 8-int rows), as csrc/fmi.cu `rank4` computes them."""
    blk, off = row >> 6, row & 63
    c0, c1, c2, c3, a0, a1, b0, b1 = table[blk]
    a0, a1, b0, b1 = (v & 0xFFFFFFFF for v in (a0, a1, b0, b1))
    m_lo = 0xFFFFFFFF if off >= 32 else (1 << off) - 1
    m_hi = (1 << (off - 32)) - 1 if off > 32 else 0
    n0, n1 = ~a0 & 0xFFFFFFFF, ~a1 & 0xFFFFFFFF
    o0, o1 = ~b0 & 0xFFFFFFFF, ~b1 & 0xFFFFFFFF
    r = [c0 + (n0 & o0 & m_lo).bit_count() + (n1 & o1 & m_hi).bit_count(),
         c1 + (a0 & o0 & m_lo).bit_count() + (a1 & o1 & m_hi).bit_count(),
         c2 + (n0 & b0 & m_lo).bit_count() + (n1 & b1 & m_hi).bit_count(),
         c3 + (a0 & b0 & m_lo).bit_count() + (a1 & b1 & m_hi).bit_count()]
    r[0] -= int((sent >> 6) == blk and sent < row)
    return r


def _line_ext(table, C, sent, a, other, s, c):
    """csrc/fmi.cu `ext`: (a', other', s', rank lines loaded)."""
    b = a + s
    lo, hi = _line_ranks(table, sent, a), _line_ranks(table, sent, b)
    s4 = [h - l for h, l in zip(hi, lo)]
    suf = (s4[1] + s4[2] + s4[3], s4[2] + s4[3], s4[3], 0)
    other_n = other + int(a <= sent < b) + suf[c]
    return C[c] + lo[c], other_n, s4[c], 1 if (a >> 6) == (b >> 6) else 2


def lane_group_smem1(index, query, qlen, qrow=None, pivot=None, min_intv=None, *,
                     min_seed_len, group=SMEM1_GROUP):
    """A model of `gb_fmi_smem1`'s schedule, one work item at a time on its
    group of `group` lanes, in the kernel's rounds: the read staged; a round
    first seeds where a pivot ended (a scan over the staged bases that
    costs no load), then makes at most one extension a lane: a forward
    step on every lane of the group alike, or one interval of a backward
    column per lane, the column's list read longest first in its first
    column, `group` intervals a round; then the state update, where the
    column's survivors are compacted by ballots (the size test against
    the previous survivor, read by a shuffle, or the last one of the
    chunk before), the one emit a column can make (its first interval
    dying) and the caps stop the item as the sequential walk stops it,
    counting only the extensions that walk made.  One list of CP slots a
    group: the forward collection fills it from the top down, so that
    every column reads it upwards from `base`, longest first, and its
    survivors are compacted in place at 0 upwards (a chunk reads before it
    writes, and no survivor lands above the slot it was read from).

    `index` is an FmdIndex (host arrays).  Returns the plain version's
    (count, ovf, loads, steps, slots) as numpy arrays and the rounds each
    item took."""
    table = index.packed().tolist()
    C = [int(c) for c in index.C]
    sent = int(index.sentinel_row)
    query = np.asarray(query, np.uint8)
    qlen = np.asarray(qlen, np.int64)
    B, L = query.shape
    has_pivot = pivot is not None
    N = len(qrow) if qrow is not None else B
    CP, ME = min(L + 1, 24), min(L + 1, 48)
    count, ovf, loads, steps, rounds = (np.zeros(N, np.int64) for _ in range(5))
    slots = np.zeros((N, ME, 4), np.int64)
    below = [(1 << gl) - 1 for gl in range(group)]
    for w in range(N):
        row = int(qrow[w]) if qrow is not None else w
        ql = int(qlen[row])
        rd = query[row, :max(ql, 0)].tolist()          # the staged bases
        mi = int(min_intv[w]) if min_intv is not None else 1
        x = int(pivot[w]) if has_pivot else 0
        if ql < 1:
            x = ql
        lst = [(0, 0, 0)] * CP                         # (k, s, e)
        phase = "scan"
        ovf_w = loads_w = steps_w = rounds_w = 0
        while True:
            rounds_w += 1
            if phase == "scan":
                while x < ql:
                    nb = rd[x] if x >= 0 else 4
                    if nb < 4 and C[nb + 1] - C[nb] >= mi:
                        break
                    x += 1
                if x >= ql:
                    phase = "done"
                else:
                    phase = "fwd"
                    wk, wl, ws = C[nb], C[3 - nb], C[nb + 1] - C[nb]
                    cnt, i = 0, x + 1
            if phase == "fwd":
                cf = rd[i] if i < ql else 4
                if cf < 4:
                    lf, kf, sf, nl = _line_ext(table, C, sent, wl, wk, max(ws, 1), 3 - cf)
                    loads_w += nl
                    steps_w += 1
                stop = cf >= 4 or sf < mi
                if stop or sf != ws:
                    if cnt >= CP:
                        ovf_w = 1
                        phase = "done"
                    else:
                        lst[CP - 1 - cnt] = (wk, ws, i)
                        cnt += 1
                if phase != "done":
                    if stop:
                        phase, ex, base, prev_n, j = "bwd", i, CP - cnt, cnt, x - 1
                        ptr, curr_n, last_s = 0, 0, 0
                    else:
                        wk, wl, ws, i = kf, lf, sf, i + 1
            elif phase == "bwd":
                cb = rd[j] if 0 <= j < ql else 4
                ent, sb, kb = [None] * group, [0] * group, [0] * group
                m_ext = m_two = m_surv = 0
                for gl in range(group):          # every lane's request and extension
                    p = ptr + gl
                    if p < prev_n:
                        ent[gl] = lst[base + p]
                        if cb < 4:
                            pk, ps, _ = ent[gl]
                            kb[gl], _, sb[gl], nl = _line_ext(table, C, sent, pk, 0, max(ps, 1),
                                                              cb)
                            m_ext |= 1 << gl
                            m_two |= (nl == 2) << gl
                            m_surv |= (sb[gl] >= mi) << gl
                m_app = 0
                for gl in range(group):          # the size test by shuffle
                    if m_surv >> gl & 1:
                        prev = m_surv & below[gl]
                        if prev:
                            app = sb[gl] != sb[prev.bit_length() - 1]
                        else:
                            app = curr_n == 0 or sb[gl] != last_s
                        m_app |= app << gl
                pk0, ps0, pe0 = ent[0]
                emit = ptr == 0 and not m_surv & 1 and pe0 - (j + 1) >= min_seed_len
                counted = m_ext
                if emit and count[w] >= ME:       # stops at interval 0 of the column
                    ovf_w, counted, phase = 1, m_ext & 1, "done"
                elif emit:
                    slots[w, count[w]] = (j + 1, pe0, pk0, ps0)
                    count[w] += 1
                steps_w += counted.bit_count()
                loads_w += counted.bit_count() + (m_two & counted).bit_count()
                if phase != "done":
                    for gl in range(group):      # the appenders, compacted by rank
                        if m_app >> gl & 1:
                            rank = (m_app & below[gl]).bit_count()
                            lst[curr_n + rank] = (kb[gl], sb[gl], ent[gl][2])
                    curr_n += m_app.bit_count()
                    if m_surv:
                        last_s = sb[m_surv.bit_length() - 1]
                    ptr += group
                    if cb >= 4 or ptr >= prev_n:      # the column's end
                        if curr_n == 0:
                            if has_pivot:
                                phase = "done"
                            else:
                                x, phase = max(ex, x + 1), "scan"
                        else:
                            base, prev_n, curr_n, ptr = 0, curr_n, 0, 0
                            j -= 1
            if phase == "done":
                break
        ovf[w], loads[w], steps[w], rounds[w] = ovf_w, loads_w, steps_w, rounds_w
    return dict(count=count, ovf=ovf, loads=loads, steps=steps, slots=slots, rounds=rounds)


# ------------------------------------------------------- the seed3 schedule
# gb_fmi_seed3's lanes a read (csrc/fmi.cu kSeedGroup)
SEED3_GROUP = 2


def _part_ranks(line, sent, row, p):
    """Lane part p of a rank at `row` from its 8-int line: the line's counts
    (p even), or the plane popcounts with the sentinel row taken out (p
    odd), as gb_fmi_seed3's lanes compute them."""
    if p % 2 == 0:
        return list(line[:4])
    r = _line_ranks({row >> 6: line}, sent, row)
    return [r[i] - line[i] for i in range(4)]


def seed3_cap_of(width, min_len):
    """EM3 of a walk over width `width` (ops/fmi.py `seed3_cap`)."""
    return min(width + 1, max(16, width // max(min_len, 1) + 2))


def _group_step(table, C, sent, a, other, s, cc, group):
    """A step from its lines' four 16-byte parts on `group` lanes, 4 / group
    consecutive parts a lane: each lane's share of the interval sizes and
    of the rank at a, summed (the shuffles); checked against csrc/fmi.cu
    `ext`.  Returns (a', other', s', rank lines loaded)."""
    b = a + s
    lines = [table[a >> 6], table[a >> 6], table[b >> 6], table[b >> 6]]
    P, Q = [0, 0, 0, 0], 0
    per = 4 // group
    for gl in range(group):                 # lane gl takes parts per * gl ..
        for p in range(per * gl, per * (gl + 1)):
            r = _part_ranks(lines[p], sent, a if p < 2 else b, p)
            sign = -1 if p < 2 else 1
            P = [P[i] + sign * r[i] for i in range(4)]
            if p < 2:
                Q += r[cc]
    suf = (P[1] + P[2] + P[3], P[2] + P[3], P[3], 0)
    got = (C[cc] + Q, other + int(a <= sent < b) + suf[cc], P[cc],
           1 if (a >> 6) == (b >> 6) else 2)
    assert got == _line_ext(table, C, sent, a, other, s, cc)
    return got


def staged_seed3(index, query, qlen, *, min_intv, min_len, group=SEED3_GROUP, em3=None):
    """A model of `gb_fmi_seed3`'s schedule, one read at a time on its group
    of `group` lanes, in the kernel's rounds: the read staged (positions at
    or past the width read its last base, as the plain version's clamp
    does); a round loads the step's lines first, the 16-byte parts [counts,
    planes of row l's line, counts, planes of row l + s's] 4 / group a lane
    (with 2 lanes, lane j row j's line), then reads the step's base; an
    ambiguous base or the read's
    end discards the loads and reseeds past it in the same round, as an
    emit does; each lane adds its share of the four interval sizes and of
    the rank at l, and the group's sum is the step.  Counts only the
    sequential walk's loads and steps.  `em3` (default the wrapper's cap)
    sizes the slots; an emit past them overwrites the last.

    `index` is an FmdIndex (host arrays).  Returns the plain version's
    (count, loads, steps, slots) as numpy arrays, the rounds each read took
    and the rounds whose loads were discarded."""
    table = index.packed().tolist()
    C = [int(c) for c in index.C]
    sent = int(index.sentinel_row)
    query = np.asarray(query, np.uint8)
    qlen = np.asarray(qlen, np.int64)
    B, L = query.shape
    EM3 = em3 or seed3_cap_of(L, min_len)
    count, loads, steps, rounds, discarded = (np.zeros(B, np.int64) for _ in range(5))
    slots = np.zeros((B, EM3, 4), np.int64)
    for w in range(B):
        ql = int(qlen[w])
        rd = query[w, :max(min(ql, L), 0)].tolist()     # the staged bases

        def base(p):
            return rd[min(p, L - 1)]

        def reseed(x):
            while x < ql and base(x) >= 4:
                x += 1
            if x >= ql:
                return x, None
            nb = base(x)
            s = C[nb + 1] - C[nb]
            tail = s < min_intv
            return x, [C[nb], C[3 - nb], s, tail, x if tail else x + 1, x + 1]

        x, st = reseed(0) if ql >= 1 else (0, None)
        while st is not None:
            rounds[w] += 1
            k, l, s, tail, exr, ee = st
            pos = ee
            c = base(pos) if pos < ql else 4
            if c >= 4:                      # the loads discarded, no emit
                discarded[w] += 1
                x, st = reseed(ql if pos >= ql else pos + 1)
                continue
            l_n, k_n, s_n, nl = _group_step(table, C, sent, l, k, s, 3 - c, group)
            loads[w] += nl
            steps[w] += 1
            if not tail and s_n < min_intv:
                exr, tail = ee, True
            istar = max(exr, x + min_len)
            if tail and pos >= istar:       # [x, istar] covered: emit, hop
                slots[w, min(count[w], EM3 - 1)] = (x, istar, k_n, s_n)
                count[w] += 1
                x, st = reseed(istar + 1)
            else:
                st = [k_n, l_n, s_n, tail, exr, pos + 1]
    return dict(count=count, loads=loads, steps=steps, slots=slots, rounds=rounds,
                discarded=discarded)


def extend_lanes(query, qlen, floors=((1, 1 << 30), (0, None), (3, 1 << 30), (40, 1 << 30))):
    """E-table lanes over every read of a batch: each start -1 .. width + 1
    with each (floor, max_e) of `floors` (max_e None: half the width), as
    int32 (qrow, start, min_intv, max_e)."""
    B, L = np.asarray(query).shape
    starts = np.arange(-1, L + 2, dtype=np.int32)
    qrow, start, mi, me = [], [], [], []
    for floor, end in floors:
        qrow.append(np.repeat(np.arange(B, dtype=np.int32), len(starts)))
        start.append(np.tile(starts, B))
        mi.append(np.full(B * len(starts), floor, np.int32))
        me.append(np.full(B * len(starts), L // 2 if end is None else end, np.int32))
    return tuple(np.concatenate(v) for v in (qrow, start, mi, me))


def seed3_cases():
    """label -> dict(ref, query, qlen, min_intv, min_len) for the seed walk's
    edges: reads of length 0, 1 and below min_len; runs of N and an N at
    the last base; reads whose emits pass a small EM3 (`em3`, for the C
    entry: the wrapper's cap is never passed); a 1,000-base read at widths
    1,001 and 1,500, past the kernel's staged width; qlen past the width
    (the last base read again, as the plain version's clamp reads it)."""
    rng = np.random.default_rng(71)
    ref = rng.integers(0, 4, 6000).astype(np.uint8)
    out = {}
    reads = [ref[100:100 + n].copy() for n in (0, 1, 2, 19, 20, 21, 40)]
    q, ql = pad_batch(reads, 48)
    out["short"] = dict(ref=ref, query=q, qlen=ql, min_intv=20, min_len=20)
    reads = _mutated_slices(rng, ref, 10, 151, subs=2)
    reads[0][30:45] = 4                              # a run of N
    reads[1][-1] = 4                                 # an N at the last base
    reads[2][0] = 4
    reads[3][::10] = 4
    reads[4][:] = 4
    reads[5][-3:] = 4
    reads[6][[20, 21, 60, 150]] = 4
    q, ql = pad_batch(reads)
    out["ambiguous"] = dict(ref=ref, query=q, qlen=ql, min_intv=20, min_len=20)
    reads = _mutated_slices(rng, ref, 8, 151, subs=1)
    q, ql = pad_batch(reads)
    out["em3_overflow"] = dict(ref=ref, query=q, qlen=ql, min_intv=2, min_len=3, em3=4)
    long_read = _mutated_slices(rng, ref, 1, 1000, subs=6) + _mutated_slices(rng, ref, 2, 151)
    for width in (1001, 1500):
        q, ql = pad_batch(long_read, width)
        out[f"width{width}"] = dict(ref=ref, query=q, qlen=ql, min_intv=20, min_len=20)
    q, ql = pad_batch(_mutated_slices(rng, ref, 4, 64), 64)
    ql = ql + np.array([0, 1, 5, 40], np.int32)
    out["qlen_past_width"] = dict(ref=ref, query=q, qlen=ql, min_intv=20, min_len=20)
    return out
