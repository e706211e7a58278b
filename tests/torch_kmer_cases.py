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


# ------------------------------------------------- the canonical pass's sweep
# A numpy model of gb_kmer_canonical (csrc/kmer.cu), in plain Python
# integers: each unit of CANON_UNIT positions of the flat (B * L) plane,
# whose codes sit at byte offset `off` of a 16-byte aligned buffer, starts
# at 16 c - (off % 16) and sees its own aligned 16 bytes, the next 16 (where
# any of them is in the plane) and, in mode 1, the 4 bytes before it (for
# every unit but the first).  From the unit's first position it walks the
# rows that its window of CANON_UNIT + k - 1 positions touches, one segment
# a row: the 16 positions' validity (col < length - k) and, in mode 1, the
# window's positions at a column that is a multiple of 4 (a packed byte's
# first slot).  Mode 1 derives each code as `pack_codes_2bit` and
# `_unpack_codes_2bit` read it: d = (c | carry) & 3, the carry the last
# code's and carry's bits above the slot, cleared at a byte's first slot.
# The k-mer is seeded from the first k codes and rolled a position at a
# time, x' = (x - d_q 4^(k-1)) 4 + d_(q+k) mod 2^32: the flat window sum,
# which at a valid position is that position's k-mer (its k codes lie in
# its row), so the roll needs no restart at a row boundary.
CANON_UNIT = 16
_MASK32 = 0xFFFFFFFF


def _revcomp_int(x, k):
    x = ~x & (_MASK32 if k == 16 else (1 << (2 * k)) - 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x << 16) | (x >> 16)) & _MASK32
    return x >> (32 - 2 * k)


def unit_sweep_keys(buf, off, B, L, lengths, k, mode):
    """The (B * L,) int32 keys that the sweep gives for the plane
    buf[off : off + B * L] (bytes of `buf` around it stand for whatever
    memory the aligned loads touch), `lengths` (B,), k from 1 to 16, mode 0
    (codes as given) or 1 (codes through their packed bytes)."""
    buf = np.asarray(buf, np.uint8)
    N, sh = B * L, off % 16
    sentinel = 0x7FFFFFFF
    keys = np.full(N, sentinel, np.int64)
    W = CANON_UNIT + k - 1
    top = 1 << (2 * (k - 1))

    def byte(p):                        # the byte at plane position p, as loaded
        i = off + p
        return int(buf[i]) if 0 <= i < len(buf) else 0

    for c in range(-(-(N + sh) // 16)):
        p0 = 16 * c - sh
        nxt = 16 * (c + 1) - sh < N     # the next 16 bytes hold a plane byte
        code = [byte(p0 + q) if q < 16 or nxt else 0 for q in range(32)]
        prev = [byte(p0 - m) if c > 0 else 0 for m in (1, 2, 3)]
        q = max(0, -p0)
        b, col = divmod(p0 + q, L)
        valid = slot0 = 0
        col0 = col
        while q < W and p0 + q < N:     # one segment a row
            seg = min(L - col, W - q)
            slot0 |= (0x1111111111111111 << (q + (-col & 3))) & (((1 << seg) - 1) << q)
            if q < CANON_UNIT:
                nv = max(0, min(int(lengths[b]) - k - col, seg, CANON_UNIT - q))
                valid |= ((1 << nv) - 1) << q
            q, col, b = q + seg, 0, b + 1
        if mode == 0:
            d = code[:W]
        else:
            a = col0 & 3 if p0 >= 0 else 0
            carry = 0
            for m in range(1, a + 1):
                carry |= prev[m - 1] >> (2 * m)
            d = []
            for q in range(W):
                if q and slot0 >> q & 1:
                    carry = 0
                u = code[q] | carry
                d.append(u & 3)
                carry = u >> 2
        x = 0
        for j in range(k):
            x = (x * 4 + d[j]) & _MASK32
        for q in range(CANON_UNIT):
            p = p0 + q
            if 0 <= p < N and valid >> q & 1:
                keys[p] = min(x, _revcomp_int(x, k)) ^ 0x80000000
            if q + 1 < CANON_UNIT:
                x = ((x - d[q] * top) * 4 + d[q + k]) & _MASK32
    return keys.astype(np.uint32).view(np.int32)


def canon_sweep_batches(k, seed=0):
    """{label: (codes (B, L), lengths)}: L = 1, 3, 5, 15, 16, 17 and L
    of every residue mod 4 and mod 16 (rows starting inside units; L
    smaller than a unit), a batch of one row, lengths 0, k - 1, k, k + 1
    and L, codes 4 and 5-255 at every slot of a packed byte, runs of 4."""
    rng = np.random.default_rng(seed * 100 + k)
    out = {}
    for L in (1, 3, 5, 15, 16, 17, 36, 37, 38, 39, 61, 96):
        lens = np.array([0, max(0, k - 1), k, k + 1, L] + list(rng.integers(0, L + 1, 4)),
                        np.int64)
        lens = np.minimum(lens, L).astype(np.int32)
        codes = rng.integers(0, 4, (len(lens), L)).astype(np.uint8)
        amb = rng.random(codes.shape) < 0.15
        codes[amb] = 4
        big = rng.random(codes.shape) < 0.05
        codes[big] = rng.integers(5, 256, int(big.sum()))
        codes[-1, :] = np.arange(L) % 4 + 4 * (np.arange(L) // 4 % 2)
        out[f"L{L}"] = (codes, lens)
    L = 200
    codes = rng.integers(0, 6, (1, L)).astype(np.uint8)
    out["one_row"] = (codes, np.array([L], np.int32))
    return out


# --------------------------------------------------- the minimizer walk's scan
# A numpy model of gb_kmer_minimizers' exactness argument (csrc/kmer.cu).
# The deque's front after step p is always a position of the window's
# minimum hash, so it moves only when a strictly smaller hash enters (to
# that position) or when step front + w evicts it (to the last minimum of
# the window front + 1 .. front + w): its next position depends on its
# position alone.  The fronts are the chain of `next_fronts` from position
# 0, and the mask is the set of them.  A segment of `seg` positions maps
# its entry (the first front at or past its start: one of w offsets, or
# none) to its exit (the first front at or past its end); the maps compose
# associatively, so an exclusive scan of them gives every segment's entry,
# and a walk of each segment from its entry marks its fronts.
NO_FRONT = np.iinfo(np.int64).max


def _splitmix_np(v):
    z = v.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _canonical_np(x, k):
    m = np.uint64((1 << (2 * k)) - 1)
    y = ~x.astype(np.uint64) & m
    rc = np.zeros_like(y)
    for _ in range(k):
        rc = (rc << np.uint64(2)) | (y & np.uint64(3))
        y >>= np.uint64(2)
    return np.minimum(x.astype(np.uint64), rc)


def walk_hashes(codes, lengths, k):
    """(raw k-mers (B, L) int64, columns read modulo L as jnp.roll does;
    hashes (B, L) uint64 of the canonical k-mers; live (B,) steps)."""
    B, L = codes.shape
    x = np.zeros((B, L), np.uint64)
    for j in range(k):
        x += np.roll(codes, -j, 1).astype(np.uint64) << np.uint64(2 * (k - 1 - j))
    raw = x & np.uint64(0xFFFFFFFF)
    live = np.asarray(lengths, np.int64) - k
    return raw.astype(np.int64), _splitmix_np(_canonical_np(raw, k)), live


def next_fronts(h, live, w):
    """The front's next position from each position s < live: the first q
    in s+1 .. s+w with h[q] < h[s], else the last minimum of s+1 .. s+w;
    NO_FRONT where the step that would move it is not live."""
    nxt = np.full(len(h), NO_FRONT, np.int64)
    for s in range(max(live, 0)):
        best, to = None, NO_FRONT
        for q in range(s + 1, s + w + 1):
            if q >= live:
                to = NO_FRONT
                break
            if h[q] < h[s]:
                to = q
                break
            if best is None or h[q] <= best:
                best, to = h[q], q
        nxt[s] = to
    return nxt


def segment_maps(nxt, L, w, seg):
    """(n_seg, w + 1) int64: segment i's exit offset (from its end) for each
    entry offset (from its start), offset w standing for no front."""
    n_seg = -(-L // seg)
    maps = np.full((n_seg, w + 1), w, np.int64)
    for i in range(n_seg):
        a, end = i * seg, (i + 1) * seg
        for o in range(w):
            x = a + o
            while x < end:
                x = nxt[x] if x < len(nxt) else NO_FRONT
            maps[i, o] = w if x == NO_FRONT else x - end
    return maps


def exclusive_scan_maps(maps):
    """Each segment's entry map: the composition of the maps before it
    (identity first), by a Hillis-Steele scan, log2(n_seg) rounds."""
    n_seg, width = maps.shape
    incl = maps.copy()
    d = 1
    while d < n_seg:
        nxt = incl.copy()
        nxt[d:] = np.take_along_axis(incl[d:], incl[:-d], 1)   # later after earlier
        incl, d = nxt, 2 * d
    excl = np.empty_like(incl)
    excl[0] = np.arange(width)
    excl[1:] = incl[:-1]
    return excl


def segment_scan_walk(codes, lengths, k, window, seg):
    """The minimizer walk's (raw (B, L) int64, mask (B, L) bool) by the
    segment-map scan, segments of `seg` positions."""
    codes = np.asarray(codes, np.uint8)
    B, L = codes.shape
    w = window
    raw, hashes, live = walk_hashes(codes, lengths, k)
    mask = np.zeros((B, L), bool)
    for b in range(B):
        nxt = next_fronts(hashes[b], live[b], w)
        entries = exclusive_scan_maps(segment_maps(nxt, L, w, seg))[:, 0 if live[b] > 0 else w]
        for i, o in enumerate(entries):
            x = NO_FRONT if o == w else i * seg + o
            while x < (i + 1) * seg:
                mask[b, x] = True
                x = nxt[x]
    return raw, mask


def warmup_split_walk(codes, lengths, k, window, seg):
    """The split that the scan replaces: each segment's steps walked by the
    plain recurrence from a fresh deque `window` positions before the
    segment, as if the read began there.  Not exact: on periodic sequence
    the fresh walk keeps another phase of the fronts."""
    codes = np.asarray(codes, np.uint8)
    B, L = codes.shape
    w = window
    raw, hashes, live = walk_hashes(codes, lengths, k)
    mask = np.zeros((B, L), bool)
    for b in range(B):
        h = hashes[b]
        for a in range(0, L, seg):
            s0 = max(0, a - w)
            front = s0
            for p in range(s0, min(a + seg, live[b])):
                lo = max(s0, p - w + 1)
                win = h[lo:p + 1]
                m = win.min()
                earliest = lo + int(np.argmax(win == m))
                latest = lo + len(win) - 1 - int(np.argmax(win[::-1] == m))
                new = latest if front <= p - w else max(front, earliest)
                if p - s0 < w:
                    new = min(new, earliest)
                front = new
                if p >= a:
                    mask[b, front] = True
    return raw, mask


# ------------------------------------------ the run count and the frequencies
# Sorted key arrays for gb_kmer_runs and gb_kmer_freqs.  SENTINEL_KEY (no
# k-mer) sorts last; a run is a stretch of equal keys.
SENTINEL = 0x7FFFFFFF
FREQ_SLOTS = 8                      # sorted slots a thread of gb_kmer_freqs
FREQ_THREADS = 256
FREQ_TILE = FREQ_THREADS * FREQ_SLOTS
FREQ_WINDOW = 1 << 24               # positions of the plane a pass of gb_kmer_freqs stores,
FREQ_MAX_PASSES = 4                 # or more where the plane needs more passes than this
RUNS_UNROLL = 4                     # 16-byte loads a lane takes at a time in gb_kmer_runs
RUNS_CHUNK = 32 * RUNS_UNROLL       # vectors a warp takes at a time


def keys_of_runs(lengths, sentinels=0, seed=0):
    """Sorted int32 keys: a run of each length in `lengths`, of distinct
    increasing random values (negative ones among them), then `sentinels`
    SENTINEL keys."""
    rng = np.random.default_rng(seed)
    step = (SENTINEL + (1 << 31)) // (len(lengths) + 1)
    vals = -(1 << 31) + np.cumsum(rng.integers(1, step + 1, len(lengths)))
    keys = np.repeat(vals, np.asarray(lengths, np.int64))
    return np.concatenate([keys, np.full(sentinels, SENTINEL, np.int64)]).astype(np.int32)


def short_runs(n, seed, longest=4):
    """Run lengths of 1..longest summing to n."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, longest + 1, n // 2 + 2)
    lens = lens[:int(np.searchsorted(np.cumsum(lens), n)) + 1]
    lens[-1] -= lens.sum() - n
    return [int(x) for x in lens if x > 0]


def runs_ending_at(ends, n, seed):
    """Run lengths summing to n in which a run ends at each slot of `ends`
    (its last slot), short runs elsewhere."""
    out, at = [], 0
    for i, e in enumerate(sorted(ends) + [n - 1]):
        if e >= at:
            out += short_runs(e + 1 - at, seed + i)
            at = e + 1
    return out


def freq_tile_cases(seed=0):
    """{label: (sorted int32 keys, int64 permutation)}: the tile edges of
    gb_kmer_freqs (FREQ_TILE slots a block) and its edge searches.
    `edge_{d}`: runs ending exactly one slot before, at and after each of
    three tile edges (d -1, 0, 1), and runs crossing them by one slot;
    `across_tiles`: a run over three whole tiles and parts of two more;
    `poly_a`: a run of 69,985 keys (a 70,000-base poly-A read's 15-mer:
    saturating) beside runs of 0xFFFE and 0xFFFF; `below_saturation`: a
    run of 0xFFFE, the longest that does not saturate; `at_saturation`: a
    run of 0xFFFF, the shortest that does; `sentinel_tail`: sentinels
    from the middle of a tile to the end; `sentinel_tiles`: sentinels filling
    two whole tiles from a tile edge; `one`, `below_tile`, `odd`: n of 1,
    1,000 and 3 tiles + 77."""
    T = FREQ_TILE
    cases = {}
    for d in (-1, 0, 1):
        n = 4 * T + 100
        ends = [k * T + d - 1 for k in (1, 2, 3)] + [k * T + d for k in (1, 2, 3)]
        cases[f"edge_{d}"] = keys_of_runs(runs_ending_at(ends, n, seed + 30 + d),
                                          seed=seed + 10 + d)
    cases["across_tiles"] = keys_of_runs(
        short_runs(T - 300, seed) + [3 * T + 700] + short_runs(T + 9, seed + 1), seed=seed + 20)
    cases["poly_a"] = keys_of_runs(short_runs(2_000, seed + 2) + [0xFFFE, 69_985, 0xFFFF]
                                   + short_runs(1_000, seed + 3), sentinels=45, seed=seed + 21)
    cases["below_saturation"] = keys_of_runs(short_runs(500, seed + 8) + [0xFFFE],
                                             sentinels=3, seed=seed + 27)
    cases["at_saturation"] = keys_of_runs(short_runs(300, seed + 9) + [0xFFFF]
                                          + short_runs(40, seed + 10), seed=seed + 28)
    cases["sentinel_tail"] = keys_of_runs(short_runs(2 * T + 1_234, seed + 4),
                                          sentinels=T + 2_000, seed=seed + 22)
    cases["sentinel_tiles"] = keys_of_runs(short_runs(2 * T - 3, seed + 5) + [3],
                                           sentinels=2 * T, seed=seed + 23)
    cases["one"] = keys_of_runs([1], seed=seed + 24)
    cases["below_tile"] = keys_of_runs(short_runs(1_000, seed + 6, longest=9), sentinels=17,
                                       seed=seed + 25)
    cases["odd"] = keys_of_runs(short_runs(3 * T + 77, seed + 7, longest=30), sentinels=5,
                                seed=seed + 26)
    rng = np.random.default_rng(seed + 99)
    return {k: (s, rng.permutation(len(s)).astype(np.int64)) for k, s in cases.items()}


def _run_first(s, i, v, loads):
    good, bad, step = i, -1, 1
    while i - step >= 0:
        loads.append(i - step)
        if s[i - step] != v:
            bad = i - step
            break
        good, step = i - step, 2 * step
    while good - bad > 1:
        mid = bad + (good - bad) // 2
        loads.append(mid)
        good, bad = (mid, bad) if s[mid] == v else (good, mid)
    return good


def _run_last(s, n, i, v, loads):
    good, bad, step = i, n, 1
    while i + step < n:
        loads.append(i + step)
        if s[i + step] != v:
            bad = i + step
            break
        good, step = i + step, 2 * step
    while bad - good > 1:
        mid = good + (bad - good) // 2
        loads.append(mid)
        good, bad = (mid, bad) if s[mid] == v else (good, mid)
    return good


def _warp_scan(x, op, up):
    """Hillis-Steele inclusive scan over the last axis (32 lanes), as the
    kernel's shuffles do it: __shfl_up_sync (up) or __shfl_down_sync."""
    x = x.copy()
    lane = np.arange(32)
    d = 1
    while d < 32:
        if up:
            y = np.concatenate([x[..., :d], x[..., :-d]], -1)
            x = np.where(lane >= d, op(x, y), x)
        else:
            y = np.concatenate([x[..., d:], x[..., -d:]], -1)
            x = np.where(lane + d < 32, op(x, y), x)
        d *= 2
    return x


def freq_window(n):
    """The positions a pass of gb_kmer_freqs stores, for n keys."""
    return max(FREQ_WINDOW, -(-n // FREQ_MAX_PASSES))


def tile_freqs(s, order, stats=None, window=None):
    """A numpy model of gb_kmer_freqs' schedule (csrc/kmer.cu): (freq (n,)
    uint16, sat (1,) int32).  Each tile of FREQ_TILE sorted slots, FREQ_SLOTS
    a thread, with the key before and after it (the halo); each thread's
    head and tail masks, its last head and first tail, their exclusive
    max- and min-scans across the warp's lanes by shuffles and across the
    block's warps; the first run's start and the last run's end by the edge
    searches where the tile has no head or tail for them; each slot's count
    from the head and tail at or around it; then, a pass for each `window`
    positions of the plane, the counts whose position lies in it.  With
    `stats`, a dict, the loads of every edge search go to
    stats["searches"] as (tile, side, loads) and the stores of each pass to
    stats["stores"]."""
    s = np.asarray(s, np.int64)
    n = len(s)
    T, S, W = FREQ_TILE, FREQ_SLOTS, FREQ_THREADS // 32
    freq = np.zeros(n, np.uint16)
    sat = 0
    counts = np.zeros(n, np.int64)
    for t0 in range(0, n, T):
        idx = t0 + np.arange(T)
        v = np.where(idx < n, s[np.minimum(idx, n - 1)], SENTINEL)
        prev = np.concatenate([[s[t0 - 1] if t0 > 0 else ~v[0]], v[:-1]])
        nxt = np.concatenate([v[1:], [s[t0 + T] if t0 + T < n else ~v[-1]]])
        head = (prev != v).reshape(W, 32, S)
        tail = ((nxt != v) | (idx >= n - 1)).reshape(W, 32, S)
        local = np.arange(T).reshape(W, 32, S)
        hs = np.where(head, local, -1).max(-1)                  # each thread's last head
        ts = np.where(tail, local, T).min(-1)                   # and first tail
        hs, ts = _warp_scan(hs, np.maximum, True), _warp_scan(ts, np.minimum, False)
        carry_h = np.concatenate([np.full((W, 1), -1), hs[:, :-1]], 1)
        carry_t = np.concatenate([ts[:, 1:], np.full((W, 1), T)], 1)
        for w in range(W):
            carry_h[w] = np.maximum(carry_h[w], max([-1] + [hs[u, 31] for u in range(w)]))
            carry_t[w] = np.minimum(carry_t[w], min([T] + [ts[u, 0] for u in range(w + 1, W)]))
        first0, last0 = t0, t0 + T - 1
        if not head[0, 0, 0]:
            loads = []
            first0 = _run_first(s, t0 - 1, v[0], loads)
            if stats is not None:
                stats.setdefault("searches", []).append((t0 // T, "first", loads))
        if not tail[-1, -1, -1]:
            loads = []
            last0 = _run_last(s, n, t0 + T, v[-1], loads)
            if stats is not None:
                stats.setdefault("searches", []).append((t0 // T, "last", loads))
        # the slot's run: the last head at or before it in its thread, else
        # the carry; the first tail at or after it, else the carry
        sl = np.maximum(np.maximum.accumulate(np.where(head, local, -1), -1), carry_h[..., None])
        el = np.minimum(np.minimum.accumulate(np.where(tail, local, T)[..., ::-1], -1)[..., ::-1],
                        carry_t[..., None])
        cnt = (np.where(el < T, t0 + el, last0) - np.where(sl >= 0, t0 + sl, first0) + 1).ravel()
        ok = (v != SENTINEL) & (idx < n)
        sat |= bool((ok & (cnt >= 0xFFFF)).any())
        here = idx < n
        counts[idx[here]] = np.where(v[here] == SENTINEL, 0, np.minimum(cnt[here], 0xFFFF))
    order = np.asarray(order, np.int64)
    window = window or freq_window(n)
    for w0 in range(0, n, window):
        inside = (order >= w0) & (order < w0 + window)
        freq[order[inside]] = counts[inside]
        if stats is not None:
            stats.setdefault("stores", []).append(int(inside.sum()))
    return freq, np.array([int(sat)], np.int32)


def vector_runs(buf, off, n, warps=3):
    """A numpy model of gb_kmer_runs' read (csrc/kmer.cu): (run starts,
    valid keys) of the n int32 keys at byte offset `off` (a multiple of 4)
    of the 16-byte aligned int32 array `buf`.  The keys before the first
    16-byte boundary (0-3) and after the last whole vector are counted one
    at a time; the vectors between in chunks of RUNS_CHUNK, `warps` warps
    striding over them, each lane RUNS_UNROLL vectors 32 apart, its left
    neighbour the lane before's last key and lane 0's the previous step's
    lane 31's, or at a chunk's start the key before the chunk; vectors past
    the end read as sentinels."""
    keys = np.asarray(buf, np.int64)[off // 4:off // 4 + n]
    head = min(((16 - off % 16) % 16) // 4, n)
    nv = (n - head) // 4
    starts = valid = 0

    def count(v, prev):
        ok = v != SENTINEL
        return int((ok & (v != prev)).sum()), int(ok.sum())

    chunks = [c for w in range(warps) for c in range(w, -(-nv // RUNS_CHUNK), warps)]
    for c in chunks:
        v0 = c * RUNS_CHUNK
        vid = v0 + np.arange(RUNS_UNROLL)[:, None] * 32 + np.arange(32)    # (unroll, lane)
        x = np.full((RUNS_UNROLL, 32, 4), SENTINEL, np.int64)
        inside = vid < nv
        x[inside] = keys[head + 4 * vid[inside, None] + np.arange(4)]
        p = head + 4 * v0 - 1
        before = keys[p] if p >= 0 else ~x[0, 0, 0]
        for u in range(RUNS_UNROLL):
            prev = np.concatenate([[before], x[u, :-1, 3]])
            before = x[u, 31, 3]
            st, va = count(x[u].ravel(), np.stack([prev, x[u, :, 0], x[u, :, 1], x[u, :, 2]],
                                                   1).ravel())
            starts, valid = starts + st, valid + va
    i = 0
    while i < n:
        if i == head:
            i = head + 4 * nv
            if i >= n:
                break
        st, va = count(keys[i:i + 1], keys[i - 1:i] if i > 0 else ~keys[i:i + 1])
        starts, valid, i = starts + st, valid + va, i + 1
    return starts, valid


def runs_view_cases(seed=0):
    """(16-byte aligned int32 buffer, [(byte offset, n)]): sorted keys with
    runs and trailing sentinels, viewed at byte offsets 0, 4, 8 and 12 with n
    of 1-70, and n around a chunk's RUNS_CHUNK vectors."""
    buf = keys_of_runs(short_runs(2_600, seed, longest=5), sentinels=300, seed=seed)
    views = [(off, n) for off in (0, 4, 8, 12) for n in range(1, 71)]
    views += [(off, n) for off in (0, 4, 8, 12)
              for n in (4 * RUNS_CHUNK - 1, 4 * RUNS_CHUNK + 5, 2_880)]
    return buf, views


# ------------------------------------------------------------------ sites
def site_cases(seed=0):
    """{label: (raw (B, L) int64, mask (B, L) bool, lengths (B,) int32,
    offsets (B,) int64, k)} for the site build (gb_kmer_sites): rows of
    width 1, 15, 17 and 4,097, one row of 20,000, no sites, every position
    a site, and offsets past 2^33; each some 10,000 positions or more, the
    masks about a third sites."""
    rng = np.random.default_rng(seed)
    cases = {}
    for label, (B, L, k, density, base) in {
            "width1": (9_000, 1, 15, 1 / 3, 0), "width15": (700, 15, 5, 1 / 3, 0),
            "width17": (600, 17, 16, 1 / 3, 0), "width4097": (3, 4_097, 15, 1 / 3, 0),
            "one_row": (1, 20_000, 15, 1 / 3, 0), "no_sites": (40, 300, 15, 0.0, 0),
            "all_sites": (12, 1_000, 16, 1.0, 0),
            "offsets_past_2_33": (50, 230, 15, 1 / 3, 1 << 33)}.items():
        top = 1 << 32 if k == 16 else 1 << (2 * k)
        raw = rng.integers(0, top, (B, L), dtype=np.int64)
        mask = rng.random((B, L)) < density
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        offsets = base + np.concatenate([[0], np.cumsum(lengths[:-1], dtype=np.int64)])
        cases[label] = (raw, mask, lengths, offsets.astype(np.int64), k)
    return cases
