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
  chip_smoke.py holds the card to;
* `sliding_window`, `window_fill_codes`: numpy models of how
  `gb_abea_fill` carries each band's emission inputs in its lanes;
* `wave_reads`: many short reads, made fast, for a batch of more warps
  than the card holds at once.
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
    # one event per k-mer (every other read one short): walks of nearly all
    # diagonal moves (two bands a step), at lengths that put the reads'
    # bands at many offsets from the backtrack's 64-band tile edges, so
    # diagonals cross the edges from a tile's first and its second band
    seqs, evs, sc = batch([(n, 1.0) for n in (70, 83, 97, 111, 126, 140, 151, 167)])
    evs = [(mean[_ranks(s_)] * np.float32(sc_[0]) + np.float32(sc_[1])).astype(np.float32)
           [:len(s_) - KMER + 1 - (i_ % 2)] for i_, (s_, sc_) in enumerate(zip(seqs, sc))]
    out["diagonal_walks"] = (seqs, evs, sc)
    # walks shorter than one tile (reads of 4-30 k-mers)
    out["short_walks"] = batch([(n, 1.0) for n in (9, 12, 17, 23, 35)])
    # a read with no walk: its event means are NaN (as a zero-length event
    # gives), so every cell of its matrix is NaN and its best stays -inf;
    # beside it a read that walks
    seqs, evs, sc = batch([(80, 1.0), (120, 1.2)])
    out["no_walk"] = (seqs, [np.full(len(evs[0]), np.nan, np.float32), evs[1]], sc)
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


W = 100           # band cells
LIVE_LANES = 25   # lanes of 4 cells


def sliding_window(bll_e, band_off, n_kmers):
    """A numpy model of how `gb_abea_fill` (csrc/abea.cu) carries a band's
    emission inputs: every read's 32 lanes x 4 cells of event indices and
    k-mer indices, from band 1's corner (event 50, k-mer -51), shifted by
    each move the bands' corners `bll_e` take (right: cell o takes cell
    o + 1's k-mer, across the lane edge as __shfl_down_sync does, and k-mer
    `kin` enters at cell 99; down: cell o takes cell o - 1's event, as
    __shfl_up_sync does, and event `ein` enters at cell 0), with the
    kernel's look-ahead (the entering k-mer's terms, and the rank of the one
    after, loaded a move ahead).  Returns (NB, 100) event and k-mer indices
    of cells 0..99 at each band, in the flat band layout."""
    band_off = np.asarray(band_off, np.int64)
    bll_e = np.asarray(bll_e, np.int64)
    R = len(band_off) - 1
    nb = np.diff(band_off)
    o = 4 * np.arange(32)[:, None] + np.arange(4)[None, :]           # (32, 4) cells
    be = np.full(R, W // 2, np.int64)
    bk = np.full(R, -1 - W // 2, np.int64)
    ev = be[:, None, None] - o[None]                                  # (R, 32, 4)
    km = bk[:, None, None] + o[None]
    kin, ein = bk + W, be + 1                 # what enters on a right / a down move
    k_next, r_after = kin.copy(), kin + 1     # the look-ahead: terms of kin, rank of kin + 1
    out_ev = np.zeros((int(band_off[-1]), W), np.int64)
    out_km = np.zeros_like(out_ev)
    rows = np.arange(R)
    for s in range(int(nb.max()) if R else 0):
        live = s < nb
        r = rows[live]
        nbe = bll_e[band_off[r] + s]
        right = nbe == be[r]
        if not ((nbe == be[r]) | (nbe == be[r] + 1)).all():
            raise AssertionError(f"band {s}: a corner moved by more than one cell")
        rr, dd = r[right], r[~right]
        # right: in-lane moves, lane l's cell 3 takes lane l + 1's cell 0 (the
        # last lane keeps its own), lane 24's cell 3 takes the look-ahead
        k = km[rr]
        down0 = np.concatenate([k[:, 1:, 0], k[:, -1:, 0]], 1)
        km[rr] = np.concatenate([k[:, :, 1:], down0[:, :, None]], 2)
        km[rr, LIVE_LANES - 1, 3] = k_next[rr]
        k_next[rr] = r_after[rr]
        kin[rr] += 1
        r_after[rr] = kin[rr] + 1
        # down: in-lane moves, lane l's cell 0 takes lane l - 1's cell 3 (the
        # first lane keeps its own), lane 0's cell 0 takes event ein
        e = ev[dd]
        up3 = np.concatenate([e[:, :1, 3], e[:, :-1, 3]], 1)
        ev[dd] = np.concatenate([up3[:, :, None], e[:, :, :3]], 2)
        ev[dd, 0, 0] = ein[dd]
        ein[dd] += 1
        be[dd] += 1
        bk[rr] += 1
        out_ev[band_off[r] + s] = ev[r].reshape(len(r), -1)[:, :W]
        out_km[band_off[r] + s] = km[r].reshape(len(r), -1)[:, :W]
    return out_ev, out_km


def window_fill_codes(ranks, evs, p, model, ev_idx, km_idx):
    """One read's fill in numpy float32 (abea.py:298-406) as the kernel
    computes its emissions: each k-mer's terms once (m = scale * mean +
    shift, stdv, c = -0.918938 - log stdv), gathered at the event and k-mer
    indices the window carries (`sliding_window`'s rows of this read), each
    emission c + (-0.5 a) a with a = (x - m) / stdv.  Returns the 2-bit codes
    (nk + ne, 100) and the best score."""
    f32, neg = np.float32, np.float32(-np.inf)
    mean, stdv, log_stdv = model
    scale, shift, lp_skip, lp_stay, lp_step, lp_trim = p
    r = np.asarray(ranks) & 4095
    km_m = scale * mean[r] + shift
    km_sd = stdv[r]
    km_c = f32(-0.918938) - log_stdv[r]
    nk, ne = len(ranks), len(evs)
    offs = np.arange(W)
    prev2 = np.where(offs == W // 2, f32(0), neg).astype(f32)
    prev = np.where(offs == W // 2, lp_trim, neg).astype(f32)
    be, bk, bk_p = W // 2, -1 - W // 2, -1 - W // 2
    codes = np.zeros((nk + ne, W), np.uint8)
    best = [neg]

    def check(band, e, k):      # the best (event, last k-mer) cell
        off = (nk - 1) - k
        if 0 <= off < W and 0 <= e - off < ne:
            sc = band[off] + f32(ne - (e - off)) * lp_trim
            best[0] = sc if sc > best[0] else best[0]

    check(prev2, be - 1, bk)
    check(prev, be, bk)
    with np.errstate(invalid="ignore", over="ignore"):
        for s in range(nk + ne):
            ll, ur = prev[0], prev[W - 1]
            right = s % 2 == 1 if ll == neg and ur == neg else bool(ll < ur)
            nbe, nbk = (be, bk + 1) if right else (be + 1, bk)
            up = np.append(prev[1:], neg) if right else prev
            left = prev if right else np.insert(prev[:-1], 0, neg)
            diag = [np.insert(prev2[:-1], 0, neg), prev2,
                    np.append(prev2[1:], neg)][int(right) + bk - bk_p]
            evi, kmi = nbe - offs, nbk + offs
            ev_in = (evi >= 0) & (evi < ne)
            valid = ev_in & (kmi >= 0) & (kmi < nk)
            if not (np.array_equal(ev_idx[s][valid], evi[valid])
                    and np.array_equal(km_idx[s][valid], kmi[valid])):
                raise AssertionError(f"band {s}: the window carries other indices")
            k = np.clip(km_idx[s], 0, nk - 1)
            x = evs[np.clip(ev_idx[s], 0, max(ne - 1, 0))] if ne else np.zeros(W, f32)
            a = (x - km_m[k]) / km_sd[k]
            lp_e = km_c[k] + (f32(-0.5) * a) * a
            s_d = (diag + lp_step) + lp_e
            s_u = (up + lp_stay) + lp_e
            s_l = left + lp_skip
            mx = np.maximum(s_d, s_u)
            mx2 = np.maximum(mx, s_l)
            frm = np.where(mx2 == s_l, 2, np.where(mx == s_u, 1, 0))
            trim = ev_in & (kmi == -1)
            band = np.where(valid, mx2, neg).astype(f32)
            band = np.where(trim, lp_trim * (evi + 1).astype(f32), band).astype(f32)
            codes[s] = np.where(trim, 1, np.where(valid, frm, 0))
            check(band, nbe, nbk)
            prev2, prev = prev, band
            bk_p, be, bk = bk, nbe, nbk
    return codes, best[0]


def wave_reads(n_reads, seed, lo=60, hi=400):
    """`n_reads` reads of lo..hi-1 bases with about 1.5 events per k-mer
    (`_events_for`), made a read at a time with numpy: (sequences, event
    means, scalings)."""
    mean, stdv = _model()
    rng = np.random.default_rng(seed)
    seqs, evs, sc = [], [], np.zeros((n_reads, 2), np.float32)
    for b in range(n_reads):
        seq = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        sc[b] = rng.uniform(0.9, 1.1), rng.uniform(-5, 5)
        ev = _events_for(rng, seq, mean, stdv, float(sc[b, 0]), float(sc[b, 1]), 1.5)
        seqs.append(seq)
        evs.append(ev if len(ev) else mean[_ranks(seq)[:1]].astype(np.float32))
    return seqs, evs, sc


# gb_abea_backtrack's schedule (csrc/abea.cu): tiles of BT_TILE bands
# staged two deep, a path buffer of BT_PATH steps between term batches
BT_TILE, BT_PATH, TAIL_STEPS = 64, 128, 3
FROM_U, FROM_L = 1, 2


def _emission_f32(x, rank, scale, shift, model):
    """One step's emission term in float32, each operation rounding once in
    the kernel's order: (x - (scale * mean + shift)) / stdv, then
    (-0.918938 - log stdv) + (-0.5 a) a."""
    f32 = np.float32
    r = int(rank) & 4095
    m = f32(f32(scale) * model[0][r]) + f32(shift)
    a = (f32(x) - m) / model[1][r]
    return (f32(-0.918938) - model[2][r]) + (f32(-0.5) * a) * a


def tile_walk_backtrack(ranks, events, k_off, e_off, band_off, params, model, order, traces,
                        bll_e, best, best_ev):
    """A numpy model of `gb_abea_backtrack`'s schedule: the reads in
    `order`, each walk over tiles of BT_TILE bands (the 25-byte trace rows
    and bll_e of bands 64q .. 64q + 63, zero past the arrays' ends) staged
    from the flat arrays, the tile below staged as the walk enters a tile;
    the walk's (k-mer, event) steps into a path buffer of BT_PATH, each full
    buffer (and the last) turned into emission terms and pairs, written
    back to front into the read's slot, and the terms added into the
    float32 Kahan sum in walk order, then the TAIL_STEPS zero terms.  The
    kernel runs four such walks a warp in lockstep, a round until all four
    have stopped, and flushes a half-full buffer beside a full one; that
    changes no read's tiles, steps, terms or sum, so the model walks the
    reads one at a time.

    Returns the kernel's int32 buffer (headers, then pairs; -1 where no
    pair is written) and per read: `tiles` (tiles the walk stepped into),
    `steps`, and `diag_edge` (diagonal moves that crossed a tile edge from
    the tile's first band and from its second, shape (B, 2))."""
    f32 = np.float32
    k_off, e_off, band_off = (np.asarray(a, np.int64) for a in (k_off, e_off, band_off))
    traces = np.asarray(traces, np.uint8).reshape(-1)
    bll_e = np.asarray(bll_e, np.int32)
    params, model = np.asarray(params, f32), np.asarray(model, f32)
    ranks, events = np.asarray(ranks), np.asarray(events, f32)
    B, NB = len(k_off) - 1, int(band_off[-1])
    out = np.full(4 * B + 2 * NB, -1, np.int32)
    pairs = out[4 * B:].reshape(NB, 2) if NB else np.zeros((0, 2), np.int32)
    stats = dict(tiles=np.zeros(B, np.int64), steps=np.zeros(B, np.int64),
                 diag_edge=np.zeros((B, 2), np.int64))
    W, LIVE = 100, 25

    def stage(q):
        tr = np.zeros(BT_TILE * LIVE, np.uint8)
        seg = traces[q * BT_TILE * LIVE:(q + 1) * BT_TILE * LIVE]
        tr[:len(seg)] = seg
        be = np.zeros(BT_TILE, np.int32)
        seg = bll_e[q * BT_TILE:(q + 1) * BT_TILE]
        be[:len(seg)] = seg
        return tr, be

    with np.errstate(all="ignore"):
        for b in np.asarray(order, np.int64).tolist():
            nk = int(k_off[b + 1] - k_off[b])
            end = int(band_off[b + 1])
            scale, shift = params[b, 0], params[b, 1]
            n, gap, max_gap = 0, 0, 0
            total, comp = f32(0), f32(0)
            if np.isfinite(best[b]):
                k, e = nk - 1, int(best_ev[b])
                band0 = int(band_off[b]) + e + k
                q, rel = divmod(band0, BT_TILE)
                bufs = [stage(q), stage(q - 1) if q > 0 else None]
                cur, walked = 0, 1
                while True:
                    steps, need = [], 0
                    tr, be = bufs[cur]
                    while k >= 0 and e >= 0:
                        if rel < 0:
                            need = 1
                            break
                        if len(steps) == BT_PATH:
                            need = 2
                            break
                        steps.append((k, e))
                        off = min(max(int(be[rel]) - e, 0), W - 1)
                        frm = (int(tr[rel * LIVE + (off >> 2)]) >> (2 * (off & 3))) & 3
                        dk, de = int(frm != FROM_U), int(frm != FROM_L)
                        if dk and de and rel < 2:
                            stats["diag_edge"][b, rel] += 1
                        k, e, rel = k - dk, e - de, rel - dk - de
                        gap = gap + 1 if frm == FROM_L else 0
                        max_gap = max(max_gap, gap)
                    for s, (ks, es) in enumerate(steps):
                        pairs[end - 1 - (n + s)] = (ks, es)
                    terms = [_emission_f32(events[e_off[b] + es], ranks[k_off[b] + ks], scale, shift,
                                           model) for ks, es in steps]
                    for term in terms:                  # Kahan, in walk order
                        y = f32(term) - comp
                        tt = total + y
                        comp = (tt - total) - y
                        total = tt
                    n += len(steps)
                    if need == 0:
                        break
                    if need == 1:
                        q, rel, cur, walked = q - 1, rel + BT_TILE, cur ^ 1, walked + 1
                        bufs[cur ^ 1] = stage(q - 1) if q > 0 else None
                for _ in range(TAIL_STEPS):
                    y = f32(0) - comp
                    tt = total + y
                    comp = (tt - total) - y
                    total = tt
                stats["tiles"][b] = walked
            stats["steps"][b] = n
            out[4 * b:4 * b + 4] = (n, np.array(total, f32).view(np.int32), max_gap,
                                    np.array(best[b], f32).view(np.int32))
    return out, stats
