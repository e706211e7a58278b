"""phmm inputs shared by the PyTorch port's tests and chip_smoke.py.

Imports numpy only (neither JAX nor either package), so it serves on a
machine that has a card and no JAX.  A case is (reads, haps, pairs): reads
as dicts of bases/q/i/d/c arrays, haps as uint8 arrays, pairs as (read
index, hap index) tuples or None for the read-major cross product, the
form that both packages' `pairhmm_batch` take.
"""

import math

import numpy as np


def gen_phmm_workload(n_pairs=100_000, seed=17):
    """The phmm scale workload (tools/scale_bench.py `_gen_phmm_workload`,
    copied, with the rng of `bench_phmm`, seed 17): GATK-shaped active
    regions, read-major cross products of 10-40 reads against 2-8
    haplotypes of 200-400 bases that share a base sequence with up to 5
    SNPs; reads of 10-151 bases sampled from a haplotype with 2% errors,
    except about 5% random reads, which underflow float32 and take the
    float64 recompute.  The first k pairs of a larger count are the pairs
    of count k.  Returns (reads, haps, pairs, cells)."""
    rng = np.random.default_rng(seed)
    reads, haps, pairs = [], [], []
    while len(pairs) < n_pairs:
        n_haps = int(rng.integers(2, 9))
        n_reads = int(rng.integers(10, 41))
        H = int(rng.integers(200, 401))
        base_hap = rng.integers(0, 4, H).astype(np.uint8)
        h0 = len(haps)
        for _ in range(n_haps):
            hap = base_hap.copy()
            nsnp = int(rng.integers(0, 6))
            if nsnp:
                at = rng.integers(0, H, nsnp)
                hap[at] = rng.integers(0, 4, nsnp)
            haps.append(hap)
        for _ in range(n_reads):
            R = int(rng.integers(10, 152))
            mk = lambda lo, hi: rng.integers(lo, hi, R).astype(np.int32)
            if rng.random() < 0.05:
                bases = rng.integers(0, 4, R).astype(np.uint8)
            else:
                src = haps[h0 + int(rng.integers(0, n_haps))]
                off = int(rng.integers(0, len(src) - R + 1))
                bases = src[off : off + R].copy()
                nmut = rng.binomial(R, 0.02)
                if nmut:
                    at = rng.integers(0, R, nmut)
                    bases[at] = rng.integers(0, 4, nmut)
            r_id = len(reads)
            reads.append(dict(bases=bases, q=mk(6, 61), i=mk(30, 51),
                              d=mk(30, 51), c=mk(8, 13)))
            for h in range(n_haps):
                pairs.append((r_id, h0 + h))
    pairs = pairs[:n_pairs]
    cells = sum(len(reads[r]["bases"]) * len(haps[h]) for r, h in pairs)
    return reads, haps, pairs, cells


def _read(rng, R, q=(6, 61), i=(30, 51), d=(30, 51), c=(8, 13), bases=None):
    mk = lambda lohi: rng.integers(lohi[0], lohi[1], R).astype(np.int32)
    if bases is None:
        bases = rng.integers(0, 4, R).astype(np.uint8)
    return dict(bases=np.asarray(bases, np.uint8), q=mk(q), i=mk(i), d=mk(d), c=mk(c))


def _like(rng, src, err=0.03):
    out = np.array(src, np.uint8)
    at = rng.integers(0, len(out), max(1, int(err * len(out))))
    out[at] = rng.integers(0, 4, len(at))
    return out


def _underflow_read(n):
    """All-mismatch against a haplotype of 1s at high qualities: the float32
    pass underflows (tests/test_pairhmm.py test_fallback_pairs_exact)."""
    return dict(bases=np.zeros(n, np.uint8), q=np.full(n, 40, np.int32),
                i=np.full(n, 45, np.int32), d=np.full(n, 45, np.int32),
                c=np.full(n, 10, np.int32))


def edge_cases():
    """{label: (reads, haps, pairs)}: lengths of 1; base N (code 4) in reads
    and haplotypes; all-mismatch pairs that underflow float32; qualities at
    0, 6 and 127 and one at 200, which both packages clamp to 127; a read
    longer than its haplotype; reads across the kernel's 32-row strip edges
    (R = 31, 32, 33, 64, 65); one batch that mixes float32 and float64
    pairs."""
    rng = np.random.default_rng(23)
    out = {}

    reads = [_read(rng, 1), _read(rng, 5), _read(rng, 1, bases=[4])]
    haps = [np.array([2], np.uint8), rng.integers(0, 4, 7).astype(np.uint8),
            np.array([4], np.uint8)]
    out["length1"] = (reads, haps, None)

    base = rng.integers(0, 4, 90).astype(np.uint8)
    reads = []
    for R in (20, 45, 70):
        r = _read(rng, R, bases=_like(rng, base[5:5 + R]))
        r["bases"][::6] = 4
        reads.append(r)
    haps = [_like(rng, base), _like(rng, base)]
    haps[0][::7] = 4
    out["ambiguous_n"] = (reads, haps, None)

    out["underflow"] = ([_underflow_read(240), _underflow_read(120)],
                        [np.full(240, 1, np.uint8), np.full(150, 1, np.uint8)], None)

    base = rng.integers(0, 4, 60).astype(np.uint8)
    reads = []
    for qv in (0, 6, 127, 200):
        r = _read(rng, 40, bases=_like(rng, base[10:50]))
        r["q"][::3] = qv
        r["i"][1::5] = qv
        r["d"][2::5] = qv
        r["c"][3::7] = qv
        reads.append(r)
    out["qualities"] = (reads, [_like(rng, base), base.copy()], None)

    hap = rng.integers(0, 4, 40).astype(np.uint8)
    out["read_longer"] = ([_read(rng, 120, bases=np.concatenate([hap, hap, hap])),
                           _read(rng, 41)], [hap], None)

    base = rng.integers(0, 4, 150).astype(np.uint8)
    reads = [_read(rng, R, bases=_like(rng, base[7:7 + R])) for R in (31, 32, 33, 64, 65)]
    out["strip_edges"] = (reads, [_like(rng, base), base[:100].copy()], None)

    base = rng.integers(0, 4, 200).astype(np.uint8)
    reads = [_read(rng, 80, bases=_like(rng, base[50:130])), _underflow_read(150),
             _read(rng, 100, bases=_like(rng, base[:100])), _underflow_read(200)]
    haps = [np.full(200, 1, np.uint8), _like(rng, base), base.copy()]
    pairs = [(0, 1), (1, 0), (2, 2), (3, 0), (0, 2), (1, 1), (2, 0), (3, 2)]
    out["mixed"] = (reads, haps, pairs)
    return out


def long_haplotype_case(h_len=10_000, seed=29):
    """Three reads against one haplotype of h_len bases; the 300-base read
    runs on a whole warp in strips, whose top row (M, X, Y of every column)
    fills most of a block's shared memory in float32 and passes it in
    float64, where it lives in device scratch."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 4, h_len).astype(np.uint8)
    reads = [_read(rng, 60, bases=_like(rng, hap[1000:1060])), _read(rng, 33),
             _read(rng, 300, bases=_like(rng, hap[5000:5300]))]
    return reads, [hap], None


# ------------------------------------------------- the kernel's schedule
AMBIG = 4
LANE_ROW_R = (1, 3, 4, 5, 16, 17, 31, 32, 33, 64, 127, 128, 129, 151, 300)
LANE_ROW_H = (1, 2, 31, 400, 1000)


def _ph2pr(dtype):
    """The instances' tables: float32 of numpy's powers, float64 of C pow's
    (math.pow), as genomicsbench_tpu_torch/oracle/pairhmm.py makes them."""
    if np.dtype(dtype) == np.float32:
        return (10.0 ** (-np.arange(128, dtype=np.float64) / 10.0)).astype(np.float32)
    return np.array([math.pow(10.0, -q / 10.0) for q in range(128)], np.float64)


def lane_row_case(seed=41):
    """(reads, haps, pairs): a read of every R in LANE_ROW_R against a
    haplotype of every H in LANE_ROW_H, reads sampled from the haplotype
    with errors where it is long enough, bases N (code 4) in some reads and
    haplotypes, qualities 0 and 127 among the usual ranges."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, max(LANE_ROW_H) + max(LANE_ROW_R)).astype(np.uint8)
    haps = []
    for n, H in enumerate(LANE_ROW_H):
        hap = _like(rng, base[:H])
        if n % 2:
            hap[::13] = AMBIG
        haps.append(hap)
    reads = []
    for n, R in enumerate(LANE_ROW_R):
        rd = _read(rng, R, bases=_like(rng, base[7:7 + R]))
        if n % 3 == 0:
            rd["bases"][::9] = AMBIG
        rd["q"][::5] = 0
        rd["q"][1::7] = 127
        rd["i"][2::11] = 0
        rd["c"][3::17] = 127
        reads.append(rd)
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    return reads, haps, pairs


def lane_row_forward(reads, haps, pairs, g, rr, dtype):
    """A numpy model of gb_pairhmm_f32 / gb_pairhmm_f64's schedule for pairs
    of one class: each pair on g lanes of rr read rows, in S strips of
    g * rr rows placed bottom-aligned (the rows above row 1 repeat row 0:
    mm = gapm = mx = my = 0, xx = yy = 1, both priors 0, Y starting at
    2^E / H); at step t lane l at column t - l computes its rows top to
    bottom, its top row from lane l-1's bottom row shifted in (the first
    lane: row 0 in strip 0, the top row the last lane wrote in the strip
    before), a row of base N taking p_match for both priors; the last
    lane's last row adds M + X in column order.  Every operation is one
    numpy operation in `dtype`, so each rounds alone, as __fmul_rn and
    __fadd_rn do.  Returns the (P,) scaled values."""
    dt = np.dtype(dtype)
    T = dt.type
    zero, one, three = T(0), T(1), T(3)
    tab = _ph2pr(dt)
    E = 120 if dt == np.float32 else 1020
    P, rows = len(pairs), g * rr
    Rp = np.array([len(reads[r]["bases"]) for r, _ in pairs], np.int64)
    Hp = np.array([len(haps[h]) for _, h in pairs], np.int64)
    S = np.where((Rp > 0) & (Hp > 0), -(-Rp // rows), 0)
    if g < 32 and (S > 1).any():
        raise ValueError(f"a class of {g} lanes takes pairs of at most {rows} rows")
    dead = S * rows - Rp
    init_y = np.where(Hp > 0, T(2.0 ** E) / np.maximum(Hp, 1).astype(dt), zero).astype(dt)
    fin = np.zeros(P, dt)
    if S.max(initial=0) == 0:
        return fin
    Hw = int(Hp[S > 0].max())
    lg = np.arange(g)
    lane_row = lg[:, None] * rr + np.arange(rr)[None, :]            # (g, rr)
    top = np.zeros((P, 3, Hw + 1), dt)
    hap_pad = np.full((P, Hw + 1), -1, np.int64)
    for p, (_, h) in enumerate(pairs):
        hap_pad[p, :len(haps[h])] = haps[h]

    def plane(name, i):
        out = np.zeros(i.shape, np.int64)
        for p, (r, _) in enumerate(pairs):
            live = (i[p] >= 1) & (i[p] <= Rp[p])
            out[p][live] = np.asarray(reads[r][name], np.int64)[i[p][live] - 1]
        return out

    for s in range(int(S.max())):
        i = s * rows + lane_row[None] - dead[:, None, None] + 1        # (P, g, rr)
        live = (s < S)[:, None, None] & (i >= 1)
        look = lambda name: tab[np.minimum(np.clip(plane(name, i), 0, None), 127)]
        pi, pd, pc, pq = look("i"), look("d"), look("c"), look("q")
        gap_open = pi + pd
        rb = np.where(live, plane("bases", i), -1)
        t_mm = np.where(live, one - np.where(gap_open < one, gap_open, one), zero).astype(dt)
        t_gapm = np.where(live, one - pc, zero).astype(dt)
        t_pi = np.where(live, pi, zero).astype(dt)
        t_pd = np.where(live, pd, zero).astype(dt)
        t_pc = np.where(live, pc, one).astype(dt)
        p_match = np.where(live, one - pq, zero).astype(dt)
        p_mis = np.where(live, np.where(rb == AMBIG, p_match, pq / three), zero).astype(dt)
        pM = np.zeros((P, g, rr), dt)
        pX = np.zeros((P, g, rr), dt)
        pY = np.where(live, zero, init_y[:, None, None]).astype(dt)
        qM, qX, qY = np.zeros((P, g), dt), np.zeros((P, g), dt), np.zeros((P, g), dt)
        if s == 0:
            qY[:, 0] = init_y
        result = (lg == g - 1)[None, :] & (s == S - 1)[:, None]
        writes_top = (lg == g - 1)[None, :] & (s + 1 < S)[:, None]
        for t in range(1, Hw + g):
            rM, rX, rY = pM[:, :, -1].copy(), pX[:, :, -1].copy(), pY[:, :, -1].copy()
            rM[:, 1:], rX[:, 1:], rY[:, 1:] = rM[:, :-1].copy(), rX[:, :-1].copy(), rY[:, :-1].copy()
            j = t - lg                                                   # (g,)
            in_row = (s < S)[:, None] & (j >= 1)[None, :] & (j[None, :] <= Hp[:, None])
            if s == 0:
                rM[:, 0], rX[:, 0], rY[:, 0] = zero, zero, init_y
            elif t <= Hw:
                rM[:, 0], rX[:, 0], rY[:, 0] = top[:, 0, t], top[:, 1, t], top[:, 2, t]
            hb = hap_pad[:, np.clip(j - 1, 0, Hw)]                       # (P, g)
            uM, uX, dM, dX, dY = rM, rX, qM, qX, qY
            for kk in range(rr):
                match = (hb == AMBIG) | (hb == rb[:, :, kk])
                prior = np.where(match, p_match[:, :, kk], p_mis[:, :, kk])
                M = prior * (t_mm[:, :, kk] * dM + t_gapm[:, :, kk] * (dX + dY))
                X = t_pi[:, :, kk] * uM + t_pc[:, :, kk] * uX
                Y = t_pd[:, :, kk] * pM[:, :, kk] + t_pc[:, :, kk] * pY[:, :, kk]
                dM, dX, dY = pM[:, :, kk].copy(), pX[:, :, kk].copy(), pY[:, :, kk].copy()
                uM, uX = M, X
                pM[:, :, kk] = np.where(in_row, M, pM[:, :, kk])
                pX[:, :, kk] = np.where(in_row, X, pX[:, :, kk])
                pY[:, :, kk] = np.where(in_row, Y, pY[:, :, kk])
            add = result & in_row
            fin = np.where(add.any(1), fin + (pM[:, -1, -1] + pX[:, -1, -1]), fin).astype(dt)
            w = (writes_top & in_row)[:, -1]
            if w.any():
                jt = t - (g - 1)
                top[w, 0, jt], top[w, 1, jt], top[w, 2, jt] = (pM[w, -1, -1], pX[w, -1, -1],
                                                              pY[w, -1, -1])
            qM, qX, qY = rM, rX, rY
    return fin
