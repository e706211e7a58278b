"""phmm inputs shared by the PyTorch port's tests and chip_smoke.py.

Imports numpy only (neither JAX nor either package), so it serves on a
machine that has a card and no JAX.  A case is (reads, haps, pairs): reads
as dicts of bases/q/i/d/c arrays, haps as uint8 arrays, pairs as (read
index, hap index) tuples or None for the read-major cross product, the
form that both packages' `pairhmm_batch` take.
"""

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
    """Two reads against one haplotype of h_len bases: in float64 the
    kernel's per-warp rows pass a block's shared memory and live in device
    scratch."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 4, h_len).astype(np.uint8)
    reads = [_read(rng, 60, bases=_like(rng, hap[1000:1060])), _read(rng, 33)]
    return reads, [hap], None
