"""Inputs of the grm port's tests and of chip_smoke.py's grm phases.

Plain numpy: either package takes these (M variants, N samples) uint8
genotype matrices (0/1/2 ALT dosage, 3 missing).

* `bench_grm`: tools/scale_bench.py's grm generator (:676-684), copied:
  100,000 variants by 2,504 samples (the chr22 phase3 sample count,
  run-cpu.sh:84), seed 13, allele frequencies from beta(0.3, 2.0), so most
  variants are rare, and 0.1% of the calls missing.
* `rand_geno`: tests/test_grm.py's generator (uniform frequencies 0.005 to
  0.5, 5% missing).
* `edge_cases`: {name: (geno, maf)} at M = 200 (not a multiple of the
  tests' block of 128) and N <= 128 (one padded sample width): one sample,
  13 samples (not a multiple of 4), a monomorphic variant, an all-hom-alt
  one (p = 1), an all-missing variant and an all-missing sample, maf 0 and
  0.5, and the MAF boundary.
* `maf_boundary`: a variant with one het among 50 observed samples, so its
  float64 p is 1 / 100, exactly the double 0.01: kept at maf 0.01 by the
  float64 filter, dropped by an f32 p held against the double.
"""

from __future__ import annotations

import numpy as np

BENCH = dict(n_variants=100_000, n_samples=2_504, seed=13)
EDGE_M = 200
EDGE_BLOCK = 128


def bench_grm(n_variants=BENCH["n_variants"], n_samples=BENCH["n_samples"],
              seed=BENCH["seed"]):
    """tools/scale_bench.py bench_grm's genotypes (:676-684)."""
    rng = np.random.default_rng(seed)
    af = rng.beta(0.3, 2.0, n_variants)
    geno = (rng.random((n_variants, n_samples)) < af[:, None]).astype(np.uint8)
    geno += (rng.random((n_variants, n_samples)) < af[:, None]).astype(np.uint8)
    geno[rng.random(geno.shape) < 0.001] = 3
    return geno


def rand_geno(rng, M, N, miss_rate=0.05):
    """tests/test_grm.py `_rand_geno`."""
    p = rng.uniform(0.005, 0.5, M)
    g = (rng.random((M, N)) < p[:, None]).astype(np.uint8) + (
        rng.random((M, N)) < p[:, None]).astype(np.uint8)
    g[rng.random((M, N)) < miss_rate] = 3
    return g


def maf_boundary(N=64, M=EDGE_M, seed=5):
    """Random variants, then row 0: 14 samples missing, one het and 49
    hom-ref among the 50 observed: p = 1 / 100 in float64."""
    g = rand_geno(np.random.default_rng(seed), M, N)
    g[0] = 0
    g[0, N - 14:] = 3
    g[0, 7] = 1
    return g


def special_rows(N=64, M=EDGE_M, seed=3):
    """Random variants with a monomorphic row (all 0), an all-hom-alt row
    (all 2, p = 1), an all-missing row, rows with one observed sample, and
    an all-missing sample (column 5)."""
    g = rand_geno(np.random.default_rng(seed), M, N)
    g[0] = 0
    g[1] = 2
    g[2] = 3
    g[3] = 3
    g[3, 9] = 1
    g[4] = 3
    g[4, 10] = 2
    g[:, 5] = 3
    return g


def edge_cases():
    rng = np.random.default_rng(11)
    return {
        "n1": (rand_geno(rng, EDGE_M, 1), 0.01),
        "n13": (rand_geno(rng, EDGE_M, 13), 0.01),
        "n128": (rand_geno(rng, EDGE_M, 128), 0.05),
        "special_rows": (special_rows(), 0.01),
        "maf0": (special_rows(seed=4), 0.0),
        "maf05": (rand_geno(rng, EDGE_M, 40, miss_rate=0.3), 0.5),
        "maf_boundary": (maf_boundary(), 0.01),
    }
