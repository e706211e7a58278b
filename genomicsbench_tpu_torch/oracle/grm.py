"""NumPy float64 oracle of plink2 --make-grm-bin's GCTA relationship matrix.

The port's copy of `grm_oracle` (genomicsbench_tpu/ops/grm.py:136):

    x_ij = (g_ij - 2 p_j) / sqrt(2 p_j (1 - p_j)),  missing -> 0
    GRM_ik = (1 / M_ik) * sum_j x_ij x_kj
    M_ik   = #variants observed in both i and k

over the variants whose observed minor allele frequency min(p, 1 - p) is at
least `maf`, p taken in float64.
"""

from __future__ import annotations

import numpy as np


def grm_oracle(geno: np.ndarray, maf: float = 0.01):
    """geno (M, N) uint8 (0/1/2 dosage, 3 missing) -> (grm, nobs), (N, N)
    float64."""
    M, N = geno.shape
    miss = geno == 3
    g = np.where(miss, 0, geno).astype(np.float64)
    n_obs = (~miss).sum(1)
    p = g.sum(1) / np.maximum(2 * n_obs, 1)
    keep = (np.minimum(p, 1 - p) >= maf) & (n_obs > 0)
    x = (g - 2 * p[:, None]) / np.sqrt(np.maximum(2 * p * (1 - p), 1e-30))[:, None]
    x = np.where(miss, 0.0, x)
    x = x[keep]
    obs = (~miss)[keep].astype(np.float64)
    num = x.T @ x
    den = obs.T @ obs
    return num / np.maximum(den, 1.0), den
