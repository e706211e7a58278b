"""Oracle for the GATK/GKL pair-HMM forward likelihood.

A copy of the JAX package's oracle (genomicsbench_tpu/oracle/pairhmm.py),
so that the port imports nothing of that package.  The reference's test
program (benchmarks/phmm/PairHMMUnitTest.cpp:86,245) calls GKL's
`computelikelihoodsboth`, which runs the GATK "logless caching" forward
algorithm in float32 and recomputes in float64 any pair whose scaled float32
result underflows below MIN_ACCEPTED = 1e-28 (pairhmm_common.h:16):

* ph2pr[q] = 10^(-q/10)
* transitions per read base (qual strings i=ins-open, d=del-open, c=cont):
    mm  = 1 - min(1, ph2pr[i] + ph2pr[d])   (match->match)
    gapm= 1 - ph2pr[c]                       (gap->match)
    mx  = ph2pr[i], xx = ph2pr[c]            (match->ins, ins->ins)
    my  = ph2pr[d], yy = ph2pr[c]            (match->del, del->del)
* prior(i,j) = 1 - ph2pr[q_i] on a base match (or either base ambiguous),
  else ph2pr[q_i] / 3 (the tristate correction)
* scaled initial deletion row: Y[0][j] = 2^E / haplen (E = 120 for float32,
  1020 for float64); result = log10(sum_j M[R][j] + X[R][j]) - E*log10(2).

Bases are integer-coded via {A:0, C:1, T:2, G:3, N:4} with 4 = ambiguous
(pairhmm_common.h:26-44).

Departures from the copied module.  Both forward functions run the deletion
row Y as the sequential loop along the haplotype in both dtypes (the JAX
oracle takes scipy's lfilter for float64) and sum the last row in column
order (the JAX oracle sums M and X apart with numpy), so their operation
order is that of the reference's loop, cell for cell.  The batched pass
`pairhmm_forward_scaled_many` has no native branch: in the port the float64
fallback is `ops/pairhmm.py` (the kernel on the card, its plain version on
the CPU).  `pairhmm_forward_scaled` takes an optional `ph2pr` table, so
that the float64 witness can run on PH2PR_F64_CPOW, the table of the
reference's float64 code.
"""

from __future__ import annotations

import math

import numpy as np

AMBIG = 4
TRISTATE_CORRECTION = 3.0

_BASE_CODE = np.full(256, AMBIG, dtype=np.uint8)
for _b, _c in zip(b"ACTG", range(4)):
    _BASE_CODE[_b] = _c
    _BASE_CODE[ord(chr(_b).lower())] = _c


def encode_bases(s: bytes | str) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return _BASE_CODE[np.frombuffer(s, dtype=np.uint8)].copy()


def _ph2pr(dtype):
    q = np.arange(128, dtype=np.float64)
    return (10.0 ** (-q / 10.0)).astype(dtype)


_PH2PR_F32 = _ph2pr(np.float32)
_PH2PR_F64 = _ph2pr(np.float64)

# The float64 table of the reference's float64 code, C's pow(10.0, -q/10.0)
# (gbingest.cpp gb_pairhmm_f64, the fallback the JAX package's pairhmm_batch
# runs).  It is not _PH2PR_F64: numpy's power rounds its own way, and the
# two tables differ by one ulp at q = 22, 50, 61, 78 and 118.  math.pow is
# C's pow, so this table is the reference's bit for bit.  Cast to float32,
# the two tables are equal, so _PH2PR_F32 serves the float32 pass.
PH2PR_F64_CPOW = np.array([math.pow(10.0, -q / 10.0) for q in range(128)], np.float64)


def pairhmm_forward_scaled(
    read: np.ndarray,
    hap: np.ndarray,
    q: np.ndarray,
    ins: np.ndarray,
    dele: np.ndarray,
    cont: np.ndarray,
    dtype=np.float64,
    initial_exponent: int | None = None,
    ph2pr: np.ndarray | None = None,
) -> float:
    """One forward pass; returns the scaled probability (not log).  `ph2pr`
    defaults to numpy's table in `dtype`."""
    dtype = np.dtype(dtype)
    if ph2pr is None:
        ph2pr = _PH2PR_F32 if dtype == np.float32 else _PH2PR_F64
    ph2pr = np.asarray(ph2pr, dtype)
    if initial_exponent is None:
        initial_exponent = 120 if dtype == np.float32 else 1020
    R, H = len(read), len(hap)
    one = dtype.type(1.0)

    mm = one - np.minimum(one, ph2pr[ins] + ph2pr[dele])
    gapm = one - ph2pr[cont]
    mx = ph2pr[ins]
    xx = ph2pr[cont]
    my = ph2pr[dele]
    yy = ph2pr[cont]

    qprob = ph2pr[q]
    is_match = (read[:, None] == hap[None, :]) | (read[:, None] == AMBIG) | (
        hap[None, :] == AMBIG
    )
    prior = np.where(
        is_match, one - qprob[:, None], (qprob / dtype.type(TRISTATE_CORRECTION))[:, None]
    ).astype(dtype)

    init_y = dtype.type(np.ldexp(1.0, initial_exponent)) / dtype.type(H)

    M_prev = np.zeros(H + 1, dtype=dtype)
    X_prev = np.zeros(H + 1, dtype=dtype)
    Y_prev = np.full(H + 1, init_y, dtype=dtype)  # uniform, column 0 too

    for i in range(1, R + 1):
        M_cur = np.zeros(H + 1, dtype=dtype)
        X_cur = np.zeros(H + 1, dtype=dtype)
        Y_cur = np.zeros(H + 1, dtype=dtype)
        t_mm, t_gapm = mm[i - 1], gapm[i - 1]
        t_mx, t_xx = mx[i - 1], xx[i - 1]
        t_my, t_yy = my[i - 1], yy[i - 1]
        M_cur[1:] = prior[i - 1] * (
            t_mm * M_prev[:-1] + t_gapm * (X_prev[:-1] + Y_prev[:-1])
        )
        X_cur[1:] = t_mx * M_prev[1:] + t_xx * X_prev[1:]
        for j in range(1, H + 1):
            Y_cur[j] = t_my * M_cur[j - 1] + t_yy * Y_cur[j - 1]
        M_prev, X_prev, Y_prev = M_cur, X_cur, Y_cur

    final = dtype.type(0.0)
    for j in range(1, H + 1):              # the reference's column order
        final = final + (M_prev[j] + X_prev[j])
    return float(final)


def pairhmm_forward_oracle(
    read, hap, q, ins, dele, cont, min_accepted: float = 1e-28
) -> float:
    """log10 likelihood with the float32-then-float64 fallback policy of
    computelikelihoodsboth."""
    f32 = pairhmm_forward_scaled(read, hap, q, ins, dele, cont, dtype=np.float32)
    if f32 >= min_accepted:
        return float(np.log10(f32) - 120 * np.log10(2.0))
    f64 = pairhmm_forward_scaled(read, hap, q, ins, dele, cont, dtype=np.float64)
    return float(np.log10(f64) - 1020 * np.log10(2.0))


def pairhmm_forward_scaled_many(testcases, dtype=np.float64):
    """Batched forward pass over many (read, hap, q, i, d, c) testcases —
    the same recurrences as pairhmm_forward_scaled, vectorized across
    pairs (rows loop in Python, per-row ops over the (P, H) batch; the
    sequential Y recurrence loops j with (P,) vector steps).  Matches the
    per-pair results bit-for-bit (same op order per pair)."""
    dtype = np.dtype(dtype)
    ph2pr = _PH2PR_F32 if dtype == np.float32 else _PH2PR_F64
    E = 120 if dtype == np.float32 else 1020
    P = len(testcases)
    rl = np.array([len(t[0]) for t in testcases])
    hl = np.array([len(t[1]) for t in testcases])
    R, H = int(rl.max()), int(hl.max())
    one = dtype.type(1.0)

    read = np.full((P, R), AMBIG, np.uint8)
    q = np.zeros((P, R), np.int64)
    ins = np.zeros((P, R), np.int64)
    dele = np.zeros((P, R), np.int64)
    cont = np.zeros((P, R), np.int64)
    hap = np.full((P, H), AMBIG, np.uint8)
    for p, (rd, hp, qq, ii, dd, cc) in enumerate(testcases):
        read[p, : rl[p]] = rd
        q[p, : rl[p]] = qq
        ins[p, : rl[p]] = ii
        dele[p, : rl[p]] = dd
        cont[p, : rl[p]] = cc
        hap[p, : hl[p]] = hp

    mm = one - np.minimum(one, ph2pr[ins] + ph2pr[dele])
    gapm = one - ph2pr[cont]
    mx, xx = ph2pr[ins], ph2pr[cont]
    my, yy = ph2pr[dele], ph2pr[cont]
    qprob = ph2pr[q]

    cols = np.arange(H)
    col_ok = cols[None, :] < hl[:, None]           # (P, H)
    init_y = (np.ldexp(one, E) / hl.astype(dtype))[:, None]

    M_prev = np.zeros((P, H + 1), dtype)
    X_prev = np.zeros((P, H + 1), dtype)
    Y_prev = np.broadcast_to(init_y, (P, H + 1)).astype(dtype)

    M_out = np.zeros((P, H + 1), dtype)
    X_out = np.zeros((P, H + 1), dtype)
    for i in range(1, R + 1):
        live = (i <= rl)[:, None]
        is_match = (read[:, i - 1 : i] == hap) | (read[:, i - 1 : i] == AMBIG) | (hap == AMBIG)
        prior = np.where(is_match, one - qprob[:, i - 1 : i],
                         qprob[:, i - 1 : i] / dtype.type(TRISTATE_CORRECTION)).astype(dtype)
        prior = np.where(col_ok, prior, dtype.type(0.0))
        t_mm, t_gapm = mm[:, i - 1 : i], gapm[:, i - 1 : i]
        t_mx, t_xx = mx[:, i - 1 : i], xx[:, i - 1 : i]
        t_my, t_yy = my[:, i - 1], yy[:, i - 1]
        M_cur = np.zeros((P, H + 1), dtype)
        X_cur = np.zeros((P, H + 1), dtype)
        Y_cur = np.zeros((P, H + 1), dtype)
        M_cur[:, 1:] = prior * (
            t_mm * M_prev[:, :-1] + t_gapm * (X_prev[:, :-1] + Y_prev[:, :-1])
        )
        X_cur[:, 1:] = t_mx * M_prev[:, 1:] + t_xx * X_prev[:, 1:]
        for j in range(1, H + 1):
            Y_cur[:, j] = t_my * M_cur[:, j - 1] + t_yy * Y_cur[:, j - 1]
        M_prev = np.where(live, M_cur, M_prev)
        X_prev = np.where(live, X_cur, X_prev)
        Y_prev = np.where(live, Y_cur, Y_prev)
        at_end = (i == rl)[:, None]
        M_out = np.where(at_end, M_cur, M_out)
        X_out = np.where(at_end, X_cur, X_out)
    final = np.zeros(P, dtype)
    for j in range(1, H + 1):              # the reference's column order
        final = final + (M_out[:, j] + X_out[:, j])
    return final
