"""NumPy scalar oracle of the long-read banded global alignment.

The port's copy of `banded_nw_oracle` (genomicsbench_tpu/ops/longread.py:45):
global Needleman-Wunsch with linear gaps inside a band of W lanes, lane k of
target row i holding query position j = i + k - W // 2.
"""

from __future__ import annotations

import numpy as np

NEG = -(1 << 30)


def banded_nw_oracle(query, target, band: int, match=1, mismatch=-1, gap=2):
    """Banded global NW, linear gaps, int32.  band = full width W; cell
    (i, j) is reachable iff k = j - i + W//2 lies in [0, W).  Returns the
    alignment score (query fully consumed at the last target row), or None
    if the end cell is outside the band."""
    q = np.asarray(query)
    t = np.asarray(target)
    n, m = len(t), len(q)
    W = band
    W2 = W // 2
    kend = m - n + W2
    if not (0 <= kend < W):
        return None
    H = np.full(W, NEG, np.int64)
    for k in range(W):
        j = k - W2
        if 0 <= j <= m:
            H[k] = -gap * j
    for i in range(1, n + 1):
        Hn = np.full(W, NEG, np.int64)
        for k in range(W):
            j = i + k - W2
            if j < 0 or j > m:
                continue
            best = NEG
            if j >= 1 and H[k] > NEG:
                s = match if q[j - 1] == t[i - 1] else mismatch
                best = max(best, H[k] + s)
            if k + 1 < W and H[k + 1] > NEG:
                best = max(best, H[k + 1] - gap)
            if k >= 1 and Hn[k - 1] > NEG:
                best = max(best, Hn[k - 1] - gap)
            Hn[k] = best
        H = Hn
    return int(H[kend])
