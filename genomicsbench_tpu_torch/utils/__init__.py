"""Small host-math helpers (the port's copy of
genomicsbench_tpu/utils/__init__.py:8-30)."""

import numpy as np


def offsets_from_lengths(lens, with_total: bool = False) -> np.ndarray:
    """int64 exclusive offsets of flattened variable-length rows.

    Routed through a float64 cumsum: integer np.cumsum is much slower on
    some hosts for multi-million-row arrays, and float64 partial sums are
    exact below 2^53 total elements.  With with_total=True the result has
    len(lens)+1 entries, the last being the flattened total.
    """
    lens = np.asarray(lens)
    n = len(lens)
    if with_total:
        out = np.zeros(n + 1, np.int64)
        if n:
            np.cumsum(lens, dtype=np.float64, out=out[1:])
        return out
    out = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(lens[:-1], dtype=np.float64, out=out[1:])
    return out
