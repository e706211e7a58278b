"""Inputs of the long-read banded NW port's tests and of chip_smoke.py's
longread phases.

Plain numpy: either package takes these int code arrays (query, target)
and a band width W.

* `pair`: tests/test_longread.py's `_pair`, copied: a random target and a
  query read from it with substitutions and, with `indels`, deletions and
  insertions, each at a third of `div`.
* `edge_cases`: {name: (query, target, W)}: tests/test_longread.py's three
  cases (300 bases at W 128, seed 0, four trials; 500 identical bases at W
  128; 200 bases at W 64, seed 2, div 0.05), the end cell on the band's
  first lane and on its last, an odd band, a band above 1,024 lanes (so a
  thread of the kernel holds several lanes), a query longer than the
  target, a 2,000-base read at W 256, an empty target, a single lane, and
  a band of 10,000 lanes (wider than any one thread block could hold).
* `with_end_lane`: a read whose end cell is a given lane of the band.
* `band_binds`: reads whose best unbanded path leaves the band (an
  insertion of 20 bases later deleted, and the reverse, at W 16 and 33; of
  200 bases at W 256), and ones whose gaps are cheaper than a mismatch,
  where a path around the band's edge would win.
* `MAIN`: the main path's read, 100,000 target bases at div 0.08, seed 23,
  W 2,048: 204.8 M band cells, the ultra-long reads that f5c routes off the
  GPU (SURVEY.md §5.7).
"""

from __future__ import annotations

import numpy as np

MAIN = dict(n=100_000, div=0.08, seed=23, band=2_048)


def pair(rng, n, div=0.1, indels=True):
    """tests/test_longread.py `_pair`: (query, target)."""
    t = rng.integers(0, 4, n)
    q = []
    for c in t:
        r = rng.random()
        if indels and r < div / 3:
            continue
        if r < 2 * div / 3:
            q.append(int(rng.integers(0, 4)))
        elif indels and r < div:
            q.append(int(c))
            q.append(int(rng.integers(0, 4)))
        else:
            q.append(int(c))
    return np.array(q), t


def main_read():
    """The main path's (query, target, W)."""
    q, t = pair(np.random.default_rng(MAIN["seed"]), MAIN["n"], div=MAIN["div"])
    return q, t, MAIN["band"]


def with_end_lane(rng, n, W, kend):
    """A target of n bases and a query from it whose end cell is lane kend."""
    t = rng.integers(0, 4, n)
    m = n + kend - W // 2
    q = t[:m].copy() if m <= n else np.concatenate([t, rng.integers(0, 4, m - n)])
    flip = rng.random(len(q)) < 0.05
    q[flip] = rng.integers(0, 4, int(flip.sum()))
    return q, t


def edge_cases():
    out = {}
    rng = np.random.default_rng(0)
    for trial in range(4):
        q, t = pair(rng, 300, div=0.08)
        out[f"random300_{trial}"] = (q, t, 128)
    s = np.random.default_rng(1).integers(0, 4, 500)
    out["identical500"] = (s, s.copy(), 128)
    q, t = pair(np.random.default_rng(2), 200, div=0.05)
    out["single200"] = (q, t, 64)
    rng = np.random.default_rng(3)
    out["kend_first"] = (*with_end_lane(rng, 100, 64, 0), 64)
    out["kend_last"] = (*with_end_lane(rng, 100, 64, 63), 64)
    q, t = pair(np.random.default_rng(4), 150, div=0.06)
    out["odd_band"] = (q, t, 63)
    q, t = pair(np.random.default_rng(5), 150, div=0.2)
    out["band1040"] = (q, t, 1040)
    t = np.random.default_rng(6).integers(0, 4, 200)
    q = np.concatenate([t[:100], np.random.default_rng(7).integers(0, 4, 30), t[100:]])
    out["query_longer"] = (q, t, 128)
    q, t = pair(np.random.default_rng(8), 2_000, div=0.08)
    out["mid2000"] = (q, t, 256)
    out["empty_target"] = (np.arange(5) % 4, np.zeros(0, np.int64), 16)
    s = np.random.default_rng(9).integers(0, 4, 40)
    out["one_lane"] = (s, s.copy(), 1)
    q, t = pair(np.random.default_rng(12), 300, div=0.1)
    out["band10000"] = (q, t, 10_000)
    return out


def band_binds():
    """{name: (query, target, W, (match, mismatch, gap))}: the band binds
    the best path, at narrow bands and with cheap gaps."""
    rng = np.random.default_rng(11)
    t = rng.integers(0, 4, 300)
    ins = np.concatenate([t[:100], rng.integers(0, 4, 20), t[100:200], t[220:]])
    dele = np.concatenate([t[:100], t[120:220], rng.integers(0, 4, 20), t[220:]])
    out = {}
    for W in (16, 33):
        for name, q in (("insert", ins), ("delete", dele)):
            out[f"{name}_W{W}"] = (q, t, W, (1, -1, 2))
            out[f"{name}_W{W}_cheap_gap"] = (q, t, W, (1, -6, 1))
    for W in (1, 2):
        q, t1 = pair(np.random.default_rng(30 + W), 300, div=0.2, indels=False)
        out[f"W{W}_cheap_gap"] = (q, t1, W, (1, -6, 1))
    # a band wide enough for the kernel's untested middle steps, cut by
    # 200-base indels
    t2 = rng.integers(0, 4, 1_200)
    ins2 = np.concatenate([t2[:300], rng.integers(0, 4, 200), t2[300:700], t2[900:]])
    dele2 = np.concatenate([t2[:300], t2[500:900], rng.integers(0, 4, 200), t2[900:]])
    # a path along the band's top (bottom) edge, then a 20-base indel that
    # an unbanded path would take outside the band and back
    up = np.concatenate([t2[:600], rng.integers(0, 4, 120), t2[600:900], rng.integers(0, 4, 20),
                         t2[900:1000], t2[1020:]])
    down = np.concatenate([t2[:600], t2[720:900], t2[920:1000], rng.integers(0, 4, 20),
                           t2[1000:]])
    for name, q in (("insert", ins2), ("delete", dele2), ("top_edge", up),
                    ("bottom_edge", down)):
        out[f"{name}_W256"] = (q, t2, 256, (1, -1, 2))
        out[f"{name}_W256_cheap_gap"] = (q, t2, 256, (1, -6, 1))
    return out


def outside_band():
    """A query 40 bases longer than its target at W 64: the end cell is
    lane 72, outside the band."""
    t = np.random.default_rng(10).integers(0, 4, 100)
    return np.concatenate([t, t[:40]]), t, 64
