"""bsw inputs shared by the PyTorch port's tests and chip_smoke.py.

Imports numpy only (neither JAX nor either package), so it serves on a
machine that has a card and no JAX.  Pairs are (query, target, h0) triples,
as `genomicsbench_tpu_torch.io.pairs.write_pairs` and `pack_pairs` take them.
"""

import pathlib

import numpy as np

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
# BswParams fields of each golden (the alternate set of test_bsw_kernel.py)
PARAMS = {
    "default": {},
    "altparams": dict(match=2, mismatch=3, ambig=-2, o_del=4, e_del=2,
                      o_ins=4, e_ins=2, zdrop=50, w=40),
}


def load_golden(name):
    """tests/golden/bsw_<name>.{in,gold} -> (pairs, (n, 6) int64 gold rows)."""
    toks = (GOLDEN / f"bsw_{name}.in").read_text().split()
    n, pos = int(toks[0]), 1
    pairs = []
    for _ in range(n):
        h0, l1, l2 = int(toks[pos]), int(toks[pos + 1]), int(toks[pos + 2])
        t = np.frombuffer(toks[pos + 3].encode(), dtype=np.uint8) - ord("0")
        q = np.frombuffer(toks[pos + 4].encode(), dtype=np.uint8) - ord("0")
        if (len(t), len(q)) != (l1, l2):
            raise ValueError(f"bsw_{name}.in: case lengths disagree")
        pairs.append((q, t, h0))
        pos += 5
    gold = np.loadtxt(GOLDEN / f"bsw_{name}.gold", dtype=np.int64).reshape(n, 6)
    return pairs, gold


def random_pairs(seed, n, max_q, max_t):
    """Mixed-length pairs: most targets are a mutated copy of the query with
    a random tail (long extensions), the rest unrelated (early z-drop or
    zero-row exits); some queries hold base 4; h0 is 0 for some; a few
    queries or targets are empty."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(n):
        ql = int(rng.integers(1, max_q + 1))
        tl = int(rng.integers(1, max_t + 1))
        q = rng.integers(0, 5 if k % 5 == 0 else 4, ql).astype(np.uint8)
        t = rng.integers(0, 4, tl).astype(np.uint8)
        if k % 4:
            m = min(ql, tl)
            t[:m] = q[:m]
            mut = rng.integers(0, m, max(1, m // 12))
            t[mut] = rng.integers(0, 4, mut.size)
        h0 = 0 if k % 7 == 0 else int(rng.integers(1, 60))
        if k % 23 == 3:
            q = q[:0]        # empty query, target > 0
        if k % 29 == 5:
            t = t[:0]        # empty target
        pairs.append((q, t, h0))
    return pairs


# BswParams fields of each stress case of stress_pairs
STRESS = {
    "long_queries": {},         # queries of 300 .. max_q bases, many chunks
    "w3": dict(w=3),            # the band crosses a chunk edge every few rows
    "w10": dict(w=10),
    "zdrop0": dict(zdrop=0),    # no z-drop test
    "big_h0": {},               # h0 up to 5000: wide first rows, long gscore
    "n_in_targets": {},         # base 4 in targets as well as queries
    "chunk_edges": {},          # qlen at 31, 32, 33, 63, 64, 65
    "query_8000": {},           # three warps per block, 211 KB of shared memory
    "query_30000": {},          # too long for shared memory: device scratch
}


def _mutant(rng, q, tl, indel):
    """A target of tl bases copied from q with substitutions (1 in 12) and
    single-base insertions and deletions (rate indel each), so the best
    path drifts off the diagonal, then a random tail."""
    out, j = [], 0
    while len(out) < tl and j < len(q):
        r = rng.random()
        if r < indel:
            j += 1
        elif r < 2 * indel:
            out.append(int(rng.integers(0, 4)))
        else:
            out.append(int(q[j]) if rng.random() >= 1 / 12 else int(rng.integers(0, 4)))
            j += 1
    t = rng.integers(0, 4, tl).astype(np.uint8)
    t[:len(out)] = out
    return t


def stress_pairs(label, seed, n, max_q=1100):
    """n pairs of the stress case `label` (a key of STRESS; score them with
    its BswParams fields).  A quarter of the targets are unrelated to their
    query; the rest are mutants of it (_mutant).  The two long-query cases
    hold one such pair and min(n, 8) - 1 short ones."""
    rng = np.random.default_rng(seed)
    pairs = []
    if label.startswith("query_"):
        n = min(n, 8)
    for k in range(n):
        ql = int(rng.integers(1, 256))
        h0 = int(rng.integers(0, 60))
        if label == "long_queries":
            ql = int(rng.integers(300, max_q + 1))
        elif label == "chunk_edges":
            ql = (31, 32, 33, 63, 64, 65)[k % 6]
        elif label == "big_h0":
            h0 = int(rng.integers(0, 5001)) if k % 3 else h0
        elif label in ("query_8000", "query_30000") and k == 0:
            ql = int(label.split("_")[1])
        tl = int(rng.integers(1, 2 * ql + 2))
        if label.startswith("query_") and k == 0:
            tl = 64
        q = rng.integers(0, 4, ql).astype(np.uint8)
        t = (rng.integers(0, 4, tl).astype(np.uint8) if k % 4 == 3
             else _mutant(rng, q, tl, indel=0.02))
        if label == "n_in_targets" or k % 5 == 0:
            q[rng.random(ql) < 0.05] = 4
        if label == "n_in_targets":
            t[rng.random(tl) < 0.05] = 4
        pairs.append((q, t, h0))
    return pairs


def rows(res):
    """A BswBatchResult of either package -> (n, 6) rows."""
    return np.stack([res.score, res.qle, res.tle, res.gtle, res.gscore,
                     res.max_off], 1)
