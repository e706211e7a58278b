"""chain inputs shared by the PyTorch port's tests and chip_smoke.py.

Imports numpy only (neither JAX nor either package), so it serves on a
machine that has a card and no JAX.  A call is a plain dict with the fields
of `AnchorCall` (x and y as uint64 arrays), the form that
`genomicsbench_tpu_torch.io.anchors.anchor_calls_from_dicts` takes and that
the JAX package's `AnchorCall(**d)` takes.
"""

import pathlib

import numpy as np

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
U64 = np.uint64


def call(x, y, avg_qspan, max_dist_x=5000, max_dist_y=5000, bw=500, n_segs=1):
    return dict(x=np.asarray(x, np.uint64), y=np.asarray(y, np.uint64),
                avg_qspan=avg_qspan, max_dist_x=max_dist_x, max_dist_y=max_dist_y,
                bw=bw, n_segs=n_segs)


def load_golden(name="default"):
    """tests/golden/chain_<name>.{in,gold} -> (calls, [(n, 3) int64 rows of
    score, parent, peak per call])."""
    toks = (GOLDEN / f"chain_{name}.in").read_text().split()
    calls, pos = [], 0
    while pos + 6 <= len(toks):
        n, avg = int(toks[pos]), float(toks[pos + 1])
        mdx, mdy, bw, n_segs = (int(t) for t in toks[pos + 2:pos + 6])
        xy = np.array(toks[pos + 6:pos + 6 + 2 * n], dtype=np.uint64).reshape(n, 2)
        pos += 6 + 2 * n
        if pos < len(toks) and toks[pos] == "EOR":
            pos += 1
        calls.append(call(xy[:, 0].copy(), xy[:, 1].copy(), avg, mdx, mdy, bw, n_segs))
    gold_toks = (GOLDEN / f"chain_{name}.gold").read_text().split()
    expected, pos = [], 0
    for c in calls:
        n = len(c["x"])
        expected.append(np.array(gold_toks[pos:pos + 3 * n], dtype=np.int64).reshape(n, 3))
        pos += 3 * n
        if gold_toks[pos] != "EOR":
            raise ValueError(f"chain_{name}.gold: no EOR after a call of {n} anchors")
        pos += 1
    return calls, expected


def bench_chain_calls(n_reads=10_000, seed=11):
    """The large chain dataset's synthetic model (tools/scale_bench.py
    `bench_chain`, copied): c_elegans_40x.10k.in scale, 10,000 reads of
    200-1,999 anchors advancing 10-39 bp on the reference with +-8 bp of
    query noise, span 10-19, avg_qspan to 4 decimals in [10, 20),
    max_dist_x = max_dist_y = 5,000, bw = 500, n_segs = 1.  The first k
    reads of a larger count are the reads of count k."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(n_reads):
        nn = int(rng.integers(200, 2000))
        dx = rng.integers(10, 40, nn)
        xs = (100_000 + np.cumsum(dx)).astype(np.uint64)
        dq = np.maximum(1, dx + rng.integers(-8, 9, nn))
        qs = np.cumsum(dq).astype(np.uint64)
        span = U64(int(rng.integers(10, 20))) << U64(32)
        avg = round(float(rng.uniform(10, 20)), 4)
        calls.append(call(xs, qs | span, avg))
    return calls


def _read(rng, n, *, dx=(1, 40), noise=10, rids=1, sids=False, spans=(10, 20),
          avg=15.0, **fields):
    """One x-sorted read of n anchors: reference steps dx, query steps dx
    plus noise, rid drawn from [0, rids), sid 0/1 when sids, span per anchor."""
    step = rng.integers(dx[0], dx[1], n)
    rid = np.sort(rng.integers(0, rids, n)).astype(np.uint64)
    x = np.sort((rid << U64(32)) | (1000 + np.cumsum(step)).astype(np.uint64))
    dq = np.maximum(1, step + rng.integers(-noise, noise + 1, n))
    sid = (rng.integers(0, 2, n) if sids else np.zeros(n, np.int64)).astype(np.uint64)
    y = (np.cumsum(dq).astype(np.uint64)
         | (rng.integers(spans[0], spans[1], n).astype(np.uint64) << U64(32))
         | (sid << U64(48)))
    return call(x, y, avg, **fields)


def _f32(v):
    """A 4-decimal avg_qspan rounded through float32, so the scalar oracle
    (a Python double) computes what the reference and both packages do."""
    return float(np.float32(v))


def edge_cases():
    """label -> (calls, chain_batch keyword arguments).  Each case is small
    enough for the CPU tests.  avg_qspan is float32-exact except in
    'avg_4dec', which tests the rounding of a 4-decimal value."""
    cases = {}
    rng = np.random.default_rng(21)
    cases["multi_rid"] = ([_read(rng, int(rng.integers(3, 300)), rids=3,
                                 avg=_f32(rng.uniform(8, 30)))
                           for _ in range(12)], {})
    for cdna in (False, True):
        rng = np.random.default_rng(22 + cdna)
        cases[f"n_segs2_cdna{int(cdna)}"] = (
            [_read(rng, int(rng.integers(3, 300)), sids=True, n_segs=2,
                   spans=(10, 250), dx=(1, 200), noise=60,
                   avg=_f32(rng.uniform(10, 40))) for _ in range(10)],
            dict(is_cdna=cdna))
    rng = np.random.default_rng(24)
    cases["avg_integer"] = ([_read(rng, int(rng.integers(50, 300)), avg=v)
                             for v in (15.0, 15.0, 19.0, 13.0, 17.0, 20.0)], {})
    rng = np.random.default_rng(25)
    cases["avg_4dec"] = ([_read(rng, int(rng.integers(50, 300)),
                                avg=round(float(rng.uniform(10, 20)), 4))
                          for _ in range(10)], {})
    rng = np.random.default_rng(26)
    # dense anchors with every query step 1: chains of equal scores that
    # skip, so the break comes early
    cases["max_skip2"] = ([_read(rng, int(rng.integers(100, 300)), dx=(1, 4),
                                 noise=3, avg=_f32(rng.uniform(10, 20)))
                           for _ in range(8)], dict(max_skip=2))
    rng = np.random.default_rng(27)
    cases["max_iter50"] = ([_read(rng, int(rng.integers(100, 300)), dx=(1, 6),
                                  avg=15.0) for _ in range(8)], dict(max_iter=50))
    rng = np.random.default_rng(28)
    tiny = [call(np.zeros(0, np.uint64), np.zeros(0, np.uint64), 15.0),
            call([1000], [(U64(12) << U64(32)) | U64(500)], 15.0)]
    cases["n0_n1"] = (tiny + [_read(rng, 40, avg=13.0)] + tiny, {})
    rng = np.random.default_rng(29)
    unsorted = []
    for _ in range(6):
        c = _read(rng, int(rng.integers(60, 250)), avg=_f32(rng.uniform(10, 20)))
        k = int(rng.integers(0, len(c["x"]) - 40))
        seg = np.arange(k, k + 40)
        perm = rng.permutation(seg)          # the anchors of one stretch reordered
        c["x"][seg], c["y"][seg] = c["x"][perm], c["y"][perm]
        unsorted.append(c)
    cases["unsorted"] = (unsorted, {})
    rng = np.random.default_rng(30)
    cases["window128"] = ([_read(rng, int(rng.integers(200, 400)), dx=(1, 10),
                                 avg=_f32(rng.uniform(10, 20)))
                           for _ in range(6)], dict(window=128))
    return cases
