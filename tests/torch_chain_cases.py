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
    # dense anchors (reference steps 1-3, max_dist_x 5,000) with a max_skip
    # that never breaks, so an anchor's window is its whole prefix and the
    # walk visits it all: anchors past the first 192 visit at least twice
    # the kernel's ring of 96, the deepest from global memory
    rng = np.random.default_rng(31)
    cases["deep_window"] = ([_read(rng, int(rng.integers(300, 420)), dx=(1, 4), noise=2,
                                   avg=_f32(rng.uniform(10, 20))) for _ in range(5)],
                            dict(max_skip=5000))
    return cases


# gb_chain_dp's schedule (csrc/chain.cu): a read on G_LANES lanes of
# R_CANDS candidates each, its last RING anchors in shared memory, filled
# FILL at a time a block ahead
G_LANES, R_CANDS, RING, FILL = 8, 4, 96, 32
CHUNK = G_LANES * R_CANDS
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _wrap32(v):
    return ((np.asarray(v, np.int64) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _shift_up(v, s, fill):
    """__shfl_up_sync(v, s, width 8) over the lane axis (1): lane l gets
    lane l - s; lanes below s keep `fill` (the caller's own value or an
    identity)."""
    out = np.empty_like(v)
    out[:, s:] = v[:, :-s]
    out[:, :s] = fill if np.ndim(fill) == 0 else fill[:, :s]
    return out


def lane_group_chain(x, y, offs, avg_qspan, max_dist_x, max_dist_y, bw, n_segs,
                     max_iter=5000, max_skip=25, is_cdna=False, window=0, ring=RING):
    """A numpy model of `gb_chain_dp`'s schedule, every read on its own
    group of G_LANES lanes, all reads a step at a time:

    * the ring of the read's last `ring` anchors (x and y by the anchor they
      hold, score, parent, peak), filled FILL anchors at a time a block
      ahead (a block becomes readable at the next multiple of FILL), the
      results written back to the outputs a block at a time, and candidates
      older than the block before the current one read from the outputs
      (which start as garbage, so a read of one not yet written shows);
    * the two-pointer as 8-lane ballots over x[st .. st + 7], loaded an
      anchor ahead;
    * a chunk of 32 positions as lanes x R_CANDS, the in-chunk max_skip
      marks OR-reduced by xor shuffles and the marks past it in a bitmap of
      words written only when the group goes on (and cleared after the
      anchor), the exclusive max-scan, the (sum, prefix minimum) scan of
      the n_skip walk, the break and last-improvement ballots, all as
      Hillis-Steele steps over the lanes.

    x, y: (T,) uint64 (or their int64 bit patterns); offs (R+1,); per read
    avg_qspan (float32), max_dist_x, max_dist_y, bw, n_segs.  Returns
    (scores, parents, peak, visited) as `chain_dp` does, and a dict of per
    read arrays: candidates loaded, those read past the ring (`deep`), and
    the most candidates one anchor visited (`most`)."""
    x = np.ascontiguousarray(x).view(np.uint64)
    y = np.ascontiguousarray(y).view(np.uint64)
    offs = np.asarray(offs, np.int64)
    R, T = len(offs) - 1, int(offs[-1])
    n = np.diff(offs)
    base = offs[:-1]
    avg = np.asarray(avg_qspan, np.float32).astype(np.float64)
    mdx, mdy = np.asarray(max_dist_x, np.int64), np.asarray(max_dist_y, np.int64)
    bw_, nsegs = np.asarray(bw, np.int64), np.asarray(n_segs, np.int64)
    pos_a, rid_a = (x & U64(0xFFFFFFFF)).astype(np.int64), (x >> U64(32)).astype(np.int64)
    q_a = (y & U64(0xFFFFFFFF)).astype(np.int64)
    span_a = ((y >> U64(32)) & U64(0xFF)).astype(np.int64)
    sid_a = ((y >> U64(48)) & U64(0xFF)).astype(np.int64)
    garbage = -1_234_567
    sco_g = np.full(T + 1, garbage, np.int64)
    par_g = np.full(T + 1, garbage, np.int64)
    pk_g = np.full(T + 1, garbage, np.int64)
    visited = np.zeros(R, np.int64)
    stats = {k: np.zeros(R, np.int64) for k in ("loaded", "deep", "most")}
    if R == 0 or T == 0:
        return sco_g[:T], par_g[:T], pk_g[:T], visited, stats
    n_max = int(n.max())
    w_max = min(max(n_max - 1, 0), max_iter)
    w_max = min(w_max, window) if window > 0 else w_max
    words = -(-(w_max + 3) // 32)       # virtual positions reach the window + 2
    g = np.arange(R)
    lanes = np.arange(G_LANES)
    kk = np.arange(R_CANDS)
    ring_anchor = np.full((R, ring), T, np.int64)         # flat anchor index held
    rsc, rpar, rpk = (np.full((R, ring), garbage, np.int64) for _ in range(3))
    bits = np.zeros((R, words), np.int64)

    def block(a0):          # the flat anchors [a0, a0 + FILL) of each read, or T
        a = a0 + np.arange(FILL)[None, :]
        return np.where(a < n[:, None], base[:, None] + a, T), (a0 % ring) + np.arange(FILL)

    def flush(a0):
        a = a0 + np.arange(FILL)[None, :]
        s = (a0 % ring) + np.arange(FILL)
        ok = a < n[:, None]
        dst = (base[:, None] + a)[ok]
        for out, src in ((sco_g, rsc), (par_g, rpar), (pk_g, rpk)):
            out[dst] = src[:, s][ok]

    def x_at(flat):         # x of flat anchors, T past the end
        return np.where(flat < T, x[np.minimum(flat, T - 1)], U64(0))

    pending = block(0)
    st = np.zeros(R, np.int64)
    xpre = x_at(base[:, None] + np.minimum(lanes[None, :], np.maximum(n - 1, 0)[:, None]))
    slot = 0
    for i in range(n_max):
        if i % FILL == 0:
            if i > 0:
                flush(i - FILL)
            anchors, slots = pending
            written = anchors < T
            ring_anchor[:, slots] = np.where(written, anchors, ring_anchor[:, slots])
            pending = block(i + FILL)
        active = i < n
        ai = ring_anchor[:, slot]
        xi = x_at(ai)
        go = active.copy()
        while True:         # the two-pointer, 8 lanes a round, while a group goes on
            d = xi[:, None] - xpre                       # wraps where xi <= xpre
            c = (go[:, None] & (st[:, None] + lanes[None, :] < i)
                 & (xi[:, None] > xpre) & (d > mdx.astype(np.uint64)[:, None]))
            adv = np.where(c.all(1), G_LANES, np.argmin(c, 1))
            st += adv
            go = adv == G_LANES
            if go.any():
                nxt = base[:, None] + np.minimum(st[:, None] + lanes[None, :],
                                                 np.maximum(n - 1, 0)[:, None])
                xpre = np.where(go[:, None], x_at(nxt), xpre)
            else:
                break
        st = np.where(i - st > max_iter, i - max_iter, st)
        lo = np.where((window > 0) & (i - window > st), i - window, st)
        wn = np.where(active, i - lo, 0)
        nxt = base[:, None] + np.minimum(st[:, None] + lanes[None, :], np.maximum(n - 1, 0)[:, None])
        xpre = np.where(active[:, None], x_at(nxt), xpre)
        pos_i, rid_i = pos_a[np.minimum(ai, T - 1)], rid_a[np.minimum(ai, T - 1)]
        q_i, span_i = q_a[np.minimum(ai, T - 1)], span_a[np.minimum(ai, T - 1)]
        sid_i = sid_a[np.minimum(ai, T - 1)]
        ring_lo = (i & ~(FILL - 1)) - 2 * FILL
        # quads: chunk c's lane l holds the anchors of quad qd - 8c - l in
        # visit order, j = 4 quad + 3 - k, at virtual position 32c + 4l + k
        qd, off = (i - 1) >> 2, 3 - ((i - 1) & 3)

        max_f, max_j = span_i.copy(), np.full(R, -1, np.int64)
        nskip = np.zeros(R, np.int64)
        done = wn.copy()
        live = wn > 0
        wrote = np.zeros(R, bool)
        c0 = 0
        while True:
            here = live.copy()
            quad = qd - (c0 >> 2) - lanes                               # (8,)
            j = R_CANDS * quad[:, None] + 3 - kk[None, :]               # (8, 4)
            inwin = here[:, None, None] & (j[None] >= lo[:, None, None]) & (j[None] < i)
            in_ring = np.broadcast_to((R_CANDS * quad >= ring_lo)[:, None], j.shape)
            jr = np.where(in_ring, np.maximum(j, 0) % ring, 0)
            flat = np.where(in_ring[None], ring_anchor[g[:, None, None], jr[None]],
                            base[:, None, None] + np.maximum(j, 0)[None])
            flat = np.where(inwin, flat, T)
            gidx = np.minimum(base[:, None, None] + np.maximum(j, 0)[None], T)
            scj = np.where(in_ring[None], rsc[g[:, None, None], jr[None]], sco_g[gidx])
            pj = np.where(in_ring[None], rpar[g[:, None, None], jr[None]], par_g[gidx])
            stats["deep"] += (inwin & ~in_ring[None]).sum((1, 2))
            stats["loaded"] += inwin.sum((1, 2))
            fc = np.minimum(flat, T - 1)
            dr = _wrap32(pos_i[:, None, None] - pos_a[fc])
            dq = _wrap32(q_i[:, None, None] - q_a[fc])
            same_sid = sid_i[:, None, None] == sid_a[fc]
            dd = _wrap32(np.abs(_wrap32(dr - dq)))
            e3 = (slice(None), None, None)
            valid = (inwin & (rid_i[:, None, None] == rid_a[fc])
                     & ~((same_sid & (dr == 0)) | (dq <= 0))
                     & ~((same_sid & (dq > mdy[e3])) | (dq > mdx[e3]))
                     & ~(same_sid & (dd > bw_[e3])))
            if not is_cdna:
                valid &= ~((nsegs[e3] > 1) & same_sid & (dr > mdy[e3]))
            sc0 = np.minimum(np.minimum(dq, dr), span_i[e3])
            log_dd = np.where(dd > 0, np.frexp(np.maximum(dd, 1).astype(np.float64))[1] - 1, 0)
            c_lin = ((np.clip(dd, 0, (1 << 22) - 1).astype(np.float64) * 0.01)
                     * avg[e3]).astype(np.int64)
            bonus = ~same_sid & (dr == 0)
            gap_anchor = c_lin + (log_dd >> 1)
            gap_diff = np.where(bonus, 0, np.where((dr > dq) | ~same_sid,
                                                   np.minimum(c_lin, log_dd), gap_anchor))
            gap = np.where(is_cdna | ~same_sid, gap_diff, gap_anchor)
            sc = _wrap32(sc0 + bonus - gap + scj)
            val = valid
            m = R_CANDS * qd + 3 - pj                  # the mark's virtual position
            marked = val & (pj >= lo[:, None, None])
            near = marked & (m < c0 + CHUNK)
            far = np.where(marked & ~near, m, -1)
            mk = np.bitwise_or.reduce(
                np.where(near, np.left_shift(1, np.where(near, m - c0, 0)), 0), axis=2)
            for step in (1, 2, 4):      # the three xor shuffles
                mk = mk | mk[:, lanes ^ step]
            if c0 > 0:
                mk = mk | np.where(here, bits[:, min(c0 >> 5, words - 1)], 0)[:, None]
            mloc = np.where(val, sc, _I32_MIN).max(2)
            incl = mloc.copy()
            for step in (1, 2, 4):
                incl = np.where(lanes >= step, np.maximum(incl, _shift_up(incl, step, incl)), incl)
            run = np.where(lanes == 0, max_f[:, None],
                           np.maximum(max_f[:, None], _shift_up(incl, 1, incl)))
            imp = np.zeros_like(val)
            skip = np.zeros_like(val)
            ps = np.zeros(val.shape, np.int64)
            s_loc = np.zeros((R, G_LANES), np.int64)
            m_loc = np.full((R, G_LANES), _I32_MAX, np.int64)
            for k in range(R_CANDS):
                v = val[:, :, k]
                im = v & (sc[:, :, k] > run)
                run = np.where(v, np.maximum(run, sc[:, :, k]), run)
                hit = ((mk >> (lanes * R_CANDS + k)) & 1).astype(bool)
                sk = v & ~im & hit
                imp[:, :, k], skip[:, :, k] = im, sk
                s_loc = s_loc + sk - im
                ps[:, :, k] = s_loc
                m_loc = np.minimum(m_loc, s_loc)
            S, M = s_loc.copy(), m_loc.copy()
            for step in (1, 2, 4):      # (sum, prefix minimum) pairs
                sv, mv = _shift_up(S, step, S), _shift_up(M, step, M)
                up = lanes >= step
                M = np.where(up, np.minimum(mv, sv + M), M)
                S = np.where(up, sv + S, S)
            O = S - s_loc
            X = np.where(lanes == 0, _I32_MAX, _shift_up(M, 1, M))
            brk = np.full((R, G_LANES), R_CANDS)
            nlast = np.zeros((R, G_LANES), np.int64)
            for k in range(R_CANDS):
                Sk = O + ps[:, :, k]
                X = np.minimum(X, Sk)
                nk = Sk - np.minimum(-nskip[:, None], X)
                brk = np.where((brk == R_CANDS) & skip[:, :, k] & (nk > max_skip), k, brk)
                nlast = nk
            has_brk = brk < R_CANDS
            L = np.where(has_brk.any(1), np.argmax(has_brk, 1), G_LANES)
            lim = np.where(lanes < L[:, None], R_CANDS,
                           np.where(lanes == L[:, None], brk, 0))
            ok = imp & (kk[None, None, :] < lim[:, :, None])
            last = np.where(ok.any(2), R_CANDS - 1 - np.argmax(ok[:, :, ::-1], 2), -1)
            vlast = np.take_along_axis(sc, np.maximum(last, 0)[:, :, None], 2)[:, :, 0]
            has_imp = last >= 0
            src = np.where(has_imp.any(1), G_LANES - 1 - np.argmax(has_imp[:, ::-1], 1), 0)
            best_v = vlast[g, src]
            best_j = R_CANDS * quad[src] + 3 - last[g, src]
            Lc = np.minimum(L, G_LANES - 1)
            tail = np.where(L < G_LANES, c0 + Lc * R_CANDS + brk[g, Lc] + 1 - off,
                            nlast[:, G_LANES - 1])
            upd = here & has_imp.any(1)
            max_f = np.where(upd, best_v, max_f)
            max_j = np.where(upd, best_j, max_j)
            stop = here & (L < G_LANES)
            done = np.where(stop, tail, done)
            nskip = np.where(here & ~stop, tail, nskip)
            live = here & ~stop & (R_CANDS * (qd - (c0 >> 2)) - CHUNK + 3 >= lo)
            for r_, l_, k_ in zip(*np.nonzero(live[:, None, None] & (far >= 0))):
                f_ = far[r_, l_, k_]
                bits[r_, f_ >> 5] |= 1 << (f_ & 31)
            wrote |= live
            c0 += CHUNK
            if not live.any():
                break
        act = np.nonzero(active)[0]
        visited[act] += done[act]
        stats["most"] = np.maximum(stats["most"], np.where(active, done, 0))
        rsc[act, slot], rpar[act, slot] = max_f[act], max_j[act]
        pkj = np.where(max_j >= ring_lo, rpk[g, np.maximum(max_j, 0) % ring],
                       pk_g[np.minimum(base + np.maximum(max_j, 0), T)])
        rpk[act, slot] = np.where((max_j >= 0) & (pkj > max_f), pkj, max_f)[act]
        for r_ in np.nonzero(active & wrote)[0]:
            bits[r_, 1:(int(wn[r_]) + off + 31) >> 5] = 0
        slot = (slot + 1) % ring
    flush(((n_max - 1) // FILL) * FILL)
    return (sco_g[:T].astype(np.int32), par_g[:T].astype(np.int32), pk_g[:T].astype(np.int32),
            visited, stats)
