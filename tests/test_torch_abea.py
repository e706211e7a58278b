"""The PyTorch port's abea and eventalign (genomicsbench_tpu_torch) against
the JAX package, on the CPU.

On the CPU `abea_fill` and `abea_backtrack` take their plain PyTorch
versions.  The same numpy inputs (tests/torch_abea_cases.py) go through
both packages; tolerances:

* integers exact: the unpacked traces, each band's bll_e, trace1,
  best_ev, the pairs, the longest gap, the QC flags, the event starts and
  lengths, the eventalign flags, and the TSV bytes; except the trace cells
  of TRACE_NEAR_TIES, where two candidates lie one float32 ulp apart and
  XLA's contraction tips the choice (there a numpy fill without FMA gives
  the port's codes and one with FMA gives JAX's, and the pairs are equal);
* the event means and stdvs within 2e-4 of the goldens (the reference's
  printed precision), and equal to JAX's;
* the fill's float best score within a relative 1e-5 of JAX's, and the
  backtrack's emission sum within a relative 1e-5: XLA on the CPU
  contracts a*b + c into FMAs, which the port (and the reference's
  float-mode build behind the goldens) does not.  The largest relative
  difference seen in best is 1.7e-7 (one float32 ulp), in the sum 2.3e-7.
"""

import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

from genomicsbench_tpu import config as jax_config
from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.ops import abea as jax_abea
from genomicsbench_tpu.ops import eventalign as jax_ea

from genomicsbench_tpu_torch import native
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.config import ABEA_PROFILES, AbeaRunProfile, load_abea_profile
from genomicsbench_tpu_torch.ops import abea
from genomicsbench_tpu_torch.ops import eventalign as ea

from torch_abea_cases import (BT_TILE, MAIN_SAMPLE, MAIN_SAMPLE_FAILED, MAIN_SAMPLE_SHA256,
                              _model, bench_abea_reads, check_events, edge_cases,
                              eventalign_reads_case, load_align_golden, load_events_golden,
                              pairs_digest, sliding_window, tile_walk_backtrack,
                              window_fill_codes)

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them and slow the run many times over
torch.set_num_threads(1)

BEST_RTOL = 1e-5
EVENTS_GOLDEN = load_events_golden()


def _golden_batch():
    mean, stdv, cases, expected = load_align_golden()
    sc = np.array([(c[2], c[3]) for c in cases], np.float32)
    return [c[0] for c in cases], [c[1] for c in cases], sc, (mean, stdv), expected


def _batch(label):
    """(sequences, event means, scalings, (model mean, stdv)) of a named
    input set."""
    if label == "golden":
        seqs, evs, sc, model, _ = _golden_batch()
        return seqs, evs, sc, model
    if label == "synthetic":
        seqs, evs, sc = bench_abea_reads(32, seed=5, lo=200, hi=400)
        return seqs, evs, sc, _model()
    seqs, evs, sc = EDGES[label]
    return seqs, evs, sc, _model()


EDGES = edge_cases(longest=2000)
BATCHES = ["golden", "synthetic"] + sorted(EDGES)
# {input set: {read: [(band, cell)]}}: the trace cells where JAX differs,
# recorded in ROADMAP.md §3
TRACE_NEAR_TIES = {"golden": {7: [(335, 65)], 20: [(91, 55)]},
                   "synthetic": {15: [(36, 41), (48, 35)], 26: [(454, 38)],
                                 31: [(344, 66), (348, 64)]},
                   "few_events": {2: [(48, 66)]},
                   "mixed_lengths": {5: [(159, 50)]}}


@functools.lru_cache(maxsize=None)
def _port_run(label):
    """The port's plain versions on a named input set, once per process:
    (inputs, tables, fill, backtrack buffer)."""
    seqs, evs, sc, model = _batch(label)
    t = abea.upload_reads(seqs, evs, *model, sc, "cpu")
    f = abea.abea_fill(t)
    return (seqs, evs, sc, model), t, f, abea.abea_backtrack(t, f).numpy()


def _jax_fill(seqs, evs, sc, model):
    """JAX `_abea_scan` and `_abea_backtrack_scan` (jitted, on the CPU) on the
    inputs JAX align_batch gives them (abea.py:511-583), as numpy."""
    mean, stdv = model
    B = len(seqs)
    n_kmers = np.array([len(s) - abea.KMER + 1 for s in seqs], np.int32)
    n_events = np.array([len(e) for e in evs], np.int32)
    Kp = -(-int(n_kmers.max()) // 128) * 128
    Ep = -(-int(n_events.max()) // 128) * 128
    ranks = np.zeros((B, Kp), np.int32)
    ev = np.zeros((B, Ep), np.float32)
    for b in range(B):
        ranks[b, :n_kmers[b]] = jax_abea.kmer_ranks(seqs[b])
        ev[b, :n_events[b]] = evs[b]
    p = abea.transition_params(n_kmers.astype(np.int64), n_events.astype(np.int64), sc)
    log_stdv = np.log(stdv.astype(np.float64)).astype(np.float32)
    n_steps = -(-(int((n_events + n_kmers + 2).max()) - 2) // 256) * 256
    fill = jax_abea._abea_scan(ranks, ev, n_kmers, n_events, p[:, 0], p[:, 1], mean, stdv,
                               log_stdv, p[:, 2], p[:, 3], p[:, 4], p[:, 5], n_steps=n_steps)
    max_steps = -(-(int((n_events + n_kmers).max()) + 2) // 256) * 256
    _, sum_em, max_gap = jax_abea._abea_backtrack_scan(
        *fill, ranks, ev, n_kmers, p[:, 0], p[:, 1], mean, stdv, log_stdv,
        max_steps=max_steps)
    traces, bll_es, trace1, best, best_ev = (np.asarray(x) for x in fill)
    return traces, bll_es, trace1, best, best_ev, np.asarray(sum_em), np.asarray(max_gap)


def _numpy_fill_codes(ranks, ev, p, model, fused):
    """One read's fill in numpy float32 (abea.py:298-406), its 2-bit codes
    per band; with `fused`, scale*mean + shift, (-0.5a)*a + (c - log_stdv)
    each round once, as XLA on the CPU contracts them."""
    f32, neg = np.float32, np.float32(-np.inf)
    mean, stdv, log_stdv = model
    scale, shift, lp_skip, lp_stay, lp_step, lp_trim = p

    def fma(a, b, c):
        return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)

    nk, ne, W = len(ranks), len(ev), abea.BW
    offs = np.arange(W)
    prev2 = np.where(offs == W // 2, f32(0), neg).astype(f32)
    prev = np.where(offs == W // 2, lp_trim, neg).astype(f32)
    be, bk, bk_p = W // 2, -1 - W // 2, -1 - W // 2
    codes = np.zeros((nk + ne, W), np.uint8)
    with np.errstate(invalid="ignore", over="ignore"):
        for s in range(nk + ne):
            ll, ur = prev[0], prev[W - 1]
            right = s % 2 == 1 if ll == neg and ur == neg else bool(ll < ur)
            nbe, nbk = (be, bk + 1) if right else (be + 1, bk)
            up = np.append(prev[1:], neg) if right else prev
            left = prev if right else np.insert(prev[:-1], 0, neg)
            diag = [np.insert(prev2[:-1], 0, neg), prev2,
                    np.append(prev2[1:], neg)][int(right) + bk - bk_p]
            evi, kmi = nbe - offs, nbk + offs
            ev_in = (evi >= 0) & (evi < ne)
            valid = ev_in & (kmi >= 0) & (kmi < nk)
            r = ranks[np.clip(kmi, 0, nk - 1)]
            x = ev[np.clip(evi, 0, ne - 1)]
            c = abea.LOG_NORM - log_stdv[r]
            if fused:
                a = (x - fma(scale, mean[r], shift)) / stdv[r]
                lp_e = fma(f32(-0.5) * a, a, c)
            else:
                a = (x - (scale * mean[r] + shift)) / stdv[r]
                lp_e = c + (f32(-0.5) * a) * a
            s_d = (diag + lp_step) + lp_e
            s_u = (up + lp_stay) + lp_e
            s_l = left + lp_skip
            mx = np.maximum(s_d, s_u)
            mx2 = np.maximum(mx, s_l)
            frm = np.where(mx2 == s_l, 2, np.where(mx == s_u, 1, 0))
            trim = ev_in & (kmi == -1)
            band = np.where(valid, mx2, neg).astype(f32)
            band = np.where(trim, lp_trim * (evi + 1).astype(f32), band).astype(f32)
            codes[s] = np.where(trim, 1, np.where(valid, frm, 0))
            prev2, prev = prev, band
            bk_p, be, bk = bk, nbe, nbk
    return codes


def _unpack(packed):
    """(..., 25) packed bytes -> (..., 100) 2-bit codes."""
    p = np.asarray(packed, np.uint8)[..., None] >> np.array([0, 2, 4, 6], np.uint8)
    return (p & 3).reshape(*packed.shape[:-1], abea.BW)


@functools.lru_cache(maxsize=None)
def _jax_run(label):
    """JAX's fill and backtrack scans on a named input set, once per
    process."""
    seqs, evs, sc, model = _port_run(label)[0]
    return _jax_fill(seqs, evs, sc, model)


@functools.lru_cache(maxsize=None)
def _jax_align(label):
    """JAX align_batch on a named input set, once per process."""
    seqs, evs, sc, model = _port_run(label)[0]
    return jax_abea.align_batch(seqs, evs, *model, sc)


@pytest.mark.parametrize("label", BATCHES)
def test_fill_and_backtrack_against_jax_scans(label):
    """abea_fill_reference against JAX `_abea_scan` and
    abea_backtrack_reference against `_abea_backtrack_scan`, on each read's
    own bands."""
    (seqs, evs, sc, model), t, f, out = _port_run(label)
    traces, bll_es, trace1, best, best_ev, sum_em, max_gap = _jax_run(label)
    band_off = t.host["band_off"]
    got_tr = _unpack(f.traces.numpy().reshape(-1, abea.BW // 4))
    got_be = f.bll_e.numpy()
    differ = {}
    for b in range(len(seqs)):
        rows = slice(band_off[b], band_off[b + 1])
        nb = band_off[b + 1] - band_off[b]
        cells = np.nonzero(got_tr[rows] != _unpack(traces[:nb, b]))
        if cells[0].size:
            differ[b] = [(int(i), int(j)) for i, j in zip(*cells)]
        np.testing.assert_array_equal(got_be[rows], bll_es[:nb, b],
                                      err_msg=f"{label} read {b} bll_e")
        assert (bll_es[nb:, b] == -1).all()
    assert differ == TRACE_NEAR_TIES.get(label, {}), f"{label}: traces differ at {differ}"
    for b in differ:        # a near-tie: unfused numpy gives the port's, fused JAX's
        rows = slice(band_off[b], band_off[b + 1])
        p, model3, rk = t.params[b].numpy(), t.model.numpy(), abea.kmer_ranks(seqs[b])
        np.testing.assert_array_equal(_numpy_fill_codes(rk, evs[b], p, model3, False),
                                      got_tr[rows])
        np.testing.assert_array_equal(_numpy_fill_codes(rk, evs[b], p, model3, True),
                                      _unpack(traces[:band_off[b + 1] - band_off[b], b]))
    np.testing.assert_array_equal(f.trace1.numpy(), trace1)
    np.testing.assert_array_equal(f.best_ev.numpy(), best_ev)
    np.testing.assert_allclose(f.best.numpy(), best, rtol=BEST_RTOL, atol=0)
    assert np.array_equal(np.isfinite(f.best.numpy()), np.isfinite(best))
    hdr = out[:4 * len(seqs)].reshape(-1, 4)
    np.testing.assert_array_equal(hdr[:, 2], max_gap)
    np.testing.assert_allclose(hdr[:, 1].view(np.float32), sum_em, rtol=BEST_RTOL, atol=0)
    np.testing.assert_array_equal(hdr[:, 3].view(np.float32), f.best.numpy())


@functools.lru_cache(maxsize=None)
def _window_run(label):
    """The plain fill of a named input set (or "main64", the main path's
    first 64 reads) and `sliding_window` over its corners: (inputs, tables,
    fill, event indices, k-mer indices)."""
    if label == "main64":
        seqs, evs, sc = bench_abea_reads(64)
        model = _model()
        t = abea.upload_reads(seqs, evs, *model, sc, "cpu")
        f = abea.abea_fill(t)
    else:
        (seqs, evs, sc, model), t, f, _ = _port_run(label)
    ev_idx, km_idx = sliding_window(f.bll_e.numpy(), t.host["band_off"],
                                    np.diff(t.host["k_off"]))
    return (seqs, evs, sc, model), t, f, ev_idx, km_idx


WINDOW_BATCHES = ["golden"] + sorted(EDGES) + ["main64"]


@pytest.mark.parametrize("label", WINDOW_BATCHES)
def test_sliding_window_gives_each_cell_its_event_and_kmer(label):
    """The fill kernel's window of emission inputs (its look-ahead, its
    in-lane moves and lane-edge shuffles on right and down moves), modelled
    in numpy over the plain version's band corners: at every band of every
    read, cell o holds event bll_e - o and k-mer (band - bll_e) + o."""
    _, t, f, ev_idx, km_idx = _window_run(label)
    band_off = t.host["band_off"]
    band = np.concatenate([np.arange(n) for n in np.diff(band_off)])
    be = f.bll_e.numpy().astype(np.int64)
    o = np.arange(abea.BW)
    np.testing.assert_array_equal(ev_idx, be[:, None] - o)
    np.testing.assert_array_equal(km_idx, (band - be)[:, None] + o)


@pytest.mark.parametrize("label", WINDOW_BATCHES)
def test_window_emissions_equal_plain_bit_for_bit(label):
    """A numpy fill that computes each k-mer's emission terms once and
    gathers them at the window's indices, as the kernel does, gives the
    plain version's trace codes and best score bit for bit (on the main
    path's first 4 reads)."""
    (seqs, evs, sc, model), t, f, ev_idx, km_idx = _window_run(label)
    band_off = t.host["band_off"]
    got = _unpack(f.traces.numpy().reshape(-1, abea.BW // 4))
    for b in range(min(len(seqs), 4 if label == "main64" else len(seqs))):
        rows = slice(band_off[b], band_off[b + 1])
        codes, best = window_fill_codes(abea.kmer_ranks(seqs[b]), evs[b], t.params[b].numpy(),
                                        t.model.numpy(), ev_idx[rows], km_idx[rows])
        np.testing.assert_array_equal(codes, got[rows], err_msg=f"{label} read {b}")
        assert np.float32(best).tobytes() == f.best[b].numpy().tobytes(), (label, b)


@pytest.mark.parametrize("label", ["synthetic", "main64"])
def test_longest_first_order(label):
    """The fill kernel's start order is a permutation of the reads by band
    count, longest first and ties in read order; the plain version's
    outputs of every read are the same when the reads come in that order."""
    (seqs, evs, sc, model), t, f, _, _ = _window_run(label)
    order = t.host["order"]
    nb = np.diff(t.host["band_off"])
    assert order.dtype == np.int32 and np.array_equal(np.sort(order), np.arange(len(seqs)))
    np.testing.assert_array_equal(t.order.numpy(), order)
    assert (np.diff(nb[order]) <= 0).all()
    ties = np.diff(nb[order]) == 0
    assert (np.diff(order)[ties] > 0).all()
    perm = abea.upload_reads([seqs[i] for i in order], [evs[i] for i in order], *model,
                             sc[order], "cpu")
    assert np.array_equal(perm.host["order"], np.arange(len(seqs)))
    g = abea.abea_fill(perm)
    out, g_out = abea.abea_backtrack(t, f).numpy(), abea.abea_backtrack(perm, g).numpy()
    tr, g_tr = f.traces.view(-1, abea.BW // 4).numpy(), g.traces.view(-1, abea.BW // 4).numpy()
    bo, g_bo = t.host["band_off"], perm.host["band_off"]
    B = len(seqs)
    for k, b in enumerate(order.tolist()):
        rows, g_rows = slice(bo[b], bo[b + 1]), slice(g_bo[k], g_bo[k + 1])
        np.testing.assert_array_equal(g_tr[g_rows], tr[rows])
        np.testing.assert_array_equal(g.bll_e.numpy()[g_rows], f.bll_e.numpy()[rows])
        np.testing.assert_array_equal(g_out[4 * B + 2 * g_bo[k]:4 * B + 2 * g_bo[k + 1]],
                                      out[4 * B + 2 * bo[b]:4 * B + 2 * bo[b + 1]])
        np.testing.assert_array_equal(g_out[4 * k:4 * k + 4], out[4 * b:4 * b + 4])
    np.testing.assert_array_equal(g.trace1.numpy(), f.trace1.numpy()[order])
    np.testing.assert_array_equal(g.best.numpy().view(np.int32),
                                  f.best.numpy().view(np.int32)[order])
    np.testing.assert_array_equal(g.best_ev.numpy(), f.best_ev.numpy()[order])


@pytest.mark.parametrize("label", BATCHES)
def test_align_batch_against_jax(label):
    """align_batch's collect and QC on the plain versions' buffer against
    JAX align_batch: the pairs and the QC flags exactly."""
    (seqs, evs, sc, model), t, _, out = _port_run(label)
    got = abea._collect(t, out)
    want = _jax_align(label)
    assert got.failed == want.failed
    for b, (g, w) in enumerate(zip(got.pairs, want.pairs)):
        assert g.dtype == np.int32 and g.shape == w.shape, (label, b)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} read {b}")
    if label == "garbage":
        assert all(got.failed)


def test_golden_pairs():
    seqs, evs, sc, model, expected = _golden_batch()
    res = abea.align_batch(seqs, evs, *model, sc, device="cpu")
    assert [len(e) == 0 for e in expected] == res.failed
    for b, exp in enumerate(expected):
        np.testing.assert_array_equal(res.pairs[b], exp, err_msg=f"golden read {b}")


@functools.lru_cache(maxsize=None)
def _main_sample_jax():
    """JAX align_batch on the main path's first MAIN_SAMPLE reads, once
    per process."""
    seqs, evs, sc = bench_abea_reads(MAIN_SAMPLE)
    return jax_abea.align_batch(seqs, evs, *_model(), sc)


def test_main_path_sample_against_jax():
    """The first 512 reads of the 10,000-read main path: the port's plain
    version equals JAX align_batch, and its QC count and pairs digest are
    the constants chip_smoke.py holds the card to."""
    mean, stdv = _model()
    seqs, evs, sc = bench_abea_reads(MAIN_SAMPLE)
    got = abea.align_batch(seqs, evs, mean, stdv, sc, device="cpu")
    want = _main_sample_jax()
    assert got.failed == want.failed
    for b, (g, w) in enumerate(zip(got.pairs, want.pairs)):
        np.testing.assert_array_equal(g, w, err_msg=f"main path read {b}")
    assert sum(got.failed) == MAIN_SAMPLE_FAILED
    assert pairs_digest(got.pairs) == MAIN_SAMPLE_SHA256


def _tile_walk(t, f):
    """`tile_walk_backtrack` (the model of gb_abea_backtrack's schedule) on
    a batch's tables and fill."""
    return tile_walk_backtrack(t.ranks.numpy(), t.events.numpy(), t.host["k_off"],
                               t.host["e_off"], t.host["band_off"], t.params.numpy(),
                               t.model.numpy(), t.host["order"], f.traces.numpy(),
                               f.bll_e.numpy(), f.best.numpy(), f.best_ev.numpy())


@pytest.mark.parametrize("label", BATCHES)
def test_tile_walk_model_against_plain_and_jax(label):
    """The backtrack kernel's schedule (tiles of 64 bands staged two deep,
    the walk's steps through a 128-step path buffer, the terms a buffer at a
    time, the Kahan chain in walk order) gives the plain version's buffer
    bit for bit, the float sums' bits included; against JAX's scans and
    align_batch, each read's pair count, longest gap, pairs and QC flag
    exactly, the sum within the module's bound (XLA contracts FMAs)."""
    (seqs, evs, sc, model), t, f, out = _port_run(label)
    got, stats = _tile_walk(t, f)
    np.testing.assert_array_equal(got, out)
    assert stats["tiles"].sum() > 0
    _, _, _, _, _, sum_em, max_gap = _jax_run(label)
    hdr = got[:4 * len(seqs)].reshape(-1, 4)
    np.testing.assert_array_equal(hdr[:, 2], max_gap)
    np.testing.assert_allclose(hdr[:, 1].view(np.float32), sum_em, rtol=BEST_RTOL, atol=0)
    mine, want = abea._collect(t, got), _jax_align(label)
    assert mine.failed == want.failed
    for b, (g, w) in enumerate(zip(mine.pairs, want.pairs)):
        np.testing.assert_array_equal(g, w, err_msg=f"{label} read {b}")


def test_tile_walk_model_main_path_sample():
    """The model on the main path's first 64 reads: the plain version's
    buffer bit for bit, JAX align_batch's pairs and QC flags exactly; every
    walk crosses tiles."""
    (seqs, evs, sc, model), t, f, _, _ = _window_run("main64")
    got, stats = _tile_walk(t, f)
    np.testing.assert_array_equal(got, abea.abea_backtrack(t, f).numpy())
    want = _main_sample_jax()
    mine = abea._collect(t, got)
    assert mine.failed == want.failed[:64]
    for b, (g, w) in enumerate(zip(mine.pairs, want.pairs[:64])):
        np.testing.assert_array_equal(g, w, err_msg=f"main path read {b}")
    steps = stats["steps"]
    assert (stats["tiles"] >= -(-steps // BT_TILE)).all() and stats["tiles"].min() > 10


@pytest.mark.parametrize("label", ["diagonal_walks", "short_walks", "no_walk"])
def test_tile_walk_edges(label):
    """The backtrack's tile edges: diagonal moves that leave a tile from its
    first band and from its second (landing two bands down, in the tile
    below); walks shorter than a tile; a read whose best is not finite and
    which has no walk (its header 0 pairs, a zero sum, no tile)."""
    _, t, f, out = _port_run(label)
    _, stats = _tile_walk(t, f)
    best = f.best.numpy()
    if label == "diagonal_walks":
        assert (stats["diag_edge"] > 0).any(0).all()
    elif label == "short_walks":
        assert (stats["tiles"] == 1).sum() >= 3 and stats["steps"].max() < BT_TILE
    else:
        assert not np.isfinite(best[0]) and np.isfinite(best[1])
        assert out[:4].tolist()[:3] == [0, 0, 0] and stats["tiles"].tolist()[0] == 0
        assert stats["steps"][1] > 0


def test_bench_generator_is_scale_bench_stream():
    """bench_abea_reads equals tools/scale_bench.py's loop as written, which
    draws event by event, on the first 40 reads."""
    mean, stdv = jax_abea.synthetic_model(0)
    rng = np.random.default_rng(29)
    seqs, evs, sc = bench_abea_reads(40)
    for b in range(40):
        slen = int(rng.integers(800, 1200))
        seq = rng.integers(0, 4, slen).astype(np.uint8)
        scale = float(rng.uniform(0.9, 1.1))
        shift = float(rng.uniform(-5, 5))
        ev = []
        for r in jax_abea.kmer_ranks(seq):
            if rng.random() < 0.05:
                continue
            reps = int(rng.integers(1, 4)) if rng.random() > 0.3 else 1
            for _ in range(reps):
                ev.append(mean[r] * scale + shift + rng.normal(0, stdv[r] * 0.5))
        np.testing.assert_array_equal(seqs[b], seq)
        np.testing.assert_array_equal(evs[b].view(np.uint32),
                                      np.array(ev, np.float32).view(np.uint32))
        assert tuple(sc[b]) == (np.float32(scale), np.float32(shift))


@pytest.mark.parametrize("case", range(len(EVENTS_GOLDEN)))
def test_detect_events_golden(case):
    sig, rows = EVENTS_GOLDEN[case]
    got = abea.detect_events(sig)
    check_events(got, rows, f"events case {case}")
    for g, w in zip(got, jax_abea.detect_events(sig)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_detect_events_random_signals(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(200, 20_000))
    levels = rng.uniform(60, 140, n // 8 + 1)
    sig = (np.repeat(levels, 8)[:n] + rng.normal(0, 1 + seed, n)).astype(np.float32)
    kw = [{}, dict(threshold1=2.0, peak_height=0.5), dict(window_length2=9),
          dict(threshold2=4.0)][seed]
    for g, w in zip(abea.detect_events(sig, **kw), jax_abea.detect_events(sig, **kw)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(6))
def test_peak_detector_against_python(seed):
    """The port's native state machine against the JAX package's Python
    `_peak_detector` on random t-statistics."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 5000))
    t1 = np.abs(rng.normal(0, 1 + seed % 3, n)).astype(np.float32)
    t2 = np.abs(rng.normal(0, 3 * (seed % 4 + 1), n)).astype(np.float32)
    w1, w2, th1, th2, ph = 3 + seed % 2, 6 + seed, 1.4, 9.0 - seed, 0.2 + 0.1 * seed
    got = native.peak_detector(t1, t2, w1, w2, np.float32(th1), np.float32(th2),
                               np.float32(ph))
    want = jax_abea._peak_detector(t1, t2, dict(
        window_length1=w1, window_length2=w2, threshold1=np.float32(th1),
        threshold2=np.float32(th2), peak_height=ph))
    assert got.dtype == np.int64 and got.tolist() == want


def test_model_and_ranks_equal_jax(tmp_path):
    for a, b in zip(abea.synthetic_model(3), jax_abea.synthetic_model(3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_model()[0], jax_abea.synthetic_model(0)[0])
    mean, stdv = jax_abea.synthetic_model(1)
    path = tmp_path / "model.tsv"
    with open(path, "w") as f:
        f.write("#model\nkmer\tlevel_mean\tlevel_stdv\n")
        for r in range(0, 4096, 7):
            kmer = "".join("ACGT"[(r >> (2 * (5 - j))) & 3] for j in range(6))
            f.write(f"{kmer}\t{mean[r]:.4f}\t{stdv[r]:.4f}\n")
    for a, b in zip(abea.load_model_tsv(path), jax_abea.load_model_tsv(path)):
        np.testing.assert_array_equal(a, b)
    seq = np.random.default_rng(0).integers(0, 4, 300)
    np.testing.assert_array_equal(abea.kmer_ranks(seq), jax_abea.kmer_ranks(seq))


EA_PROFILES = {
    "none": None,
    "cpu-test": "cpu-test",
    # small batches, and reads past 300 bases in batches of their own
    "split": dict(batch_size=3, batch_size_bases=900, ultra_thresh=300),
}


@pytest.mark.parametrize("name", sorted(EA_PROFILES))
def test_eventalign_reads_against_jax(name):
    """eventalign_reads with and without a profile: the flags, the scalings,
    events per base and the TSV bytes equal JAX's."""
    raws, seqs = eventalign_reads_case(6, seed=7, lo=220, hi=420)
    rng = np.random.default_rng(8)
    raws[3] = rng.normal(0, 1, 2000).astype(np.float32)      # fails QC
    mean, stdv = _model()
    spec = EA_PROFILES[name]
    if spec is None:
        jp = tp = None
    elif isinstance(spec, str):
        jp, tp = jax_config.ABEA_PROFILES[spec], ABEA_PROFILES[spec]
    else:
        jp = jax_config.AbeaRunProfile(**spec)
        tp = AbeaRunProfile(**dataclasses.asdict(jp))
    jbuf, tbuf = io.StringIO(), io.StringIO()
    want = jax_ea.eventalign_reads(raws, seqs, mean, stdv, tsv_fp=jbuf, profile=jp)
    got = ea.eventalign_reads(raws, seqs, mean, stdv, tsv_fp=tbuf, profile=tp, device="cpu")
    assert [r.flag for r in got] == [r.flag for r in want]
    assert [r.scalings for r in got] == [r.scalings for r in want]
    assert [r.events_per_base for r in got] == [r.events_per_base for r in want]
    assert tbuf.getvalue() == jbuf.getvalue()
    assert got[3].flag == ea.FAILED_ALIGNMENT and sum(r.flag == 0 for r in got) >= 4


def test_cli_against_jax(tmp_path, capsys):
    """`eventalign --signals x.npz -r x.fa`: the port's stdout (--device cpu)
    equals the JAX CLI's, with and without a profile."""
    raws, seqs = eventalign_reads_case(5, seed=11, lo=220, hi=400)
    names = [f"read{i}" for i in range(len(seqs))]
    np.savez(tmp_path / "x.npz", **dict(zip(names[::-1], raws[::-1])))
    with open(tmp_path / "x.fa", "w") as f:
        for name, seq in zip(names + ["unsignalled"], seqs + [seqs[0]]):
            f.write(f">{name} extra\n{''.join('ACGT'[c] for c in seq)}\n")
    args = ["eventalign", "--signals", str(tmp_path / "x.npz"), "-r", str(tmp_path / "x.fa")]
    for extra in ([], ["--profile", "cpu-test"]):
        jax_cli_main(args + extra)
        want = capsys.readouterr()
        torch_cli_main(args + extra + ["--device", "cpu"])
        got = capsys.readouterr()
        assert got.out == want.out and got.out.count("\n") > 100
        assert got.err.split(";")[0] == want.err.split(";")[0]


@pytest.mark.parametrize("name", sorted(jax_config.ABEA_PROFILES))
def test_profiles_cross_as_dicts(name, tmp_path):
    jp = jax_config.ABEA_PROFILES[name]
    assert AbeaRunProfile(**dataclasses.asdict(jp)) == ABEA_PROFILES[name]
    assert load_abea_profile(name) == ABEA_PROFILES[name]
    path = tmp_path / "profile.txt"
    path.write_text("4.0 1.5 6.0 64 200000 3 5000\n")
    assert dataclasses.asdict(load_abea_profile(str(path))) == dataclasses.asdict(
        jax_config.load_abea_profile(str(path)))
