"""The PyTorch port's bsw (genomicsbench_tpu_torch) against the JAX package.

Runs on the CPU, where the port's wrapper takes its plain PyTorch version.
The same inputs, made from numpy seeds, go through both packages, the
goldens of the compiled reference and the scalar oracle.  Tolerance: none,
every output is int32 and must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu.config import BswParams as JaxBswParams
from genomicsbench_tpu.io.pairs import load_pairs as jax_load_pairs
from genomicsbench_tpu.ops import bsw as jax_bsw

from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.config import BswParams
from genomicsbench_tpu_torch.io.pairs import pack_pairs, write_pairs
from genomicsbench_tpu_torch.ops import bsw
from genomicsbench_tpu_torch.oracle.bsw import banded_sw_oracle

from torch_bsw_cases import PARAMS, STRESS, load_golden, random_pairs, rows, stress_pairs

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them and slow the run many times over
torch.set_num_threads(1)


def _port_batch(pairs, params, max_t, max_q):
    b = pack_pairs(pairs, max_t, max_q)
    return rows(bsw.banded_sw_batch(b.query, b.target, b.qlen, b.tlen, b.h0,
                                    params, device="cpu"))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_batch_matches_jax(name):
    b = pack_pairs(random_pairs(seed=len(name), n=64, max_q=120, max_t=180),
                   192, 128)
    assert (b.qlen == 0).any() and (b.tlen == 0).any() and (b.h0 == 0).any()
    want = rows(jax_bsw.banded_sw_batch(b.query, b.target, b.qlen, b.tlen,
                                        b.h0, JaxBswParams(**PARAMS[name])))
    got = rows(bsw.banded_sw_batch(b.query, b.target, b.qlen, b.tlen, b.h0,
                                   BswParams(**PARAMS[name]), device="cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("label", sorted(STRESS))
def test_stress_matches_jax(label):
    """The plain version, which the card holds its kernel against, against
    JAX banded_sw_batch on the stress inputs of the card's tests, at a
    small count."""
    b = pack_pairs(stress_pairs(label, seed=3, n=40, max_q=400))
    want = rows(jax_bsw.banded_sw_batch(b.query, b.target, b.qlen, b.tlen,
                                        b.h0, JaxBswParams(**STRESS[label])))
    got = rows(bsw.banded_sw_batch(b.query, b.target, b.qlen, b.tlen, b.h0,
                                   BswParams(**STRESS[label]), device="cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_goldens(name):
    pairs, exp = load_golden(name)
    got = _port_batch(pairs, BswParams(**PARAMS[name]), None, None)
    np.testing.assert_array_equal(got, exp)


def test_padded_slots_are_inert():
    """Zero-length slots must not perturb real pairs."""
    rng = np.random.default_rng(11)
    q = rng.integers(0, 4, 64).astype(np.uint8)
    t = np.concatenate([q, rng.integers(0, 4, 64).astype(np.uint8)])
    empty = np.zeros(0, np.uint8)
    pairs = [(q, t, 20)] + [(empty, empty, 0)] * 7
    got = _port_batch(pairs, BswParams(), 128, 128)
    want = banded_sw_oracle(q, t, BswParams().score_matrix(), h0=20)
    assert tuple(got[0]) == want.as_tuple()
    # tlen == 0: no row runs, so (h0, 0, 0, 0, -1, 0)
    assert (got[1:] == [0, 0, 0, 0, -1, 0]).all()


def test_batch_order_invariance():
    pairs, exp = load_golden("default")
    pairs, exp = pairs[:32], exp[:32]
    perm = np.random.default_rng(0).permutation(32)
    got = _port_batch([pairs[i] for i in perm], BswParams(), None, 256)
    np.testing.assert_array_equal(got, exp[perm])


def test_max_length_pair():
    """Target 2047 and query 255 (the reference's limits) with h0 = 0."""
    rng = np.random.default_rng(0)
    Q, T = 255, 2047
    q = rng.integers(0, 4, Q).astype(np.uint8)
    t = np.zeros(T, np.uint8)
    t[:Q] = q
    t[Q:] = rng.integers(0, 4, T - Q)
    mut = rng.integers(0, Q, 12)
    t[mut] = rng.integers(0, 4, 12)
    short = rng.integers(0, 4, 4).astype(np.uint8)
    pairs = [(q, t, 0)] + [(short, short, 10)] * 7
    got = _port_batch(pairs, BswParams(), 2047, 256)
    want = banded_sw_oracle(q, t, BswParams().score_matrix(), h0=0)
    assert tuple(got[0]) == want.as_tuple()


def test_all_mismatch_zdrop():
    q = np.zeros(100, np.uint8)           # AAAA...
    t = np.full(200, 1, np.uint8)         # CCCC... (all mismatch)
    short = np.zeros(4, np.uint8)
    pairs = [(q, t, 25)] + [(short, short, 5)] * 7
    got = _port_batch(pairs, BswParams(), 208, 128)
    want = banded_sw_oracle(q, t, BswParams().score_matrix(), h0=25)
    assert tuple(got[0]) == want.as_tuple()


@pytest.mark.parametrize("h0", [0, 3, 30])
def test_empty_query_matches_jax(h0):
    """qlen == 0, tlen > 0: row 0 reaches the query end at once (gscore is
    its h1) and breaks on the all-zero row."""
    rng = np.random.default_rng(h0)
    t = rng.integers(0, 4, 50).astype(np.uint8)
    q = rng.integers(0, 4, 40).astype(np.uint8)
    b = pack_pairs([(q[:0], t, h0), (q, t, h0)] + [(q[:3], t[:3], h0)] * 6,
                   64, 128)
    want = rows(jax_bsw.banded_sw_batch(b.query, b.target, b.qlen, b.tlen, b.h0))
    got = rows(bsw.banded_sw_batch(b.query, b.target, b.qlen, b.tlen, b.h0,
                                   device="cpu"))
    np.testing.assert_array_equal(got, want)
    p = BswParams()
    assert tuple(got[0]) == (h0, 0, 0, 1, max(h0 - p.o_del - p.e_del, 0), 0)


def test_plain_matches_pallas_interpret():
    """The port's plain version against the JAX Pallas kernel, run in
    interpret mode at the shapes of its own parity test."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    B, Q, T = 16, 128, 160
    q = rng.integers(0, 5, (B, Q)).astype(np.uint8)
    t = np.zeros((B, T), np.uint8)
    t[:, :Q] = q
    mut = rng.integers(0, Q, (B, 8))
    t[np.arange(B)[:, None], mut] = rng.integers(0, 4, (B, 8))
    t[:, Q:] = rng.integers(0, 4, (B, T - Q))
    qlen = rng.integers(Q - 50, Q + 1, B).astype(np.int32)
    tlen = rng.integers(Q, T + 1, B).astype(np.int32)
    h0 = rng.integers(0, 40, B).astype(np.int32)
    w = np.full(B, 100, np.int32)
    kw = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100)
    want = jax_bsw._bsw_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(qlen), jnp.asarray(tlen),
        jnp.asarray(h0), jnp.asarray(w), t_steps=T, block_b=8,
        match=1, mismatch=4, ambig=-1, interpret=True, **kw)
    args = [torch.from_numpy(a) for a in (q, t, qlen, tlen, h0, w)]
    got = bsw.bsw_extend(*args, torch.arange(B), BswParams(**kw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[:6].numpy(),
                                  np.stack([np.asarray(o) for o in want]))


def test_pairs_match_jax():
    """banded_sw_pairs over ~300 mixed-length pairs in several buckets:
    same results in input order, same bucketing and padding report."""
    batch = pack_pairs(random_pairs(seed=7, n=300, max_q=200, max_t=250),
                       250, 200)
    want = jax_bsw.BswScorer(batch, JaxBswParams(), batch_size=128)
    got = bsw.BswScorer(batch, BswParams(), batch_size=128, device="cpu")
    assert len(got.buckets) == 3
    for a, b in zip(got.buckets, want.buckets):
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.pad_sizes == b.pad_sizes
    assert got.padding_report() == want.padding_report()
    np.testing.assert_array_equal(rows(got.score()), rows(want.score()))
    np.testing.assert_array_equal(
        rows(bsw.banded_sw_pairs(batch, batch_size=128, device="cpu")),
        rows(jax_bsw.banded_sw_pairs(batch, JaxBswParams(), batch_size=128)))


def test_cli_rows_match_jax(tmp_path, capsys):
    """The port's CLI against JAX banded_sw_pairs on the same pairs file.
    (Not against the JAX CLI, which passes the mismatch penalty with the
    wrong sign.)"""
    pairs = random_pairs(seed=9, n=40, max_q=90, max_t=140)
    path = tmp_path / "pairs.txt"
    write_pairs(str(path), [(q, t, h0) for q, t, h0 in pairs if len(q) and len(t)])
    torch_cli_main(["bsw", "-pairs", str(path), "--print-output",
                    "--device", "cpu"])
    out = capsys.readouterr()
    got = np.array([line.split() for line in out.out.strip().splitlines()],
                   dtype=np.int64)
    want = rows(jax_bsw.banded_sw_pairs(jax_load_pairs(str(path)),
                                        JaxBswParams()))
    np.testing.assert_array_equal(got, want)
    assert "Overall SW cycles(sec)" in out.err
    assert "bucket padding efficiency" in out.err


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_w_eff_matches_jax(name):
    p = BswParams(**PARAMS[name])
    np.testing.assert_array_equal(
        bsw._compute_w_eff(np.arange(300), p),
        jax_bsw._compute_w_eff(np.arange(300), JaxBswParams(**PARAMS[name])))
