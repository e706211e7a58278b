"""The bsw CUDA kernel on the card, against its plain PyTorch version and the
goldens.  Every test needs an NVIDIA GPU (marker `cuda`) and skips without
one.  Tolerance: none, the outputs are int32 and must agree bit for bit.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_bsw_cuda.py
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.config import BswParams
from genomicsbench_tpu_torch.io.pairs import pack_pairs
from genomicsbench_tpu_torch.ops import bsw

from torch_bsw_cases import PARAMS, STRESS, load_golden, random_pairs, rows, stress_pairs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _on(batch, params, dev):
    w = bsw._compute_w_eff(batch.qlen, params)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (batch.query, batch.target, batch.qlen, batch.tlen,
                      batch.h0, w)]


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_goldens_on_card(card, name):
    pairs, gold = load_golden(name)
    b = pack_pairs(pairs)
    res = bsw.banded_sw_batch(b.query, b.target, b.qlen, b.tlen, b.h0,
                              BswParams(**PARAMS[name]), device=card)
    np.testing.assert_array_equal(rows(res), gold)


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain(card, name, seed):
    """All 7 rows (band cells too) of the kernel against the plain version
    on the same card tensors, over a shuffled index with repeats."""
    params = BswParams(**PARAMS[name])
    b = pack_pairs(random_pairs(seed, 700, max_q=255, max_t=600))
    arrays = _on(b, params, card)
    idx = torch.from_numpy(np.random.default_rng(seed).integers(
        0, b.n, 1000)).to(card)
    got = bsw.bsw_extend(*arrays, idx, params)
    want = bsw.bsw_extend_reference(*arrays, idx, params)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("label", sorted(STRESS))
def test_stress_matches_plain(card, label):
    """Long queries (blocks above 48 KB), narrow bands, zdrop = 0, large h0,
    base 4 in targets, qlen at chunk edges, and the two long-query
    launches: three warps per block, and in device scratch."""
    params = BswParams(**STRESS[label])
    b = pack_pairs(stress_pairs(label, seed=2, n=300))
    launch = bsw.bsw_launch(b.query.shape[1])
    assert launch.scratch == (label == "query_30000")
    assert (launch.warps_per_block < bsw.WARPS_PER_BLOCK) == (label == "query_8000")
    arrays = _on(b, params, card)
    idx = torch.arange(b.n, device=card)
    got = bsw.bsw_extend(*arrays, idx, params)
    want = bsw.bsw_extend_reference(*arrays, idx, params)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_scratch_instance_matches_plain(card):
    """Mixed pairs padded to a query width past shared memory, so every
    pair's eh row lives in device scratch."""
    b = pack_pairs(random_pairs(5, 300, max_q=255, max_t=600), None, 26000)
    assert bsw.bsw_launch(b.query.shape[1]).scratch
    arrays = _on(b, BswParams(), card)
    idx = torch.arange(b.n, device=card)
    got = bsw.bsw_extend(*arrays, idx)
    torch.testing.assert_close(got, bsw.bsw_extend_reference(*arrays, idx),
                               rtol=0, atol=0)


def test_edge_slots_on_card(card):
    """Empty targets give (h0, 0, 0, 0, -1, 0); empty queries with a target
    take row 0 and break; the 255 x 2047 pair with h0 = 0 and an
    all-mismatch pair agree with the plain version."""
    rng = np.random.default_rng(0)
    empty = np.zeros(0, np.uint8)
    q = rng.integers(0, 4, 255).astype(np.uint8)
    t = rng.integers(0, 4, 2047).astype(np.uint8)
    t[:255] = q
    b = pack_pairs([(q, t, 0),
                    (np.zeros(100, np.uint8), np.full(200, 1, np.uint8), 25),
                    (q, empty, 9), (empty, t[:40], 30), (empty, t[:40], 3),
                    (empty, empty, 0)])
    params = BswParams()
    arrays = _on(b, params, card)
    idx = torch.arange(b.n, device=card)
    got = bsw.bsw_extend(*arrays, idx, params)
    torch.testing.assert_close(
        got, bsw.bsw_extend_reference(*arrays, idx, params), rtol=0, atol=0)
    got = got[:6].T.cpu().tolist()
    assert got[2] == [9, 0, 0, 0, -1, 0]
    assert got[3] == [30, 0, 0, 1, 23, 0]
    assert got[4] == [3, 0, 0, 1, 0, 0]
    assert got[5] == [0, 0, 0, 0, -1, 0]


def test_scorer_launches_once_per_score(card):
    b = pack_pairs(random_pairs(3, 3000, max_q=200, max_t=400))
    scorer = bsw.BswScorer(b, batch_size=256, device=card)
    assert len(scorer.buckets) > 1
    before = bsw.bsw_extend.launches
    got = scorer.score()
    got = scorer.score()
    assert bsw.bsw_extend.launches - before == 2
    want = bsw.banded_sw_pairs(b, batch_size=256, device="cpu")
    np.testing.assert_array_equal(rows(got), rows(want))
    rep = scorer.padding_report()
    assert 0 < rep["band_cells"] <= rep["logical_cells"] == b.cells()


def test_wrapper_refuses_mixed_devices(card):
    b = pack_pairs(random_pairs(4, 8, max_q=20, max_t=40))
    arrays = _on(b, BswParams(), card)
    arrays[3] = arrays[3].cpu()
    with pytest.raises(ValueError, match="tlen"):
        bsw.bsw_extend(*arrays, torch.arange(b.n, device=card))
