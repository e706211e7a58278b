"""The chain CUDA kernel on the card, against its plain PyTorch version and the
goldens.  Every test needs an NVIDIA GPU (marker `cuda`) and skips without
one.  Tolerance: none, the outputs are integers and must agree bit for bit.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_chain_cuda.py
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts
from genomicsbench_tpu_torch.ops import chain

from torch_chain_cases import bench_chain_calls, edge_cases, load_golden

pytestmark = pytest.mark.cuda
EDGES = edge_cases()


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _kernel_vs_plain(dicts, kw, dev):
    """chain_dp and chain_dp_reference on the same card tensors; all four
    outputs (visited too) equal.  Returns the dispatched batch."""
    calls = anchor_calls_from_dicts(dicts)
    pending = chain._chain_dispatch(calls, kw.get("window"), kw.get("max_iter", 5000),
                                    kw.get("max_skip", 25), kw.get("is_cdna", False), dev)
    t, _, _ = chain.upload_calls(calls, dev)
    args = [t[k] for k in chain.CHAIN_DP_INPUTS]
    want = chain.chain_dp_reference(*args, kw.get("max_iter", 5000), kw.get("max_skip", 25),
                                    kw.get("is_cdna", False), kw.get("window") or 0)
    for got, exp in zip(pending.out, want):
        torch.testing.assert_close(got, exp, rtol=0, atol=0)
    return pending


def test_goldens_on_card(card):
    calls, gold = load_golden()
    res = chain.chain_batch(anchor_calls_from_dicts(calls), device=card)
    for k, (c, exp) in enumerate(zip(calls, gold)):
        n = len(c["x"])
        got = np.stack([res.scores[k, :n], res.parents[k, :n], res.peak_scores[k, :n]], 1)
        np.testing.assert_array_equal(got, exp, err_msg=f"call {k}")


def test_goldens_kernel_matches_plain(card):
    calls, _ = load_golden()
    _kernel_vs_plain(calls, {}, card)


@pytest.mark.parametrize("label", sorted(EDGES))
def test_edges_kernel_matches_plain(card, label):
    dicts, kw = EDGES[label]
    _kernel_vs_plain(dicts, kw, card)


def test_main_workload_sample(card):
    """500 reads of the main path's generator (about 540,000 anchors)."""
    pending = _kernel_vs_plain(bench_chain_calls(500), {}, card)
    assert int(pending.out[3].sum()) > 0


def test_one_launch_per_chain_batch(card):
    calls = anchor_calls_from_dicts(bench_chain_calls(20))
    before = chain.chain_dp.launches
    chain.chain_batch(calls, device=card)
    chain.chain_batch(calls, device=card)
    assert chain.chain_dp.launches - before == 2


def test_wrapper_refuses_mixed_devices(card):
    calls = anchor_calls_from_dicts(EDGES["avg_integer"][0])
    t, _, _ = chain.upload_calls(calls, card)
    args = [t[k] for k in chain.CHAIN_DP_INPUTS]
    args[4] = args[4].cpu()
    with pytest.raises(ValueError, match="max_dist_x"):
        chain.chain_dp(*args)
