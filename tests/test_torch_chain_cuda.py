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

from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts
from genomicsbench_tpu_torch.ops import chain

from torch_chain_cases import bench_chain_calls, call, edge_cases, lane_group_chain, load_golden

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


@pytest.mark.parametrize("direction", ["shortest_first", "longest_first"])
def test_reads_in_either_length_order(card, direction):
    """Reads handed over sorted by length either way: the kernel's own
    longest-first order is then the reversal or the identity."""
    dicts = sorted(bench_chain_calls(40, seed=5), key=lambda d: len(d["x"]),
                   reverse=direction == "longest_first")
    _kernel_vs_plain(dicts, {}, card)


def test_one_read(card):
    _kernel_vs_plain(bench_chain_calls(1, seed=6), {}, card)


def test_warp_of_uneven_reads(card):
    """Five reads, four of them one warp's: the longest of 200 main-path
    reads (about 2,000 anchors) and reads cut to 600, 40, 1 and 0 anchors,
    so three groups idle while the first walks on, and their last blocks
    are written back from their rings at different anchors."""
    src = sorted(bench_chain_calls(200, seed=7), key=lambda d: -len(d["x"]))[:5]
    dicts = [call(d["x"][:m], d["y"][:m], d["avg_qspan"]) for d, m in
             zip(src, (len(src[0]["x"]), 600, 40, 1, 0))]
    assert len(dicts[0]["x"]) > 1900 and [len(d["x"]) for d in dicts[1:]] == [600, 40, 1, 0]
    _kernel_vs_plain(dicts, {}, card)


@pytest.mark.parametrize("label", ["deep_window", "window128", "main"])
def test_ring_counts_match_model(card, label):
    """The kernel's count of candidates loaded and of those read past its
    ring (the C entry's optional `ring` output) equals the model's
    (`lane_group_chain`) read by read, with the outputs equal too."""
    dicts, kw = (bench_chain_calls(64), {}) if label == "main" else EDGES[label]
    calls = anchor_calls_from_dicts(dicts)
    t, ns, offs = chain.upload_calls(calls, card)
    args = [t[k] for k in chain.CHAIN_DP_INPUTS]
    opts = (kw.get("max_iter", 5000), kw.get("max_skip", 25), kw.get("is_cdna", False),
            kw.get("window") or 0)
    R, T = len(ns), int(offs[-1])
    order = torch.from_numpy(chain._launch_order(offs)).to(card)
    out = torch.empty((3, T), dtype=torch.int32, device=card)
    visited = torch.empty(R, dtype=torch.int64, device=card)
    ring = torch.zeros((R, 2), dtype=torch.int64, device=card)
    ptr = [a.data_ptr() for a in args]
    rc = _kernels.load().gb_chain_dp(
        *ptr[:3], order.data_ptr(), *ptr[3:], R, opts[0], opts[1], int(opts[2]), opts[3],
        chain._max_window(offs, opts[0], opts[3]), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), visited.data_ptr(), ring.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    got = lane_group_chain(*(a.cpu().numpy() for a in args), *opts)
    for g, w in zip(got[:3], out.cpu().numpy()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3], visited.cpu().numpy())
    np.testing.assert_array_equal(ring.cpu().numpy(),
                                  np.stack([got[4]["loaded"], got[4]["deep"]], 1))


def test_wrapper_refuses_a_window_past_shared_memory(card):
    """One read of 460,000 anchors at max_iter 1,000,000: its bitmap of
    max_skip marks would pass a block's shared memory, so the wrapper
    refuses it before any launch (the plain version takes it)."""
    n = 460_000
    x = (1000 + np.arange(n, dtype=np.uint64) * np.uint64(3))
    y = np.arange(n, dtype=np.uint64) * np.uint64(3) | (np.uint64(15) << np.uint64(32))
    calls = anchor_calls_from_dicts([call(x, y, 15.0)])
    t, _, offs = chain.upload_calls(calls, card)
    before = chain.chain_dp.launches
    with pytest.raises(ValueError, match="shared memory"):
        chain.chain_dp(*(t[k] for k in chain.CHAIN_DP_INPUTS), max_iter=1_000_000,
                       host_offs=offs)
    assert chain.chain_dp.launches == before
