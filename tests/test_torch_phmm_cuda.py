"""The pair-HMM CUDA kernel on the card, against its plain PyTorch version.
Every test needs an NVIDIA GPU (marker `cuda`) and skips without one.
Tolerance: none; both instances (float and double) follow the plain
version's operation order and must agree bit for bit.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_phmm_cuda.py
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.ops import pairhmm

from torch_phmm_cases import edge_cases, gen_phmm_workload, long_haplotype_case

pytestmark = pytest.mark.cuda
EDGES = edge_cases()
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _tables(reads, haps, pairs, dev):
    if pairs is None:
        pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    return pairhmm.upload_pairs(reads, haps, pairs, dev)


def _kernel_vs_plain(t, dtype, idx=None):
    got = pairhmm.pairhmm_forward(t, idx, dtype)
    want = pairhmm.pairhmm_forward_reference(t, idx, dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=False)
    return got


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("label", sorted(EDGES))
def test_edges_kernel_matches_plain(card, label, dtype):
    t = _tables(*EDGES[label], card)
    _kernel_vs_plain(t, dtype)
    rev = torch.arange(t.n_pairs - 1, -1, -1, device=card)
    _kernel_vs_plain(t, dtype, rev)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_main_workload_sample(card, dtype):
    """2,000 pairs of the main workload's generator."""
    reads, haps, pairs, _ = gen_phmm_workload(2000)
    got = _kernel_vs_plain(_tables(reads, haps, pairs, card), dtype)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_long_haplotype(card, dtype):
    """A 10,000-base haplotype: one warp per block in float32, device scratch
    in float64."""
    t = _tables(*long_haplotype_case(), card)
    _, _, scratch = pairhmm.phmm_launch(10_000, torch.empty((), dtype=dtype).element_size())
    assert scratch == (dtype == torch.float64)
    _kernel_vs_plain(t, dtype)


def test_batch_matches_cpu(card):
    """pairhmm_batch on the card equals it on the CPU, bit for bit, with one
    launch of each instance per call."""
    reads, haps, pairs, _ = gen_phmm_workload(600)
    before = dict(pairhmm.pairhmm_forward.launches)
    got = pairhmm.pairhmm_batch(reads, haps, pairs, device=card)
    after = pairhmm.pairhmm_forward.launches
    assert {k: after[k] - before[k] for k in after} == {torch.float32: 1, torch.float64: 1}
    np.testing.assert_array_equal(got, pairhmm.pairhmm_batch(reads, haps, pairs, device="cpu"))


def test_wrapper_refuses_mixed_devices(card):
    t = _tables(*EDGES["length1"], card)
    t.haps = t.haps.cpu()
    with pytest.raises(ValueError, match="haps"):
        pairhmm.pairhmm_forward(t)
