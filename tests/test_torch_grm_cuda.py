"""The grm CUDA kernels on the card, against their plain PyTorch versions
and the float64 oracle.  Every test needs an NVIDIA GPU (marker `cuda`)
and skips without one.  gb_grm_standardize and gb_grm_finish equal their
plain versions bit for bit (the same f32 operations in the same order, no
FMA); grm() on the card is held within the JAX package's rtol/atol 2e-5
of the float64 oracle (tests/test_grm.py:25), its pair counts exactly.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_grm_cuda.py
"""

import numpy as np
import pytest
import torch

import genomicsbench_tpu_torch.ops.grm as T
from genomicsbench_tpu_torch.oracle.grm import grm_oracle

from torch_grm_cases import EDGE_BLOCK, bench_grm, edge_cases, rand_geno

pytestmark = pytest.mark.cuda
EDGES = edge_cases()


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _planes(dev, geno, maf):
    pk = torch.from_numpy(T.pack_genotypes(geno)).to(dev)
    ok = torch.from_numpy(T.maf_filter(geno, maf)).to(dev)
    return pk, ok


@pytest.mark.parametrize("case", sorted(EDGES) + ["bench"])
def test_standardize_and_finish_bit_for_bit(card, case):
    geno, maf = EDGES[case] if case != "bench" else (bench_grm(4_096, 2_504), 0.01)
    pk, ok = _planes(card, geno, maf)
    x, w = T.grm_standardize(pk, ok)
    rx, rw = T.grm_standardize_reference(pk, ok)
    assert torch.equal(_bits(x), _bits(rx)) and torch.equal(_bits(w), _bits(rw))
    num, den = x.T @ x, w.T @ w
    N = geno.shape[1]
    assert torch.equal(_bits(T.grm_finish(num, den, N)),
                       _bits(T.grm_finish_reference(num, den, N)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("N", list(range(1, 10)) + list(range(127, 132)) + [255, 256, 257,
                                                                            2_504])
def test_finish_at_alignment_edges(card, N):
    """gb_grm_finish against its plain version, bit for bit, at N whose rows
    start at every residue of a 16-byte vector and across the 128-sample
    padding, num and den at the padded width (den with zeros: max(den, 1))."""
    Nb = -(-N // T.SAMPLE_PAD) * T.SAMPLE_PAD
    gen = torch.Generator(device=card).manual_seed(N)
    num = torch.randn(Nb, Nb, generator=gen, device=card) * 300.0
    den = torch.randint(0, 100_001, (Nb, Nb), generator=gen, device=card).float()
    den[torch.rand(Nb, Nb, generator=gen, device=card) < 0.01] = 0.0
    got = T.grm_finish(num, den, N)
    assert got.shape == (2, N * (N + 1) // 2)
    assert torch.equal(_bits(got), _bits(T.grm_finish_reference(num, den, N)))


@pytest.mark.parametrize("case", sorted(EDGES))
def test_grm_on_card_matches_oracle(card, case):
    geno, maf = EDGES[case]
    got, nobs = T.grm(geno, maf=maf, block=EDGE_BLOCK, device="cuda")
    want, want_n = grm_oracle(geno, maf=maf)
    np.testing.assert_array_equal(nobs, want_n)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    cpu, cpu_n = T.grm(geno, maf=maf, block=EDGE_BLOCK, device="cpu")
    np.testing.assert_array_equal(nobs, cpu_n)
    np.testing.assert_allclose(got, cpu, rtol=2e-5, atol=2e-5)


def test_launch_counts(card):
    geno = rand_geno(np.random.default_rng(0), 300, 50)
    T.grm_standardize.launches = T.grm_finish.launches = 0
    T.grm(geno, block=EDGE_BLOCK)
    assert (T.grm_standardize.launches, T.grm_finish.launches) == (3, 1)
    T.grm(geno[:0], block=EDGE_BLOCK)             # no variant: no standardise launch
    assert (T.grm_standardize.launches, T.grm_finish.launches) == (3, 2)


def test_products_run_without_tf32(card):
    """grm turns TF32 off around its products and restores the caller's
    setting; with TF32 on outside, the result still meets the bound."""
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        with T.full_f32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
        geno = rand_geno(np.random.default_rng(1), 2_000, 96)
        got, _ = T.grm(geno)
        np.testing.assert_allclose(got, grm_oracle(geno)[0], rtol=2e-5, atol=2e-5)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("fault", ["device", "dtype", "shape", "contiguity"])
def test_wrappers_refuse_on_the_card(card, fault):
    geno = rand_geno(np.random.default_rng(2), 20, 40)
    pk, ok = _planes(card, geno, 0.01)
    num = torch.zeros(128, 128, device=card)
    err = ValueError
    if fault == "device":
        calls = [lambda: T.grm_standardize(pk, ok.cpu()), lambda: T.grm_finish(num, num.cpu(), 4)]
    elif fault == "dtype":
        err, calls = TypeError, [lambda: T.grm_standardize(pk.int(), ok),
                                 lambda: T.grm_finish(num.double(), num, 4)]
    elif fault == "shape":
        calls = [lambda: T.grm_standardize(pk, ok[:10]), lambda: T.grm_finish(num, num, 200)]
    else:
        calls = [lambda: T.grm_standardize(pk[:, ::2], ok),
                 lambda: T.grm_finish(num.t()[:, :64], num[:, :64], 4)]
    before = T.grm_standardize.launches, T.grm_finish.launches
    for call in calls:
        with pytest.raises(err):
            call()
    assert (T.grm_standardize.launches, T.grm_finish.launches) == before
