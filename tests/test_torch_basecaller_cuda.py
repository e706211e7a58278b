"""The basecaller's CUDA kernels on the card, against their plain PyTorch
versions.  Every test needs an NVIDIA GPU (marker `cuda`) and skips without
one.  Tolerances: the depthwise conv bit for bit; the epilogue within one
bf16 ulp (its expf against torch.sigmoid's); the head's float16 log-probs
within one float16 ulp (its expf and logf against torch's log_softmax,
whose logits it equals bit for bit); whole forwards within JAX's own
crosscheck bound (posteriors 0.05, frame argmax above 0.98,
tests/test_fast5_and_weights.py:196-199).

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_basecaller_cuda.py
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.models import basecaller as bc
from genomicsbench_tpu_torch.ops import basecaller as ops

from torch_basecaller_cases import calibrated_tree, depthwise_shapes, mixed_signals

pytestmark = pytest.mark.cuda
FULL, TINY = bc.BasecallerConfig(), bc.BasecallerConfig.tiny()
_BF16 = torch.bfloat16


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def ulps(a, b):
    """Distance in units in the last place of two 16-bit float tensors."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("k,C", depthwise_shapes(FULL) + [(9, 64), (1, 2)])
@pytest.mark.parametrize("T_len", [1, 2, 3, 300, 6_000])
def test_depthwise_kernel_equals_plain(card, k, C, T_len):
    g = torch.Generator(device=card).manual_seed(k * 7 + C + T_len)
    x = torch.randn(3, T_len, C, device=card, generator=g).to(_BF16)
    w = (torch.randn(k, C, device=card, generator=g) * (2.0 / k) ** 0.5).to(_BF16)
    for stride in (1, 3):
        got = ops.depthwise_conv(x, w, stride)
        want = ops.depthwise_conv_reference(x, w, stride)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (3, (T_len - 1) // stride + 1, C)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (k, C, T_len, stride)


@pytest.mark.parametrize("mode", ["swish", "plain", "residual"])
@pytest.mark.parametrize("C", [344, 464, 48])
def test_epilogue_within_one_ulp(card, mode, C):
    g = torch.Generator(device=card).manual_seed(C)
    x = (torch.randn(4, 1_001, C, device=card, generator=g) * 3).to(_BF16)
    r = (torch.randn(4, 1_001, C, device=card, generator=g) * 3).to(_BF16)

    def rows():
        return ops.bn_params(1 + 0.2 * torch.randn(C, device=card, generator=g),
                             0.2 * torch.randn(C, device=card, generator=g),
                             0.5 * torch.randn(C, device=card, generator=g),
                             0.5 + 1.5 * torch.rand(C, device=card, generator=g))

    p, pr = rows(), rows()
    res = (r, pr) if mode == "residual" else (None, None)
    got = ops.bn_act(x, p, *res, swish=mode != "plain")
    want = ops.bn_act_reference(x, p, *res, swish=mode != "plain")
    torch.cuda.synchronize()
    d = ulps(got, want)
    assert int(d.max()) <= 1, (mode, C, int(d.max()), int((d > 0).sum()))
    if mode == "plain":
        assert torch.equal(got, want)


@pytest.mark.parametrize("T_len", [1, 2, 2_000])
def test_head_within_one_ulp(card, T_len):
    g = torch.Generator(device=card).manual_seed(T_len)
    x = (torch.randn(5, T_len, 48, device=card, generator=g) * 2).to(_BF16)
    w = (torch.randn(48, 5, device=card, generator=g) * 0.5).to(_BF16)
    got = ops.decoder_head(x, w)
    want = ops.decoder_head_reference(x, w)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float16
    assert int(ulps(got, want).max()) <= 1
    with pytest.raises(TypeError):      # the kernel writes float16 only
        ops.decoder_head(x, w, torch.float32)


def _posteriors_close(got, want):
    got, want = got.float().exp(), want.float().exp()
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert err < 0.05 and agree > 0.98, (err, agree)


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_forward_kernels_match_plain_forward(card, which):
    cfg = {"tiny": TINY, "full": FULL}[which]
    for params in (bc.init_params(cfg),
                   bc.params_from_jax(calibrated_tree(cfg, seed=3), cfg)):
        model = bc.build_model(params, cfg, card)
        x = torch.randn(8, 6_000, device=card, generator=torch.Generator(device=card)
                        .manual_seed(1))
        prep = model.prepare()
        got = bc.run_network(prep, x, torch.float16)
        want = bc.run_network(prep, x, torch.float16, reference=True)
        torch.cuda.synchronize()
        assert got.shape == (8, 2_000, 5) and torch.isfinite(got).all()
        _posteriors_close(got, want)


def test_basecall_on_card_matches_cpu(card):
    params = bc.params_from_jax(calibrated_tree(TINY, seed=4), TINY)
    sigs = list(mixed_signals(chunksize=3_000).values())
    kw = dict(chunksize=3_000, overlap=300, batch_size=4, normalize=True)
    on_card = bc._batched_posteriors(bc.build_model(params, TINY, card), sigs, **kw)
    on_cpu = bc._batched_posteriors(bc.build_model(params, TINY, "cpu"), sigs, **kw)
    for (p, n), (q, m) in zip(on_card, on_cpu):
        assert n == m and p.shape == q.shape
        finite = ~np.isnan(q).any(-1)
        assert np.array_equal(finite, ~np.isnan(p).any(-1))
        if finite.any():
            _posteriors_close(torch.from_numpy(np.log(p[finite])),
                              torch.from_numpy(np.log(q[finite])))
    counts = [f.launches for f in (ops.depthwise_conv, ops.bn_act, ops.decoder_head)]
    seqs = bc.basecall_signals(params, sigs, TINY, chunksize=3_000, device=card)
    n_batches = 1 + 6        # one batch of the 6 full chunks, one per short length
    per = (5, 7, 1)          # depthwise repeats, epilogues, heads of the tiny config
    assert [f.launches - c for f, c in zip((ops.depthwise_conv, ops.bn_act,
                                            ops.decoder_head), counts)] == \
        [n_batches * p for p in per]
    assert len(seqs) == len(sigs)
