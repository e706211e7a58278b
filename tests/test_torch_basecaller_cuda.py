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


def _depthwise_equal(card, B, T_len, C, k, stride, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(B, T_len, C, device=card, generator=g).to(_BF16)
    w = (torch.randn(k, C, device=card, generator=g) * (2.0 / k) ** 0.5).to(_BF16)
    got = ops.depthwise_conv(x, w, stride)
    want = ops.depthwise_conv_reference(x, w, stride)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, ops.depthwise_out_len(T_len, k, stride), C)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (B, T_len, C, k, stride)


@pytest.mark.parametrize("k", [123, 5])
@pytest.mark.parametrize("T_len", [ops.DW_TILE - 1, ops.DW_TILE, ops.DW_TILE + 1])
def test_depthwise_tile_edges(card, k, T_len):
    """Sequences one frame short of a tile, a whole tile, one frame past."""
    _depthwise_equal(card, 3, T_len, 464, k, 1, k + T_len)


@pytest.mark.parametrize("stride", [1, 3])
def test_depthwise_past_one_wave(card, stride):
    """More (batch row, tile) items per slab than the card holds blocks, so
    each block walks several items and double-buffers across them."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    B = 4 * sms + 3
    _depthwise_equal(card, B, 3 * ops.DW_TILE * stride + 7, 136, 33, stride, B + stride)


@pytest.mark.parametrize("k,stride", [(780, 1), (1_001, 1), (129, 1), (100, 7), (16, 7)])
def test_depthwise_taps_in_chunks(card, k, stride):
    """Taps past one chunk: k 780 (the largest the layout before chunks
    held at stride 1), 1,001 and 129 at stride 1, and stride 7, where the
    rows leave room for 10 taps a chunk."""
    assert ops.depthwise_tap_chunk(k, stride) < k
    _depthwise_equal(card, 2, 900, 72, k, stride, k)
    with pytest.raises(ValueError):
        ops.depthwise_conv(torch.zeros(1, 50, 64, dtype=_BF16, device=card),
                           torch.zeros(k, 64, dtype=_BF16, device=card), stride=8)


@pytest.mark.parametrize("C", [2, 6, 130, 464])
@pytest.mark.parametrize("N", [1, 3, 1_001, 100_003])
def test_epilogue_widths_and_rows(card, C, N):
    """C 2, 6 and 130 take 2 channels a thread, 464 takes 8; N odd, so the
    last step of a thread's two-row walk has one row."""
    g = torch.Generator(device=card).manual_seed(C * 7 + N)
    x = (torch.randn(N, C, device=card, generator=g) * 3).to(_BF16)
    r = (torch.randn(N, C, device=card, generator=g) * 3).to(_BF16)
    p = ops.bn_params(*(torch.rand(C, device=card, generator=g) + 0.5 for _ in range(4)))
    pr = ops.bn_params(*(torch.rand(C, device=card, generator=g) + 0.5 for _ in range(4)))
    for res, swish in (((None, None), True), ((r, pr), True), ((None, None), False)):
        got = ops.bn_act(x, p, *res, swish=swish)
        want = ops.bn_act_reference(x, p, *res, swish=swish)
        torch.cuda.synchronize()
        assert int(ulps(got, want).max()) <= (1 if swish else 0), (C, N, swish)


def test_epilogue_unaligned_rows(card):
    """A C of 464 whose tensors start 4 bytes past a 16-byte boundary: the
    2-channel width, equal to the 8-channel width's output."""
    g = torch.Generator(device=card).manual_seed(11)
    flat = (torch.randn(1_001 * 464 + 2, device=card, generator=g) * 3).to(_BF16)
    x = flat[2:].view(1_001, 464)
    assert x.data_ptr() % 16 == 4
    p = ops.bn_params(*(torch.rand(464, device=card, generator=g) + 0.5 for _ in range(4)))
    got = ops.bn_act(x, p)
    aligned = ops.bn_act(x.clone(), p)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    assert int(ulps(got, ops.bn_act_reference(x, p)).max()) <= 1


@pytest.mark.parametrize("C", [464, 6])
def test_epilogue_swish_far_below_zero(card, C):
    """Pre-Swish values y from -200 to 100, dense between -90 and -80 (each
    channel scales the bf16 inputs by its own f32 factor), and inputs of
    -1e4 and -3e38: where 1 + e^-y reaches 2^120 the kernel takes the
    sigmoid's reciprocal without the f32 division's slow path.  Its output
    equals y * (1 / (1 + exp(-y))) with the reciprocal rounded once to f32
    (in torch: exp in f32, the reciprocal in f64 rounded to f32, which is
    the f32 reciprocal rounded once) bit for bit, and is within one ulp of
    the plain version."""
    g = torch.Generator(device=card).manual_seed(C)
    near = torch.arange(0xC2A0, 0xC2B5, dtype=torch.int32).to(torch.int16).view(_BF16)
    x = torch.cat([near.float(), torch.linspace(-200, 100, 20_000),
                   torch.tensor([-1e4, -3e38, 0.0, -0.0])]).to(_BF16).to(card).repeat(11)
    x = x[:len(x) // C * C].view(-1, C)
    p = torch.stack([torch.zeros(C, device=card),
                     0.9 + 0.2 * torch.rand(C, device=card, generator=g),
                     torch.zeros(C, device=card)])
    got = ops.bn_act(x, p)
    y = (x.float() - p[0]) * p[1] + p[2]
    want = (y * (1.0 / (1.0 + torch.exp(-y)).double()).float()).to(_BF16)
    torch.cuda.synchronize()
    assert int((y < -83).sum()) > 1_000
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert int(ulps(got, ops.bn_act_reference(x, p)).max()) <= 1


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



@pytest.mark.parametrize("N", [1, 255, 257, 100_003])
@pytest.mark.parametrize("C,L", [(6, 1), (6, 5), (48, 3), (48, 5), (48, 8), (130, 1),
                                 (130, 6), (130, 8)])
@pytest.mark.parametrize("offset", [0, 1])
def test_head_tiles_widths_and_offsets(card, N, C, L, offset):
    """Frames past a tile's edge, widths whose rows are staged flat (6,
    130) or padded (48), label counts of each weight-row width (1, 3, 5-8),
    and x a view that starts an odd number of frames into its buffer (at C
    6 and 130 off the 16-byte grid)."""
    g = torch.Generator(device=card).manual_seed(N + 7 * C + L + offset)
    buf = (torch.randn((N + 1) * C, device=card, generator=g) * 2).to(_BF16)
    x = buf[offset * C:(offset + N) * C].view(1, N, C)
    w = (torch.randn(C, L, device=card, generator=g) * 0.5).to(_BF16)
    got = ops.decoder_head(x, w)
    want = ops.decoder_head_reference(x, w)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (1, N, L)
    assert int(ulps(got, want).max()) <= 1, (N, C, L, offset)

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
