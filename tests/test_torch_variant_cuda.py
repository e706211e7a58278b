"""The nn-variant path on the card: PyTorch's CUDA LSTM and cuBLAS's
products in IEEE float32 (`full_f32`: cuDNN off, TF32 off), against the
plain versions and the CPU path.  Every test needs an NVIDIA GPU (marker
`cuda`) and skips without one.  The heads are held within the JAX
package's own tolerance, rtol 2e-5 and atol 2e-6
(tests/test_variant_caller.py:43), of the CPU path.  The LSTM layers and
the card's heads are held to the plain float32 versions on the card
(`bilstm_reference`, the reference forward) at that tolerance; where the
two float32 paths differ by more (the LSTM's hidden states carry the
rounding of 33 steps), each is held against float64 instead and the card's
error must be at most twice the plain version's: the tolerance is not
loosened.  cuDNN's float32 LSTM, even with its RNN flag at "ieee", fails
that rule (tools/variant_precision_probe.py), which is why the port runs
without it.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_variant_cuda.py
"""

import numpy as np
import pytest
import torch

import genomicsbench_tpu_torch.models.variant_caller as T
from genomicsbench_tpu_torch.models import basecaller as bc
from genomicsbench_tpu_torch.ops import grm
from genomicsbench_tpu_torch.oracle.grm import grm_oracle

from torch_grm_cases import rand_geno
from torch_variant_cases import count_inputs, jax_tree, normal_inputs

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-5, atol=2e-6)        # tests/test_variant_caller.py:43
CFGS = {"tiny": T.ClairConfig.tiny(), "full": T.ClairConfig()}


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("which", sorted(CFGS))
def test_card_matches_cpu_path(card, which):
    cfg = CFGS[which]
    state = T.params_from_jax(jax_tree(cfg, 5), cfg)
    rng = np.random.default_rng(6)
    batches = [count_inputs(rng, 300, cfg), normal_inputs(rng, 7, cfg),
               count_inputs(rng, 2, cfg, wide=True)]
    for group in (batches[:1], batches):        # int8 transport, then float32
        on_card = T.predict_batches(state, group, cfg, device=card)
        on_cpu = T.predict_batches(state, group, cfg, device="cpu")
        for a, b in zip(on_card, on_cpu):
            for name, ha, hb in zip(T.HEAD_NAMES, a, b):
                np.testing.assert_allclose(ha, hb, err_msg=name, **TOL)


def _held(got, plain, f64):
    """The card's float32 output against the plain float32 version within
    TOL, or, where they differ by more, its error against float64 at most
    twice the plain version's."""
    got, plain, f64 = (t.double().cpu().numpy() for t in (got, plain, f64))
    if np.allclose(got, plain, **TOL):
        return
    err, err_plain = np.abs(got - f64).max(), np.abs(plain - f64).max()
    assert err <= 2 * err_plain, (np.abs(got - plain).max(), err, err_plain)


@pytest.mark.parametrize("inputs", ["normal", "counts"])
@pytest.mark.parametrize("which", sorted(CFGS))
def test_lstm_against_reference_and_float64(card, which, inputs):
    cfg = CFGS[which]
    model = T.build_model(T.params_from_jax(jax_tree(cfg, 7), cfg), cfg, card)
    m64 = T.build_model(T.params_from_jax(jax_tree(cfg, 7), cfg), cfg, card).double()
    rng = np.random.default_rng(8)
    xs = normal_inputs(rng, 512, cfg) if inputs == "normal" else count_inputs(rng, 512, cfg,
                                                                             wide=True)
    x = torch.from_numpy(xs).to(card)
    h = x.reshape(512, cfg.seq_len, -1)
    with torch.inference_mode(), T.full_f32():
        for lstm, lstm64 in ((model.lstm1, m64.lstm1), (model.lstm2, m64.lstm2)):
            got = lstm(h)[0]
            _held(got, T.bilstm_reference(lstm, h), T.bilstm_reference(lstm64, h.double()))
            h = got
        heads, plain = model.packed(x), model.packed(x, reference=True)
    _held(heads, plain, m64.packed(x.double(), reference=True))


def test_precision_helper_restores_flags(card):
    rnn = torch.backends.cudnn.rnn
    saved = rnn.fp32_precision, torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        rnn.fp32_precision = "tf32"
        with T.full_f32():
            assert T.precision_state() == T.IEEE
            assert not torch.backends.cuda.matmul.allow_tf32
        assert T.precision_state() == dict(rnn="tf32", matmul="high", cudnn=True)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        rnn.fp32_precision = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_nn_variant_then_grm_and_basecaller(card):
    """An nn-variant call, then grm() (whose helper reads the legacy matmul
    flag) and a basecaller forward (cuDNN convs) in the same process."""
    cfg = CFGS["tiny"]
    state = T.init_params(cfg)
    x = count_inputs(np.random.default_rng(9), 64, cfg)
    before = T.precision_state()
    T.predict_batches(state, [x], cfg, device=card)
    assert T.precision_state() == before
    geno = rand_geno(np.random.default_rng(1), 2_000, 96)
    got, _ = grm.grm(geno)
    np.testing.assert_allclose(got, grm_oracle(geno)[0], rtol=2e-5, atol=2e-5)
    bcfg = bc.BasecallerConfig.tiny()
    model = bc.build_model(bc.init_params(bcfg), bcfg, card)
    sig = torch.randn(4, 3_000, device=card, generator=torch.Generator(device=card)
                      .manual_seed(2))
    prep = model.prepare()
    lp = bc.run_network(prep, sig, torch.float16)
    want = bc.run_network(prep, sig, torch.float16, reference=True)
    got_p, want_p = lp.float().exp(), want.float().exp()
    assert torch.isfinite(got_p).all()
    assert float((got_p - want_p).abs().max()) < 0.05
    T.predict_batches(state, [x], cfg, device=card)
    assert T.precision_state() == before
