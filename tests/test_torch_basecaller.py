"""The nn-base basecaller port (genomicsbench_tpu_torch.models.basecaller)
against the JAX package, on the CPU.

The same numpy inputs and weights (tests/torch_basecaller_cases.py) go
through the JAX function and the port's: the weights as the JAX params
pytree to JAX and through `params_from_jax` to the port.  Tolerances, each
with its reason:

* The three kernels' plain versions against JAX's XLA ops on the CPU.  The
  depthwise conv: XLA sums the k taps in another order than the plain
  version's increasing one, so an output may differ by one bf16 ulp where
  the two f32 sums round to different sides, and by the f32 sums' own
  error, 2k * 2^-24 * sum|x w|, where the taps cancel to near zero; every
  output is held to ulp + that error, and fewer than 0.1% may differ at
  all.  The epilogue likewise, its sums of up to four terms (BatchNorm's
  shift and bias, the residual branch's) cancelling where the output is
  near zero (XLA may contract a multiply-add into an FMA, and its sigmoid
  differs from torch's in the last f32 bit), fewer than 0.1% differing.  The head: bf16 logits
  equal, the f32 log-probs within 2^-20 relative (exp and log).
* One block at a time on the tiny config: its convs, BatchNorms and the
  residual sum add in other orders than XLA's, so an output may differ by
  one bf16 ulp, or where its sums cancel to near zero by one bf16 ulp of
  the block's mean output magnitude; fewer than 0.1% differ at all.
* Whole forwards (tiny config; full config at B 2, T 1,200) and the CLI:
  the bf16 differences compound over the layers, so JAX's own crosscheck
  bound holds them (tests/test_fast5_and_weights.py:196-199): posteriors
  within 0.05 absolute and frame argmax agreement above 0.98.
* The host functions (norm, chunk, stitch, greedy and quality decodes) and
  the beam search: exact.  The beam search's C++ copy (native/ctc.cpp)
  equals JAX's gb_ctc_beam_search, cut from the JAX package's native
  source and compiled with g++ -ffp-contract=off into a temporary
  directory (the JAX package's own native build races between test
  workers), and the port's plain version; JAX's Python loop, run with the
  JAX native library masked off, sums float32 frames in float32 under
  numpy 2 and is held to the same strings.

Nothing here calls the JAX package's native library: every JAX decode runs
with `genomicsbench_tpu.native.available` patched to False.
"""

import contextlib
import ctypes
import io
import pathlib
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomicsbench_tpu.models.basecaller as J
import genomicsbench_tpu.native as jax_native
from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.io.fast5 import read_fast5 as jax_read_fast5
from genomicsbench_tpu.io.fast5 import write_fast5 as jax_write_fast5

import genomicsbench_tpu_torch.models.basecaller as T
from genomicsbench_tpu_torch import native
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.io.fast5 import read_fast5, read_fast5_dir, write_fast5
from genomicsbench_tpu_torch.io.signals import load_signals
from genomicsbench_tpu_torch.ops import basecaller as ops

from torch_basecaller_cases import (bonito_state, calibrated_tree, depthwise_shapes, jax_tree,
                                    mixed_signals, peaked_posteriors)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY, FULL = T.BasecallerConfig.tiny(), T.BasecallerConfig()
JTINY, JFULL = J.BasecallerConfig.tiny(), J.BasecallerConfig()
POST_ABS, ARGMAX_AGREE = 0.05, 0.98       # tests/test_fast5_and_weights.py:196-199
jax_forward = jax.jit(J.forward, static_argnames=("cfg",))
_BF16 = torch.bfloat16


@pytest.fixture
def no_jax_native(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


def bf16(a):
    """A numpy array rounded to bf16, as a torch tensor."""
    return to_torch(a, _BF16)


def from_jax_bf16(a):
    return to_torch(jnp.asarray(a).astype(jnp.float32), _BF16)


def ordered(t):
    """bf16 bit patterns as integers in the order of the values."""
    b = t.view(torch.int16).int()
    return torch.where(b < 0, -32768 - b, b)


def bf16_ulp(v):
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8)


def assert_sums_close(got, want, depth, scale, what, max_share):
    """got, want: bf16 roundings of f32 sums of `depth` exact products in
    two orders; `scale` the f32 sums of |products|.  Each output within one
    bf16 ulp of the larger plus both sums' error, fewer than max_share
    differing.  Returns the number that differ."""
    a, b = got.float(), want.float()
    allowed = bf16_ulp(torch.maximum(a.abs(), b.abs())) + 2 * depth * 2.0 ** -24 * scale
    diff = (a - b).abs()
    n = int((ordered(got) != ordered(want)).sum())
    assert (diff <= allowed).all(), (what, float((diff - allowed).max()))
    assert n <= max_share * got.numel(), (what, n, got.numel())
    return n


def posteriors_close(got_lp, want_lp, what):
    got, want = np.exp(np.asarray(got_lp, np.float64)), np.exp(np.asarray(want_lp, np.float64))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # a read of constant signal normalises to NaN (MAD 0) in both packages
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    rows = ~np.isnan(want).any(-1)
    got, want = got[rows], want[rows]
    assert np.isfinite(got).all(), what
    if not got.size:
        return 0.0, 1.0
    err = np.abs(got - want).max()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert err < POST_ABS and agree > ARGMAX_AGREE, (what, err, agree)
    return err, agree


# ------------------------------------------------------- the kernels' plain versions
DW_CASES = ([(k, c, 1, 300) for k, c in depthwise_shapes(FULL)]
            + [(k, c, 1, 301) for k, c in depthwise_shapes(TINY)]
            + [(9, 64, 3, 301), (9, 64, 3, 2), (5, 64, 1, 1), (123, 64, 1, 122)])


@pytest.mark.parametrize("k,C,stride,T_len", DW_CASES)
def test_depthwise_plain_matches_jax(k, C, stride, T_len):
    rng = np.random.default_rng(k * 1000 + C + stride)
    x = rng.normal(size=(2, T_len, C)).astype(np.float32)
    w = (rng.normal(size=(k, 1, C)) * (2.0 / k) ** 0.5).astype(np.float32)
    want = from_jax_bf16(J._conv1d(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                                   stride, groups=C))
    xt, wt = bf16(x), bf16(w[:, 0, :])
    got = ops.depthwise_conv(xt, wt, stride)
    assert got.dtype == _BF16 and got.shape == want.shape
    assert got.shape[1] == ops.depthwise_out_len(T_len, k, stride) == (T_len - 1) // stride + 1
    scale = torch.nn.functional.conv1d(
        xt.abs().double().transpose(1, 2), wt.abs().double().T[:, None, :], stride=stride,
        padding=k // 2, groups=C).transpose(1, 2)
    assert_sums_close(got, want, k, scale, f"depthwise k {k} C {C}", 1e-3)


def _bn_rows(p):
    return ops.bn_params(*(to_torch(p[n]) for n in ("scale", "bias", "mean", "var")))


@pytest.mark.parametrize("mode", ["bn_swish", "bn_only", "residual"])
def test_epilogue_plain_matches_jax(mode):
    from torch_basecaller_cases import _bn

    rng = np.random.default_rng(3)
    C = 464
    x = np.asarray(jnp.asarray(rng.normal(0, 2, (2, 300, C)).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    r = np.asarray(jnp.asarray(rng.normal(0, 2, (2, 300, C)).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    p, pr = _bn(rng, C), _bn(rng, C)
    y = J._bn(jnp.asarray(x), jparams(p), False)
    if mode == "residual":
        y = y + J._bn(jnp.asarray(r), jparams(pr), False)
    if mode != "bn_only":
        y = J._swish(y)
    want = from_jax_bf16(y.astype(jnp.bfloat16))
    res = (bf16(r), _bn_rows(pr)) if mode == "residual" else (None, None)
    got = ops.bn_act(bf16(x), _bn_rows(p), *res, swish=mode != "bn_only")

    def magnitude(v, q):        # |(v - mean) * factor| + |bias| in float64
        rows = _bn_rows(q).double()
        return ((torch.from_numpy(np.array(v)).double() - rows[0]) * rows[1]).abs() + rows[2].abs()

    scale = magnitude(x, p) + (magnitude(r, pr) if mode == "residual" else 0)
    assert_sums_close(got, want, 4, scale, f"epilogue {mode}", 1e-3)


def test_head_plain_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 400, 48)).astype(np.float32)
    w = (rng.normal(size=(1, 48, 5)) * (2.0 / 48) ** 0.5).astype(np.float32)
    logits = J._conv1d(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    want = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1))
    xt, wt = bf16(x), bf16(w[0])
    # the plain version's logits: the same loop as decoder_head_reference
    acc = torch.zeros(3, 400, 5)
    for c in range(48):
        acc += xt.float()[..., c:c + 1] * wt.float()[c]
    assert torch.equal(acc.to(_BF16), from_jax_bf16(logits))
    got32 = ops.decoder_head(xt, wt, torch.float32).numpy()
    np.testing.assert_allclose(got32, want, rtol=2.0 ** -20, atol=2.0 ** -20)
    got16 = ops.decoder_head(xt, wt)
    assert got16.dtype == torch.float16
    assert torch.equal(got16, torch.from_numpy(got32).half())


def _jax_block(b, block, x):
    """The JAX package's `forward` loop body (models/basecaller.py:166-184)
    for one block, on a bf16 input."""
    inp = x
    for r in range(b.repeat):
        conv = block["convs"][r]
        stride = b.stride if r == 0 else 1
        xc = x.astype(jnp.bfloat16)
        if b.separable:
            x = J._conv1d(xc, conv["depth"], stride, groups=x.shape[-1])
            x = J._conv1d(x, conv["point"])
        else:
            x = J._conv1d(xc, conv["full"], stride)
        x = J._bn(x.astype(jnp.float32), block["bns"][r], False)
        if not (b.residual and r == b.repeat - 1):
            x = J._swish(x)
    if b.residual:
        res = J._conv1d(inp.astype(jnp.bfloat16), block["res_conv"])
        x = J._swish(x + J._bn(res.astype(jnp.float32), block["res_bn"], False))
    return x.astype(jnp.bfloat16)


def test_blocks_one_at_a_time_tiny():
    tree = jax_tree(TINY, seed=11)
    jp = jparams(tree)
    prep = T.build_model(T.params_from_jax(tree, TINY), TINY, "cpu").prepare()
    x = np.random.default_rng(12).normal(size=(2, 901, 1)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    counts = []
    for i, (b, entry) in enumerate(zip(JTINY.blocks, prep["blocks"])):
        want = _jax_block(b, jp["blocks"][i], xj)
        got = T.run_block(entry, from_jax_bf16(xj))
        assert got.shape == tuple(want.shape), (i, got.shape, want.shape)
        a, w = got.float(), from_jax_bf16(want).float()
        # one bf16 ulp of the element, or of the block's mean magnitude where
        # its sums cancel to near zero
        scale = torch.maximum(torch.maximum(a.abs(), w.abs()), w.abs().mean())
        counts.append(int((ordered(got) != ordered(from_jax_bf16(want))).sum()))
        assert ((a - w).abs() <= bf16_ulp(scale)).all(), (i, float((a - w).abs().max()))
        assert counts[-1] <= 1e-3 * a.numel(), (i, counts)
        xj = want                       # each block from JAX's own input
    logits = J._conv1d(xj, jp["decoder"])
    want = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1))
    got = ops.decoder_head(from_jax_bf16(xj), prep["decoder"], torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -20, atol=2.0 ** -20)


# ------------------------------------------------------------------ forwards
@pytest.mark.parametrize("which", ["tiny", "full"])
def test_forward_matches_jax(which):
    cfg, jcfg, shape = {"tiny": (TINY, JTINY, (3, 2_000)),
                        "full": (FULL, JFULL, (2, 1_200))}[which]
    tree = calibrated_tree(cfg, seed=21)
    x = np.random.default_rng(22).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_forward(jparams(tree), jnp.asarray(x), jcfg))
    model = T.build_model(T.params_from_jax(tree, cfg), cfg, "cpu")
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (shape[0], (shape[1] - 1) // 3 + 1, 5)
    posteriors_close(got.numpy(), want, which)
    half = T.run_network(model.prepare(), torch.from_numpy(x), torch.float16)
    assert half.dtype == torch.float16
    assert torch.equal(half, got.half())


def test_entry_conv_output_length():
    """floor((T + 8 - 9) / 3) + 1 frames for T not a multiple of 3, and the
    frames of JAX's entry conv (tests/test_fast5_and_weights.py pins it)."""
    tree = calibrated_tree(TINY, seed=2)
    model = T.build_model(T.params_from_jax(tree, TINY), TINY, "cpu")
    for n in (1, 2, 4, 10, 3001):
        x = np.random.default_rng(n).normal(size=(1, n)).astype(np.float32)
        got = model(torch.from_numpy(x))
        want = np.asarray(jax_forward(jparams(tree), jnp.asarray(x), JTINY))
        assert got.shape[1] == (n + 8 - 9) // 3 + 1 == want.shape[1], n
        posteriors_close(got.numpy(), want, f"T {n}")


# ------------------------------------------------------------------- weights
def test_params_from_jax_and_state_dict_import_agree():
    tree = jax_tree(TINY, seed=31)
    from_tree = T.params_from_jax(tree, TINY)
    state = bonito_state(tree, TINY)
    imported = T.import_torch_state_dict(state, TINY)
    assert set(imported) == set(from_tree)
    for k in from_tree:
        assert torch.equal(imported[k], from_tree[k]), k
    # the JAX package's import of the same state dict, leaf for leaf
    jp = J.import_torch_state_dict(state, JTINY)
    for i, block in enumerate(jp["blocks"]):
        for r, conv in enumerate(block["convs"]):
            if "depth" in conv:
                assert np.array_equal(np.asarray(conv["depth"])[:, 0, :],
                                      imported[f"blocks.{i}.depth.{r}"].numpy())
                assert np.array_equal(np.asarray(conv["point"])[0],
                                      imported[f"blocks.{i}.point.{r}"].numpy())
            else:
                assert np.array_equal(np.asarray(conv["full"]),
                                      imported[f"blocks.{i}.full.{r}"].numpy())
            for name in ("scale", "bias", "mean", "var"):
                assert np.array_equal(np.asarray(block["bns"][r][name]),
                                      imported[f"blocks.{i}.bns.{r}.{name}"].numpy())
        if "res_conv" in block:
            assert np.array_equal(np.asarray(block["res_conv"])[0],
                                  imported[f"blocks.{i}.res_conv"].numpy())
    assert np.array_equal(np.asarray(jp["decoder"])[0], imported["decoder"].numpy())
    # a weights tar round trip through torch.save / torch.load
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    again = T.import_torch_state_dict(torch.load(buf, map_location="cpu"), TINY)
    assert all(torch.equal(again[k], imported[k]) for k in imported)


@pytest.mark.parametrize("fault", ["shape", "leftover", "short"])
def test_state_dict_import_errors(fault):
    state = bonito_state(jax_tree(TINY, seed=32), TINY)
    keys = list(state)
    if fault == "shape":
        state[keys[0]] = torch.zeros(3, 3, 3)
        for imp, cfg in ((T.import_torch_state_dict, TINY), (J.import_torch_state_dict, JTINY)):
            with pytest.raises(ValueError, match="shape"):
                imp(state, cfg)
    elif fault == "leftover":
        state["extra.weight"] = torch.zeros(2)
        for imp, cfg in ((T.import_torch_state_dict, TINY), (J.import_torch_state_dict, JTINY)):
            with pytest.raises(ValueError, match="1 unconsumed"):
                imp(state, cfg)
    else:
        del state[keys[-1]]                 # the decoder
        with pytest.raises(ValueError, match="decoder conv"):
            T.import_torch_state_dict(state, TINY)
        with pytest.raises(StopIteration):  # the JAX package lets it escape
            J.import_torch_state_dict(state, JTINY)


def test_params_from_jax_checks_shapes():
    tree = jax_tree(TINY, seed=33)
    tree["decoder"] = np.zeros((1, 3, 5), np.float32)
    with pytest.raises(ValueError, match="decoder"):
        T.params_from_jax(tree, TINY)


def test_init_params_is_deterministic_with_jax_std():
    a = T.init_params(FULL)
    b = T.init_params(FULL, torch.Generator().manual_seed(0))
    c = T.init_params(FULL, torch.Generator().manual_seed(1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder"], c["decoder"])
    want = T.Basecaller(FULL).state_dict()
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape)
                                                         for k, v in want.items()}
    w = a["blocks.3.depth.1"]                        # k 123 over 456 channels, cin 1
    assert abs(float(w.std()) - (2.0 / 123) ** 0.5) < 0.01
    w = a["blocks.4.point.0"]                        # 456 -> 440
    assert abs(float(w.std()) - (2.0 / 456) ** 0.5) < 0.005
    assert torch.equal(a["blocks.2.bns.0.scale"], torch.ones(464))
    assert torch.equal(a["blocks.2.bns.0.var"], torch.ones(464))
    assert torch.equal(a["blocks.2.res_bn.mean"], torch.zeros(464))


# ------------------------------------------------------------ host functions
def test_normalisation_and_chunks_match_jax():
    sigs = list(mixed_signals().values())
    sigs.append(np.full(5_000, 7.0, np.float32))         # MAD 0: NaN, as in JAX
    for sig in sigs:
        got, want = T.norm_by_noisiest_section(sig), J.norm_by_noisiest_section(sig)
        assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
        assert T.med_mad(sig) == J.med_mad(sig)
        for cs, ov in ((3_000, 300), (6_000, 300), (1_000, 0), (0, 0)):
            a, b = T.chunk_signal(sig, cs, ov), J.chunk_signal(sig, cs, ov)
            assert a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def test_stitch_and_decodes_match_jax():
    rng = np.random.default_rng(41)
    for n_chunks, ov in ((1, 50), (2, 50), (5, 50), (3, 1)):
        preds = rng.random((n_chunks, 200, 5)).astype(np.float32)
        assert np.array_equal(T.stitch_posteriors(preds, ov), J.stitch_posteriors(preds, ov))
    probs = peaked_posteriors(3_000, seed=42)
    probs[100:103] = probs[99]                            # a repeated frame
    assert T.decode_with_quals(probs) == J.decode_with_quals(probs)
    assert T.decode_with_quals(probs, 0.8, 3.0) == J.decode_with_quals(probs, 0.8, 3.0)
    logp = np.log(rng.dirichlet(np.full(5, 0.3), (4, 500)) + 1e-9).astype(np.float32)
    logp[:, 10:14] = logp[:, 9:10]                        # repeats to collapse
    ids, n = T.greedy_decode(torch.from_numpy(logp))
    jids, jn = J.greedy_decode(jnp.asarray(logp))
    assert ids.dtype == torch.int32 and np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(n.numpy(), np.asarray(jn))


# --------------------------------------------------------------- beam search
@pytest.fixture(scope="module")
def jax_beam_search(tmp_path_factory):
    """gb_ctc_beam_search and its PrefixNode, cut from the JAX package's
    native source and compiled with -ffp-contract=off."""
    src = (ROOT / "genomicsbench_tpu" / "native" / "gbingest.cpp").read_text()
    node = re.search(r"namespace \{\n// child\[s-1\].*?\n\}\n", src, re.S)
    body = re.search(r"int64_t gb_ctc_beam_search\(.*?\n    return \(int64_t\)rev.size\(\);\n\}\n",
                     src, re.S)
    assert node and body, "gb_ctc_beam_search not found in the native source"
    d = tmp_path_factory.mktemp("jax_ctc")
    (d / "ctc.cpp").write_text("#include <algorithm>\n#include <cstdint>\n#include <vector>\n"
                               + node.group(0) + 'extern "C" {\n' + body.group(0) + "}\n")
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(d / "ctc.so"), str(d / "ctc.cpp")], check=True, timeout=120)
    fn = ctypes.CDLL(str(d / "ctc.so")).gb_ctc_beam_search
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_int64]

    def run(probs, beamsize, threshold=1e-3):
        probs = np.ascontiguousarray(probs, np.float32)
        out = np.empty(len(probs) + 1, np.int32)
        n = fn(probs.ctypes.data, len(probs), probs.shape[1], beamsize, threshold,
               out.ctypes.data, len(out))
        assert n >= 0
        return "".join(J.CTC_LABELS[int(s)] for s in out[:n])
    return run


def _tiny_posteriors():
    tree = calibrated_tree(TINY, seed=51)
    model = T.build_model(T.params_from_jax(tree, TINY), TINY, "cpu")
    x = torch.from_numpy(np.random.default_rng(52).normal(size=(1, 6_000)).astype(np.float32))
    return np.exp(model(x)[0].numpy())


@pytest.mark.parametrize("beamsize", [1, 2, 5, 10])
def test_beam_search_matches_jax(beamsize, jax_beam_search, no_jax_native):
    cases = [peaked_posteriors(4_000, seed=61), peaked_posteriors(500, seed=62),
             _tiny_posteriors(), np.zeros((0, 5), np.float32), np.full((50, 5), 0.2, np.float32)]
    for i, probs in enumerate(cases):
        got = T.beam_search_decode(probs, beamsize)
        assert got == T.beam_search_reference(probs, beamsize), (i, beamsize)
        assert got == jax_beam_search(probs, beamsize), (i, beamsize)
        if i < 3:
            # JAX's Python loop: not on the uniform frames, whose beams tie
            # exactly, so its float32 sums break the ties otherwise than
            # JAX's own C++ decoder (and the port) in float64
            assert got == J.beam_search_decode(probs, beamsize), (i, beamsize)
    assert len(T.beam_search_decode(cases[0], beamsize)) > 100


def test_beam_search_refuses_bad_input():
    with pytest.raises(ValueError):
        native.ctc_beam_search(np.zeros((4, 10), np.float32))
    with pytest.raises(ValueError):
        native.ctc_beam_search(np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        native.ctc_beam_search(np.zeros((4, 5), np.float32), beamsize=0)


# ------------------------------------------------------------------ pipeline
def _jax_decoders(posts, overlap, stride, beamsize):
    """JAX's stitch and decoders over (posteriors, signal length) pairs."""
    out = []
    for p, n in posts:
        st = J.stitch_posteriors(p, overlap // stride // 2)[: n // stride]
        out.append(J.beam_search_decode(st, beamsize) if beamsize > 1
                   else J.decode_with_quals(st))
    return out


def test_pipeline_matches_jax(no_jax_native):
    tree = calibrated_tree(TINY, seed=71)
    params = T.params_from_jax(tree, TINY)
    sigs = list(mixed_signals(chunksize=3_000).values())
    kw = dict(chunksize=3_000, overlap=300)
    model = T.build_model(params, TINY, "cpu")
    posts = T._batched_posteriors(model, sigs, batch_size=4, normalize=True, **kw)
    want = J._batched_posteriors(jparams(tree), sigs, JTINY, batch_size=4, normalize=True,
                                 **kw)
    assert [n for _, n in posts] == [n for _, n in want] == [len(s) for s in sigs]
    for i, ((p, _), (q, _)) in enumerate(zip(posts, want)):
        assert p.dtype == np.float32
        posteriors_close(np.log(p), np.log(q), f"read {i}")
    seqs = T.basecall_signals(params, sigs, TINY, batch_size=4, device="cpu", **kw)
    assert seqs == _jax_decoders(posts, 300, 3, 5)
    assert any(len(s) > 50 for s in seqs)
    quals = T.basecall_with_quals(params, sigs, TINY, batch_size=4, device="cpu", **kw)
    assert quals == _jax_decoders(posts, 300, 3, 1)
    greedy = T.basecall_signals(params, sigs, TINY, beamsize=1, batch_size=4, device="cpu",
                                **kw)
    # JAX's greedy decode over every read in one batch (its eager ops
    # compile once, not once per read length): each read padded with
    # all-blank frames, which a CTC decode drops
    st = [J.stitch_posteriors(p, 50)[: n // 3] for p, n in posts]
    blank = np.eye(1, st[0].shape[1], dtype=np.float32)
    padded = np.stack([np.concatenate([s, np.repeat(blank, max(map(len, st)) - len(s), 0)])
                       for s in st])
    ids, m = J.greedy_decode(jnp.log(padded + 1e-9))
    jgreedy = ["".join(J.CTC_LABELS[i] for i in row[:k])
               for row, k in zip(np.asarray(ids), np.asarray(m))]
    assert greedy == jgreedy
    stats = {}
    assert T.basecall_signals(params, sigs, TINY, batch_size=4, device="cpu", stats=stats,
                              **kw) == seqs
    assert set(stats) == {"normalize", "upload", "forward", "fetch", "stitch", "decode"}


# ----------------------------------------------------------------------- CLI
def _fastq(text):
    lines = text.strip().split("\n")
    assert len(lines) % 4 == 0
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    assert all(r[0].startswith("@") and r[2] == "+" and len(r[1]) == len(r[3]) for r in recs)
    return [(r[0][1:], r[1], r[3]) for r in recs]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A model directory with weights_0.tar (full-width random weights in
    bonito's layout), an .npz of 3 reads (one of 7,000 samples, three
    3,000-sample chunks, and two shorter than a chunk), and both
    packages' posteriors of those reads at --chunksize 3000, which are held
    within JAX's bound here, once."""
    d = tmp_path_factory.mktemp("nn_base")
    tree = calibrated_tree(FULL, seed=81)
    (d / "model").mkdir()
    torch.save(bonito_state(tree, FULL), str(d / "model" / "weights_0.tar"))
    rng = np.random.default_rng(82)
    sigs = {f"read_{i}": (90 + 15 * rng.standard_normal(n)).astype(np.float32)
            for i, n in enumerate((7_000, 2_000, 2_000))}
    np.savez(d / "signals.npz", **sigs)
    raws = list(sigs.values())
    model = T.build_model(T.params_from_jax(tree, FULL), FULL, "cpu")
    posts = T._batched_posteriors(model, raws, 3_000, 300, 64, True)
    jposts = J._batched_posteriors(jparams(tree), raws, JFULL, 3_000, 300, 64, True)
    for i, ((p, _), (q, _)) in enumerate(zip(posts, jposts)):
        posteriors_close(np.log(np.maximum(p, 1e-30)), np.log(np.maximum(q, 1e-30)),
                         f"cli read {i}")
    return d, sigs, posts


@pytest.mark.parametrize("beamsize", [5, 1])
def test_cli_matches_jax(cli_inputs, beamsize, no_jax_native):
    d, sigs, posts = cli_inputs
    args = ["nn-base", str(d / "model"), "--signals", str(d / "signals.npz"), "--chunksize",
            "3000", "--beamsize", str(beamsize)]
    out, err = _run(torch_cli_main, args + ["--device", "cpu", "--fastq"])
    jout, _ = _run(jax_cli_main, args)
    got, want = _fastq(out), _fastq(jout)
    assert [r[0] for r in got] == [r[0] for r in want] == list(sigs)
    assert "> loaded weights_0.tar" in err and "> completed reads: 3" in err
    assert re.search(r"> samples per second \d\.\dE[+-]\d+", err)
    # the port's FASTQ is what JAX's decoders give on the port's posteriors
    # (held within JAX's bound of JAX's own by the fixture)
    dec = _jax_decoders(posts, 300, 3, beamsize)
    if beamsize > 1:
        assert [r[1] for r in got] == dec
        assert all(r[2] == "I" * len(r[1]) for r in got)
    else:
        assert [(r[1], r[2]) for r in got] == dec


def test_cli_fast5_without_weights(tmp_path):
    """The positional form on a fast5 directory and a model directory with
    no weights: the deterministic random init at full width, the same
    FASTQ as the same signals from an .npz."""
    rng = np.random.default_rng(91)
    raws = {f"r{i}": rng.integers(300, 700, n).astype(np.int16)
            for i, n in enumerate((4_000, 900))}
    (tmp_path / "reads").mkdir()
    (tmp_path / "model").mkdir()
    write_fast5(tmp_path / "reads" / "batch0.fast5", raws)
    sigs = load_signals(tmp_path / "reads")
    np.savez(tmp_path / "s.npz", **sigs)
    out, err = _run(torch_cli_main, ["nn-base", str(tmp_path / "model"), str(tmp_path / "reads"),
                                     "--device", "cpu", "--chunksize", "3000"])
    assert "no weights_*.tar" in err
    got = _fastq(out)
    assert [r[0] for r in got] == ["r0", "r1"]
    again, _ = _run(torch_cli_main, ["nn-base", "--signals", str(tmp_path / "s.npz"),
                                     "--device", "cpu", "--chunksize", "3000"])
    assert again == out


# --------------------------------------------------------------------- fast5
def _single_read_fast5(path, rid, raw, attrs):
    import h5py

    with h5py.File(path, "w") as f:
        ch = f.create_group("UniqueGlobalKey/channel_id")
        for k, v in attrs.items():
            ch.attrs[k] = v
        g = f.create_group("Raw/Reads/Read_7")
        g.attrs["read_id"] = rid
        g.create_dataset("Signal", data=raw)


def test_fast5_layouts_match_jax(tmp_path):
    rng = np.random.default_rng(95)
    multi = {f"id{i}": (rng.integers(0, 2_000, 500 + i).astype(np.int16),
                        dict(offset=float(i), range=1_500.0 + i))
             for i in range(3)}
    write_fast5(tmp_path / "multi.fast5", multi)
    jax_write_fast5(tmp_path / "jax_multi.fast5", multi)
    _single_read_fast5(tmp_path / "single.fast5", "one", rng.integers(0, 2_000, 800)
                       .astype(np.int16), dict(digitisation=2048.0, offset=-3.0,
                                               range=1_200.0, sampling_rate=4_000.0))
    for name in ("multi.fast5", "jax_multi.fast5", "single.fast5"):
        got, want = list(read_fast5(tmp_path / name)), list(jax_read_fast5(tmp_path / name))
        assert [r.read_id for r in got] == [r.read_id for r in want]
        for a, b in zip(got, want):
            assert np.array_equal(a.signal, b.signal) and np.array_equal(a.raw, b.raw)
            assert (a.digitisation, a.offset, a.range, a.sample_rate) == \
                (b.digitisation, b.offset, b.range, b.sample_rate)
    by_file = load_signals(tmp_path / "single.fast5")
    assert list(by_file) == ["one"] and by_file["one"].dtype == np.float32
    by_dir = load_signals(tmp_path)
    assert sorted(by_dir) == ["id0", "id1", "id2", "one"]
    assert len(read_fast5_dir(tmp_path, limit=2)) == 2


def test_fast5_without_h5py_is_refused(tmp_path, monkeypatch):
    import genomicsbench_tpu_torch.io.fast5 as f5

    monkeypatch.setattr(f5, "fast5_available", lambda: False)
    with pytest.raises(RuntimeError, match="h5py"):
        load_signals(tmp_path)
