"""Training in the port (genomicsbench_tpu_torch.models.train, the train mode
of models/basecaller.py, the backward passes of ops/basecaller.py and
Clair's trainer in models/variant_caller.py) against the JAX package, on
the CPU.

Both packages take the same numpy inputs (tests/torch_train_cases.py) and
the same weights, the port through `params_from_jax`.  On the CPU the
port's backward passes are the kernels' plain versions.  Tolerances, each
with its reason:

* Function level, the depthwise conv's two gradients against `jax.vjp` of
  `_conv1d(..., groups=C)` on the same bf16 values: the f32 sums run in
  other orders than XLA's, so each output is held to one bf16 ulp plus
  both sums' error bound, 2 * depth * 2^-24 * sum|terms| (depth: k taps
  for the input gradient, B * T frames for the weight gradient), and fewer
  than 0.1% may differ by more than one ulp (`sums_close`).
* The train-mode epilogue's backward against `jax.vjp` of `_bn(train=True)`
  + the residual's + `_swish`: XLA differentiates the mean and the variance
  apart where the port uses the closed form, and sums in other orders; dx
  (and dres) as bf16 within one ulp plus 2 * (N + 8) * 2^-24 times the
  formula's magnitude |factor| (|g| + mean|g| + |xhat| mean|g xhat|)
  (`bn_bwd_scales`), fewer than 0.1% past one ulp; dscale and dbias, f32
  sums over N rows, within 2 * (N + 8) * 2^-24 * sum|terms|.
* The forward epilogue's output on batch statistics: as the eval-mode
  epilogue's test (tests/test_torch_basecaller.py), 4 terms.
* Model level (tiny config): the loss within 1e-4 relative (bf16
  activations rounded at the same points; the sums' orders differ); each
  gradient leaf within 3% relative L2 and a cosine above 0.999: an ulp of
  bf16 in one activation moves the next layers' sums, and the differences
  compound over the depth (the measured worst leaf is about 0.9%).
* Train steps: AdamW normalises each update, so a leaf moves by about lr a
  step whatever its gradient's size; after N steps every parameter is
  within 2 * N * lr of JAX's and the updates' cosine above 0.99; losses
  within 1e-3 relative.  The BatchNorm statistics take only the decay:
  (1 - lr * 1e-4) ** N times their start within 1e-6 relative, in both.
* Clair, float32 throughout: losses and gradients within 1e-4 relative
  (f32 sums in other orders), 8 Adam steps' parameters within 1e-4 of
  JAX's absolutely (an Adam step is lr in size whatever the gradient).
* Checkpoints: bit for bit, and a resumed step on the CPU equal to the
  uninterrupted one bit for bit (every CPU op here is deterministic).
* The card's checks of the two reductions (`kernel_sum_close` at the
  depth of each kernel's own order): f32 sums taken in that order, in
  numpy, pass them at the main path's sizes, and the same sums with one
  partial dropped or doubled fail them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import genomicsbench_tpu.models.basecaller as J
import genomicsbench_tpu.models.variant_caller as JV
from genomicsbench_tpu.models.train import make_train_step as jax_make_train_step
from genomicsbench_tpu.models.train import place_params
from genomicsbench_tpu.parallel.mesh import make_mesh, shard_batch

import genomicsbench_tpu_torch.models.basecaller as T
import genomicsbench_tpu_torch.models.variant_caller as V
from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.models import train as TR
from genomicsbench_tpu_torch.ops import basecaller as ops

from torch_basecaller_cases import depthwise_shapes
from torch_train_cases import (BN_ROWS, WG_TILE, agreement, bn_bwd_scales, bn_bwd_sums64,
                               bn_sums_depth, clair_batch, ctc_batch, input_grad_abs_sum,
                               kernel_sum_close, sums_close, train_launch_shapes,
                               wgrad_abs_sum, wgrad_depth, wgrad_sums64)

torch.set_num_threads(1)

TINY, FULL = T.BasecallerConfig.tiny(), T.BasecallerConfig()
JTINY = J.BasecallerConfig.tiny()
CTINY = V.ClairConfig.tiny()
_BF16 = torch.bfloat16
LR, WD = 1e-3, 1e-4
N_STEPS = 3


def from_jax(a, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t if dtype is None else t.to(dtype)


def bf16_pair(rng, shape, sd=1.0, loc=0.0):
    """A random array rounded to bf16: (jax bf16 array, torch bf16 tensor)."""
    a = jnp.asarray(rng.normal(loc, sd, shape).astype(np.float32)).astype(jnp.bfloat16)
    return a, from_jax(a, _BF16)


# ------------------------------------------------------- depthwise backward
DW_CASES = sorted(set(depthwise_shapes(FULL) + depthwise_shapes(TINY)))


@pytest.mark.parametrize("k,C", DW_CASES)
def test_depthwise_backward_matches_jax(k, C):
    rng = np.random.default_rng(k * 1009 + C)
    B, T_len = 2, 2 * k + 7
    xj, x = bf16_pair(rng, (B, T_len, C))
    gyj, gy = bf16_pair(rng, (B, T_len, C))
    wf = (rng.normal(size=(k, 1, C)) * (2.0 / k) ** 0.5).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: J._conv1d(a, b, 1, groups=C), xj, jnp.asarray(wf))
    dxj, dwj = vjp(gyj)
    w = torch.from_numpy(wf[:, 0, :]).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y = ops.depthwise_conv_train(xr, w)
    y.backward(gy)
    assert xr.grad.dtype == _BF16 and w.grad.dtype == torch.float32
    assert torch.equal(w.grad, w.grad.to(_BF16).float())      # bf16 values as f32
    wb = w.detach().to(_BF16)
    sums_close(xr.grad, from_jax(dxj), k, input_grad_abs_sum(gy, wb, T_len),
               f"input grad k {k} C {C}", 1e-3)
    sums_close(w.grad, from_jax(dwj)[:, 0, :], B * T_len, wgrad_abs_sum(x, gy, k),
               f"weight grad k {k} C {C}", 1e-3)
    # the input gradient is the conv of gy with the taps reversed, bit for bit
    assert torch.equal(xr.grad.view(torch.int16),
                       ops.depthwise_conv_reference(gy, wb.flip(0).contiguous())
                       .view(torch.int16))


@pytest.mark.parametrize("k,stride,T_len", [(9, 3, 31), (8, 1, 20), (6, 2, 1), (4, 1, 3)])
def test_depthwise_backward_other_shapes_on_cpu(k, stride, T_len):
    """The plain versions take what the card refuses (stride past 1, even
    k), as JAX does."""
    rng = np.random.default_rng(k + 10 * stride)
    C = 6
    xj, x = bf16_pair(rng, (2, T_len, C))
    wf = rng.normal(size=(k, 1, C)).astype(np.float32)
    yj, vjp = jax.vjp(lambda a, b: J._conv1d(a, b, stride, groups=C), xj, jnp.asarray(wf))
    gyj, gy = bf16_pair(rng, yj.shape)
    dxj, dwj = vjp(gyj)
    w = torch.from_numpy(wf[:, 0, :]).requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y = ops.depthwise_conv_train(xr, w, stride)
    assert y.shape == tuple(yj.shape)
    y.backward(gy)
    sums_close(xr.grad, from_jax(dxj), k, input_grad_abs_sum(gy, w.detach().to(_BF16), T_len,
                                                              stride), "input grad", 1e-3)
    sums_close(w.grad, from_jax(dwj)[:, 0, :], 2 * T_len,
               wgrad_abs_sum(x, gy, k, stride), "weight grad", 1e-3)


def test_card_refuses_other_strides_and_even_k():
    """On the card the backward takes stride 1 and odd k only, and says so
    before any build or launch (meta tensors take the card's path here)."""
    x = torch.zeros(1, 8, 4, dtype=_BF16, device="meta")
    for k, stride in ((9, 2), (8, 1), (4, 3)):
        w = torch.zeros(k, 4, device="meta")
        with pytest.raises(ValueError, match="stride 1 and an odd k"):
            ops.depthwise_conv_train(x, w, stride)
        with pytest.raises(ValueError, match="stride 1 and an odd k"):
            ops.depthwise_wgrad(x, x, k, stride)
        with pytest.raises(ValueError, match="stride 1 and an odd k"):
            ops.depthwise_input_grad(x, w.to(_BF16), 8, stride)


# ------------------------------------------------------- epilogue backward
def _jax_epilogue(res, swish):
    def f(x, r, sc, bi, rsc, rbi):
        z = J._bn(x, dict(scale=sc, bias=bi), True)
        if res:
            z = z + J._bn(r, dict(scale=rsc, bias=rbi), True)
        return J._swish(z) if swish else z
    return f


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_epilogue_vjp(args, dout, res, swish):
    out, vjp = jax.vjp(_jax_epilogue(res, swish), *args)
    return out, vjp(dout)


EP_CASES = sorted(set(train_launch_shapes(FULL)[1] + train_launch_shapes(TINY)[1]))


@pytest.mark.parametrize("C,res", EP_CASES + [(6, False)])
def test_epilogue_backward_matches_jax(C, res):
    rng = np.random.default_rng(C + 7 * res)
    B, T_len = 2, 150
    xj, x = bf16_pair(rng, (B, T_len, C), 2.0, 0.5)
    rj, r = bf16_pair(rng, (B, T_len, C), 3.0, -1.0)
    dj, dout = bf16_pair(rng, (B, T_len, C))
    vec = [rng.normal(m, 0.2, C).astype(np.float32) for m in (1, 0, 1, 0)]
    swish = C != 6                  # one case without Swish
    out_j, grads = _jax_epilogue_vjp((xj.astype(jnp.float32), rj.astype(jnp.float32),
                                      *map(jnp.asarray, vec)), dj.astype(jnp.float32),
                                     res, swish)
    sc, bi, rsc, rbi = (torch.from_numpy(v).requires_grad_(True) for v in vec)
    xr, rr = x.clone().requires_grad_(True), r.clone().requires_grad_(True)
    out = ops.bn_act_train(xr, sc, bi, *((rr, rsc, rbi) if res else ()), swish=swish)
    p = ops.bn_train_rows(x, sc.detach(), bi.detach())
    rp = ops.bn_train_rows(r, rsc.detach(), rbi.detach()) if res else None
    mag = ((x.double() - p[0].double()) * p[1].double()).abs() + p[2].double().abs()
    if res:
        mag = mag + ((r.double() - rp[0].double()) * rp[1].double()).abs() + rp[2].abs()
    sums_close(out, from_jax(out_j.astype(jnp.bfloat16), _BF16), 4, mag, "forward", 1e-3)
    out.backward(dout)
    N = B * T_len
    depth = N + 8
    dx_s, dres_s, sum_s = bn_bwd_scales(x, dout, p, r if res else None, rp, swish)
    sums_close(xr.grad, from_jax(grads[0].astype(jnp.bfloat16), _BF16), depth, dx_s, "dx", 1e-3)
    bound = 2 * depth * 2.0 ** -24
    for got, want, s in ((sc.grad, grads[2], sum_s[1]), (bi.grad, grads[3], sum_s[0])):
        assert ((got.double() - from_jax(want).double()).abs() <= bound * s).all()
    if res:
        sums_close(rr.grad, from_jax(grads[1].astype(jnp.bfloat16), _BF16), depth, dres_s,
                   "dres", 1e-3)
        for got, want, s in ((rsc.grad, grads[4], sum_s[2]), (rbi.grad, grads[5], sum_s[0])):
            assert ((got.double() - from_jax(want).double()).abs() <= bound * s).all()


def test_epilogue_backward_one_row_and_empty():
    """One row: the statistics are the row itself, xhat 0, so dx is 0 and
    dscale 0, as in JAX; and the wrappers take an empty batch."""
    x = torch.randn(1, 1, 8).to(_BF16)
    sc = torch.ones(8, requires_grad=True)
    bi = torch.zeros(8, requires_grad=True)
    xr = x.clone().requires_grad_(True)
    ops.bn_act_train(xr, sc, bi).backward(torch.ones(1, 1, 8, dtype=_BF16))
    assert float(xr.grad.float().abs().max()) == 0.0 and float(sc.grad.abs().max()) == 0.0
    _, vjp = jax.vjp(_jax_epilogue(False, True), jnp.asarray(x.float().numpy()),
                     jnp.zeros((1, 1, 8)), jnp.ones(8), jnp.zeros(8), jnp.ones(8), jnp.zeros(8))
    g = vjp(jnp.ones((1, 1, 8)))
    np.testing.assert_array_equal(np.asarray(g[3]), bi.grad.numpy())
    p = ops.bn_train_rows(torch.zeros(0, 8, dtype=_BF16), torch.ones(8), torch.zeros(8))
    dx, dres, sums = ops.bn_act_bwd(torch.zeros(0, 8, dtype=_BF16),
                                    torch.zeros(0, 8, dtype=_BF16), p)
    assert dx.shape == (0, 8) and dres is None and float(sums.abs().sum()) == 0.0


def _ordered_f32_sum(t: np.ndarray, rows: int) -> np.ndarray:
    """(G, C) float32 partials of (N, C) float32 terms, `rows` rows each,
    every sum taken in row order (numpy's float32 add.accumulate is
    sequential), as the card's kernels take them."""
    G = -(-t.shape[0] // rows)
    tp = np.zeros((G * rows,) + t.shape[1:], np.float32)
    tp[:t.shape[0]] = t
    return np.add.accumulate(tp.reshape((G, rows) + t.shape[1:]), axis=1,
                             dtype=np.float32)[:, -1]


def _faults(parts: np.ndarray, i: int):
    """The partials as they are, with partial i dropped and with it doubled."""
    dropped, doubled = parts.copy(), parts.copy()
    dropped[i] = 0
    doubled[i] *= 2
    return parts, dropped, doubled


@pytest.mark.parametrize("res", [False, True])
def test_bn_sums_check_holds_the_kernel_order_and_fails_a_fault(res):
    """gb_bc_bn_act_bwd's column sums at the main path's N 128,000: kBnRows
    rows in order into each partial, the partials in order, from the plain
    formula's f32 terms; a dropped or doubled partial of 256 rows fails."""
    N, C = 128_000, 8
    g = torch.Generator().manual_seed(11 + res)
    x = (torch.randn(N, C, generator=g) * 2 + 0.5).to(_BF16)
    r = (torch.randn(N, C, generator=g) * 3 - 1).to(_BF16)
    dout = torch.randn(N, C, generator=g).to(_BF16)
    sc, bi = 1 + 0.2 * torch.randn(C, generator=g), 0.2 * torch.randn(C, generator=g)
    p = ops.bn_train_rows(x, sc, bi)
    rr, rp = (r, ops.bn_train_rows(r, bi + 1, sc - 1)) if res else (None, None)
    xf = x.float()
    y = (xf - p[0]) * p[1] + p[2]
    if res:
        y = y + ((r.float() - rp[0]) * rp[1] + rp[2])
    s = torch.sigmoid(y)
    gt = dout.float() * (s * (1 + y * (1 - s)))
    terms = [gt, gt * ((xf - p[0]) * p[3])]
    if res:
        terms.append(gt * ((r.float() - rp[0]) * rp[3]))
    parts = [_ordered_f32_sum(t.numpy(), BN_ROWS) for t in terms]
    exact, mags, term_err = bn_bwd_sums64(x, dout, p, rr, rp)
    for i, case in enumerate(zip(*(_faults(pt, 123) for pt in parts))):
        got = torch.from_numpy(np.stack([_ordered_f32_sum(pt, len(pt))[0] for pt in case]))
        if i == 0:
            share = kernel_sum_close(got, exact, bn_sums_depth(N), mags, "in order", term_err)
            assert 0 < share < 1
        else:
            with pytest.raises(AssertionError, match="order bound"):
                kernel_sum_close(got, exact, bn_sums_depth(N), mags, "a fault", term_err)


def test_wgrad_check_holds_the_kernel_order_and_fails_a_fault():
    """gb_bc_depthwise_wgrad's sums at the main path's B 64 x T 2,000: at C
    2 and k 9 the layout gives a thread one item of kWgTile frames (the
    products exact, added in order), and the partials are added in item
    order, then rounded to bf16; a dropped or doubled item fails."""
    B, T_len, C, k = 64, 2_000, 2, 9
    g = torch.Generator().manual_seed(12)
    x = torch.randn(B, T_len, C, generator=g).to(_BF16)
    gy = torch.randn(B, T_len, C, generator=g).to(_BF16)
    depth = wgrad_depth(B, T_len, C, k)
    assert float(depth.max()) == WG_TILE + B * -(-T_len // WG_TILE)
    xp = torch.nn.functional.pad(x.float(), (0, 0, k // 2, k // 2)).numpy()
    gf = gy.float().numpy()
    parts = np.stack([np.concatenate([_ordered_f32_sum(xp[b, j:j + T_len] * gf[b], WG_TILE)
                                      for b in range(B)]) for j in range(k)], axis=1)
    exact, scale = wgrad_sums64(x, gy, k)
    for i, case in enumerate(_faults(parts, 100)):
        got = torch.from_numpy(_ordered_f32_sum(case, len(case))[0]).to(_BF16).float()
        if i == 0:
            share = kernel_sum_close(got, exact, depth, scale, "in order", bf16=True)
            assert 0 < share < 1
        else:
            with pytest.raises(AssertionError, match="order bound"):
                kernel_sum_close(got, exact, depth, scale, "a fault", bf16=True)


@pytest.mark.parametrize("fault", ["dtype", "rows", "dout_shape", "res_rows", "odd", "device"])
def test_backward_wrappers_check_inputs(fault, monkeypatch):
    """bn_act_bwd and depthwise_wgrad refuse what the kernels do not take,
    on the host, before any build or launch."""
    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    x = torch.randn(2, 10, 8).to(_BF16)
    p = ops.bn_train_rows(x, torch.ones(8), torch.zeros(8))
    err = ValueError
    if fault == "dtype":
        err, calls = TypeError, [lambda: ops.bn_act_bwd(x, x.float(), p),
                                 lambda: ops.depthwise_wgrad(x.float(), x, 3)]
    elif fault == "rows":
        calls = [lambda: ops.bn_act_bwd(x, x, p[:3].contiguous())]
    elif fault == "dout_shape":
        calls = [lambda: ops.bn_act_bwd(x, x[:, :5].contiguous(), p)]
    elif fault == "res_rows":
        calls = [lambda: ops.bn_act_bwd(x, x, p, x, None), lambda: ops.bn_act_bwd(x, x, p, None, p)]
    elif fault == "odd":
        calls = [lambda: ops.depthwise_wgrad(x[..., :7].contiguous(), x[..., :7].contiguous(), 3)]
    else:
        calls = [lambda: ops.bn_act_bwd(x, x.to("meta"), p),
                 lambda: ops.depthwise_wgrad(x, x.to("meta"), 3)]
    for call in calls:
        with pytest.raises(err):
            call()
    assert ops.bn_act_bwd(x, x, p, x, p)[1].shape == x.shape
    assert ops.depthwise_wgrad(x, x, 3).shape == (3, 8)


# ------------------------------------------------------------ model level
@pytest.fixture(scope="module")
def jax_init():
    """JAX's own init of the tiny config (make_train_step's init, key 0),
    as numpy leaves."""
    mesh = make_mesh(jax.devices()[:1])
    init, step = jax_make_train_step(JTINY, mesh)
    sig, _, _ = ctc_batch(8, 16, 0)
    params, opt = init(jax.random.key(0), jnp.asarray(sig))
    return mesh, step, params, opt, jax.tree_util.tree_map(np.asarray, params)


def _leaves(model):
    return dict(model.state_dict(keep_vars=True))


def _jax_flat(tree):
    """The JAX tree's leaves under the port's state-dict names."""
    out = {}
    for i, block in enumerate(tree["blocks"]):
        for r, conv in enumerate(block["convs"]):
            if "depth" in conv:
                out[f"blocks.{i}.depth.{r}"] = np.asarray(conv["depth"])[:, 0, :]
                out[f"blocks.{i}.point.{r}"] = np.asarray(conv["point"])[0]
            else:
                out[f"blocks.{i}.full.{r}"] = np.asarray(conv["full"])
            for n, v in block["bns"][r].items():
                out[f"blocks.{i}.bns.{r}.{n}"] = np.asarray(v)
        if "res_conv" in block:
            out[f"blocks.{i}.res_conv"] = np.asarray(block["res_conv"])[0]
            for n, v in block["res_bn"].items():
                out[f"blocks.{i}.res_bn.{n}"] = np.asarray(v)
    out["decoder"] = np.asarray(tree["decoder"])[0]
    return out


def test_ctc_loss_and_gradients_match_jax(jax_init):
    *_, tree = jax_init
    sig, labels, lens = ctc_batch(4, 16, 1, short=True)
    loss_j, grads_j = jax.jit(jax.value_and_grad(J.ctc_loss), static_argnames=("cfg",))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(sig), jnp.asarray(labels),
        jnp.asarray(lens), cfg=JTINY)
    model = T.Basecaller(TINY)
    model.load_state_dict(T.params_from_jax(tree, TINY))
    model.requires_grad_(True)
    loss = T.ctc_loss(model, sig, labels, lens)
    loss.backward()
    assert abs(float(loss) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    leaves, want = _leaves(model), _jax_flat(grads_j)
    for name, t in leaves.items():
        if name.endswith((".mean", ".var")):
            assert t.grad is None and not np.asarray(want[name]).any()   # zero in JAX too
            continue
        rel, cos = agreement(t.grad, torch.from_numpy(want[name]))
        assert rel < 0.03 and cos > 0.999, (name, rel, cos)


def test_ctc_gradient_at_the_logits_matches_optax():
    """F.ctc_loss on log_softmax against optax.ctc_loss, held at the logits
    (PyTorch's CTC backward is the true gradient only after log_softmax's)."""
    rng = np.random.default_rng(2)
    B, T_len, S = 3, 40, 9
    logits = rng.normal(0, 2, (B, T_len, 5)).astype(np.float32)
    labels = rng.integers(1, 5, (B, S)).astype(np.int32)
    lens = np.array([9, 4, 1], np.int32)
    labels[np.arange(S)[None, :] >= lens[:, None]] = 0

    def jax_loss(lg):
        pad = (jnp.arange(S)[None, :] >= lens[:, None]).astype(jnp.float32)
        return jnp.mean(optax.ctc_loss(jax.nn.log_softmax(lg, -1), jnp.zeros((B, T_len)),
                                       jnp.asarray(labels), pad, blank_id=0))

    lj, gj = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = T.ctc_loss_from_logp(torch.log_softmax(lt, -1), labels, lens)
    loss.backward()
    assert abs(float(loss) - float(lj)) <= 1e-5 * abs(float(lj))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-6)


def test_impossible_alignment_is_inf_where_optax_floors_it():
    """More labels than frames: F.ctc_loss gives inf (the port's choice,
    ROADMAP §3), optax a large finite loss from its log_epsilon floor."""
    B, T_len, S = 1, 4, 6
    logp = jax.nn.log_softmax(jnp.zeros((B, T_len, 5)), -1)
    labels = np.array([[1, 2, 3, 4, 1, 2]], np.int32)
    want = jax.jit(optax.ctc_loss, static_argnames=("blank_id",))(
        logp, jnp.zeros((B, T_len)), jnp.asarray(labels), jnp.zeros((B, S)), blank_id=0)
    assert np.isfinite(np.asarray(want)).all() and float(want[0]) > 1e4
    got = T.ctc_loss_from_logp(from_jax(logp), labels, np.array([S]))
    assert torch.isinf(got)


def test_train_steps_match_jax(jax_init):
    """N steps of the port's make_train_step against JAX's through a
    one-device mesh (tests/test_checkpoint.py:44-72): losses, parameters and
    the BatchNorm statistics' decay."""
    mesh, jstep, jparams, jopt, tree = jax_init
    sig, labels, lens = ctc_batch(8, 16, 0)
    init, step = TR.make_train_step(TINY, device="cpu")
    model, opt = init(T.params_from_jax(tree, TINY))
    with mesh:
        jp, jo = place_params(jparams, jopt, mesh)
        s, lab, ll = shard_batch(mesh, (jnp.asarray(sig), jnp.asarray(labels),
                                        jnp.asarray(lens)))
        for _ in range(N_STEPS):
            jp, jo, jloss = jstep(jp, jo, s, lab, ll)
            model, opt, loss = step(model, opt, sig, labels, lens)
            assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    want, start = _jax_flat(jax.tree_util.tree_map(np.asarray, jp)), _jax_flat(tree)
    decay = (1 - LR * WD) ** N_STEPS
    for name, t in _leaves(model).items():
        got, w, s0 = t.detach().double(), torch.from_numpy(want[name]).double(), \
            torch.from_numpy(start[name]).double()
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(got, s0 * decay, rtol=1e-6, atol=0)
            np.testing.assert_allclose(w, s0 * decay, rtol=1e-6, atol=0)
            continue
        assert float((got - w).abs().max()) <= 2 * N_STEPS * LR, name
        rel, cos = agreement(got - s0, w - s0)
        assert cos > 0.99, (name, rel, cos)


def test_tiny_training_converges():
    """As JAX's test_basecaller_ctc_training_converges: the loss falls below
    0.7 times its first value in 12 steps."""
    sig, labels, lens = ctc_batch(8, 16, 0)
    init, step = TR.make_train_step(TINY, device="cpu")
    model, opt = init()
    losses = []
    for _ in range(12):
        model, opt, loss = step(model, opt, sig, labels, lens)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses


def test_train_step_split_and_adamw_settings():
    sig, labels, lens = ctc_batch(2, 4, 3)
    init, step = TR.make_train_step(TINY, device="cpu", learning_rate=2e-3)
    model, opt = init()
    stats = {}
    step(model, opt, sig, labels, lens, stats=stats)
    assert set(stats) == {"forward", "loss", "backward", "optimizer"}
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (2e-3, (0.9, 0.999), 1e-8, 1e-4)
    assert len(g["params"]) == len(model.state_dict())      # every leaf, the statistics too


# ---------------------------------------------------------------- checkpoints
def _step_twice(tmp_path, init, step, batch):
    model, opt = init()
    model, opt, _ = step(model, opt, *batch)
    TR.save_checkpoint(tmp_path / "ck.pt", model, opt, step=1)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model, opt, loss2 = step(model, opt, *batch)
    back = TR.load_checkpoint(tmp_path / "ck.pt")
    assert back["step"] == 1 and set(back) == {"params", "opt_state", "step"}
    for k, v in saved.items():
        assert torch.equal(back["params"][k], v), k
    m2, o2 = init(back["params"], back["opt_state"])
    m2, o2, loss2b = step(m2, o2, *batch)
    assert torch.equal(loss2, loss2b)
    for (k, a), b in zip(model.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k


def test_basecaller_checkpoint_round_trip_and_resume(tmp_path):
    init, step = TR.make_train_step(TINY, device="cpu")
    _step_twice(tmp_path, init, step, ctc_batch(2, 8, 4))
    TR.save_checkpoint(tmp_path / "p.pt", T.init_params(TINY), step=7)
    back = TR.load_checkpoint(tmp_path / "p.pt")
    assert back["step"] == 7 and "opt_state" not in back
    for k, v in T.init_params(TINY).items():
        assert torch.equal(back["params"][k], v)


def test_clair_checkpoint_round_trip_and_resume(tmp_path):
    init, step = V.make_train_step(CTINY, device="cpu")
    _step_twice(tmp_path, init, step, clair_batch(CTINY, 8, 5))


# ---------------------------------------------------------------------- Clair
def _clair_jax_params(cfg, seed):
    return jax.tree_util.tree_map(np.asarray, JV.init_params(jax.random.key(seed), JV.ClairConfig(
        **{f: getattr(cfg, f) for f in ("lstm_units", "l3_units", "l4_units", "l5_units")})))


def _clair_flat(tree):
    return V.params_from_jax(tree, CTINY)


def test_focal_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, (16, 21)).astype(np.float32)
    target = np.zeros((16, 21), np.float32)
    target[np.arange(16), rng.integers(0, 21, 16)] = 1.0
    lj, gj = jax.jit(jax.value_and_grad(JV.focal_loss))(jnp.asarray(logits),
                                                        jnp.asarray(target))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = V.focal_loss(lt, torch.from_numpy(target))
    loss.backward()
    assert abs(float(loss) - float(lj)) <= 1e-5 * abs(float(lj))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("lr", [1e-3, 3e-3])
def test_clair_loss_gradients_and_adam_steps_match_jax(lr):
    """ClairConfig.tiny() (the config of tests/test_variant_caller.py:111-130
    too): clair_loss and its gradients, then 8 Adam steps, against JAX; the
    LSTMs' bias_hh stays zero and out of the optimizer."""
    jcfg = JV.ClairConfig.tiny()
    tree = _clair_jax_params(CTINY, 0)
    x, labels = clair_batch(CTINY, 32, 0)
    loss_j, grads_j = jax.jit(jax.value_and_grad(JV.clair_loss), static_argnames=("cfg",))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(labels),
        cfg=jcfg)
    init, step = V.make_train_step(CTINY, device="cpu", learning_rate=lr)
    model, opt = init(_clair_flat(tree))
    with V.full_f32():
        loss = V.clair_loss(model, torch.from_numpy(x), torch.from_numpy(labels))
        loss.backward()
    assert abs(float(loss) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    want = V.params_from_jax(jax.tree_util.tree_map(np.asarray, grads_j), CTINY)
    got = dict(model.state_dict(keep_vars=True))
    for name, t in got.items():
        if ".bias_hh_" in name:
            assert not t.requires_grad and t.grad is None
            continue
        np.testing.assert_allclose(t.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(want[name].abs().max()), err_msg=name)
    assert len(opt.param_groups[0]["params"]) == len(got) - 4         # bias_hh left out
    _, jstep = JV.make_train_step(jcfg, learning_rate=lr)
    jp, jo = jax.tree_util.tree_map(jnp.asarray, tree), optax.adam(lr).init(tree)
    model, opt = init(_clair_flat(tree))
    for _ in range(8):
        jp, jo, jl = jstep(jp, jo, jnp.asarray(x), jnp.asarray(labels))
        model, opt, loss = step(model, opt, x, labels)
        assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    want = V.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CTINY)
    for name, t in model.state_dict().items():
        if ".bias_hh_" in name:
            assert not t.any(), name
            continue
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_clair_full_width_step_matches_jax():
    """One step at the full ClairConfig on a batch of 8."""
    cfg, jcfg = V.ClairConfig(), JV.ClairConfig()
    tree = jax.tree_util.tree_map(np.asarray, JV.init_params(jax.random.key(1), jcfg))
    x, labels = clair_batch(cfg, 8, 1)
    loss_j, _ = jax.jit(jax.value_and_grad(JV.clair_loss), static_argnames=("cfg",))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(labels), cfg=jcfg)
    init, step = V.make_train_step(cfg, device="cpu")
    model, opt = init(V.params_from_jax(tree, cfg))
    _, _, loss = step(model, opt, x, labels)
    assert abs(float(loss) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
