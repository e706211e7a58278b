"""The nn-base basecaller's device passes in PyTorch: the depthwise conv, the
BatchNorm/Swish/residual epilogue and the decoder head.

The JAX package computes them inside `forward`
(genomicsbench_tpu/models/basecaller.py:158-186) as XLA ops: the depthwise
conv is `_conv1d(..., groups=C)` (:135), the epilogue `_bn` and `_swish`
(:144-155) with the residual sum, the head the decoder's 1x1 conv and
`log_softmax` (:185-186).  Each function here has two versions: on the
card the hand-written kernel of `csrc/basecaller.cu`, on the CPU the plain
PyTorch version beside it, which rounds where the kernel rounds.

* `depthwise_conv` (gb_bc_depthwise): (B, T, C) bf16 through (k, C) bf16
  taps, padding k // 2 both sides, stride s; the taps summed in increasing
  order in f32 from +0, rounded once to bf16.  The kernel fuses each tap
  into an FMA, the plain version multiplies and adds apart; they agree bit
  for bit because a product of two bf16 values is exact in f32 (see
  `depthwise_conv_reference`).
* `bn_act` (gb_bc_bn_act): eval BatchNorm `(x - mean) * factor + bias` in
  f32 from the bf16 conv output, optionally plus a second bf16 input
  through its own BatchNorm, optionally Swish `y * sigmoid(y)`, written as
  bf16 (every consumer of the JAX package's f32 activations casts them to
  bf16 first).  Within one bf16 ulp of the plain version: the kernel's
  expf may differ from torch.sigmoid's in the last f32 bit.
* `decoder_head` (gb_bc_head): (B, T, C) bf16 by (C, L) bf16 summed over C
  in increasing order in f32, rounded to bf16, then `log_softmax` in f32,
  in float16 (the inference transport, JAX `_forward_f16`).  The logits
  agree bit for bit; the log-probs within one float16 ulp.  The plain
  version also writes float32, for comparison with the JAX package's
  float32 `forward` on the CPU; the kernel writes float16 only.

`bn_params` turns a BatchNorm's (scale, bias, mean, var) into the (3, C)
rows (mean, factor, bias) the epilogue takes, factor = 1 / sqrt(var + eps) *
scale, as `_bn` forms `rsqrt(var + eps) * scale`.

Training (models/train.py) runs two of them under autograd, with backward
passes that are kernels too:
* `depthwise_conv_train`: the conv on the bf16 cast of an f32 weight.  Its
  input gradient is gb_bc_depthwise on the reversed taps (stride 1 and odd
  k, where k - 1 - k // 2 == k // 2), its weight gradient
  gb_bc_depthwise_wgrad (`depthwise_wgrad`): the f32 sums over (b, t) of x
  times the output gradient, by per-block partials and a fixed-order sum
  (two runs give the same bits), rounded once to bf16 as JAX's bf16 conv
  rounds its cotangent.  The card refuses other strides and even k with
  ValueError; the plain versions take any shape.
* `bn_act_train`: the epilogue on batch statistics (`bn_train_rows`: the
  population mean and variance of the f32 view, JAX's `_bn(train=True)`),
  its backward gb_bc_bn_act_bwd (`bn_act_bwd`): the statistics' share
  included, column sums by per-block partials and a fixed-order sum, then
  dx (and the residual's dres) as bf16.  With a `BatchGroup` (the
  data-parallel step) both take the statistics over every rank's rows, as
  GSPMD gives them to JAX: the forward combines the ranks' means and
  variances in two all-reduces, the backward runs gb_bc_bn_act_bwd_sums,
  all-reduces the sums and runs gb_bc_bn_act_bwd_apply with the global
  row count.  The
  scale and bias gradients stay the rank's own sums: the step's gradient
  average adds them over the ranks.
"""

from __future__ import annotations

import ctypes
import time

import torch
import torch.distributed as dist

from genomicsbench_tpu_torch._kernels import check_device as _check_device
from genomicsbench_tpu_torch._kernels import check_tensor as _check
from genomicsbench_tpu_torch._kernels import launch as _launch
from genomicsbench_tpu_torch._kernels import load as _load

_BF16, _F32, _F16 = torch.bfloat16, torch.float32, torch.float16
BN_EPS = 1e-5
# gb_bc_depthwise's tiling (csrc/basecaller.cu): output frames per item and
# channels per block; a block stages, in each of at least two buffers,
# (DW_TILE - 1) * stride + kc + 1 input rows of DW_SLAB bf16 channels (at
# stride 1 with a pad row after every 16), and kc taps as f32 (once, or one
# chunk per buffer where kc < k), kc at most DW_TAP_CHUNK
DW_TILE, DW_SLAB, DW_TAP_CHUNK = 256, 32, 128
SHARED_MAX = 232_448            # bytes of shared memory a Hopper block can opt in to
HEAD_MAX_LABELS = 8
HEAD_SHARED_MAX = 48 * 1024     # the head's f32 weights, without the opt-in


def depthwise_out_len(T: int, k: int, stride: int) -> int:
    """Output frames of a conv of width k with padding k // 2 both sides."""
    return max((T + 2 * (k // 2) - k) // stride + 1, 0)


def _dw_bytes(kc: int, k: int, stride: int) -> int:
    rows = (DW_TILE - 1) * stride + kc
    if stride == 1:
        rows += rows >> 4
    return 2 * (rows + 1) * DW_SLAB * 2 + (1 if kc == k else 2) * kc * DW_SLAB * 4


def depthwise_tap_chunk(k: int, stride: int) -> int:
    """The taps a gb_bc_depthwise block stages at once: all k up to
    DW_TAP_CHUNK, fewer where the stride's rows leave no room; 0 where not
    even one tap fits (csrc/basecaller.cu `dw_tap_chunk`)."""
    for kc in range(min(k, DW_TAP_CHUNK), 0, -1):
        if _dw_bytes(kc, k, stride) <= SHARED_MAX:
            return kc
    return 0


def depthwise_shared_bytes(k: int, stride: int) -> int:
    """The least shared memory of one gb_bc_depthwise block, at two buffers
    (at one tap a stage where no chunk fits, which is then more than
    SHARED_MAX).  The kernel adds buffers where two blocks an SM still fit."""
    return _dw_bytes(depthwise_tap_chunk(k, stride) or 1, k, stride)


# ------------------------------------------------------------ depthwise conv
def _check_depthwise(x, w, stride):
    _check("x", x, _BF16, 3)
    _check("w", w, _BF16, 2)
    _check_device(x.device, w)
    k, C = w.shape
    if x.shape[2] != C:
        raise ValueError(f"x has {x.shape[2]} channels, w {C}")
    if C % 2:
        raise ValueError(f"the depthwise conv takes an even channel count, got {C}")
    if k < 1 or stride < 1:
        raise ValueError(f"k and stride must be positive, got k {k}, stride {stride}")
    if not depthwise_tap_chunk(k, stride):
        raise ValueError(f"stride {stride} needs {depthwise_shared_bytes(k, stride)} bytes of "
                         f"shared memory for even one of the {k} taps, more than the "
                         f"{SHARED_MAX} a block can have")


def depthwise_conv_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The plain version of gb_bc_depthwise: the taps in increasing order,
    one f32 multiply and one f32 add each from +0, rounded once to bf16.

    The kernel computes each tap as fmaf(x, w, acc), rounding once where
    this rounds twice.  The two agree bit for bit: a bf16 value has 8
    significant bits, so the product of two has at most 16 and is exact in
    f32, and round(acc + x * w) is then the same either way.  They can
    differ only where a product is not exact: below 2^-134 in magnitude,
    past the last bit of f32's subnormal grid (2^-149), or past f32's range
    (tests/test_torch_basecaller.py `test_bf16_products_exact_in_f32`)."""
    B, T, C = x.shape
    k = w.shape[0]
    p = k // 2
    T_out = depthwise_out_len(T, k, stride)
    xp = torch.nn.functional.pad(x.float(), (0, 0, p, p))
    wf = w.float()
    acc = torch.zeros(B, T_out, C, dtype=_F32, device=x.device)
    if T_out:
        for j in range(k):
            acc += xp[:, j:j + (T_out - 1) * stride + 1:stride] * wf[j]
    return acc.to(_BF16)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, T, C) bf16 through the (k, C) bf16 taps with padding k // 2:
    (B, T_out, C) bf16.  Checks its inputs on the host before any build or
    launch; CPU tensors take the plain version, CUDA tensors one launch on
    the current stream, without synchronising."""
    _check_depthwise(x, w, stride)
    if x.device.type == "cpu":
        return depthwise_conv_reference(x, w, stride)
    B, T, C = x.shape
    k = w.shape[0]
    T_out = depthwise_out_len(T, k, stride)
    out = torch.empty(B, T_out, C, dtype=_BF16, device=x.device)
    if B and T_out:
        _launch(x.device, "gb_bc_depthwise", x.data_ptr(), w.data_ptr(), B, T, C, k, stride,
                T_out, out.data_ptr())
        depthwise_conv.launches += 1
    return out


depthwise_conv.launches = 0     # kernel launches, counted where they happen


# ------------------------------------------------------------------ epilogue
def bn_params(scale, bias, mean, var, eps: float = BN_EPS) -> torch.Tensor:
    """A BatchNorm's (3, C) f32 rows mean, factor, bias for `bn_act`."""
    factor = 1.0 / torch.sqrt(var.float() + eps) * scale.float()
    return torch.stack([mean.float(), factor, bias.float()]).contiguous()


def _check_bn_act(x, p, res, res_p):
    _check("x", x, _BF16, x.dim())
    if x.dim() < 2:
        raise ValueError("x must have a channel dimension")
    C = x.shape[-1]
    if C % 2:
        raise ValueError(f"the epilogue takes an even channel count, got {C}")
    _check("bn", p, _F32, 2)
    if tuple(p.shape) != (3, C):
        raise ValueError(f"bn must have shape (3, {C}), got {tuple(p.shape)}")
    if (res is None) != (res_p is None):
        raise ValueError("res and res_bn go together")
    if res is not None:
        _check("res", res, _BF16, x.dim())
        if res.shape != x.shape:
            raise ValueError(f"res has shape {tuple(res.shape)}, x {tuple(x.shape)}")
        _check("res_bn", res_p, _F32, 2)
        if tuple(res_p.shape) != (3, C):
            raise ValueError(f"res_bn must have shape (3, {C}), got {tuple(res_p.shape)}")
    _check_device(x.device, p, res, res_p)


def bn_act_reference(x, p, res=None, res_p=None, swish: bool = True) -> torch.Tensor:
    """The plain version of gb_bc_bn_act, one torch op per rounding."""
    y = (x.float() - p[0]) * p[1] + p[2]
    if res is not None:
        y = y + ((res.float() - res_p[0]) * res_p[1] + res_p[2])
    if swish:
        y = y * torch.sigmoid(y)
    return y.to(_BF16)


def bn_act(x: torch.Tensor, p: torch.Tensor, res: torch.Tensor | None = None,
           res_p: torch.Tensor | None = None, swish: bool = True) -> torch.Tensor:
    """act(bn(x) [+ bn_res(res)]) as bf16 of x's shape: x (..., C) bf16, p
    and res_p the (3, C) rows of `bn_params`.  CPU tensors take the plain
    version, CUDA tensors one launch."""
    _check_bn_act(x, p, res, res_p)
    if x.device.type == "cpu":
        return bn_act_reference(x, p, res, res_p, swish)
    out = torch.empty_like(x)
    C = x.shape[-1]
    N = x.numel() // C if C else 0
    if N and C:
        _launch(x.device, "gb_bc_bn_act", x.data_ptr(), p.data_ptr(),
                None if res is None else res.data_ptr(),
                None if res_p is None else res_p.data_ptr(), N, C, int(bool(swish)),
                out.data_ptr())
        bn_act.launches += 1
    return out


bn_act.launches = 0


# -------------------------------------------------------------- decoder head
def _check_head(x, w, out_dtype):
    _check("x", x, _BF16, 3)
    _check("w", w, _BF16, 2)
    _check_device(x.device, w)
    C, L = w.shape
    if x.shape[2] != C:
        raise ValueError(f"x has {x.shape[2]} channels, w {C}")
    if not 1 <= L <= HEAD_MAX_LABELS:
        raise ValueError(f"the head takes 1 to {HEAD_MAX_LABELS} labels, got {L}")
    if C * L * 4 > HEAD_SHARED_MAX:
        raise ValueError(f"the head's {C} x {L} weights pass {HEAD_SHARED_MAX} bytes")
    if out_dtype not in (_F16, _F32):
        raise TypeError(f"out_dtype must be float16 or float32, got {out_dtype}")
    if out_dtype != _F16 and x.device.type == "cuda":
        raise TypeError("the head kernel writes float16 log-probs; float32 ones come from "
                        "the plain version on CPU tensors")


def decoder_head_reference(x, w, out_dtype=_F16) -> torch.Tensor:
    """The plain version of gb_bc_head: the channels summed in increasing
    order in f32, rounded to bf16, log_softmax in f32, cast."""
    xf, wf = x.float(), w.float()
    acc = torch.zeros(*x.shape[:2], w.shape[1], dtype=_F32, device=x.device)
    for c in range(w.shape[0]):
        acc += xf[..., c:c + 1] * wf[c]
    return torch.log_softmax(acc.to(_BF16).float(), dim=-1).to(out_dtype)


def decoder_head(x: torch.Tensor, w: torch.Tensor, out_dtype=_F16) -> torch.Tensor:
    """(B, T, C) bf16 by (C, L) bf16 to (B, T, L) log-probs in `out_dtype`.
    CPU tensors take the plain version (float16 or float32), CUDA tensors
    one launch (float16 only)."""
    _check_head(x, w, out_dtype)
    if x.device.type == "cpu":
        return decoder_head_reference(x, w, out_dtype)
    B, T, C = x.shape
    L = w.shape[1]
    out = torch.empty(B, T, L, dtype=out_dtype, device=x.device)
    if B * T:
        _launch(x.device, "gb_bc_head", x.data_ptr(), w.data_ptr(), B * T, C, L,
                out.data_ptr())
        decoder_head.launches += 1
    return out


decoder_head.launches = 0


# ------------------------------------------------------------------ training
# The train step's passes (models/train.py): the depthwise conv and the
# train-mode epilogue as autograd Functions whose backwards are kernels too.
# JAX differentiates its XLA convs itself (models/basecaller.py:135-186), so
# these replace no TPU kernel; the port needs them because its forwards are
# hand-written and autograd cannot see through a ctypes launch.
BN_BWD_GROUPS = 264             # gb_bc_bn_act_bwd: blocks of the column sums, at most
BN_BWD_MAX_ROWS = 1 << 24       # N as f32 is exact


def bn_bwd_scratch_floats(N: int, C: int, nsum: int) -> int:
    """The floats of gb_bc_bn_act_bwd_sums' partials: one (nsum, C) row a
    block down the rows, at most min(N, BN_BWD_GROUPS) blocks."""
    return min(N, BN_BWD_GROUPS) * nsum * C


def _check_aligned(*tensors) -> None:
    for t in tensors:
        if t is not None and t.device.type == "cuda" and t.data_ptr() % 4:
            raise ValueError("the backward kernels read bf16 pairs: every tensor must start "
                             "4-byte aligned")


def _check_train_depthwise(k: int, stride: int) -> None:
    """The card's backward takes stride 1 and odd k only: the input gradient
    is then the conv of the output gradient with the taps reversed (k - 1 -
    k // 2 == k // 2), and the output has the input's T frames."""
    if stride != 1 or k % 2 == 0:
        raise ValueError(f"the depthwise conv's backward on the card takes stride 1 and an odd "
                         f"k, got stride {stride}, k {k}")


def depthwise_input_grad_reference(gy: torch.Tensor, w: torch.Tensor, T: int,
                                   stride: int = 1) -> torch.Tensor:
    """The plain version of the depthwise conv's input gradient: (B, T, C)
    bf16 from the (B, T_out, C) bf16 output gradient through the (k, C) bf16
    taps.  At stride 1 and odd k it is `depthwise_conv_reference` of gy on
    the reversed taps, the kernel's own order (bit for bit with the card);
    at any other shape each tap's products are scattered back in increasing
    tap order in f32 and rounded once, as JAX's conv transpose takes any."""
    k = w.shape[0]
    if stride == 1 and k % 2:
        return depthwise_conv_reference(gy, w.flip(0).contiguous())
    B, T_out, C = gy.shape
    p = k // 2
    acc = torch.zeros(B, T + 2 * p, C, dtype=_F32, device=gy.device)
    gf, wf = gy.float(), w.float()
    if T_out:
        for j in range(k):
            acc[:, j:j + (T_out - 1) * stride + 1:stride] += gf * wf[j]
    return acc[:, p:p + T].to(_BF16)


def depthwise_input_grad(gy: torch.Tensor, w: torch.Tensor, T: int,
                         stride: int = 1) -> torch.Tensor:
    """The depthwise conv's input gradient, (B, T, C) bf16.  CUDA tensors:
    one gb_bc_depthwise launch on the reversed taps (stride 1 and odd k
    only, else ValueError before any launch); CPU tensors the plain version
    at any shape."""
    if gy.device.type == "cpu":
        return depthwise_input_grad_reference(gy, w, T, stride)
    _check_train_depthwise(w.shape[0], stride)
    if gy.shape[1] != T:
        raise ValueError(f"the output gradient has {gy.shape[1]} frames, the input {T}")
    return depthwise_conv(gy, w.flip(0).contiguous())


def depthwise_wgrad_reference(x: torch.Tensor, gy: torch.Tensor, k: int,
                              stride: int = 1) -> torch.Tensor:
    """The plain version of gb_bc_depthwise_wgrad: dw (k, C), for each tap
    the f32 sum over (b, t) of x[b, t * stride + j - k // 2, c] * gy[b, t, c]
    (zero past both ends), rounded once to bf16 and returned as f32, as the
    JAX package's bf16 conv gives a bf16 cotangent that `astype` carries
    back to the f32 weight.  The products are exact in f32; the sums run in
    torch's order, not the kernel's."""
    B, T, C = x.shape
    p = k // 2
    T_out = gy.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, p, p))
    gf = gy.float()
    dw = torch.zeros(k, C, dtype=_F32, device=x.device)
    if T_out:
        for j in range(k):
            dw[j] = (xp[:, j:j + (T_out - 1) * stride + 1:stride] * gf).sum((0, 1))
    return dw.to(_BF16).float()


def _check_wgrad(x, gy, k):
    _check("x", x, _BF16, 3)
    _check("gy", gy, _BF16, 3)
    _check_device(x.device, gy)
    if x.shape[2] % 2:
        raise ValueError(f"the depthwise conv takes an even channel count, got {x.shape[2]}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")


def depthwise_wgrad(x: torch.Tensor, gy: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """The depthwise conv's weight gradient, (k, C) f32 of bf16 values, from
    its input x (B, T, C) bf16 and output gradient gy (B, T_out, C) bf16.
    CUDA tensors: one gb_bc_depthwise_wgrad call (per-block partial sums
    into a scratch buffer, then their sum in a fixed order: two runs give
    the same bits, those of `wgrad_schedule` in tests/torch_train_cases.py),
    stride 1 and odd k only, else ValueError before any
    launch; CPU tensors the plain version at any shape."""
    if x.device.type != "cpu":
        _check_train_depthwise(k, stride)
    _check_wgrad(x, gy, k)
    if x.device.type == "cpu":
        return depthwise_wgrad_reference(x, gy, k, stride)
    if gy.shape != x.shape:
        raise ValueError(f"gy has shape {tuple(gy.shape)}, x {tuple(x.shape)}")
    _check_aligned(x, gy)
    B, T, C = x.shape
    out = torch.empty(k, C, dtype=_F32, device=x.device)
    floats = ctypes.c_int64(0)
    err = _load().gb_bc_depthwise_wgrad_scratch(B, T, C, k, ctypes.byref(floats))
    if err:
        raise RuntimeError(f"gb_bc_depthwise_wgrad_scratch failed with cudaError {err}")
    part = torch.empty(max(floats.value, 1), dtype=_F32, device=x.device)
    _launch(x.device, "gb_bc_depthwise_wgrad", x.data_ptr(), gy.data_ptr(), B, T, C, k,
            part.data_ptr(), floats.value, out.data_ptr())
    depthwise_wgrad.launches += 1
    return out


depthwise_wgrad.launches = 0


class _DepthwiseConvFn(torch.autograd.Function):
    """`depthwise_conv` on the bf16 cast of an f32 weight (JAX's
    `w.astype(x.dtype)`), with the two gradients above."""

    @staticmethod
    def forward(ctx, x, w, stride, reference):
        wb = w.to(_BF16).contiguous()
        ctx.save_for_backward(x, wb)
        ctx.stride, ctx.reference, ctx.T = stride, reference, x.shape[1]
        return (depthwise_conv_reference if reference else depthwise_conv)(x, wb, stride)

    @staticmethod
    def backward(ctx, gy):
        x, wb = ctx.saved_tensors
        gy = gy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (depthwise_input_grad_reference if ctx.reference else depthwise_input_grad)(
                gy, wb, ctx.T, ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = (depthwise_wgrad_reference if ctx.reference else depthwise_wgrad)(
                x, gy, wb.shape[0], ctx.stride)
        return dx, dw, None, None


def depthwise_conv_train(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                         reference: bool = False) -> torch.Tensor:
    """The depthwise conv under autograd: x (B, T, C) bf16, w (k, C) f32 (a
    trained weight, cast to bf16 inside).  CUDA tensors run the kernels
    forward and backward, at stride 1 and odd k only (ValueError before any
    launch); `reference` takes the plain versions on any device."""
    if x.device.type != "cpu" and not reference:
        _check_train_depthwise(w.shape[0], stride)
    return _DepthwiseConvFn.apply(x, w, stride, reference)


class BatchGroup:
    """The ranks a train-mode BatchNorm takes its statistics over: every
    rank of the torch.distributed process group `group`, each holding as
    many rows (models/train.py's data-parallel step checks the split).
    `seconds`, a dict or None: where a dict, each all-reduce is waited for
    on both sides and its seconds added under its name ("bn forward
    all_reduce", "bn backward all_reduce")."""

    def __init__(self, group, seconds: dict | None = None):
        self.group, self.seconds = group, seconds
        self.ranks = dist.get_world_size(group)

    def all_reduce(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """t summed over the ranks, in place."""
        timed = self.seconds is not None
        if timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        if timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return t


def bn_train_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = BN_EPS, group: BatchGroup | None = None) -> torch.Tensor:
    """The batch statistics of x (..., C) bf16 over every row, from its f32
    view, the variance a population one (JAX's `jnp.mean` and `jnp.var` over
    (B, T) in `_bn(train=True)`, :144-151), as (4, C) f32 rows mean, factor,
    bias, inv with inv = 1 / sqrt(var + eps) and factor = inv * scale; the
    first three are `bn_act`'s rows.  With `group`, over every rank's rows:
    each rank's mean and variance (torch.var_mean, as one card takes them)
    combined with equal weights w = 1 / ranks, mean = sum w mean_r and var =
    sum w (var_r + (mean_r - mean)^2), each sum one all_reduce (Chan et
    al.'s pairwise combination).  At one rank w is 1 and the rows are the
    one-card rows bit for bit; JAX's two passes over the global batch
    (sums, then centred squares) round otherwise, and the full-depth
    network at random weights amplifies a last-bit change of the
    statistics into gradients far past the train step's checks."""
    xf = x.reshape(-1, x.shape[-1]).float()
    var, mean = torch.var_mean(xf, dim=0, correction=0)
    if group is not None:
        w = 1.0 / group.ranks
        local = mean
        mean = group.all_reduce(local * w, "bn forward all_reduce")
        d = local - mean
        var = group.all_reduce((var + d * d) * w, "bn forward all_reduce")
    inv = 1.0 / torch.sqrt(var + eps)
    return torch.stack([mean, inv * scale.float(), bias.float(), inv]).contiguous()


def _check_bn_bwd(x, dout, p, res, res_p):
    _check_bn_act(x, p[:3], res, None if res_p is None else res_p[:3])
    for name, rows in (("bn", p), ("res_bn", res_p)):
        if rows is not None and tuple(rows.shape) != (4, x.shape[-1]):
            raise ValueError(f"{name} must have shape (4, {x.shape[-1]}), got "
                             f"{tuple(rows.shape)}")
    _check("dout", dout, _BF16, x.dim())
    if dout.shape != x.shape:
        raise ValueError(f"dout has shape {tuple(dout.shape)}, x {tuple(x.shape)}")
    _check_device(x.device, dout)


def _means(sums: torch.Tensor, n: int) -> torch.Tensor:
    # a tensor divisor: torch on the card multiplies by the reciprocal of a
    # scalar one, where the kernel divides
    return sums / torch.full_like(sums, float(n))


def bn_act_bwd_reference(x, dout, p, res=None, res_p=None, swish: bool = True,
                         group: BatchGroup | None = None):
    """The plain version of gb_bc_bn_act_bwd, one torch op per rounding:
    (dx, dres or None, sums), sums (2 or 3, C) f32 = sum g, sum g * xhat and
    with res sum g * rhat, where g = dout * swish'(y) (dout without Swish), y
    the forward's pre-Swish value recomputed, xhat = (x - mean) * inv; dx =
    factor * ((g - mean g) - xhat * mean(g * xhat)) as bf16, dres likewise
    with the residual's rows.  p and res_p the (4, C) rows of
    `bn_train_rows`.  With `group` the means are of the sums all-reduced
    over its ranks, by the global row count; the sums returned stay this
    rank's."""
    C = x.shape[-1]
    xf = x.reshape(-1, C).float()
    y = (xf - p[0]) * p[1] + p[2]
    if res is not None:
        rf = res.reshape(-1, C).float()
        y = y + ((rf - res_p[0]) * res_p[1] + res_p[2])
    g = dout.reshape(-1, C).float()
    if swish:
        s = torch.sigmoid(y)
        g = g * (s * (1 + y * (1 - s)))
    xh = (xf - p[0]) * p[3]
    parts = [g.sum(0), (g * xh).sum(0)]
    if res is not None:
        rh = (rf - res_p[0]) * res_p[3]
        parts.append((g * rh).sum(0))
    sums = torch.stack(parts)
    if group is None:
        mean = _means(sums, xf.shape[0])
    else:
        mean = _means(group.all_reduce(sums.clone(), "bn backward all_reduce"),
                      xf.shape[0] * group.ranks)
    gc = g - mean[0]
    dx = (p[1] * (gc - xh * mean[1])).to(_BF16).reshape(x.shape)
    dres = None
    if res is not None:
        dres = (res_p[1] * (gc - rh * mean[2])).to(_BF16).reshape(x.shape)
    return dx, dres, sums


def bn_act_bwd(x: torch.Tensor, dout: torch.Tensor, p: torch.Tensor,
               res: torch.Tensor | None = None, res_p: torch.Tensor | None = None,
               swish: bool = True, group: BatchGroup | None = None):
    """The train-mode epilogue's backward, the statistics' share included:
    (dx, dres or None, sums) as `bn_act_bwd_reference` gives them.  CUDA
    tensors: one gb_bc_bn_act_bwd call (column sums by per-block partials
    and a fixed-order final sum, no float atomics, then the apply pass), or
    with `group` gb_bc_bn_act_bwd_sums, the sums all-reduced over the group
    and gb_bc_bn_act_bwd_apply with the global row count; CPU tensors the
    plain version.  The sums returned are this rank's own."""
    _check_bn_bwd(x, dout, p, res, res_p)
    if x.device.type == "cpu":
        return bn_act_bwd_reference(x, dout, p, res, res_p, swish, group)
    _check_aligned(x, dout, res)
    C = x.shape[-1]
    N = x.numel() // C if C else 0
    total = N if group is None else N * group.ranks
    if total >= BN_BWD_MAX_ROWS:
        raise ValueError(f"the backward epilogue takes fewer than {BN_BWD_MAX_ROWS} rows, got "
                         f"{total}")
    nsum = 2 if res is None else 3
    sums = torch.zeros(nsum, C, dtype=_F32, device=x.device)
    dx = torch.empty_like(x)
    dres = None if res is None else torch.empty_like(res)
    if N and C:
        part = torch.empty(bn_bwd_scratch_floats(N, C, nsum), dtype=_F32, device=x.device)
        ins = (x.data_ptr(), dout.data_ptr(), None if res is None else res.data_ptr(),
               p.data_ptr(), None if res_p is None else res_p.data_ptr(), N, C,
               int(bool(swish)))
        outs = (dx.data_ptr(), None if dres is None else dres.data_ptr())
        if group is None:
            _launch(x.device, "gb_bc_bn_act_bwd", *ins, part.data_ptr(), part.numel(),
                    sums.data_ptr(), *outs)
        else:
            _launch(x.device, "gb_bc_bn_act_bwd_sums", *ins, part.data_ptr(), part.numel(),
                    sums.data_ptr())
            summed = group.all_reduce(sums.clone(), "bn backward all_reduce")
            _launch(x.device, "gb_bc_bn_act_bwd_apply", *ins, summed.data_ptr(), total, *outs)
        bn_act_bwd.launches += 1
    elif group is not None:         # the other ranks' all-reduce waits for this one's
        group.all_reduce(sums.clone(), "bn backward all_reduce")
    return dx, dres, sums


bn_act_bwd.launches = 0


class _BnActTrainFn(torch.autograd.Function):
    """`bn_act` on batch statistics, with `bn_act_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, res, res_scale, res_bias, swish, reference, group):
        p = bn_train_rows(x, scale, bias, group=group)
        rp = None if res is None else bn_train_rows(res, res_scale, res_bias, group=group)
        out = (bn_act_reference if reference else bn_act)(
            x, p[:3], res, None if rp is None else rp[:3], swish)
        ctx.save_for_backward(x, p, res, rp)
        ctx.swish, ctx.reference, ctx.group = swish, reference, group
        return out

    @staticmethod
    def backward(ctx, dout):
        x, p, res, rp = ctx.saved_tensors
        bwd = bn_act_bwd_reference if ctx.reference else bn_act_bwd
        # the scale and bias gradients are this rank's own sums: the step's
        # gradient average adds them over the ranks, so the group's sums
        # would count them once per rank
        dx, dres, sums = bwd(x, dout.contiguous(), p, res, rp, ctx.swish, ctx.group)
        if res is None:
            return dx, sums[1], sums[0], None, None, None, None, None, None
        return dx, sums[1], sums[0], dres, sums[2], sums[0].clone(), None, None, None


def bn_act_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 res: torch.Tensor | None = None, res_scale: torch.Tensor | None = None,
                 res_bias: torch.Tensor | None = None, swish: bool = True,
                 reference: bool = False, group: BatchGroup | None = None) -> torch.Tensor:
    """JAX's `_bn(x, p, train=True)` (:144-151), optionally plus the residual
    branch's own train-mode BatchNorm, optionally `_swish`, as bf16, under
    autograd: x (and res) (..., C) bf16, scale and bias (C,) f32.  No running
    statistics are kept (JAX reads none back).  CUDA tensors run
    gb_bc_bn_act forward and gb_bc_bn_act_bwd backward; CPU tensors, or
    `reference`, the plain versions.  With `group` (a `BatchGroup`) the
    statistics are over every rank's rows."""
    return _BnActTrainFn.apply(x, scale, bias, res, res_scale, res_bias, swish, reference,
                               group)
