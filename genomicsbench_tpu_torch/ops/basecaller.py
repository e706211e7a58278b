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
"""

from __future__ import annotations

import torch

from genomicsbench_tpu_torch._kernels import check_device as _check_device
from genomicsbench_tpu_torch._kernels import check_tensor as _check
from genomicsbench_tpu_torch._kernels import launch as _launch

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
