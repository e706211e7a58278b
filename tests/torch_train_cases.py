"""Inputs and checks of the training tests and of chip_smoke.py's train phases.

Plain numpy and torch: either package takes these, and the card's machine
(which has no JAX) runs them.

* `ctc_batch`: a synthetic signal -> label task (tests/test_checkpoint.py
  :56-60): labels of 1..4, each label's level (label - 2.5) held for
  `hold` samples plus normal noise of sd 0.1, from a seed.  At 125 labels
  and hold 48 a chunk is 6,000 samples, the inference path's chunk size.
* `clair_batch`: tests/test_variant_caller.py:111-130's Clair task: normal
  inputs and one one-hot class per head.
* `train_launch_shapes`: the (k, C) of every depthwise conv and the (C,
  residual) of every epilogue of a config, in forward order.
* The tolerances' yardsticks, in float64: `wgrad_sums64` (each weight
  gradient's sum and sum of |x * gy|; `wgrad_abs_sum` the latter),
  `input_grad_abs_sum` (each input gradient's sum of |gy * w|),
  `bn_bwd_scales` (the backward epilogue's magnitudes) and `bn_bwd_sums64`
  (its column sums, their terms' magnitudes and the terms' f32 error);
  `sums_close`, the check that holds a bf16 rounding of an f32 sum to
  another taken in a different order; `kernel_sum_close`, the check that
  holds a kernel's f32 sums to the float64 ones at the depth of the
  kernel's own order (`wgrad_depth`, `bn_sums_depth`: csrc/basecaller.cu's
  partitions); `ulps`, `bf16_ulp` and `agreement` (relative L2 error and
  cosine of two gradients).
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 2.0 ** -24        # f32's unit roundoff


def ctc_batch(B: int, L: int, seed: int, hold: int = 48, short: bool = False):
    """(signal (B, L * hold) f32, labels (B, L) int32, label_lens (B,)
    int32).  With `short`, rows past the first carry fewer labels (0
    padding past label_lens; the signal keeps the padded labels' levels)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, 5, size=(B, L)).astype(np.int32)
    sig = np.repeat(labels.astype(np.float32) - 2.5, hold, axis=1)
    sig += rng.normal(0, 0.1, sig.shape).astype(np.float32)
    lens = np.full((B,), L, np.int32)
    if short:
        lens[1:] = rng.integers(1, L + 1, B - 1)
        labels[np.arange(L)[None, :] >= lens[:, None]] = 0
    return sig.astype(np.float32), labels, lens


def clair_batch(cfg, B: int, seed: int):
    """(x (B, seq_len, rows, channels) f32, labels (B, sum(head_sizes)) f32
    one-hot per head)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, cfg.seq_len, cfg.rows, cfg.channels)).astype(np.float32)
    labels = np.zeros((B, sum(cfg.head_sizes)), np.float32)
    offs = np.cumsum((0,) + tuple(cfg.head_sizes))[:-1]
    for b in range(B):
        for o, hs in zip(offs, cfg.head_sizes):
            labels[b, o + rng.integers(0, hs)] = 1.0
    return x, labels


def train_launch_shapes(cfg):
    """([(k, C)] of the depthwise convs, [(C, residual)] of the epilogues),
    one entry per launch of a forward, in order."""
    dw, ep, cin = [], [], cfg.features_in
    for b in cfg.blocks:
        c = cin
        for r in range(b.repeat):
            if b.separable:
                dw.append((b.kernel, c))
            ep.append((b.filters, b.residual and r == b.repeat - 1))
            c = b.filters
        cin = b.filters
    return dw, ep


# ------------------------------------------------------------ yardsticks
def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8)


def ordered(t: torch.Tensor) -> torch.Tensor:
    """16-bit float bit patterns as integers in the order of the values."""
    b = t.view(torch.int16).int()
    return torch.where(b < 0, -32768 - b, b)


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (ordered(a) - ordered(b)).abs()


def wgrad_sums64(x: torch.Tensor, gy: torch.Tensor, k: int, stride: int = 1):
    """((k, C), (k, C)) float64: for each tap, the sum over (b, t) of
    x[b, t * stride + j - k // 2] * gy[b, t], and the sum of the products'
    magnitudes.  The products of bf16 values are exact; the float64 sums
    err by at most B * T * 2^-53 of the magnitudes."""
    p = k // 2
    xp = torch.nn.functional.pad(x.double(), (0, 0, p, p))
    g = gy.double()
    T_out = gy.shape[1]
    out = torch.zeros(2, k, x.shape[2], dtype=torch.float64, device=x.device)
    for j in range(k):
        prod = xp[:, j:j + (T_out - 1) * stride + 1:stride] * g
        out[0, j] = prod.sum((0, 1))
        out[1, j] = prod.abs_().sum((0, 1))
    return out[0], out[1]


def wgrad_abs_sum(x: torch.Tensor, gy: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """(k, C) float64: for each tap, the sum over (b, t) of |x[b, t * stride
    + j - k // 2] * gy[b, t]|."""
    return wgrad_sums64(x, gy, k, stride)[1]


# gb_bc_depthwise_wgrad's partition (csrc/basecaller.cu `wg_layout`: kSlab,
# kWgTaps, kWgLanes, kWgTile, kWgBlocks) and gb_bc_bn_act_bwd's (kBnRows)
WG_SLAB, WG_TAPS, WG_LANES, WG_TILE, WG_BLOCKS = 32, 8, 16, 256, 528
BN_ROWS = 256


def wgrad_depth(B: int, T: int, C: int, k: int) -> torch.Tensor:
    """(k, 1) float64: the roundings in gb_bc_depthwise_wgrad's sum of each
    tap's products at stride 1, in its own order.  A thread adds the
    frames of its items in order (one FMA a frame, the product exact): at
    most ceil(items / (groups * splits)) items of min(T, kWgTile) frames;
    then the groups * splits partials are added in order, of which at most
    `items` are not zero (adding a zero is exact)."""
    chunk = WG_TAPS * WG_LANES
    n_slabs, n_chunks, n_tiles = -(-C // WG_SLAB), -(-k // chunk), -(-T // WG_TILE)
    items = B * n_tiles
    groups = min(max(WG_BLOCKS // (n_slabs * n_chunks), 1), items)
    depth = torch.empty(k, 1, dtype=torch.float64)
    for c in range(n_chunks):
        kc = min(chunk, k - c * chunk)
        splits = WG_LANES // -(-kc // WG_TAPS)
        depth[c * chunk:c * chunk + kc] = (-(-items // (groups * splits)) * min(T, WG_TILE)
                                           + min(items, groups * splits))
    return depth


def bn_sums_depth(N: int) -> int:
    """The roundings in gb_bc_bn_act_bwd's column sums, in its own order:
    kBnRows rows added in order into a partial, then the ceil(N / kBnRows)
    partials added in order."""
    return min(N, BN_ROWS) + -(-N // BN_ROWS)


def input_grad_abs_sum(gy: torch.Tensor, w: torch.Tensor, T: int, stride: int = 1):
    """(B, T, C) float64: each input gradient's sum of |gy * w| over the
    taps that reach it."""
    k = w.shape[0]
    p = k // 2
    B, T_out, C = gy.shape
    acc = torch.zeros(B, T + 2 * p, C, dtype=torch.float64, device=gy.device)
    g, wa = gy.double().abs(), w.double().abs()
    for j in range(k):
        acc[:, j:j + (T_out - 1) * stride + 1:stride] += g * wa[j]
    return acc[:, p:p + T]


def _bn_bwd_terms64(x, dout, p, res, res_p, swish):
    """The backward epilogue's per-element values in float64, (N, C) each:
    g, xhat, rhat (None without res) and Y = |x - mean| |factor| + |bias|
    (plus the residual's), the size of the forward's pre-Swish sum y."""
    C = x.shape[-1]
    pd = p.double()
    xf = x.reshape(-1, C).double()
    y = (xf - pd[0]) * pd[1] + pd[2]
    mag_y = ((xf - pd[0]) * pd[1]).abs() + pd[2].abs()
    rh = None
    if res is not None:
        rd = res_p.double()
        rf = res.reshape(-1, C).double()
        y = y + (rf - rd[0]) * rd[1] + rd[2]
        mag_y = mag_y + ((rf - rd[0]) * rd[1]).abs() + rd[2].abs()
        rh = (rf - rd[0]) * rd[3]
    g = dout.reshape(-1, C).double()
    if swish:
        s = torch.sigmoid(y)
        g = g * (s * (1 + y * (1 - s)))
    return g, (xf - pd[0]) * pd[3], rh, mag_y


def bn_bwd_scales(x, dout, p, res=None, res_p=None, swish=True):
    """The backward epilogue's magnitudes in float64 from the plain
    formula's terms: (dx_scale, dres_scale or None, sum_scales), dx_scale
    (N, C) = |factor| * (|g| + mean|g| + |xhat| * mean|g * xhat|) (dres
    likewise) and sum_scales (2 or 3, C) = sum |g|, sum |g * xhat| (and
    sum |g * rhat|): the sizes that each output's f32 errors scale with."""
    pd = p.double()
    g, xh, rh, _ = _bn_bwd_terms64(x, dout, p, res, res_p, swish)
    g, xh = g.abs(), xh.abs()
    sums = [g.sum(0), (g * xh).sum(0)]
    N = max(g.shape[0], 1)
    dx = pd[1].abs() * (g + sums[0] / N + xh * sums[1] / N)
    dres = None
    if res is not None:
        rh = rh.abs()
        sums.append((g * rh).sum(0))
        dres = (res_p.double()[1].abs() * (g + sums[0] / N + rh * sums[2] / N)).reshape(x.shape)
    return dx.reshape(x.shape), dres, torch.stack(sums)


def bn_bwd_sums64(x, dout, p, res=None, res_p=None, swish=True):
    """The backward epilogue's column sums in float64 from the same inputs:
    (sums, magnitudes, term_err), each (2 or 3, C): sum g, sum g * xhat (and
    sum g * rhat); the same sums of the terms' magnitudes; and the sums of
    what each term computed in f32 may differ from its float64 value.  With
    Swish, g in f32 errs by at most 32 u |dout| (1 + Y) (u = 2^-24; Y the
    size of y's computation: y's own roundings reach g through swish'' <=
    0.5, and expf's 2 ulps, the reciprocal, the four roundings of swish'(y)
    and the product with dout stay within 12 u |dout| (1 + |y|)); without,
    g is dout exactly.  A product g * xhat adds 3 u |g xhat| (xhat's two
    roundings and its own)."""
    g, xh, rh, mag_y = _bn_bwd_terms64(x, dout, p, res, res_p, swish)
    e_g = (32 * U32 * dout.reshape(g.shape).double().abs() * (1 + mag_y) if swish
           else torch.zeros_like(g))
    sums, mags, errs = [g.sum(0)], [g.abs().sum(0)], [e_g.sum(0)]
    for h in (xh,) if rh is None else (xh, rh):
        t = g * h
        sums.append(t.sum(0))
        mags.append(t.abs().sum(0))
        errs.append((e_g * h.abs() + 3 * U32 * t.abs()).sum(0))
    return torch.stack(sums), torch.stack(mags), torch.stack(errs)


def sums_close(got: torch.Tensor, want: torch.Tensor, depth: int, scale: torch.Tensor,
               what: str, max_share: float) -> int:
    """got and want: roundings to bf16 (held as bf16, or as f32 of bf16
    values) of f32 sums of the same terms in two orders; `depth` the terms a
    sum adds, `scale` (float64) the sum of their magnitudes.  Each output
    within one bf16 ulp of the larger plus both sums' error bound, 2 *
    depth * 2^-24 * scale; fewer than max_share of them differing by more
    than one ulp.  Returns the number that differ at all; raises
    AssertionError otherwise."""
    a, b = got.double(), want.double()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {tuple(got.shape)} != {tuple(want.shape)}")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{what}: non-finite values")
    allowed = bf16_ulp(torch.maximum(a.abs(), b.abs())) + 2 * depth * U32 * scale.double()
    diff = (a - b).abs()
    if not (diff <= allowed).all():
        raise AssertionError(f"{what}: {float((diff - allowed).max())} past the bound")
    past_ulp = int((diff > bf16_ulp(torch.maximum(a.abs(), b.abs()))).sum())
    if past_ulp > max_share * got.numel():
        raise AssertionError(f"{what}: {past_ulp} of {got.numel()} outputs past one bf16 ulp")
    return int((a != b).sum())


def kernel_sum_close(got: torch.Tensor, exact: torch.Tensor, depth, scale: torch.Tensor,
                     what: str, term_err=None, bf16: bool = False) -> float:
    """got: a kernel's f32 sums (rounded once to bf16 where `bf16`), each
    taken in an order of at most `depth` roundings (a number, or a tensor
    that broadcasts); exact, scale and term_err (float64): the exact sums,
    the sums of their terms' magnitudes and of what each f32 term may
    differ from its exact value (none: the terms are exact).  A sum in such
    an order errs by at most depth * 2^-24 times the sum of its terms'
    magnitudes, and a float64 sum of up to 2^24 terms by under 2^-24 of
    it, so each output is held within (depth + 1) * 2^-24 * (scale +
    term_err) + term_err of the float64 sum, plus one bf16 ulp where
    rounded.
    Returns the largest share of that bound used; raises AssertionError
    past it."""
    a = got.double()
    if got.shape != exact.shape:
        raise AssertionError(f"{what}: shapes {tuple(got.shape)} != {tuple(exact.shape)}")
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite values")
    err = torch.zeros_like(exact) if term_err is None else term_err.double()
    bound = (torch.as_tensor(depth, dtype=torch.float64, device=a.device) + 1) * U32 * (
        scale.double() + err) + err
    if bf16:
        bound = bound + bf16_ulp(torch.maximum(a.abs(), exact.abs()))
    diff = (a - exact).abs()
    if not (diff <= bound).all():
        worst = int((diff - bound).argmax())
        raise AssertionError(f"{what}: {int((diff > bound).sum())} of {a.numel()} sums past "
                             f"the kernel's order bound, the worst {float(diff.flatten()[worst])!r} "
                             f"against {float(bound.flatten()[worst])!r}")
    return float((diff / bound.clamp_min(1e-300)).max()) if a.numel() else 0.0


def agreement(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(relative L2 error, cosine) of two gradients, in float64."""
    a, b = got.double().flatten(), want.double().flatten()
    nb = float(b.norm())
    rel = float((a - b).norm()) / nb if nb else float((a - b).norm())
    na = float(a.norm())
    cos = float(a @ b) / (na * nb) if na and nb else (1.0 if na == nb else 0.0)
    return rel, cos
