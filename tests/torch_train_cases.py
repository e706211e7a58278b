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
# kWgTaps, kWgRows, kWgFrames, kWgBlocks) and gb_bc_bn_act_bwd's sums pass
# (`bn_sum_layout`: kBnBlock, kBnGroups)
WG_SLAB, WG_TAPS, WG_ROWS, WG_FRAMES, WG_BLOCKS = 32, 16, 16, 256, 264
BN_BLOCK, BN_GROUPS = 256, 264

# (k, C, B, T): k below and above the 16-tap window (one tap group, or
# 2-16), past one block's 256 taps (chunks); C not a multiple of the slab's
# 32 or of 8; T below one item, at and past an item's edge
WGRAD_MODEL_SHAPES = [(1, 2, 3, 2), (5, 40, 1, 1), (9, 48, 2, 300), (9, 440, 1, 150),
                      (15, 64, 1, 241), (17, 66, 2, 257), (31, 34, 1, 300), (67, 34, 2, 290),
                      (123, 48, 1, 700), (129, 66, 1, 260), (301, 34, 1, 520)]


def wgrad_layout(B: int, T: int, C: int, k: int) -> dict:
    """`wg_layout`: J taps a thread (k below WG_TAPS, else WG_TAPS), kc taps
    a block, n_grp tap groups and `splits` frame splits of its WG_ROWS lane
    rows, fs frames a split takes of an item (a multiple of J; an odd one
    below WG_TAPS), ft = fs * splits frames an item, the slabs, tap chunks
    and tiles, the (batch row, tile) items and the blocks over them
    (`groups`)."""
    J = k if k < WG_TAPS else WG_TAPS
    kc = min(k, J * WG_ROWS)
    n_grp = -(-kc // J)
    splits = WG_ROWS // n_grp
    if J == WG_TAPS:
        fs = WG_TAPS * -(-WG_FRAMES // (splits * WG_TAPS))
    else:
        m = WG_FRAMES // (WG_ROWS * J)
        m = m if m % 2 else m - 1
        fs = J * max(m, 1)
    ft = fs * splits
    n_slabs, n_chunks, n_tiles = -(-C // WG_SLAB), -(-k // kc), -(-T // ft)
    items = B * n_tiles
    groups = min(max(WG_BLOCKS // (n_slabs * n_chunks), 1), items)
    return dict(J=J, kc=kc, n_grp=n_grp, splits=splits, fs=fs, ft=ft, n_slabs=n_slabs,
                n_chunks=n_chunks, n_tiles=n_tiles, items=items, groups=groups)


def wgrad_depth(B: int, T: int, C: int, k: int) -> torch.Tensor:
    """(k, 1) float64: the roundings in gb_bc_depthwise_wgrad's sum of each
    tap's products at stride 1, in its own order.  A thread adds the fs
    frames of each of its block's items in order (one FMA a frame, the
    product exact; frames past T add an exact zero), at most ceil(items /
    groups) items; its block adds its `splits` threads' sums in split order
    (splits - 1 roundings); then the `groups` blocks' partials are added in
    order from zero."""
    lay = wgrad_layout(B, T, C, k)
    depth = (-(-lay["items"] // lay["groups"]) * lay["fs"] + lay["splits"] - 1
             + lay["groups"])
    return torch.full((k, 1), float(depth), dtype=torch.float64)


def wgrad_partials(x: torch.Tensor, gy: torch.Tensor, k: int) -> np.ndarray:
    """The numpy model of gb_bc_depthwise_wgrad's partition at stride 1:
    (groups, k, C) float32, each block's partial sums as the kernel writes
    them.  Items are (batch row, tile of ft frames), item b * n_tiles +
    tile; block g takes items g, g + groups, ...; its split s adds, from
    +0, the products x[b, t + j - k // 2] * gy[b, t] (exact in f32, each add
    rounded once as the FMA rounds it) of frames s * fs .. + fs - 1 of each
    item in order, zero past the sequence; the block adds its splits' sums
    in split order."""
    B, T, C = x.shape
    lay = wgrad_layout(B, T, C, k)
    G, S, fs, ft, n_tiles = lay["groups"], lay["splits"], lay["fs"], lay["ft"], lay["n_tiles"]
    n_it = -(-lay["items"] // G)
    p = k // 2
    Tp = n_tiles * ft
    xp = np.zeros((B, Tp + k - 1, C), np.float32)
    xp[:, p:p + T] = x.float().cpu().numpy()
    gp = np.zeros((B, Tp, C), np.float32)
    gp[:, :T] = gy.float().cpu().numpy()
    out = np.empty((G, k, C), np.float32)
    for j in range(k):
        prod = np.zeros((n_it * G, ft, C), np.float32)
        prod[:lay["items"]] = (xp[:, j:j + Tp] * gp).reshape(B * n_tiles, ft, C)
        # (item n * G + g) -> (g, split, frames of the split's items in order)
        seq = prod.reshape(n_it, G, S, fs, C).transpose(1, 2, 0, 3, 4).reshape(G, S, n_it * fs, C)
        seq = np.concatenate([np.zeros((G, S, 1, C), np.float32), seq], axis=2)
        acc = np.add.accumulate(seq, axis=2, dtype=np.float32)[:, :, -1]
        out[:, j] = np.add.accumulate(acc, axis=1, dtype=np.float32)[:, -1]
    return out


def wgrad_final(parts: np.ndarray) -> torch.Tensor:
    """gb_bc_depthwise_wgrad's second kernel on (groups, k, C) float32
    partials: each (j, c) added in block order from +0, rounded to bf16,
    as float32 (k, C)."""
    seq = np.concatenate([np.zeros((1,) + parts.shape[1:], np.float32), parts], axis=0)
    tot = np.add.accumulate(seq, axis=0, dtype=np.float32)[-1]
    return torch.from_numpy(tot).to(torch.bfloat16).float()


def wgrad_schedule(x: torch.Tensor, gy: torch.Tensor, k: int) -> torch.Tensor:
    """gb_bc_depthwise_wgrad's output as its schedule computes it, bit for
    bit: (k, C) float32 of bf16 values."""
    return wgrad_final(wgrad_partials(x, gy, k))


def bn_sum_width(C: int, res: bool, wide: bool) -> int:
    """The channels a thread of gb_bc_bn_act_bwd takes (`bn_bwd_dispatch`):
    where `wide` (C a multiple of 8 and every pointer 16-byte aligned) 8,
    or 4 with the residual branch; else 2."""
    return (4 if res else 8) if wide else 2


def bn_sum_layout(N: int, C: int, V: int) -> dict:
    """`bn_sum_layout` at V channels a thread: a block's gpb channel groups
    by `lanes` row lanes, and n_groups blocks down the rows, block g's lane l
    taking rows g * lanes + l, + n_groups * lanes, ..."""
    gpb = min(C // V, BN_BLOCK)
    lanes = BN_BLOCK // gpb
    return dict(gpb=gpb, lanes=lanes, n_groups=min(-(-N // lanes), BN_GROUPS))


def bn_sums_depth(N: int, C: int, res: bool) -> int:
    """The roundings in gb_bc_bn_act_bwd's column sums, in its own order, at
    either width a thread may take (the larger): a thread adds its rows in
    order from zero, ceil(N / (n_groups * lanes)); the block adds its lanes'
    partials in lane order (lanes - 1); the final kernel's lane adds
    ceil(n_groups / 32) blocks' partials from zero, and the butterfly 5."""
    depths = []
    for wide in {C % 8 == 0, False}:
        lay = bn_sum_layout(N, C, bn_sum_width(C, res, wide))
        depths.append(-(-N // (lay["n_groups"] * lay["lanes"])) + lay["lanes"] - 1
                      + -(-lay["n_groups"] // 32) + 5)
    return max(depths)


def bn_sum_partials(terms: np.ndarray, V: int) -> np.ndarray:
    """The numpy model of gb_bc_bn_act_bwd's sums pass on (N, C) float32
    terms at V channels a thread (`bn_sum_width`): (n_groups, C) float32,
    each block's partial as it writes it.  Block g's lane l adds rows g *
    lanes + l, + n_groups * lanes, ... in order from +0; the block adds its
    lanes' sums in lane order."""
    N, C = terms.shape
    lay = bn_sum_layout(N, C, V)
    G, lanes = lay["n_groups"], lay["lanes"]
    n_i = -(-N // (G * lanes))
    rows = np.zeros((n_i * G * lanes, C), np.float32)
    rows[:N] = terms
    # row (i * G + g) * lanes + l is lane l of block g's i-th
    lane_rows = rows.reshape(n_i, G, lanes, C).transpose(1, 2, 0, 3)
    lane_rows = np.concatenate([np.zeros((G, lanes, 1, C), np.float32), lane_rows], axis=2)
    acc = np.add.accumulate(lane_rows, axis=2, dtype=np.float32)[:, :, -1]
    return np.add.accumulate(acc, axis=1, dtype=np.float32)[:, -1]


def bn_sum_final(parts: np.ndarray) -> np.ndarray:
    """gb_bc_bn_act_bwd's final kernel on (n_groups, C) float32 partials:
    lane l of a column's warp adds partials l, l + 32, ... in order from +0,
    then the lanes meet in the butterfly xor 16, 8, 4, 2, 1.  (C,) float32."""
    G, C = parts.shape
    n_w = -(-G // 32)
    p = np.zeros((n_w * 32, C), np.float32)
    p[:G] = parts
    seq = np.concatenate([np.zeros((1, 32, C), np.float32), p.reshape(n_w, 32, C)], axis=0)
    lanes = np.add.accumulate(seq, axis=0, dtype=np.float32)[-1]
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[idx ^ o]).astype(np.float32)
    return lanes[0]


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
