"""GATK/GKL pair-HMM forward likelihood (phmm) in PyTorch.

The port of genomicsbench_tpu/ops/pairhmm.py.  Semantics: the GATK "logless
caching" forward model of benchmarks/phmm/PairHMMUnitTest.cpp:86,245
(computelikelihoodsboth): a float32 pass over every (read, hap) pair, and a
float64 recompute of the pairs whose scaled float32 result underflows
MIN_ACCEPTED = 1e-28 (pairhmm_common.h:16).  The recurrences are in
oracle/pairhmm.py.

Two versions of one function, `pairhmm_forward`, over the uploaded tables of
`upload_pairs` and a list of pairs, in float32 or float64:

* on the card, the hand-written CUDA kernel `csrc/pairhmm.cu` (one warp per
  pair, 32 read rows at a time sweeping the haplotype as a wavefront; see
  the note there), one template instantiated for float and double;
* on the CPU, `pairhmm_forward_reference`, the plain PyTorch version: an
  anti-diagonal wavefront over all listed pairs at once, one step per
  diagonal.  `chip_smoke.py` also runs it on the card to hold the kernel
  against it.

Every cell of both follows the operation order of the reference's loop
(gb_pairhmm_f64, genomicsbench_tpu/native/gbingest.cpp:1436-1454), each
multiply and add rounded on its own (no fused multiply-add), with the
deletion row Y sequential along the haplotype and the result summed over
the last row in column order.  So the two versions agree bit for bit in
both dtypes.  The float64 table is C's pow table (PH2PR_F64_CPOW), the
reference's own.  Against the JAX package: its float64 fallback is that
same loop compiled natively, equal to this order wherever the compiler
forms no FMA; its float32 pass evaluates Y by a doubling scan and sums the
last row by a reduction, so float32 results differ from it in the last
bits (about 2e-6 in log10).

The TPU layouts of the JAX package compute the same function and have no
counterpart here: the 128-lane haplotype-class buckets and `bucket_rows`,
the gather-mode switch (the port always uploads the unique reads and
haplotypes once and ships per-pair indices, which is what the gather mode
does), the unroll knob, and the host-side transition arrays.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.oracle.pairhmm import AMBIG, PH2PR_F64_CPOW, _PH2PR_F32

LOG10_2 = float(np.log10(2.0))
INITIAL_EXP_F32 = 120
INITIAL_EXP_F64 = 1020
MIN_ACCEPTED = 1e-28
QUAL_MAX = 127              # qualities are clamped to [0, 127], the table's range
PH2PR_F32 = _PH2PR_F32      # numpy's table cast to float32, equal to C pow's
PH2PR_F64 = PH2PR_F64_CPOW
# Floating-point operations that the forward pass needs per cell without
# fused multiply-adds (the breakdown is in csrc/pairhmm.cu), and per cell
# of a pair's last row for the result's sum; the kernel's bound counts them
PHMM_OPS_PER_CELL = 11
PHMM_OPS_PER_LAST_ROW_CELL = 2
# Shared memory of one Hopper block at most (227 KB), less the kernel's
# static 1 KB table
SMEM_MAX_BYTES = 232_448 - 1024
WARPS_PER_BLOCK = 8         # the kernel's most (kMaxWarpsPerBlock)

_U8, _I32, _I64 = torch.uint8, torch.int32, torch.int64


@dataclasses.dataclass
class PairTables:
    """The unique reads and haplotypes and the pair list, on one device, as
    `upload_pairs` makes them: read r's bases and its q/i/d/c quality planes
    (uint8, clamped to [0, 127]) at [r_off[r], r_off[r+1]), haplotype h at
    [h_off[h], h_off[h+1]), pair p = (pair_r[p], pair_h[p]); the two ph2pr
    tables.  `host` holds numpy copies of r_off, h_off, pair_r and pair_h,
    which the wrapper checks before a launch."""

    bases: torch.Tensor
    q: torch.Tensor
    i: torch.Tensor
    d: torch.Tensor
    c: torch.Tensor
    r_off: torch.Tensor
    haps: torch.Tensor
    h_off: torch.Tensor
    pair_r: torch.Tensor
    pair_h: torch.Tensor
    ph2pr_f32: torch.Tensor
    ph2pr_f64: torch.Tensor
    host: dict

    @property
    def n_pairs(self) -> int:
        return self.pair_r.numel()

    def cells(self, pair_idx=None) -> int:
        """sum(R * H) over the listed pairs (all by default)."""
        rl, hl = np.diff(self.host["r_off"]), np.diff(self.host["h_off"])
        r, h = self.host["pair_r"], self.host["pair_h"]
        if pair_idx is not None:
            r, h = r[pair_idx], h[pair_idx]
        return int((rl[r] * hl[h]).sum())


def _marshal(reads, haps, pairs):
    """Flat host arrays of the unique reads, haplotypes and the pairs,
    packed into one byte buffer for one upload: (buffer, {name: (byte
    offset, dtype, length)}, host copies of the offsets and pair indices)."""
    n_r, n_h = len(reads), len(haps)
    r_off = np.zeros(n_r + 1, np.int64)
    np.cumsum([len(rd["bases"]) for rd in reads], out=r_off[1:])
    h_off = np.zeros(n_h + 1, np.int64)
    np.cumsum([len(h) for h in haps], out=h_off[1:])
    pr = np.fromiter(itertools.chain.from_iterable(pairs), np.int64,
                     2 * len(pairs)).reshape(-1, 2)
    for name, col, n in (("read", pr[:, 0], n_r), ("haplotype", pr[:, 1], n_h)):
        if len(col) and (col.min() < 0 or col.max() >= n):
            raise IndexError(f"a pair's {name} index lies outside [0, {n})")
    NR, NH, P = int(r_off[-1]), int(h_off[-1]), len(pr)
    fields = [("bases", np.uint8, NR), ("q", np.uint8, NR), ("i", np.uint8, NR),
              ("d", np.uint8, NR), ("c", np.uint8, NR), ("r_off", np.int64, n_r + 1),
              ("haps", np.uint8, NH), ("h_off", np.int64, n_h + 1),
              ("pair_r", np.int32, P), ("pair_h", np.int32, P),
              ("ph2pr_f32", np.float32, 128), ("ph2pr_f64", np.float64, 128)]
    layout, nbytes = {}, 0
    for name, dt, length in fields:
        layout[name] = (nbytes, dt, length)
        nbytes += -(-length * np.dtype(dt).itemsize // 8) * 8
    buf = np.empty(nbytes, np.uint8)

    def view(name):
        o, dt, length = layout[name]
        return buf[o:o + length * np.dtype(dt).itemsize].view(dt)

    if n_r:
        view("bases")[:] = np.concatenate([rd["bases"] for rd in reads])
        for k in "qidc":
            # clamped as the JAX package clips and the reference clamps
            np.clip(np.concatenate([rd[k] for rd in reads]), 0, QUAL_MAX, out=view(k),
                    casting="unsafe")
    if n_h:
        view("haps")[:] = np.concatenate(haps)
    view("r_off")[:] = r_off
    view("h_off")[:] = h_off
    view("pair_r")[:] = pr[:, 0]
    view("pair_h")[:] = pr[:, 1]
    view("ph2pr_f32")[:] = PH2PR_F32
    view("ph2pr_f64")[:] = PH2PR_F64
    host = dict(r_off=r_off, h_off=h_off, pair_r=pr[:, 0].astype(np.int32),
                pair_h=pr[:, 1].astype(np.int32))
    return buf, layout, host


def upload_pairs(reads, haps, pairs, device) -> PairTables:
    """Marshal the reads (dicts of bases/q/i/d/c), the haplotypes (uint8
    arrays) and the (read, hap) index pairs on the host and upload them in
    one transfer.  One upload serves both passes."""
    return _upload(*_marshal(reads, haps, pairs), device)


def _upload(buf, layout, host, device) -> PairTables:
    """One copy of a marshalled buffer to `device`, cut into the tables."""
    up = torch.from_numpy(buf).to(resolve_device(device))
    tensors = {}
    for name, (o, dt, length) in layout.items():
        dt = np.dtype(dt)
        tensors[name] = up[o:o + length * dt.itemsize].view(getattr(torch, dt.name))
    return PairTables(**tensors, host=host)


def _check_tables(t: PairTables) -> None:
    """Refuse tables the kernel does not take, by what needs no wait for the
    device: devices, dtypes, dimensions, contiguity, lengths, and on the
    host copies the offsets and the pairs' indices."""
    dev = t.bases.device
    NR, NH, P = t.bases.numel(), t.haps.numel(), t.pair_r.numel()
    n_r, n_h = t.r_off.numel() - 1, t.h_off.numel() - 1
    specs = [("bases", _U8, NR), ("q", _U8, NR), ("i", _U8, NR), ("d", _U8, NR),
             ("c", _U8, NR), ("r_off", _I64, None), ("haps", _U8, NH),
             ("h_off", _I64, None), ("pair_r", _I32, P), ("pair_h", _I32, P),
             ("ph2pr_f32", torch.float32, 128), ("ph2pr_f64", torch.float64, 128)]
    for name, dtype, length in specs:
        x = getattr(t, name)
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, bases on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != 1 or (length is not None and x.numel() != length):
            raise ValueError(f"{name} must be one-dimensional of length {length}, "
                             f"got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, n, total in (("r_off", n_r, NR), ("h_off", n_h, NH)):
        h = np.asarray(t.host[name])
        if n < 0 or h.shape != (n + 1,):
            raise ValueError(f"host {name} must have {n + 1} entries")
        if h[0] != 0 or h[-1] != total:
            raise ValueError(f"{name} must run from 0 to the buffer length {total}")
        if (np.diff(h) < 0).any():
            raise ValueError(f"{name} must be nondecreasing")
    for name, n in (("pair_r", n_r), ("pair_h", n_h)):
        h = np.asarray(t.host[name])
        if h.shape != (P,):
            raise ValueError(f"host {name} must have {P} entries")
        if P and (h.min() < 0 or h.max() >= n):
            raise IndexError(f"{name} has an index outside [0, {n})")


def _pair_index(t: PairTables, pair_idx, host_idx):
    """The listed pairs as an int64 tensor on the tables' device, checked:
    one-dimensional, contiguous, every index in [0, n_pairs), the range read
    from `host_idx` (a host copy) where the caller has one, else from the
    device."""
    if pair_idx is None:
        return None
    if pair_idx.device != t.bases.device:
        raise ValueError(f"pair_idx is on {pair_idx.device}, bases on {t.bases.device}")
    if pair_idx.dtype != _I64:
        raise TypeError(f"pair_idx must be {_I64}, got {pair_idx.dtype}")
    if pair_idx.dim() != 1 or not pair_idx.is_contiguous():
        raise ValueError("pair_idx must be one-dimensional and contiguous")
    if pair_idx.numel():
        if host_idx is None:
            lo, hi = (int(v) for v in torch.aminmax(pair_idx))
        else:
            host_idx = np.asarray(host_idx)
            if host_idx.shape != tuple(pair_idx.shape):
                raise ValueError(f"host_idx has shape {host_idx.shape}, pair_idx "
                                 f"{tuple(pair_idx.shape)}")
            lo, hi = int(host_idx.min()), int(host_idx.max())
        if lo < 0 or hi >= t.n_pairs:
            raise IndexError(f"pair_idx has an index outside [0, {t.n_pairs})")
    return pair_idx


def _check_dtype(dtype) -> int:
    """The initial exponent E of a supported dtype."""
    if dtype == torch.float32:
        return INITIAL_EXP_F32
    if dtype == torch.float64:
        return INITIAL_EXP_F64
    raise TypeError(f"pairhmm_forward computes in float32 or float64, not {dtype}")


def pairhmm_forward_reference(t: PairTables, pair_idx=None, dtype=torch.float32):
    """The plain PyTorch version of the kernel: an anti-diagonal wavefront
    over the listed pairs (all by default), (n, Rmax) tiles of the cells of
    rows 1..Rmax on diagonal d = i + j, one step per diagonal.  Cells off a
    pair's matrix are held at 0, which is the column-0 boundary; row 0 is
    M = X = 0, Y = 2^E / H.  Each torch op rounds on its own, so every cell
    takes the reference loop's rounding.  Returns the (n,) scaled forward
    probabilities in `dtype`."""
    E = _check_dtype(dtype)
    dev = t.bases.device
    idx = torch.arange(t.n_pairs, device=dev) if pair_idx is None else pair_idx
    n = idx.numel()
    fin = torch.zeros(n, dtype=dtype, device=dev)
    if n == 0:
        return fin
    r, h = t.pair_r[idx].long(), t.pair_h[idx].long()
    rs, R = t.r_off[r], t.r_off[r + 1] - t.r_off[r]
    hs, H = t.h_off[h], t.h_off[h + 1] - t.h_off[h]
    Rmax, Hmax = int(R.max()), int(H.max())
    if Rmax == 0 or Hmax == 0:
        return fin
    tab = (t.ph2pr_f32 if dtype == torch.float32 else t.ph2pr_f64)
    rows = torch.arange(Rmax, device=dev)[None, :]           # row i - 1
    row_ok = rows < R[:, None]
    pos = torch.where(row_ok, rs[:, None] + rows, 0)
    look = lambda plane: tab[plane[pos].long()]
    pi, pd, pc, pq = look(t.i), look(t.d), look(t.c), look(t.q)
    one = torch.ones((), dtype=dtype, device=dev)
    t_mm = one - torch.minimum(one, pi + pd)
    t_gapm = one - pc
    p_match = one - pq
    p_mis = pq / torch.full_like(pq, 3.0)        # an IEEE division, as the kernel's
    rb = t.bases[pos]
    scale = torch.full((n,), 2.0 ** E, dtype=dtype, device=dev)
    init_y = (scale / H.to(dtype))[:, None]

    zero_col = torch.zeros((n, 1), dtype=dtype, device=dev)
    M1 = torch.zeros((n, Rmax), dtype=dtype, device=dev)      # diagonal d - 1
    X1, Y1 = torch.zeros_like(M1), torch.zeros_like(M1)
    M2, X2, Y2 = torch.zeros_like(M1), torch.zeros_like(M1), torch.zeros_like(M1)
    last = (R - 1).clamp(min=0)[:, None]                      # the row of the result
    hap_last = t.haps.numel() - 1
    for d in range(2, Rmax + Hmax + 1):
        j = d - 1 - rows                                      # column of row i
        valid = row_ok & (j >= 1) & (j <= H[:, None])
        hb = t.haps[(hs[:, None] + j - 1).clamp(0, max(hap_last, 0))]
        match = (hb == rb) | (rb == AMBIG) | (hb == AMBIG)
        prior = torch.where(match, p_match, p_mis)
        # (i-1, j-1) from diagonal d - 2 and (i-1, j) from d - 1, one row up;
        # row 0 is the boundary
        dM = torch.cat([zero_col, M2[:, :-1]], 1)
        dX = torch.cat([zero_col, X2[:, :-1]], 1)
        dY = torch.cat([init_y, Y2[:, :-1]], 1)
        uM = torch.cat([zero_col, M1[:, :-1]], 1)
        uX = torch.cat([zero_col, X1[:, :-1]], 1)
        M = prior * (t_mm * dM + t_gapm * (dX + dY))
        X = pi * uM + pc * uX
        Y = pd * M1 + pc * Y1                                  # (i, j-1) from d - 1
        M, X, Y = (torch.where(valid, v, 0.0) for v in (M, X, Y))
        at_end = valid.gather(1, last)[:, 0]
        fin = torch.where(at_end, fin + (M.gather(1, last)[:, 0] + X.gather(1, last)[:, 0]),
                          fin)
        M2, X2, Y2, M1, X1, Y1 = M1, X1, Y1, M, X, Y
    return fin


def phmm_launch(h_max: int, itemsize: int):
    """(warps per block, bytes per warp, in device scratch) for haplotypes
    of at most h_max bases in a dtype of `itemsize` bytes.  A warp holds the
    row above its strip (M, X, Y for columns 0..h_max) and its haplotype;
    past a block's shared memory the same layout lives in device scratch."""
    h_max = int(h_max)
    warp_bytes = -(-3 * (h_max + 1) * itemsize // 16) * 16 + -(-max(h_max, 1) // 16) * 16
    if warp_bytes > SMEM_MAX_BYTES:
        return WARPS_PER_BLOCK, warp_bytes, True
    return min(WARPS_PER_BLOCK, SMEM_MAX_BYTES // warp_bytes), warp_bytes, False


def pairhmm_forward(t: PairTables, pair_idx=None, dtype=torch.float32, *, host_idx=None):
    """The scaled forward probability of each listed pair (pair_idx, an
    int64 tensor of indices into the pairs; all pairs by default) in
    float32 (E = 120) or float64 (E = 1020).

    Checks the tables, the indices and the dtype on the host before any
    build or launch: pass `host_idx` (a host copy of pair_idx) where a CUDA
    caller has one, or the indices' range is read from the device.  CPU
    tables take the plain version; CUDA tables launch the kernel on the
    current stream, without synchronising, and raise if the launch fails."""
    _check_dtype(dtype)
    _check_tables(t)
    pair_idx = _pair_index(t, pair_idx, host_idx)
    dev = t.bases.device
    if dev.type == "cpu":
        return pairhmm_forward_reference(t, pair_idx, dtype)
    if dev.type != "cuda":
        raise ValueError(f"pairhmm_forward runs on cuda or cpu tensors, not {dev}")
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    n = t.n_pairs if pair_idx is None else pair_idx.numel()
    out = torch.empty(n, dtype=dtype, device=dev)
    if n == 0:
        return out
    h_max = int(np.diff(t.host["h_off"]).max()) if t.h_off.numel() > 1 else 0
    itemsize = torch.empty((), dtype=dtype).element_size()
    warps, warp_bytes, in_scratch = phmm_launch(h_max, itemsize)
    blocks = -(-n // warps)
    scratch = None
    if in_scratch:
        blocks = min(blocks, torch.cuda.get_device_properties(dev).multi_processor_count)
        scratch = torch.empty(blocks * warps * warp_bytes, dtype=_U8, device=dev)
    fn = lib.gb_pairhmm_f32 if dtype == torch.float32 else lib.gb_pairhmm_f64
    table = t.ph2pr_f32 if dtype == torch.float32 else t.ph2pr_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(t.bases.data_ptr(), t.q.data_ptr(), t.i.data_ptr(), t.d.data_ptr(),
                t.c.data_ptr(), t.r_off.data_ptr(), t.haps.data_ptr(), t.h_off.data_ptr(),
                t.pair_r.data_ptr(), t.pair_h.data_ptr(),
                None if pair_idx is None else pair_idx.data_ptr(), n, table.data_ptr(),
                h_max, None if scratch is None else scratch.data_ptr(), blocks, warps,
                warp_bytes, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pairhmm kernel launch failed with cudaError {rc}")
    pairhmm_forward.launches[dtype] += 1
    return out


# kernel launches per instance, counted where they happen
pairhmm_forward.launches = {torch.float32: 0, torch.float64: 0}


@dataclasses.dataclass
class PhmmDispatch:
    """Both passes of one batch, dispatched and not yet fetched."""

    scaled32: torch.Tensor      # (P,) float32, every pair
    fallback: torch.Tensor      # (F,) int64, the pairs below MIN_ACCEPTED
    scaled64: torch.Tensor      # (F,) float64


def _select_fallback(scaled32: torch.Tensor) -> torch.Tensor:
    """The pairs whose float32 result underflows MIN_ACCEPTED, on the
    device (compared in float32, as numpy compares the JAX package's)."""
    return torch.nonzero(scaled32 < MIN_ACCEPTED).flatten()


def _phmm_dispatch(t: PairTables) -> PhmmDispatch:
    s32 = pairhmm_forward(t, None, torch.float32)
    fail = _select_fallback(s32)
    return PhmmDispatch(s32, fail, pairhmm_forward(t, fail, torch.float64))


def _phmm_collect(pending: PhmmDispatch) -> np.ndarray:
    """One fetch of both passes; log10 and the descale on the host in
    float64, as the JAX package computes them."""
    P, F = pending.scaled32.numel(), pending.fallback.numel()
    flat = torch.cat([pending.scaled32.double(), pending.fallback.double(),
                      pending.scaled64]).cpu().numpy()
    scaled = flat[:P].astype(np.float32)
    fail = flat[P:P + F].astype(np.int64)
    out = np.empty(P, np.float64)
    ok = np.ones(P, bool)
    ok[fail] = False
    out[ok] = np.log10(scaled[ok].astype(np.float64)) - INITIAL_EXP_F32 * LOG10_2
    if F:
        out[fail] = np.log10(flat[P + F:]) - INITIAL_EXP_F64 * LOG10_2
    return out


def pairhmm_batch(reads, haps, pairs=None, *, device="cuda") -> np.ndarray:
    """log10 likelihoods of (read, hap) pairs, as JAX pairhmm_batch computes
    them: reads are dicts of bases/q/i/d/c arrays, haps uint8 arrays, pairs
    (read index, hap index) tuples, by default the reference's read-major
    cross product (PairHMMUnitTest.cpp:232-244).  Returns (P,) float64.

    One upload, one float32 launch over every pair, the selection of the
    pairs below MIN_ACCEPTED on the device, one float64 launch over those,
    and one fetch; the plain versions with device="cpu"."""
    dev = resolve_device(device)
    if pairs is None:
        pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    if len(pairs) == 0:
        return np.zeros(0, np.float64)
    return _phmm_collect(_phmm_dispatch(upload_pairs(reads, haps, pairs, dev)))
