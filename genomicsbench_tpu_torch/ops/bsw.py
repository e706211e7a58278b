"""Banded Smith-Waterman seed extension (bwa-mem ksw_extend2) in PyTorch.

The port of genomicsbench_tpu/ops/bsw.py.  Semantics: ksw_extend2 as fixed
by the reference scalar kernel (benchmarks/bsw/bandedSWA.cpp:128-249),
bit-exact with the JAX package, the scalar oracle and the goldens.

Two versions of one function, `bsw_extend`, over the uploaded pair arrays
and an index tensor of pairs:

* on the card, the hand-written CUDA kernel `csrc/bsw.cu` (one warp per
  pair, its eh row in shared memory; see the note there), launched as
  `bsw_launch` says for the padded query width;
* on the CPU, `bsw_extend_reference`, the plain PyTorch version: a
  transcription of the JAX package's `_bsw_core` over a (B, Q+1) int32
  tile, a Python loop over target rows with the column dependency of F
  broken in closed form by one `torch.cummax`:
      F(c) = max_{k<c} (A(k) + k*e_ins) - (c-1)*e_ins,
      A(k) = max(M(k) - oe_ins, 0) inside the band.
  `chip_smoke.py` also runs it on the card to hold the kernel against it.

Both return a (7, m) int32 tensor: score, qle, tle, gtle, gscore, max_off,
and the number of band cells the recurrence evaluated (the data-dependent
work that the kernel's bound counts).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.batching.bucketing import bucket_by_length
from genomicsbench_tpu_torch.config import BswParams

NEG = -(1 << 30)
BIG = 1 << 30
# int32 operations per band cell that ksw_extend2 needs at the card's best
# int32 form (the breakdown is in csrc/bsw.cu); the kernel's bound counts them
BSW_OPS_PER_CELL = 10
RESULT_ROWS = ("score", "qle", "tle", "gtle", "gscore", "max_off")
# Shared memory of one Hopper block at most (227 KB; past 48 KB the kernel's
# launcher opts in)
SMEM_MAX_BYTES = 232_448
WARPS_PER_BLOCK = 8             # the kernel's most (kMaxWarpsPerBlock)


@dataclasses.dataclass(frozen=True)
class BswLaunch:
    """How `bsw_extend` launches the kernel for one padded query width."""

    warps_per_block: int
    warp_bytes: int     # shared memory of one warp's eh row and query (0: scratch)
    scratch: bool       # eh rows in a device scratch, not in shared memory

    @property
    def shared_bytes(self) -> int:
        return self.warps_per_block * self.warp_bytes


def bsw_launch(q_width: int) -> BswLaunch:
    """The kernel's launch configuration for queries padded to `q_width`
    bases: a function of the width alone, so the host knows it without a
    device read.  A warp holds its pair's eh row (H and E, int32, columns
    0..q_width) and query bases in shared memory, 9 bytes per column.
    Blocks take as many warps, up to 8, as fit in a block's 227 KB; a row
    longer than that goes to a device scratch instead."""
    warp_bytes = -(-9 * (q_width + 1) // 16) * 16
    if warp_bytes > SMEM_MAX_BYTES:
        return BswLaunch(WARPS_PER_BLOCK, 0, True)
    warps = min(WARPS_PER_BLOCK, SMEM_MAX_BYTES // warp_bytes)
    return BswLaunch(warps, warp_bytes, False)


@dataclasses.dataclass
class BswBatchResult:
    score: np.ndarray
    qle: np.ndarray
    tle: np.ndarray
    gtle: np.ndarray
    gscore: np.ndarray
    max_off: np.ndarray

    def row(self, k):
        return (
            int(self.score[k]), int(self.qle[k]), int(self.tle[k]),
            int(self.gtle[k]), int(self.gscore[k]), int(self.max_off[k]),
        )


def _compute_w_eff(qlen: np.ndarray, p: BswParams) -> np.ndarray:
    """Per-pair clamped band width (bandedSWA.cpp:159-168), on the host in
    float64 as the reference computes it; the kernel never recomputes it."""
    max_sc = int(p.score_matrix().max())
    qlen = qlen.astype(np.float64)
    max_ins = ((qlen * max_sc + p.end_bonus - p.o_ins) / p.e_ins + 1.0).astype(np.int64)
    max_del = ((qlen * max_sc + p.end_bonus - p.o_del) / p.e_del + 1.0).astype(np.int64)
    w = np.minimum(p.w, np.maximum(max_ins, 1))
    w = np.minimum(w, np.maximum(max_del, 1))
    return w.astype(np.int32)


def _substitution_scores(p: BswParams):
    """(match, mismatch, ambig) scores, read off the 5x5 matrix as
    _bsw_core reads them: diagonal, off-diagonal, any base-4 comparison."""
    mat = p.score_matrix()
    return int(mat[0, 0]), int(mat[0, 1]), int(mat[4, 0])


def _check_lengths(qlen, tlen, q_width, t_width, idx=None) -> None:
    """Refuse lengths and pair indices the kernel would read past: it reads
    query row idx[k] up to qlen and target row idx[k] up to tlen.  Takes
    host arrays, so the entry points check where they upload and a launch
    never waits for the device."""
    qlen, tlen = np.asarray(qlen), np.asarray(tlen)
    if qlen.size and (qlen.min() < 0 or qlen.max() > q_width):
        raise ValueError(f"qlen must lie in [0, {q_width}] (the query width)")
    if tlen.size and (tlen.min() < 0 or tlen.max() > t_width):
        raise ValueError(f"tlen must lie in [0, {t_width}] (the target width)")
    if idx is not None and len(idx) and (idx.min() < 0 or idx.max() >= len(qlen)):
        raise ValueError(f"idx must lie in [0, {len(qlen)})")


def _check_inputs(query, target, qlen, tlen, h0, w_eff, idx) -> None:
    """Refuse tensors the kernel does not take, by what needs no wait for
    the device: device, dtype, dimensions, contiguity, rows."""
    dev = query.device
    specs = (("query", query, torch.uint8, 2), ("target", target, torch.uint8, 2),
             ("qlen", qlen, torch.int32, 1), ("tlen", tlen, torch.int32, 1),
             ("h0", h0, torch.int32, 1), ("w_eff", w_eff, torch.int32, 1),
             ("idx", idx, torch.int64, 1))
    for name, x, dtype, ndim in specs:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, query on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dimensions, got {x.dim()}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = query.shape[0]
    if any(x.shape[0] != n for x in (target, qlen, tlen, h0, w_eff)):
        raise ValueError("query, target, qlen, tlen, h0 and w_eff must have "
                         "one row per pair")


def bsw_extend_reference(query, target, qlen, tlen, h0, w_eff, idx,
                         params: BswParams = BswParams()) -> torch.Tensor:
    """The plain PyTorch version of the kernel: `_bsw_core`
    (genomicsbench_tpu/ops/bsw.py:113-285) over a (m, Q+1) int32 tile of
    the pairs `idx`, Q their longest query.  Returns (7, m) int32."""
    dev = query.device
    m = idx.numel()
    if m == 0:
        return torch.zeros((7, 0), dtype=torch.int32, device=dev)
    p = params
    o_del, e_del, o_ins, e_ins, zdrop = p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    match, mis, ambig = _substitution_scores(p)

    ql, tl, h0, w = qlen[idx], tlen[idx], h0[idx], w_eff[idx]
    Q, T = int(ql.max()), int(tl.max())
    Qp = Q + 1                      # columns 0..qlen of the eh row
    js = torch.arange(Qp, dtype=torch.int32, device=dev)[None, :]
    qpad = torch.zeros((m, Qp), dtype=torch.int32, device=dev)
    qpad[:, :Q] = query[idx, :Q]
    tgt = target[idx, :T].to(torch.int32)
    qlen_c, h0_c = ql[:, None], h0[:, None]

    # First row seeded from h0 (bandedSWA.cpp:154-157).
    decay = h0_c - oe_ins - (js - 1) * e_ins
    Hs = torch.where((js >= 1) & (js <= qlen_c) & (h0_c > oe_ins),
                     decay.clamp(min=0), 0)
    Hs = torch.where(js == 0, h0_c, Hs)
    E = torch.zeros((m, Qp), dtype=torch.int32, device=dev)
    neg_col = torch.full((m, 1), NEG, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((m, 1), dtype=torch.int32, device=dev)

    beg = torch.zeros_like(ql)
    end = ql.clone()
    best = h0.clone()
    best_i = torch.full_like(ql, -1)
    best_j = torch.full_like(ql, -1)
    max_ie = torch.full_like(ql, -1)
    gscore = torch.full_like(ql, -1)
    max_off = torch.zeros_like(ql)
    cells = torch.zeros_like(ql)
    active = torch.ones(m, dtype=torch.bool, device=dev)

    for i in range(T):
        run = active & (i < tl)
        beg_i = torch.maximum(beg, i - w)
        end_i = torch.minimum(torch.minimum(end, i + w + 1), ql)
        bcol, ecol = beg_i[:, None], end_i[:, None]
        in_band = (js >= bcol) & (js < ecol)

        h1_init = torch.where(beg_i == 0, (h0 - (o_del + e_del * (i + 1))).clamp(min=0), 0)

        # Substitution scores for this target row.
        t_i = tgt[:, i : i + 1]
        S = torch.where(qpad == t_i, match, mis).int()
        S = torch.where((qpad == 4) | (t_i == 4), ambig, S)

        Mx = torch.where(Hs != 0, Hs + S, 0)        # M[c] = H(i-1, c-1), gated
        E_next = torch.maximum((Mx - oe_del).clamp(min=0), E - e_del)

        # F(i, c) via the max-plus prefix (module docstring).
        A = torch.where(in_band, (Mx - oe_ins).clamp(min=0), NEG)
        cm = torch.cummax(A + js * e_ins, dim=1).values
        F = torch.cat([neg_col, cm[:, :-1]], dim=1) - (js - 1) * e_ins
        F = torch.where(js == bcol, 0, F)

        H = torch.maximum(torch.maximum(Mx, E), F)

        # Row max and its latest argmax over the band (ties, also at 0,
        # take the latest column: bandedSWA.cpp:200-201).
        row_max = torch.where(in_band, H, NEG).amax(dim=1).clamp(min=0)
        row_arg = torch.where(in_band & (H == row_max[:, None]), js, -1).amax(dim=1)

        # Write-back: eh[j].h = H(i, j-1) for j in [beg, end]; eh[end] = (h1, 0).
        band_empty = beg_i >= end_i
        h_last = H.gather(1, (ecol - 1).clamp(min=0).long())[:, 0]
        h1_final = torch.where(band_empty, h1_init, h_last)
        val_h = torch.where(js == ecol, h1_final[:, None],
                            torch.cat([zero_col, H[:, :-1]], dim=1))
        val_h = torch.where(js == bcol, h1_init[:, None], val_h)
        mask_h = ((js >= bcol) & (js <= ecol)) | (js == ecol)
        run_c = run[:, None]
        Hs_new = torch.where(run_c & mask_h, val_h, Hs)
        E_new = torch.where(run_c & in_band, E_next, E)
        E_new = torch.where(run_c & (js == ecol), 0, E_new)

        # gscore bookkeeping: the column loop exits at j == max(beg, end).
        reach = run & (torch.maximum(beg_i, end_i) == ql)
        max_ie = torch.where(reach & (h1_final >= gscore), i, max_ie)
        gscore = torch.where(reach, torch.maximum(gscore, h1_final), gscore)
        cells = cells + torch.where(run, (end_i - beg_i).clamp(min=0), 0)

        zero_break = run & (row_max == 0)
        live = run & ~zero_break
        improved = live & (row_max > best)
        if zdrop > 0:
            di = i - best_i
            dj = row_arg - best_j
            zval = torch.where(di > dj, best - row_max - (di - dj) * e_del,
                               best - row_max - (dj - di) * e_ins)
            zbreak = live & ~improved & (zval > zdrop)
        else:
            zbreak = torch.zeros_like(zero_break)
        best = torch.where(improved, row_max, best)
        best_i = torch.where(improved, i, best_i)
        best_j = torch.where(improved, row_arg, best_j)
        max_off = torch.where(improved, torch.maximum(max_off, (row_arg - i).abs()), max_off)

        # Adaptive band shrink over the freshly written row
        # (bandedSWA.cpp:229-233).
        nz = (Hs_new != 0) | (E_new != 0)
        first_nz = torch.where(nz & in_band, js, BIG).amin(dim=1)
        beg_new = torch.minimum(first_nz, end_i)
        in2 = (js >= beg_new[:, None]) & (js <= ecol)
        j_last = torch.where(nz & in2, js, (beg_new - 1)[:, None]).amax(dim=1)
        end_new = torch.minimum(j_last + 2, ql)

        keep = run & ~zero_break & ~zbreak
        beg = torch.where(keep, beg_new, beg)
        end = torch.where(keep, end_new, end)
        active = active & ~zero_break & ~zbreak
        Hs, E = Hs_new, E_new
        if not bool((active & (tl > i + 1)).any()):
            break               # every pair has finished

    return torch.stack([best, best_j + 1, best_i + 1, max_ie + 1, gscore,
                        max_off, cells])


def bsw_extend(query, target, qlen, tlen, h0, w_eff, idx,
               params: BswParams = BswParams()) -> torch.Tensor:
    """ksw_extend2 for the pairs `idx` of the uploaded arrays.

    query (n, Qs) / target (n, Ts) uint8 0..4, qlen / tlen / h0 / w_eff (n,)
    int32 with qlen <= Qs and tlen <= Ts, idx (m,) int64; all contiguous, on
    one device.  Returns (7, m) int32 aligned with idx: score, qle, tle,
    gtle, gscore, max_off, band cells.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel on the current stream, without
    synchronising, and raises if the launch fails.  On the card the lengths
    and indices are not checked here, since that would wait for the device:
    the entry points check them on the host where they upload.
    """
    _check_inputs(query, target, qlen, tlen, h0, w_eff, idx)
    dev = query.device
    if dev.type == "cpu":
        _check_lengths(qlen.numpy(), tlen.numpy(), query.shape[1],
                       target.shape[1], idx.numpy())
        return bsw_extend_reference(query, target, qlen, tlen, h0, w_eff, idx, params)
    if dev.type != "cuda":
        raise ValueError(f"bsw_extend runs on cuda or cpu tensors, not {dev}")
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    m = idx.numel()
    out = torch.empty((7, m), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    q_width, t_width = query.shape[1], target.shape[1]
    launch = bsw_launch(q_width)
    # only rows too long for shared memory: each pair's eh row, [pair][H/E][column]
    scratch = (torch.empty((m, 2, q_width + 1), dtype=torch.int32, device=dev)
               if launch.scratch else None)
    match, mis, ambig = _substitution_scores(params)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gb_bsw_extend(
            query.data_ptr(), target.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            h0.data_ptr(), w_eff.data_ptr(), idx.data_ptr(), m, q_width, t_width,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            launch.warps_per_block, launch.warp_bytes,
            match, mis, ambig, params.o_del, params.e_del, params.o_ins,
            params.e_ins, params.zdrop, stream)
    if rc != 0:
        raise RuntimeError(f"bsw kernel launch failed with cudaError {rc}")
    bsw_extend.launches += 1
    return out


bsw_extend.launches = 0     # kernel launches, counted where they happen


class BswScorer:
    """Device-resident scorer: upload a PairBatch once, score repeatedly.

    Mirrors the reference's measurement scope: the `bsw` binary loads pairs
    into RAM first and its kernel timer covers only the batched getScores16
    loop (main_banded.cpp:272-296).  Here the constructor places the
    workload on the device and `score` covers dispatch + device compute +
    the one result fetch.
    """

    def __init__(self, batch, params: BswParams = BswParams(),
                 batch_size: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        if batch_size is None:
            batch_size = 2048
        self.params = params
        self.n = batch.n
        _check_lengths(batch.qlen, batch.tlen, batch.query.shape[1],
                       batch.target.shape[1])
        # The JAX package's (tlen, qlen) pad grid by workload size; here it
        # feeds only the CPU's padding_report().  The card pads nothing.
        if self.device.type == "cuda":
            multiple = 1
        elif batch.n >= 4096:
            multiple = (16, 64)
        elif batch.n >= 1024:
            multiple = (64, 128)
        else:
            multiple = (256, 256)
        # Bucket order: pairs grouped by lane class (roundup(qlen+1, 128))
        # first and by tlen within a class, so buckets are tight on both axes.
        qcls = -(-(np.asarray(batch.qlen) + 1) // 128)
        order = np.lexsort((np.asarray(batch.tlen), qcls))
        self.buckets = bucket_by_length(
            (batch.tlen, batch.qlen), batch_size, multiple=multiple, order=order,
        )
        self._qlen_h = np.asarray(batch.qlen)
        self._tlen_h = np.asarray(batch.tlen)
        w_eff_all = _compute_w_eff(batch.qlen, params)
        # One upload of the whole workload; the kernel gathers its pairs.
        self.dev = tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(self.device)
            for a, dt in ((batch.query, np.uint8), (batch.target, np.uint8),
                          (batch.qlen, np.int32), (batch.tlen, np.int32),
                          (batch.h0, np.int32), (w_eff_all, np.int32)))
        # The card runs one launch per score() over the buckets' index lists
        # concatenated, which is `order`: it has no static shapes to compile
        # per bucket, one 2048-pair bucket fills only 16 of 132 SMs, and the
        # sorted order keeps each warp's pairs alike in length.  The plain
        # version runs bucket by bucket, each at its own tile width.  Results
        # are per pair, so the two dispatches agree.
        if self.device.type == "cuda":
            idx_lists = [order]
        else:
            idx_lists = [b.indices for b in self.buckets]
        self.idx_dev = [torch.from_numpy(np.asarray(i, dtype=np.int64)).to(self.device)
                        for i in idx_lists]
        self.band_cells = None      # band cells evaluated by the last score()

    def padding_report(self):
        """Logical DP cells against the cells the device work spans.

        On the CPU: the padded cells of the bucketed tiles, as the JAX
        package reports them (the reference's load-imbalance analog,
        main_banded.cpp:290-318).  On the card, which pads nothing: the
        band cells the kernel evaluated in the last score()."""
        ql = self._qlen_h.astype(np.int64)
        tl = self._tlen_h.astype(np.int64)
        if self.device.type == "cuda":
            if self.band_cells is None:
                raise RuntimeError("padding_report() on the card reads the "
                                   "last score(): call score() first")
            logical = int((ql * tl).sum())
            return dict(logical_cells=logical, band_cells=self.band_cells,
                        band_share=self.band_cells / logical if logical else 1.0)
        logical = padded = 0
        for b in self.buckets:
            T, Q = b.pad_sizes
            lanes = -(-(Q + 1) // 128) * 128
            padded += len(b.indices) * T * lanes
            logical += int((ql[b.indices] * tl[b.indices]).sum())
        return dict(logical_cells=int(logical), padded_cells=int(padded),
                    efficiency=logical / padded if padded else 1.0)

    def score(self) -> BswBatchResult:
        out = torch.empty((len(RESULT_ROWS) + 1, self.n), dtype=torch.int32,
                          device=self.device)
        for idx in self.idx_dev:
            out[:, idx] = bsw_extend(*self.dev, idx, self.params)
        out = out.cpu().numpy()                     # one bulk fetch
        self.band_cells = int(out[-1].astype(np.int64).sum())
        return BswBatchResult(*out[:-1])


def banded_sw_pairs(
    batch,
    params: BswParams = BswParams(),
    batch_size: int | None = None,
    device="cuda",
) -> BswBatchResult:
    """Score a PairBatch (io.pairs); results are returned in the original
    pair order — the equivalent of the reference `bsw` binary's batch loop
    (main_banded.cpp:279-291)."""
    return BswScorer(batch, params, batch_size, device=device).score()


def banded_sw_batch(
    query: np.ndarray,
    target: np.ndarray,
    qlen: np.ndarray,
    tlen: np.ndarray,
    h0: np.ndarray,
    params: BswParams = BswParams(),
    device="cuda",
) -> BswBatchResult:
    """Score a padded batch.  query (B,Qpad) / target (B,Tpad) uint8 0..4."""
    dev = resolve_device(device)
    qlen = np.asarray(qlen, dtype=np.int32)
    _check_lengths(qlen, tlen, np.shape(query)[1], np.shape(target)[1])
    arrays = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
              for a, dt in ((query, np.uint8), (target, np.uint8), (qlen, np.int32),
                            (tlen, np.int32), (h0, np.int32),
                            (_compute_w_eff(qlen, params), np.int32))]
    idx = torch.arange(len(qlen), dtype=torch.int64, device=dev)
    out = bsw_extend(*arrays, idx, params)[: len(RESULT_ROWS)].cpu().numpy()
    return BswBatchResult(*out)
