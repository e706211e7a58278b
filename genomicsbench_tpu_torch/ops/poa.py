"""Partial-order alignment MSA consensus (poa, spoa) in PyTorch.

The port of genomicsbench_tpu/ops/poa.py.  Semantics: the reference poa
benchmark's per-window spoa loop (benchmarks/poa/msa_spoa_omp.cpp:237-252:
createGraph, then per read align + add_alignment, then generate_consensus)
with global NW and the convex dual-affine gap model, bit for bit as
oracle/poa.py specifies it, tie-breaks included.

Host part: the graph of each window lives in flat numpy arrays
(`NativePoaGraph`) and the port's C++ (`native/poa.cpp`) fuses each read's
alignment into it, exports it in topological order straight into the upload
buffer, decodes the kernels' paths and computes the consensus.

Device part: per MSA round and slab of windows, two functions over one
uploaded buffer (`PoaTables`), each in two versions:

* `poa_fill`: the graph-vs-query NW over each window's nodes in
  topological order (JAX `_poa_dp_core`, ops/poa.py:264-385), writing one
  packed uint16 trace cell per (node, column) and the best sink at column
  qlen; on the card the hand-written kernel `gb_poa_fill` of `csrc/poa.cu`
  (one block per window, threads across the query columns), on the CPU
  `poa_fill_reference`, JAX's row step over (B, P, q_pad) tensors with one
  host loop over the rows;
* `poa_backtrack`: the walk back over the traces (JAX `_backtrack_batch`,
  :414-505) to path entries `rank*(q_pad+1) + jcode` or, when p_pad <= 7,
  a 4-bit code stream packed eight to a word; on the card
  `gb_poa_backtrack` (one thread per window), on the CPU
  `poa_backtrack_reference`, vectorised over windows with one host loop
  over the steps.

Both versions share one layout: the planes are padded to JAX's buckets
(n_pad, p_pad, q_pad, so path words equal JAX's word for word), but each
window's traces hold only its own n x (qlen + 1) cells, at per-window
offsets, and the kernels compute only those.  The query-gap recurrence E is
taken in closed form, as JAX does, by a running max over a key that packs
(value, smallest column): JAX packs into int32 as value*(q_pad+1) + q_pad-k,
which wraps past qlen when q_pad + 1 > 4,096; here the key is the int64
value*2^14 + (2^14-1-k), which orders the same on every column that is
read and never wraps.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.config import PoaParams

NEG = -(1 << 29)          # JAX ops/poa.py:53 (the oracle uses -(1 << 30))
CLAMP = 1 << 19           # |clamped value| bound of the E key (ops/poa.py:54)
KEY_BITS = 14             # E key: value << 14 | (2^14 - 1 - column)
KEY_LOW = (1 << KEY_BITS) - 1
AUX_BITS = 13             # trace cell: 3-bit move | 13-bit aux
PAD_LIMIT = 1 << AUX_BITS         # q_pad and p_pad must stay below it
N_PAD_LIMIT = 0xFFFF              # uint16 pred ranks with the 0xFFFF sentinel
NO_PRED = 0xFFFF
CODES_MAX_P_PAD = 7               # 4-bit codes need 2 * p_pad < 16
FILL_THREADS_MAX = 512
# int32 operations of the kernels (csrc/poa.cu), for their bounds: the fill's
# per predecessor slot and per DP cell, the backtrack's per walk step
POA_INT32_OPS_PER_SLOT = 14
POA_INT32_OPS_PER_CELL = 40
POA_BT_INT32_OPS_PER_STEP = 12

# H-move codes (oracle/poa.py; the trace cell's top 3 bits)
MOVE_M, MOVE_F1_OPEN, MOVE_F1_EXT, MOVE_F2_OPEN, MOVE_F2_EXT, MOVE_E1, MOVE_E2 = range(7)

_U8, _I16, _I32, _I64 = torch.uint8, torch.int16, torch.int32, torch.int64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bucket(x: int, base: int) -> int:
    v = base
    while v < x:
        v *= 2
    return v


def pads(n_max: int, indeg_max: int, q_max: int) -> tuple[int, int, int]:
    """JAX's plane buckets (ops/poa.py:563-565): n_pad in steps of 256 past
    the largest graph, p_pad a power of two from 2, q_pad in steps of 128
    past the longest query."""
    return _round_up(n_max + 1, 256), _bucket(max(indeg_max, 1), 2), _round_up(q_max + 1, 128)


def col0_gap_origin(q_pad: int) -> int:
    """The E gap origin JAX leaves in column 0, from its sentinel -(1 << 30)
    packed with q_pad + 1 (ops/poa.py:256-258)."""
    return q_pad - (-(1 << 30)) % (q_pad + 1)


# ---------------------------------------------------------------------------
# the graph (host)
# ---------------------------------------------------------------------------

class NativePoaGraph:
    """One window's partial-order graph in flat numpy arrays, with fusion,
    topological export and heaviest-bundle consensus in the port's C++
    (native/poa.cpp), bit-exact to oracle/poa.PoaGraph.  The port's copy of
    the JAX package's NativePoaGraph (ops/poa.py:62-191)."""

    def __init__(self, params, cap: int, ecap: int | None = None):
        from genomicsbench_tpu_torch import native

        self._lib = native.load()
        self.params = params
        ecap = ecap if ecap is not None else cap + 16
        self.cap, self.ecap = cap, ecap
        self.base = np.zeros(cap, np.uint8)
        self.ring = np.zeros(cap * 3, np.int32)
        self.ring_n = np.zeros(cap, np.uint8)
        self.out_head = np.full(cap, -1, np.int32)
        self.in_head = np.full(cap, -1, np.int32)
        self.in_tail = np.full(cap, -1, np.int32)
        self.indeg = np.zeros(cap, np.int32)
        self.e_src = np.zeros(ecap, np.int32)
        self.e_dst = np.zeros(ecap, np.int32)
        self.e_w = np.zeros(ecap, np.int32)
        self.e_nin = np.zeros(ecap, np.int32)
        self.e_nout = np.zeros(ecap, np.int32)
        self._nn = np.zeros(2, np.int64)        # node and edge counts, for the C side
        self.n_seqs = 0
        a = {k: getattr(self, k).ctypes.data for k in (
            "base", "ring", "ring_n", "out_head", "in_head", "in_tail", "indeg",
            "e_src", "e_dst", "e_w", "e_nin", "e_nout")}
        self._fuse_args = [a[k] for k in ("base", "ring", "ring_n", "out_head", "in_head",
                                          "in_tail", "indeg", "e_src", "e_dst", "e_w",
                                          "e_nin", "e_nout")]
        self._topo_args = [a[k] for k in ("base", "ring", "ring_n", "out_head", "in_head",
                                          "e_src", "e_nin", "e_nout", "e_dst", "indeg")]
        self._cons_args = [a[k] for k in ("base", "ring", "ring_n", "out_head", "in_head",
                                          "e_src", "e_w", "e_nin", "e_nout", "e_dst", "indeg")]

    @property
    def n(self) -> int:
        return int(self._nn[0])

    @property
    def n_edges(self) -> int:
        return int(self._nn[1])

    def add_alignment(self, alignment, seq, weight: int = 1):
        """Fuse one read into the graph.  alignment: an (an, aq) pair of
        int32 arrays (-1 = None) or a list of (node | None, qpos | None);
        ignored for the first read."""
        seq = np.ascontiguousarray(np.asarray(seq, np.int64)).astype(np.uint8)
        if self.n == 0:
            an = np.full(len(seq), -1, np.int32)
            aq = np.arange(len(seq), dtype=np.int32)
        elif isinstance(alignment, tuple):
            an = np.ascontiguousarray(alignment[0], np.int32)
            aq = np.ascontiguousarray(alignment[1], np.int32)
        else:
            an = np.array([-1 if a[0] is None else a[0] for a in alignment], np.int32)
            aq = np.array([-1 if a[1] is None else a[1] for a in alignment], np.int32)
        nn = self._nn.ctypes.data
        rc = self._lib.gb_poa_fuse(*self._fuse_args, nn, nn + 8, self.cap, self.ecap,
                                   an.ctypes.data, aq.ctypes.data, len(an), seq.ctypes.data,
                                   int(weight))
        if rc < 0:
            raise ValueError("POA graph capacity overflow")
        self.n_seqs += 1

    def max_in_degree(self) -> int:
        return max(int(self.indeg[: self.n].max(initial=0)), 1)

    def export_arrays(self, n_pad: int, p_pad: int):
        """({base, pred, pmask, sink, n}, order) as the oracle's
        export_graph_arrays gives them."""
        if self.n > n_pad:
            raise ValueError(f"{self.n} nodes do not fit n_pad {n_pad}")
        order = np.zeros(self.n, np.int32)
        base = np.zeros(n_pad, np.int32)
        pred = np.zeros((n_pad, p_pad), np.int32)
        pmask = np.zeros((n_pad, p_pad), np.uint8)
        sink = np.zeros(n_pad, np.uint8)
        rc = self._lib.gb_poa_export(*self._topo_args, self.n, n_pad, p_pad,
                                     order.ctypes.data, base.ctypes.data, pred.ctypes.data,
                                     pmask.ctypes.data, sink.ctypes.data)
        if rc != self.n:
            raise ValueError(f"gb_poa_export failed: {rc}")
        return (dict(base=base, pred=pred, pmask=pmask.astype(bool), sink=sink.astype(bool),
                     n=np.int32(self.n)), order.tolist())

    def export_packed(self, n_pad: int, p_pad: int, basep_row, predp_row):
        """Write the upload planes in place (basep: uint8 row, sink in bit 7;
        predp: uint16 (n_pad, p_pad) row, filled with 0xFFFF by the caller);
        returns the topological order as an int32 array."""
        if self.n > n_pad:
            raise ValueError(f"{self.n} nodes do not fit n_pad {n_pad}")
        if basep_row.dtype != np.uint8 or predp_row.dtype != np.uint16 or \
                not (basep_row.flags.c_contiguous and predp_row.flags.c_contiguous):
            raise TypeError("basep_row must be contiguous uint8 and predp_row uint16")
        order = np.zeros(self.n, np.int32)
        rc = self._lib.gb_poa_export_packed(*self._topo_args, self.n, n_pad, p_pad,
                                            order.ctypes.data, basep_row.ctypes.data,
                                            predp_row.ctypes.data)
        if rc != self.n:
            raise ValueError(f"gb_poa_export_packed failed: {rc}")
        return order

    def consensus(self) -> np.ndarray:
        if self.n == 0:
            return np.zeros(0, dtype=np.int64)
        out = np.zeros(self.n, np.int32)
        ln = self._lib.gb_poa_consensus(*self._cons_args, self.n, out.ctypes.data)
        if ln < 0:
            raise ValueError("cycle in POA graph")
        return out[:ln].astype(np.int64)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PoaTables:
    """One slab of windows on one device: `basep` (B, n_pad) uint8 (base
    code, sink in bit 7), `predp` (B, n_pad, p_pad) int16 holding uint16
    predecessor ranks (0xFFFF = no slot), `n` (B,) int32 nodes, `seq`
    (B, q_pad) int8 (lane 0 = -1, lane j = base j - 1), `qlen` (B,) int32,
    `cell_off` (B + 1,) int64 offsets of each window's (n + 1) x (qlen + 1)
    DP rows, `trace_off` (B + 1,) int64 offsets of its n x (qlen + 1) trace
    cells.  `host` holds numpy copies of n, qlen, the offsets and predp,
    which the wrappers check."""

    basep: torch.Tensor
    predp: torch.Tensor
    n: torch.Tensor
    seq: torch.Tensor
    qlen: torch.Tensor
    cell_off: torch.Tensor
    trace_off: torch.Tensor
    host: dict

    @property
    def n_windows(self) -> int:
        return self.basep.shape[0]

    @property
    def n_pad(self) -> int:
        return self.basep.shape[1]

    @property
    def p_pad(self) -> int:
        return self.predp.shape[2]

    @property
    def q_pad(self) -> int:
        return self.seq.shape[1]

    def path_width(self, codes: bool) -> int:
        """Int32 words per window of the backtrack's output: n_pad + q_pad + 1
        entries, or those entries' nibbles eight to a word."""
        lp = self.n_pad + self.q_pad + 1
        return -(-lp // 8) if codes else lp


@dataclasses.dataclass
class FillResult:
    """The fill's outputs: `score` and `best_rank` (B,) int32, and the
    trace (int16 holding the uint16 cells, window b's n x (qlen + 1) at
    trace_off[b])."""

    score: torch.Tensor
    best_rank: torch.Tensor
    trace: torch.Tensor


_FIELDS = (("basep", np.uint8), ("predp", np.uint16), ("n", np.int32), ("seq", np.int8),
           ("qlen", np.int32), ("cell_off", np.int64), ("trace_off", np.int64))


def _layout(B, n_pad, p_pad, q_pad):
    """{name: (byte offset, dtype, shape)} of the fields in one buffer, and
    its size."""
    shapes = dict(basep=(B, n_pad), predp=(B, n_pad, p_pad), n=(B,), seq=(B, q_pad),
                  qlen=(B,), cell_off=(B + 1,), trace_off=(B + 1,))
    layout, nbytes = {}, 0
    for name, dt in _FIELDS:
        layout[name] = (nbytes, dt, shapes[name])
        nbytes += _round_up(int(np.prod(shapes[name])) * np.dtype(dt).itemsize, 8)
    return layout, nbytes


def _views(buf, layout):
    out = {}
    for name, (o, dt, shape) in layout.items():
        size = int(np.prod(shape)) * np.dtype(dt).itemsize
        out[name] = buf[o:o + size].view(dt).reshape(shape)
    return out


def _offsets(v):
    """The offset arrays and the host dict of the filled fields."""
    n = v["n"].astype(np.int64)
    w = v["qlen"].astype(np.int64) + 1
    v["cell_off"][0] = v["trace_off"][0] = 0
    np.cumsum((n + 1) * w, out=v["cell_off"][1:])
    np.cumsum(n * w, out=v["trace_off"][1:])
    return {k: v[k] for k in ("n", "qlen", "cell_off", "trace_off", "predp")}


def _upload(buf, layout, host, device) -> PoaTables:
    """One copy of a marshalled buffer to `device`, cut into the tables (a
    page-locked buffer goes without blocking the host)."""
    dev = resolve_device(device)
    src = torch.from_numpy(buf)
    up = src.to(dev, non_blocking=dev.type == "cuda" and src.is_pinned())
    t = {}
    for name, (o, dt, shape) in layout.items():
        dt = np.dtype(dt)
        size = int(np.prod(shape)) * dt.itemsize
        tdt = _I16 if dt == np.uint16 else getattr(torch, dt.name)
        t[name] = up[o:o + size].view(tdt).view(shape)
    return PoaTables(**t, host=host)


def upload_windows(basep, predp, n, seq, qlen, device) -> PoaTables:
    """Upload one slab's planes, as JAX `_poa_dp_packed` takes them: basep
    (B, n_pad) uint8, predp (B, n_pad, p_pad) uint16, n (B,), seq (B, q_pad)
    int8 with lane 0 = -1 and the query in lanes 1..qlen, qlen (B,)."""
    basep = np.asarray(basep)
    predp = np.asarray(predp)
    seq = np.asarray(seq)
    if basep.ndim != 2 or predp.ndim != 3 or seq.ndim != 2 or predp.shape[:2] != basep.shape \
            or seq.shape[0] != basep.shape[0]:
        raise ValueError(f"mismatched planes: basep {basep.shape}, predp {predp.shape}, "
                         f"seq {seq.shape}")
    B, n_pad = basep.shape
    layout, nbytes = _layout(B, n_pad, predp.shape[2], seq.shape[1])
    buf = np.zeros(nbytes, np.uint8)
    v = _views(buf, layout)
    v["basep"][:] = basep
    v["predp"][:] = predp
    v["n"][:] = np.asarray(n).reshape(B)
    v["seq"][:] = seq
    v["qlen"][:] = np.asarray(qlen).reshape(B)
    return _upload(buf, layout, _offsets(v), device)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check_tensor(name, x, dev, dtype, shape):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, basep on {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tables(t: PoaTables) -> None:
    """Refuse tables the kernels do not take, by what needs no wait for the
    device: devices, dtypes, shapes, contiguity, the 13-bit aux field and the
    uint16 ranks, and on the host copies the node counts, lengths, offsets
    and predecessor ranks."""
    if t.basep.dim() != 2 or t.predp.dim() != 3 or t.seq.dim() != 2:
        raise ValueError("basep, predp and seq must be (B, n_pad), (B, n_pad, p_pad) and "
                         "(B, q_pad)")
    dev = t.basep.device
    B, n_pad, p_pad, q_pad = t.n_windows, t.n_pad, t.p_pad, t.q_pad
    for name, dtype, shape in (("basep", _U8, (B, n_pad)), ("predp", _I16, (B, n_pad, p_pad)),
                               ("n", _I32, (B,)), ("seq", torch.int8, (B, q_pad)),
                               ("qlen", _I32, (B,)), ("cell_off", _I64, (B + 1,)),
                               ("trace_off", _I64, (B + 1,))):
        _check_tensor(name, getattr(t, name), dev, dtype, shape)
    if q_pad >= PAD_LIMIT or p_pad >= PAD_LIMIT:
        raise ValueError(f"q_pad {q_pad} and p_pad {p_pad} must stay below 2^13: the trace "
                         "cell's aux field is 13 bits")
    if n_pad >= N_PAD_LIMIT or p_pad < 1:
        raise ValueError(f"n_pad {n_pad} must stay below 65,535 (uint16 ranks with the "
                         "0xFFFF sentinel), p_pad at least 1")
    h = t.host
    n = np.asarray(h.get("n"), np.int64)
    qlen = np.asarray(h.get("qlen"), np.int64)
    if n.shape != (B,) or qlen.shape != (B,):
        raise ValueError(f"host n and qlen must have {B} entries")
    if ((n < 1) | (n > n_pad)).any():
        raise ValueError(f"every window needs 1 to n_pad = {n_pad} nodes")
    if ((qlen < 0) | (qlen >= q_pad)).any():
        raise ValueError(f"every qlen must lie in [0, q_pad - 1 = {q_pad - 1}]")
    w = qlen + 1
    for name, per in (("cell_off", (n + 1) * w), ("trace_off", n * w)):
        off = np.asarray(h.get(name), np.int64)
        if off.shape != (B + 1,) or off[0] != 0 or not np.array_equal(np.diff(off), per):
            raise ValueError(f"{name} must hold each window's cells from 0")
    predp = np.asarray(h.get("predp"))
    if predp.shape != (B, n_pad, p_pad) or predp.dtype != np.uint16:
        raise ValueError("host predp must be the uint16 (B, n_pad, p_pad) plane")
    # a predecessor's rank is below the node's own (rank r0 + 1 for row r0)
    row = np.arange(n_pad, dtype=np.uint16)[None, :, None]
    if ((predp != NO_PRED) & (predp > row)).any():
        raise ValueError("a predecessor rank is not below its node's rank")


def _check_fill(t: PoaTables, f: FillResult) -> None:
    dev, B = t.basep.device, t.n_windows
    total = int(t.host["trace_off"][-1])
    for name, dtype, shape in (("score", _I32, (B,)), ("best_rank", _I32, (B,)),
                               ("trace", _I16, (total,))):
        _check_tensor(name, getattr(f, name), dev, dtype, shape)


def _check_params(params: PoaParams) -> PoaParams:
    if not isinstance(params, PoaParams):
        raise TypeError(f"params must be the port's PoaParams, got {type(params).__name__}")
    return params


# ---------------------------------------------------------------------------
# fill
# ---------------------------------------------------------------------------

def _first_max(vals, mask):
    """(max over the masked slots, first slot achieving it), over dim 1;
    masked-out slots count as NEG (JAX `_masked_first_argmax`)."""
    v = torch.where(mask, vals, NEG)
    m, at = v[:, 0], torch.zeros_like(v[:, 0])
    for s in range(1, v.shape[1]):      # a few slots: a loop beats a strided argmax
        upd = v[:, s] > m
        m, at = torch.where(upd, v[:, s], m), torch.where(upd, s, at)
    return m, at


def _closed_form_e(gf, oo, ee, cols, k0):
    """El(j) = max_{k<j} clamp(GF(k) + k*ee) - oo - j*ee, smallest k on a
    tie, as the int64 key value << 14 | (2^14 - 1 - k); column 0 is NEG with
    JAX's gap origin k0."""
    v = (gf + cols * ee).clamp(-CLAMP, CLAMP).to(_I64)
    key = (v << KEY_BITS) | (KEY_LOW - cols)
    run = torch.cummax(key, 1).values
    run = torch.cat([run[:, :1], run[:, :-1]], 1)            # max over k < j
    best_v = (run >> KEY_BITS).to(_I32)
    best_k = (KEY_LOW - (run & KEY_LOW)).to(_I32)
    e = torch.where(cols == 0, NEG, best_v - oo - cols * ee)
    return e, torch.where(cols == 0, k0, best_k)


def _int16_bits(x):
    """int32 values in [0, 65535] as the int16 of the same 16 bits."""
    return (x - ((x & 0x8000) << 1)).to(_I16)


def poa_fill_reference(t: PoaTables, params: PoaParams) -> FillResult:
    """The plain PyTorch version of the fill kernel: JAX's row step
    (ops/poa.py:295-345) over (B, p_pad, q_pad) tensors, one host loop over
    the rows of the largest graph, then each window's own n x (qlen + 1)
    trace cells gathered into the flat layout."""
    p = params
    dev = t.basep.device
    B, n_pad, q_pad = t.n_windows, t.n_pad, t.q_pad
    o1, e1, o2, e2 = -p.gap_open1, -p.gap_ext1, -p.gap_open2, -p.gap_ext2
    pr16 = t.predp.to(_I32) & 0xFFFF
    pm = pr16 != NO_PRED
    pred = torch.where(pm, pr16, 0).to(_I64)
    base = (t.basep & 0x7F).to(_I32)
    sink = (t.basep & 0x80) != 0
    seq = t.seq.to(_I32)
    n, qlen = t.n.to(_I64), t.qlen.to(_I64)
    cols = torch.arange(q_pad, device=dev, dtype=_I32)[None, :]
    colmask = cols <= qlen[:, None]
    k0 = col0_gap_origin(q_pad)
    h0 = torch.maximum(-o1 - cols * e1, -o2 - cols * e2)
    h0 = torch.where(cols == 0, 0, h0)
    H = torch.full((B, n_pad + 1, q_pad), NEG, dtype=_I32, device=dev)
    H[:, 0] = torch.where(colmask, h0, NEG)
    F1 = torch.full_like(H, NEG)
    F2 = torch.full_like(H, NEG)
    trace = torch.zeros((B, n_pad, q_pad), dtype=_I32, device=dev)
    neg_col = torch.full((B, pred.shape[2], 1), NEG, dtype=_I32, device=dev)
    n_max = int(np.asarray(t.host["n"]).max()) if B else 0
    for r0 in range(n_max):
        pr = pred[:, r0]                                          # (B, P)
        pmr = pm[:, r0][:, :, None]
        idx = pr[:, :, None].expand(-1, -1, q_pad)
        Hp = H.gather(1, idx)                                     # (B, P, Qp)
        sub = torch.where(seq == base[:, r0, None], p.match, p.mismatch).to(_I32)
        diag = torch.cat([neg_col, Hp[:, :, :-1]], 2) + sub[:, None, :]
        Mv, Mi = _first_max(diag, pmr)

        def fpiece(Fprev, oo, ee):
            opv, opi = _first_max(Hp - oo - ee, pmr)
            exv, exi = _first_max(Fprev.gather(1, idx) - ee, pmr)
            ext = exv > opv
            return torch.where(ext, exv, opv), torch.where(ext, exi, opi), ext

        F1v, F1i, F1x = fpiece(F1, o1, e1)
        F2v, F2i, F2x = fpiece(F2, o2, e2)
        GF = torch.maximum(Mv, torch.maximum(F1v, F2v))
        E1v, K1 = _closed_form_e(GF, o1, e1, cols, k0)
        E2v, K2 = _closed_form_e(GF, o2, e2, cols, k0)
        live = colmask & (r0 < n)[:, None]
        Hr = torch.where(live, torch.maximum(GF, torch.maximum(E1v, E2v)), NEG)
        # move priority M > F1 > F2 > E1 > E2
        mv = torch.full_like(Hr, MOVE_E2)
        ps = K2
        sel = E1v == Hr
        mv, ps = torch.where(sel, MOVE_E1, mv), torch.where(sel, K1, ps)
        sel = F2v == Hr
        mv = torch.where(sel, torch.where(F2x, MOVE_F2_EXT, MOVE_F2_OPEN), mv)
        ps = torch.where(sel, F2i, ps)
        sel = F1v == Hr
        mv = torch.where(sel, torch.where(F1x, MOVE_F1_EXT, MOVE_F1_OPEN), mv)
        ps = torch.where(sel, F1i, ps)
        sel = Mv == Hr
        mv, ps = torch.where(sel, MOVE_M, mv), torch.where(sel, Mi, ps)
        trace[:, r0] = ((mv << AUX_BITS) | ps) & 0xFFFF
        H[:, r0 + 1] = Hr
        F1[:, r0 + 1] = torch.where(live, F1v, NEG)
        F2[:, r0 + 1] = torch.where(live, F2v, NEG)
    # best sink at column qlen, smallest rank on a tie
    hq = H[:, 1:].gather(2, qlen[:, None, None].expand(-1, n_pad, 1))[:, :, 0]
    alive = torch.arange(n_pad, device=dev)[None, :] < n[:, None]
    hv = torch.where(sink & alive, hq, NEG)
    score = hv.max(1).values
    best_rank = (hv == score[:, None]).to(_I32).argmax(1).to(_I32) + 1
    host_n, host_q = np.asarray(t.host["n"]), np.asarray(t.host["qlen"])
    flat = [trace[b, :host_n[b], :host_q[b] + 1].reshape(-1) for b in range(B)]
    flat = torch.cat(flat) if flat else trace.new_zeros(0)
    return FillResult(score.to(_I32), best_rank, _int16_bits(flat))


def fill_threads(q_max: int) -> int:
    """Threads per block of the fill kernel: the widest window's qlen + 1
    columns in whole warps, at most FILL_THREADS_MAX (wider windows take
    several tiles of columns per row)."""
    return min(FILL_THREADS_MAX, _round_up(q_max + 1, 32))


def poa_fill(t: PoaTables, params: PoaParams | None = None) -> FillResult:
    """The graph-vs-query NW fill of every window in the slab.

    Checks the tables on the host before any build or launch.  CPU tables
    take the plain version; CUDA tables launch the kernel once on the
    current stream, without synchronising, with the H/F1/F2 rows in a
    device scratch of 12 bytes per (node + 1) x (qlen + 1) cell, and raise
    if the launch fails."""
    params = _check_params(params or PoaParams())
    _check_tables(t)
    dev = t.basep.device
    if dev.type == "cpu":
        return poa_fill_reference(t, params)
    if dev.type != "cuda":
        raise ValueError(f"poa_fill runs on cuda or cpu tensors, not {dev}")
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    B = t.n_windows
    cells = int(t.host["cell_off"][-1])
    f = FillResult(torch.empty(B, dtype=_I32, device=dev),
                   torch.empty(B, dtype=_I32, device=dev),
                   torch.empty(int(t.host["trace_off"][-1]), dtype=_I16, device=dev))
    if B == 0:
        return f
    scratch = torch.empty(3 * cells, dtype=_I32, device=dev)
    p = params
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gb_poa_fill(
            t.basep.data_ptr(), t.predp.data_ptr(), t.n.data_ptr(), t.seq.data_ptr(),
            t.qlen.data_ptr(), t.cell_off.data_ptr(), t.trace_off.data_ptr(), B,
            t.n_pad, t.p_pad, t.q_pad, col0_gap_origin(t.q_pad), p.match, p.mismatch,
            -p.gap_open1, -p.gap_ext1, -p.gap_open2, -p.gap_ext2,
            fill_threads(int(np.asarray(t.host["qlen"]).max())),
            scratch.data_ptr(), scratch[cells:].data_ptr(), scratch[2 * cells:].data_ptr(),
            f.trace.data_ptr(), f.score.data_ptr(), f.best_rank.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"poa fill kernel launch failed with cudaError {rc}")
    poa_fill.launches += 1
    return f


poa_fill.launches = 0       # kernel launches, counted where they happen


# ---------------------------------------------------------------------------
# backtrack
# ---------------------------------------------------------------------------

def _pack_codes(path, lp):
    """(B, lp) nibbles -> (B, ceil(lp / 8)) int32 words, nibble k of a word
    at bits 4k (JAX's int32 sum of shifted nibbles, wrapping)."""
    B = path.shape[0]
    lp8 = _round_up(lp, 8)
    c4 = torch.zeros((B, lp8), dtype=_I64, device=path.device)
    c4[:, :lp] = path[:, :lp]
    shifts = torch.arange(8, device=path.device, dtype=_I64) * 4
    words = (c4.view(B, lp8 // 8, 8) << shifts).sum(2)
    return (words - ((words & 0x80000000) << 1)).to(_I32)


def poa_backtrack_reference(t: PoaTables, f: FillResult, codes: bool) -> tuple:
    """The plain PyTorch version of the backtrack kernel: JAX's lockstep walk
    (ops/poa.py:441-480) over (B,), one host loop until every window's walk
    has ended.  Returns (path (B, path_width) int32, plen (B,) int32)."""
    dev = t.basep.device
    B, n_pad, p_pad, q_pad = t.n_windows, t.n_pad, t.p_pad, t.q_pad
    qw, lp = q_pad + 1, n_pad + q_pad + 1
    pr16 = t.predp.to(_I64) & 0xFFFF
    pred = torch.where(pr16 != NO_PRED, pr16, 0).view(B, -1)
    tr = torch.cat([f.trace.to(_I64) & 0xFFFF, f.trace.new_zeros(1, dtype=_I64)])
    toff, w = t.trace_off[:-1], t.qlen.to(_I64) + 1
    r = f.best_rank.to(_I64)
    j = t.qlen.to(_I64)
    gk = torch.full((B,), -1, dtype=_I64, device=dev)
    steps = torch.zeros(B, dtype=_I64, device=dev)
    path = torch.zeros((B, lp + 1), dtype=_I64, device=dev)
    rows = torch.arange(B, device=dev)
    while True:
        active = (r > 0) | (j > 0)
        if not bool(active.any()):
            break
        ri = (r - 1).clamp(0, n_pad - 1)
        at = toff + ri * w + j.clamp(0, q_pad - 1)
        cell = tr[torch.where(active & (r > 0), at, tr.numel() - 1)]
        mv, aux = cell >> AUX_BITS, cell & (PAD_LIMIT - 1)
        in_gap = active & (gk >= 0)
        is_r0 = active & ~in_gap & (r == 0)
        on_node = active & ~in_gap & (r > 0)
        is_m = on_node & (mv == MOVE_M)
        is_e = on_node & ((mv == MOVE_E1) | (mv == MOVE_E2))
        is_f = on_node & ~is_m & ~is_e
        aux_c = aux.clamp(0, p_pad - 1)
        if codes:
            entry = torch.where(is_m, aux_c, torch.where(is_f, p_pad + aux_c, 2 * p_pad))
        else:
            entry = torch.where(is_m | is_f, r, 0) * qw + torch.where(is_f, 0, j)
        prv = pred.gather(1, (ri * p_pad + aux_c)[:, None])[:, 0]
        r_new = torch.where(is_m | is_f, prv, r)
        j_new = torch.where(in_gap | is_r0 | is_m | is_e, j - 1, j)
        gk_tmp = torch.where(is_e, aux, gk)
        gk = torch.where((in_gap | is_e) & (j_new > gk_tmp), gk_tmp, -1)
        path[rows, torch.where(active, steps.clamp(max=lp - 1), lp)] = entry
        steps = steps + active.to(_I64)
        r, j = r_new, j_new
    out = _pack_codes(path, lp) if codes else path[:, :lp].to(_I32)
    return out, steps.to(_I32)


def poa_backtrack(t: PoaTables, f: FillResult, codes: bool = False) -> tuple:
    """The walk back over every window's traces: (path, plen) as
    `poa_backtrack_reference` describes them, path entries rank*(q_pad+1) +
    jcode in backward order, or with codes=True (p_pad <= 7) the 4-bit code
    stream of native/poa.cpp's gb_poa_decode_path.

    Checks the tables and the fill's outputs on the host before any build
    or launch.  CPU tensors take the plain version; CUDA tensors launch the
    kernel once on the current stream, without synchronising, and raise if
    the launch fails."""
    _check_tables(t)
    _check_fill(t, f)
    if codes and t.p_pad > CODES_MAX_P_PAD:
        raise ValueError(f"4-bit path codes need p_pad <= {CODES_MAX_P_PAD}, got {t.p_pad}")
    dev = t.basep.device
    if dev.type == "cpu":
        return poa_backtrack_reference(t, f, codes)
    if dev.type != "cuda":
        raise ValueError(f"poa_backtrack runs on cuda or cpu tensors, not {dev}")
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    B, width = t.n_windows, t.path_width(codes)
    path = torch.empty((B, width), dtype=_I32, device=dev)
    plen = torch.empty(B, dtype=_I32, device=dev)
    if B == 0:
        return path, plen
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gb_poa_backtrack(t.predp.data_ptr(), f.trace.data_ptr(),
                                  t.trace_off.data_ptr(), t.qlen.data_ptr(),
                                  f.best_rank.data_ptr(), B, t.n_pad, t.p_pad, t.q_pad,
                                  int(codes), width, path.data_ptr(), plen.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"poa backtrack kernel launch failed with cudaError {rc}")
    poa_backtrack.launches += 1
    return path, plen


poa_backtrack.launches = 0


# ---------------------------------------------------------------------------
# one slab: marshal, upload, launch, fetch, decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    """A slab whose kernels are launched: what its collect needs."""

    idx: list            # positions in the slab's graphs that went to the DP
    qlens: list          # every graph's query length
    orders: list
    predp: np.ndarray    # host planes, for the code decoder
    codes: bool
    q_pad: int
    p_pad: int
    out: object          # fetched int32 buffer: score, best_rank, plen, paths
    event: object        # CUDA event after the fetch, or None
    width: int


class _HostBuffers:
    """Page-locked host buffers on the card's path, one upload and one
    fetch buffer per slab slot, grown as needed and reused across rounds
    (a slot's previous use has been collected before it is refilled)."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.bufs: dict = {}

    def get(self, key, nbytes: int) -> np.ndarray:
        buf = self.bufs.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1 << 20), dtype=_U8, pin_memory=self.pinned)
            self.bufs[key] = buf
        return buf[:nbytes].numpy()


def _marshal(graphs, seqs, bufs: _HostBuffers, slot):
    """Export the graphs and queries of one slab into one host buffer (the
    windows with a graph of at least one node): (buffer, layout, host dict,
    orders, positions)."""
    idx = [i for i, g in enumerate(graphs) if g.n > 0]
    gs = [graphs[i] for i in idx]
    qs = [np.asarray(seqs[i]) for i in idx]
    B = len(gs)
    n_pad, p_pad, q_pad = pads(max(g.n for g in gs), max(g.max_in_degree() for g in gs),
                               max(len(s) for s in qs))
    if n_pad >= N_PAD_LIMIT or q_pad >= PAD_LIMIT or p_pad >= PAD_LIMIT:
        raise ValueError(f"a slab's planes (n_pad {n_pad}, p_pad {p_pad}, q_pad {q_pad}) pass "
                         "the kernels' limits: n_pad < 65,535, p_pad and q_pad < 2^13")
    layout, nbytes = _layout(B, n_pad, p_pad, q_pad)
    buf = bufs.get(("up", slot), nbytes)
    v = _views(buf, layout)
    v["basep"][:] = 0
    v["predp"][:] = NO_PRED
    v["seq"][:] = 0
    v["seq"][:, 0] = -1
    orders = []
    for b, (g, s) in enumerate(zip(gs, qs)):
        orders.append(g.export_packed(n_pad, p_pad, v["basep"][b], v["predp"][b]))
        v["n"][b] = g.n
        v["qlen"][b] = len(s)
        v["seq"][b, 1:len(s) + 1] = s
    return buf, layout, _offsets(v), orders, idx


def _dispatch(graphs, seqs, params, dev, bufs: _HostBuffers, slot, stats):
    """Marshal, upload and launch one slab without waiting for the card;
    the fetch goes into a page-locked buffer behind an event."""
    t0 = time.perf_counter()
    qlens = [len(s) for s in seqs]
    if not any(g.n > 0 for g in graphs):
        return _Pending([], qlens, [], None, False, 0, 0, None, None, 0)
    buf, layout, host, orders, idx = _marshal(graphs, seqs, bufs, slot)
    t0 = _stage(stats, "export and marshal", t0, dev)
    t = _upload(buf, layout, host, dev)
    t0 = _stage(stats, "upload", t0, dev)
    codes = t.p_pad <= CODES_MAX_P_PAD
    f = poa_fill(t, params)
    t0 = _stage(stats, "fill kernel", t0, dev)
    path, plen = poa_backtrack(t, f, codes)
    t0 = _stage(stats, "backtrack kernel", t0, dev)
    packed = torch.cat([f.score, f.best_rank, plen, path.view(-1)])
    event = None
    if dev.type == "cuda":
        out = torch.from_numpy(bufs.get(("down", slot), packed.numel() * 4).view(np.int32))
        out.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    else:
        out = packed
    if stats is not None:
        stats["cells"] = stats.get("cells", 0) + int(
            (host["n"].astype(np.int64) * host["qlen"]).sum())
        stats["calls"] = stats.get("calls", 0) + 1
    _stage(stats, "fetch", t0, dev)
    return _Pending(idx, qlens, orders, host["predp"], codes, t.q_pad, t.p_pad, out, event,
                    t.path_width(codes))


def _collect(p: _Pending, stats):
    """Wait for a slab's fetch and decode its paths into (an, aq) int32
    arrays (-1 = None) per window, in the slab's order.  A window whose
    graph is empty aligns every query base to a new node, as the oracle
    does."""
    t0 = time.perf_counter()
    alns = [(np.full(q, -1, np.int32), np.arange(q, dtype=np.int32)) for q in p.qlens]
    if not p.idx:
        return alns
    if p.event is not None:
        p.event.synchronize()
    out = p.out.numpy() if isinstance(p.out, torch.Tensor) else p.out
    t0 = _stage(stats, "fetch", t0, None)
    B = len(p.idx)
    best_rank, plen = out[B:2 * B], out[2 * B:3 * B]
    paths = out[3 * B:].reshape(B, p.width)
    if p.codes:
        from genomicsbench_tpu_torch import native

        lib = native.load()
        words = paths.view(np.uint32)
        for b, i in enumerate(p.idx):
            pl = int(plen[b])
            an = np.empty(pl, np.int32)
            aq = np.empty(pl, np.int32)
            lib.gb_poa_decode_path(words[b].ctypes.data, pl, int(best_rank[b]), p.qlens[i],
                                   p.predp[b].ctypes.data, p.p_pad, p.orders[b].ctypes.data,
                                   an.ctypes.data, aq.ctypes.data)
            alns[i] = (an, aq)
    else:
        qw = p.q_pad + 1
        for b, i in enumerate(p.idx):
            ent = paths[b, :plen[b]][::-1]
            ranks, jc = ent // qw, ent % qw
            an = np.where(ranks > 0, p.orders[b][np.maximum(ranks - 1, 0)], -1)
            alns[i] = (an.astype(np.int32), (jc - 1).astype(np.int32))
    _stage(stats, "decode", t0, None)
    return alns


def _stage(stats, name, t0, dev):
    """Add the seconds since t0 to stats[name] (after waiting for the card
    when stats asks for synchronised stages); returns the new start."""
    if stats is None:
        return t0
    if dev is not None and dev.type == "cuda" and stats.get("synchronize"):
        torch.cuda.synchronize(dev)
    now = time.perf_counter()
    stats[name] = stats.get(name, 0.0) + (now - t0)
    return now


def align_batch(graphs, seqs, params: PoaParams | None = None, device="cuda",
                as_arrays: bool = False):
    """Align seqs[i] to graphs[i] (NativePoaGraph) with one upload, one
    launch of each kernel and one fetch; returns (scores, alignments).  Each
    alignment is a list of (node | None, qpos | None), or with as_arrays an
    (an, aq) int32 pair (-1 = None).  A window with an empty graph scores 0
    (the oracle's answer) and aligns its whole query as new nodes."""
    params = _check_params(params or PoaParams())
    dev = resolve_device(device)
    if len(graphs) != len(seqs):
        raise ValueError(f"{len(graphs)} graphs and {len(seqs)} queries")
    p = _dispatch(graphs, seqs, params, dev, _HostBuffers(dev.type == "cuda"), 0, None)
    alns = _collect(p, None)
    scores = [0] * len(graphs)
    if p.idx:
        out = p.out.numpy() if isinstance(p.out, torch.Tensor) else p.out
        for b, i in enumerate(p.idx):
            scores[i] = int(out[b])
    if as_arrays:
        return scores, alns
    return scores, [[(None if a < 0 else int(a), None if q < 0 else int(q))
                     for a, q in zip(an, aq)] for an, aq in alns]


def msa_consensus_batch(windows, params: PoaParams | None = None, slab: int = 256,
                        device="cuda", stats: dict | None = None):
    """The poa benchmark: the consensus (int64 base codes) of each window, a
    list of int-coded reads, as the reference's per-window spoa loop gives
    it.

    Windows go in `slab`-sized groups sorted by their longest read; each MSA
    round aligns every window's next read.  Per (round, slab) the host
    exports the graphs into one buffer, uploads it, launches the fill and
    the backtrack once each and fetches the paths into a page-locked buffer
    behind an event, all without waiting; then it decodes and fuses the
    previous slab's paths while the card runs this one's.  Nothing waits for
    the card inside the round loop but the event of the slab being
    collected.  With device="cpu" the plain versions run, in turn.

    stats, if given, gathers the seconds of each stage on the host (export
    and marshal, upload, fill kernel, backtrack kernel, fetch, decode, fuse,
    consensus), the DP cells (nodes x qlen summed over the calls) and the
    calls; with stats["synchronize"] true each stage waits for the card, so
    its seconds are its own (and nothing overlaps)."""
    params = _check_params(params or PoaParams())
    dev = resolve_device(device)
    if slab < 1:
        raise ValueError(f"slab must be at least 1, got {slab}")
    graphs = [NativePoaGraph(params, cap=sum(len(s) for s in w) + 8) for w in windows]
    bufs = _HostBuffers(dev.type == "cuda")
    max_rounds = max((len(w) for w in windows), default=0)
    # windows sorted by their longest read, so each slab's planes stay close
    # to its own sizes (ops/poa.py:719-727)
    w_order = sorted(range(len(windows)),
                     key=lambda i: max((len(s) for s in windows[i]), default=0))
    slabs = [w_order[o:o + slab] for o in range(0, len(windows), slab)]
    for w, g in zip(windows, graphs):
        if w:
            g.add_alignment([], np.asarray(w[0]))
    for s in range(1, max_rounds):
        jobs = []
        for k, sl in enumerate(slabs):
            idx = [i for i in sl if s < len(windows[i])]
            if idx:
                jobs.append((k, [graphs[i] for i in idx], [np.asarray(windows[i][s])
                                                            for i in idx]))
        pending = None
        for job in jobs + [None]:       # the sentinel drains the pipeline
            nxt = None
            if job is not None:
                k, gs, qs = job
                nxt = (_dispatch(gs, qs, params, dev, bufs, k, stats), gs, qs)
            if pending is not None:
                p, gs, qs = pending
                alns = _collect(p, stats)
                t0 = time.perf_counter()
                for g, a, q in zip(gs, alns, qs):
                    g.add_alignment(a, q)
                _stage(stats, "fuse", t0, None)
            pending = nxt
    t0 = time.perf_counter()
    res = [g.consensus() for g in graphs]
    _stage(stats, "consensus", t0, None)
    return res
