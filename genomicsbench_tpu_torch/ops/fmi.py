"""FM-index SMEM seeding (bwa-mem2's fmi benchmark) in PyTorch.

The port of genomicsbench_tpu/ops/fmi.py.  The three seeding passes of
benchmarks/fmi/fmi.cpp:218-266 over an FMD (bidirectional) index of
T = ref . revcomp(ref): pass 1 all SMEMs (bwt_smem1 from every pivot,
min_intv 1), pass 2 the reseed of long rare SMEMs from their midpoints
(min_intv = s + 1, parents of length >= split_len and s <= split_width),
pass 3 the seed strategy (bwt_seed_strategy1, min_len = minSeedLen + 1,
max_intv = maxMemIntv).  The outputs are the JAX package's, in its order:
every (rid, m, n, k, s), pass by pass.

Host part (numpy, copied): the index build `build_fmd_index` over the
port's SA-IS (`native/sais.cpp`), which refuses a reference with a code
above 3, and the assembly of each pass's results (`_ragged_cols`,
`_sort_by_start`, the pass-2 parent filter, the e-table mask).

Device part: three functions over the packed (n_blocks, 8) int32 line
table (`FmdIndex.device`: occ counts in columns 0-3, then the two bit
planes of 64 BWT rows), each in two versions:

* `fmi_smem1`: the bwt_smem1 walk, one work item per read (pass 1) or per
  parent (pass 2, from a pivot, on the read `qrow` names).  On the card the
  hand-written kernel `gb_fmi_smem1` of `csrc/fmi.cu` (one thread per work
  item); on the CPU `fmi_smem1_reference`, the JAX register walk's state
  machine (`_pass1_smem1_reg`, ops/fmi.py:1805) over (N,) tensors.
* `fmi_seed3`: the pass-3 seed-strategy walk with its (k, s) from the
  unfloored tail; `gb_fmi_seed3`, or `fmi_seed3_reference`
  (`_pass3_jump_reg`, :2335).
* `fmi_extend`: forward extension, one lane per (work item, start), to
  max_e or death; the e-table that takes the work items whose interval list
  or emit slots overflow.  `gb_fmi_extend`, or `fmi_extend_reference`
  (`_extend_lanes_init` / `_extend_lanes_run`, :349-410).

The walks keep JAX's caps: at most CP = min(L + 1, 24) intervals in a
list and ME = min(L + 1, 48) emits per work item, where L is the batch
width.  A work item past either is flagged (`ovf`) and stops; the pipeline
reroutes it through the e-table, which gives the same SMEM set.  Every
version also counts, per work item, its extension steps and the rank lines
they loaded (one 32-byte line per row, one for both rows when they share a
block), the work the kernels' bound is counted from.

The TPU schedules of the same walks (`_pass1_smem1`, `_pass1_jump`,
`_pass1_jump_queued`, `_pass3_jump`, their work queues, flush windows and
environment knobs, the spans post-pass) and the `mesh` argument with
`ShardedOccTable` have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device

BLOCK = 64            # BWT rows per line of the table
CP_MAX = 24           # interval-list slots of a walk (JAX's CP cap)
ME_MAX = 48           # emit slots of a pass-1/2 work item (JAX's ME cap)
MAX_WIDTH = 1 << 15   # JAX packs m and e into 16-bit halves (:1839, :2363)
MAX_ROWS = 1 << 31    # int32 rows on the device
# int32 operations of one FMD extension step at the card's best form
# (breakdown in csrc/fmi.cu), for the kernels' bound
FMI_INT32_OPS_PER_STEP = 91

_U8, _I32, _I64 = torch.uint8, torch.int32, torch.int64
# SWAR popcount masks
_M1, _M2, _M4 = 0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F


# ---------------------------------------------------------------------------
# host-side index build
# ---------------------------------------------------------------------------

def suffix_array(t: np.ndarray) -> np.ndarray:
    """Suffix array of codes 0..4; shorter suffixes sort first on tied
    prefixes (the implicit-$ convention).  SA-IS in the port's host library
    (`native/sais.cpp`)."""
    from genomicsbench_tpu_torch import native

    t = np.asarray(t, np.uint8)
    if len(t) <= 1:
        return np.zeros(len(t), np.int64)
    return native.suffix_array(t)


@dataclasses.dataclass
class FmdTables:
    """The index on a device: C (5,) int32, the packed line table
    (n_blocks, 8) int32 and the sentinel row (a 0-d int32 tensor), with
    host copies of C and the sentinel row for the launches."""

    C: torch.Tensor
    table: torch.Tensor
    sent_row: torch.Tensor
    c_host: tuple
    sent_host: int

    @property
    def n_rows(self) -> int:
        return int(self.c_host[4])


@dataclasses.dataclass
class FmdIndex:
    """Bidirectional FM index over T = ref . revcomp(ref) with implicit $."""

    n: int                    # text length
    C: np.ndarray             # (5,) C[c] = #symbols < c in BWT rows (incl. $)
    occ_cp: np.ndarray        # (n_blocks, 4) int32 checkpointed ranks
    plane0: np.ndarray        # (n_blocks, 2) uint32 bit0 of each symbol
    plane1: np.ndarray        # (n_blocks, 2) uint32 bit1
    valid: np.ndarray         # (n_blocks, 2) uint32 1 = real non-sentinel row
    sentinel_row: int
    sa: np.ndarray            # (n+1,) row -> text position (n = $)

    def packed(self) -> np.ndarray:
        """The (n_blocks, 8) int32 line table: occ counts, plane0, plane1.
        The sentinel row's cleaned symbol (0) sits in the planes; the rank
        subtracts it arithmetically."""
        return np.ascontiguousarray(np.concatenate([
            self.occ_cp.astype(np.int32),
            self.plane0.view(np.int32), self.plane1.view(np.int32)], axis=1))

    def device(self, device="cuda") -> FmdTables:
        """The tables on `device`, one upload (about 100 MB at a 100 Mb
        reference)."""
        dev = resolve_device(device)
        C = np.asarray(self.C, np.int64)
        return FmdTables(
            C=torch.from_numpy(C.astype(np.int32)).to(dev),
            table=torch.from_numpy(self.packed()).to(dev),
            sent_row=torch.tensor(self.sentinel_row, dtype=_I32, device=dev),
            c_host=tuple(int(c) for c in C), sent_host=int(self.sentinel_row))

    def locate(self, k: int, s: int, seed_len: int, max_occ: int = 0):
        """SA lookup (FMI_search::get_sa_entries): the forward-reference
        positions of interval (k, s) and whether each hit is on the reverse
        strand; every ceil(s/max_occ)-th entry when max_occ > 0."""
        s = int(s)
        rows = np.arange(int(k), int(k) + s)
        if max_occ and s > max_occ:
            step = -(-s // max_occ)
            rows = rows[::step]
        p = self.sa[rows]
        rlen = self.n // 2
        is_rev = p >= rlen
        pos = np.where(is_rev, self.n - p - seed_len, p)
        return pos.astype(np.int64), is_rev


def _ragged_cols(count) -> np.ndarray:
    """[arange(c) for c in count] flattened, without a Python loop."""
    count = np.asarray(count, np.int64)
    total = int(count.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    off = np.concatenate([[0], np.cumsum(count)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(off, count)


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of codes 0..3 (uint8)."""
    return np.uint8(3) - np.asarray(codes, np.uint8)[::-1]


def build_fmd_index(ref_codes: np.ndarray) -> FmdIndex:
    """ref_codes: (L,) codes 0..3.  A code above 3 (an ambiguous base) is
    refused with ValueError naming its position: split contigs there."""
    ref_codes = np.asarray(ref_codes)
    bad = np.nonzero((ref_codes < 0) | (ref_codes > 3))[0]
    if len(bad):
        raise ValueError(
            f"reference code {int(ref_codes[bad[0]])} at position {int(bad[0])} is not "
            f"0..3 (A, C, G, T); split the reference at ambiguous bases "
            f"({len(bad)} such positions)")
    ref_codes = ref_codes.astype(np.uint8)
    t = np.concatenate([ref_codes, revcomp_codes(ref_codes)]).astype(np.uint8)
    n = len(t)
    # the device's rows (k, l, s) and the line table are int32
    if n + 1 >= MAX_ROWS:
        raise ValueError(
            f"FMD index rows {n + 1} overflow the int32 device lane state; "
            "split the reference into <1 Gbase shards")
    sa = np.empty(n + 1, np.int64)  # row 0 = $ suffix
    sa[0] = n
    sa[1:] = suffix_array(t)
    bwt_pos = (sa - 1).astype(np.int32)
    bwt = np.where(bwt_pos >= 0, t[np.maximum(bwt_pos, 0)], np.uint8(255))
    sentinel_row = int(np.nonzero(bwt == 255)[0][0])
    bwt_clean = np.where(bwt == 255, np.uint8(0), bwt)

    C = np.zeros(5, dtype=np.int64)
    C[0] = 1
    for c in range(4):
        C[c + 1] = C[c] + int((t == c).sum())

    n_rows = n + 1
    n_blocks = -(-n_rows // BLOCK)
    pad = n_blocks * BLOCK - n_rows
    bwt_pad = np.concatenate([bwt_clean, np.zeros(pad, np.uint8)])
    is_real = np.ones(n_rows, bool)
    is_real[sentinel_row] = False
    real_pad = np.concatenate([is_real, np.zeros(pad, bool)])

    blocks = bwt_pad.reshape(n_blocks, BLOCK)
    realb = real_pad.reshape(n_blocks, BLOCK)
    per_block = np.stack([((blocks == c) & realb).sum(1) for c in range(4)], 1)
    occ_cp = np.zeros((n_blocks, 4), np.int64)
    occ_cp[1:] = np.cumsum(per_block, axis=0)[:-1]

    def pack(bits):
        # (n_blocks, 64) bool -> two little-endian uint32 words per block
        return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)

    return FmdIndex(
        n=n, C=C, occ_cp=occ_cp.astype(np.int32),
        plane0=pack((blocks & 1).astype(bool)),
        plane1=pack(((blocks >> 1) & 1).astype(bool)),
        valid=pack(realb),
        sentinel_row=sentinel_row, sa=sa,
    )


def cleaned_bwt(index: FmdIndex) -> np.ndarray:
    """The cleaned BWT (n + 1 uint8 symbols, the sentinel row as 0), read
    back from the bit planes."""
    n_rows = index.n + 1
    p0 = np.unpackbits(index.plane0.view(np.uint8).reshape(-1, 8), axis=1,
                       bitorder="little").reshape(-1)[:n_rows]
    p1 = np.unpackbits(index.plane1.view(np.uint8).reshape(-1, 8), axis=1,
                       bitorder="little").reshape(-1)[:n_rows]
    return (p0 | (p1 << 1)).astype(np.uint8)


# ---------------------------------------------------------------------------
# rank and FMD extension (plain versions; csrc/fmi.cu has the device ones)
# ---------------------------------------------------------------------------

def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 (SWAR; the arithmetic shifts' sign bits are
    masked off at every step)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _word(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int32 words of a bit plane as one int64 (bit i = row i)."""
    return (lo & 0xFFFFFFFF) | (hi << 32)


def _rank4(tab: FmdTables, row: torch.Tensor) -> torch.Tensor:
    """Counts of each base in BWT[0:row], (M,) int64 -> (M, 4) int64
    (`_rank4`, ops/fmi.py:279-295): the line's counts plus the masked
    popcounts, with the sentinel row (whose cleaned symbol 0 the planes
    hold) taken out of base 0."""
    blk = row >> 6
    off = row & 63
    line = tab.table[blk].long()
    w0, w1 = _word(line[:, 4], line[:, 5]), _word(line[:, 6], line[:, 7])
    mask = torch.where(off == 63, torch.full_like(off, (1 << 63) - 1),
                       (torch.ones_like(off) << off.clamp(max=62)) - 1)
    hits = torch.stack([~w0 & ~w1, w0 & ~w1, ~w0 & w1, w0 & w1], 1) & mask[:, None]
    ranks = line[:, :4] + _popcount64(hits)
    sent = tab.sent_host
    ranks[:, 0] -= ((blk == (sent >> 6)) & (sent < row)).long()
    return ranks


def _ext(tab: FmdTables, a, other, s, c):
    """The symmetric FMD extension core (`_ext_pick_sym`, :309-328) on
    (M,) int64 rows: the rank pair at rows a and a + s, picking symbol c.
    Backward extension is (a, other) = (k, l) with c = base; forward is
    (a, other) = (l, k) with c = 3 - base.  Returns (a', other', s', the
    rank lines loaded: 1 when both rows share a block, else 2)."""
    M = a.numel()
    both = _rank4(tab, torch.cat([a, a + s]))
    lo, hi = both[:M], both[M:]
    s4 = hi - lo
    sent = tab.sent_host
    sent_cnt = ((sent >= a) & (sent < a + s)).long()
    zero = torch.zeros_like(a)
    suf = torch.stack([s4[:, 1] + s4[:, 2] + s4[:, 3], s4[:, 2] + s4[:, 3], s4[:, 3], zero], 1)
    cc = c[:, None]
    other_n = other + sent_cnt + suf.gather(1, cc)[:, 0]
    a_n = tab.C.long()[c] + lo.gather(1, cc)[:, 0]
    s_n = s4.gather(1, cc)[:, 0]
    loads = 1 + ((a >> 6) != ((a + s) >> 6)).long()
    return a_n, other_n, s_n, loads


def _ext_masked(tab: FmdTables, sel, a, other, s, c):
    """`_ext` on the lanes where `sel` holds; zeros elsewhere."""
    out = [torch.zeros_like(a) for _ in range(4)]
    idx = sel.nonzero().flatten()
    if idx.numel():
        got = _ext(tab, a[idx], other[idx], s[idx], c[idx])
        for o, g in zip(out, got):
            o[idx] = g
    return out


def _seed(tab: FmdTables, nb):
    """The single-base bi-interval of clipped base nb: (k, l, s)."""
    C = tab.C.long()
    return C[nb], C[3 - nb], C[nb + 1] - C[nb]


# ---------------------------------------------------------------------------
# shared checks of the wrappers
# ---------------------------------------------------------------------------

def _check_tables(tab: FmdTables, dev):
    if tab.n_rows >= MAX_ROWS:
        raise ValueError(f"index rows {tab.n_rows} do not fit the int32 device rows")
    if tab.table.dim() != 2 or tab.table.shape[1] != 8 or tab.table.dtype != _I32:
        raise ValueError("the line table must be (n_blocks, 8) int32")
    if tab.table.shape[0] * BLOCK < tab.n_rows:
        raise ValueError(f"the line table holds {tab.table.shape[0]} blocks, too few for "
                         f"{tab.n_rows} rows")
    for name, t in (("table", tab.table), ("C", tab.C)):
        if t.device != dev:
            raise ValueError(f"index {name} is on {t.device}, the query on {dev}")
    if not tab.table.is_contiguous():
        raise ValueError("the line table must be contiguous")


def _check_query(query, qlen):
    if query.dtype != _U8:
        raise TypeError(f"query must be uint8, got {query.dtype}")
    if query.dim() != 2:
        raise ValueError(f"query must be (B, L), got shape {tuple(query.shape)}")
    if query.shape[1] >= MAX_WIDTH:
        raise ValueError(f"read width {query.shape[1]} overflows the 16-bit m/e fields "
                         f"(must be below {MAX_WIDTH})")
    if qlen.dtype != _I32:
        raise TypeError(f"qlen must be int32, got {qlen.dtype}")
    if qlen.shape != (query.shape[0],):
        raise ValueError(f"qlen has shape {tuple(qlen.shape)}, the query {query.shape[0]} rows")
    if qlen.device != query.device:
        raise ValueError(f"qlen is on {qlen.device}, the query on {query.device}")
    if not (query.is_contiguous() and qlen.is_contiguous()):
        raise ValueError("query and qlen must be contiguous")


def _check_items(n, items: dict, n_rows: int, dev):
    """Per-item int32 vectors: on the query's device, length n, contiguous;
    `qrow` within the query's rows."""
    for name, t in items.items():
        if t is None:
            continue
        if t.dtype != _I32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name} must be one-dimensional of length {n}, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the query on {dev}")
    qrow = items.get("qrow")
    if qrow is not None and n:
        lo, hi = (int(v) for v in torch.aminmax(qrow))
        if lo < 0 or hi >= n_rows:
            raise ValueError(f"qrow values {lo}..{hi} fall outside the query's "
                             f"{n_rows} rows")


def _launch_consts(tab: FmdTables):
    return [int(c) for c in tab.c_host] + [tab.sent_host]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# kernel 3: forward extension lanes (the e-table)
# ---------------------------------------------------------------------------

def fmi_extend_reference(tab: FmdTables, query, qlen, qrow, start, min_intv, max_e):
    """The plain version of `fmi_extend`: `_extend_lanes_init` and
    `_extend_lanes_run` (ops/fmi.py:349-410) over all lanes, one step per
    loop turn until every lane is dead."""
    N, L = qrow.numel(), query.shape[1]
    out = torch.zeros((5, N), dtype=_I32, device=query.device)
    if N == 0:
        return out
    row = qrow.long()
    ql = qlen.long()[row]
    st, mi, me = start.long(), min_intv.long(), max_e.long()
    base0 = query[row, st.clamp(0, L - 1)].long()
    k, l, s0 = _seed(tab, base0.clamp(0, 3))
    alive = (base0 < 4) & (st < ql) & (st >= 0) & (s0 >= mi)
    s = torch.where(alive, s0, torch.zeros_like(s0))
    e = torch.where(alive, st + 1, st)
    loads, steps = torch.zeros_like(st), torch.zeros_like(st)
    while bool(alive.any()):
        pos = e
        nb = query[row, pos.clamp(0, L - 1)].long()
        can = alive & (pos < ql) & (pos < me) & (nb < 4)
        l_n, k_n, s_n, ld = _ext_masked(tab, can, l, k, s, 3 - nb.clamp(0, 3))
        loads += ld
        steps += can.long()
        ok = can & (s_n >= mi)
        k, l, s = (torch.where(ok, n_, o_) for n_, o_ in ((k_n, k), (l_n, l), (s_n, s)))
        e = torch.where(ok, pos + 1, e)
        alive = ok
    out[0], out[1], out[2], out[3], out[4] = e, k, s, loads, steps
    return out


def fmi_extend(tab: FmdTables, query, qlen, qrow, start, min_intv, max_e) -> torch.Tensor:
    """Forward extension from `start` on query row `qrow`, one lane per
    entry, with floor `min_intv`, to `max_e` or death.  Returns one (5, N)
    int32 tensor: e (the end reached), k, s, the rank lines loaded and the
    extension steps taken.

    Checks on the host before any build or launch.  CPU tensors take the
    plain version; CUDA tensors launch `gb_fmi_extend` once on the current
    stream, without synchronising, and raise if the launch fails."""
    dev = query.device
    _check_query(query, qlen)
    _check_tables(tab, dev)
    N = qrow.numel()
    _check_items(N, dict(qrow=qrow, start=start, min_intv=min_intv, max_e=max_e),
                 query.shape[0], dev)
    if dev.type == "cpu":
        return fmi_extend_reference(tab, query, qlen, qrow, start, min_intv, max_e)
    if dev.type != "cuda":
        raise ValueError(f"fmi_extend runs on cuda or cpu tensors, not {dev}")
    out = torch.zeros((5, N), dtype=_I32, device=dev)
    if N == 0:
        return out
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.gb_fmi_extend(tab.table.data_ptr(), query.data_ptr(), query.shape[1],
                               qlen.data_ptr(), qrow.data_ptr(), start.data_ptr(),
                               min_intv.data_ptr(), max_e.data_ptr(), N,
                               *_launch_consts(tab), out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fmi extend kernel launch failed with cudaError {rc}")
    fmi_extend.launches += 1
    return out


fmi_extend.launches = 0     # kernel launches, counted where they happen


# ---------------------------------------------------------------------------
# kernel 1: the bwt_smem1 walk (passes 1 and 2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WalkOut:
    """A walk's results, views of one int32 buffer `buf` (one fetch):
    count, ovf (1 = a cap overflowed: the item stopped and is rerouted),
    loads (rank lines per work item), steps (extension steps per work
    item), and the emit slots (N, cap, 4).  The smem1 walk's slot fields
    are (m, e, k, s) with e exclusive; the seed walk's (m, n, k, s) with n
    inclusive.  Slots past count are 0."""

    buf: torch.Tensor
    count: torch.Tensor
    ovf: torch.Tensor | None
    loads: torch.Tensor
    steps: torch.Tensor
    slots: torch.Tensor


SMEM1_HEAD, SEED3_HEAD = 4, 3   # per-item rows ahead of the slots


def _walk_out(buf, N, cap, head):
    views = buf[:head * N].view(head, N)
    slots = buf[head * N:].view(N, cap, 4)
    if head == SMEM1_HEAD:
        return WalkOut(buf, views[0], views[1], views[2], views[3], slots)
    return WalkOut(buf, views[0], None, views[1], views[2], slots)


def walk_caps(width: int) -> tuple[int, int]:
    """(CP, ME): the interval-list and emit caps of a smem1 walk over a
    batch of width `width` (JAX's :1836-1837)."""
    return min(width + 1, CP_MAX), min(width + 1, ME_MAX)


def seed3_cap(width: int, min_len: int) -> int:
    """EM3: the emit slots of a pass-3 walk (JAX's :2360)."""
    return min(width + 1, max(16, width // max(min_len, 1) + 2))


def fmi_smem1_reference(tab: FmdTables, query, qlen, qrow=None, pivot=None,
                        min_intv=None, *, min_seed_len: int) -> WalkOut:
    """The plain version of `fmi_smem1`: the state machine of JAX's register
    walk (`_pass1_smem1_reg`, ops/fmi.py:1805-2168, its lockstep schedule)
    over (N,) tensors, the interval lists as (N, CP) tensors, one loop turn
    per round until every work item is done."""
    dev = query.device
    B, L = query.shape
    has_pivot = pivot is not None
    N = qrow.numel() if qrow is not None else B
    CP, ME = walk_caps(L)
    buf = torch.zeros(N * (SMEM1_HEAD + 4 * ME), dtype=_I32, device=dev)
    res = _walk_out(buf, N, ME, SMEM1_HEAD)
    if N == 0:
        return res
    row = qrow.long() if qrow is not None else torch.arange(N, device=dev)
    ql = qlen.long()[row]
    mi = min_intv.long() if min_intv is not None else torch.ones(N, dtype=_I64, device=dev)
    INIT, FWD, BWD, DONE = 0, 1, 2, 3
    z = torch.zeros(N, dtype=_I64, device=dev)
    f = torch.zeros(N, dtype=torch.bool, device=dev)
    phase = torch.where(ql < 1, DONE, INIT)
    x = pivot.long().clone() if has_pivot else z.clone()
    i, j, ptr, prev_n, curr_n, cnt, last_s, ex = (z.clone() for _ in range(8))
    wk, wl, ws, count, loads, steps = (z.clone() for _ in range(6))
    emitted, first, ovf = f.clone(), f.clone(), f.clone()
    lists = torch.zeros((6, N, CP), dtype=_I64, device=dev)   # pbk pbs pbe cbk cbs cbe
    slots = torch.zeros((N, ME, 4), dtype=_I64, device=dev)
    while bool((phase != DONE).any()):
        is_init, is_fwd, is_bwd = phase == INIT, phase == FWD, phase == BWD
        pos = torch.where(is_fwd, i, torch.where(is_bwd, j, x))
        nb_raw = query[row, pos.clamp(0, L - 1)].long()
        nb = nb_raw.clamp(0, 3)
        nb_ok = (nb_raw < 4) & (pos >= 0) & (pos < ql)

        bwd_live = is_bwd & (ptr < prev_n)
        idx = torch.where(first, prev_n - 1 - ptr, ptr).clamp(0, CP - 1)
        pk, ps, pe = (lists[c].gather(1, idx[:, None])[:, 0] for c in range(3))

        # one rank-pair extension for the FWD and live BWD lanes
        a_in = torch.where(is_fwd, wl, pk)
        o_in = torch.where(is_fwd, wk, z)
        s_in = torch.where(is_fwd, ws, ps.clamp(min=0)).clamp(min=1)
        c_in = torch.where(is_fwd, 3 - nb, nb)
        ext_lane = (is_fwd | bwd_live) & nb_ok
        a_n, o_n, s_n, ld = _ext_masked(tab, ext_lane, a_in, o_in, s_in, c_in)
        loads += ld
        steps += ext_lane.long()

        # INIT: seed the single-base interval at x
        k0, l0, s0 = _seed(tab, nb)
        seed_ok = is_init & nb_ok & (s0 >= mi)
        init_done = is_init & (x >= ql)
        init_dead = is_init & ~seed_ok & ~init_done

        # FWD: one forward base, record on a change of size
        kf, lf, sf = o_n, a_n, s_n
        stopf = is_fwd & (~nb_ok | (sf < mi))
        growf = is_fwd & ~stopf
        push = stopf | (growf & (sf != ws))

        # BWD: one backward try of prev[idx]
        kb, sb = a_n, s_n
        die = bwd_live & (~nb_ok | (sb < mi))
        surv = bwd_live & ~die
        emit = die & (curr_n == 0) & ~emitted & (pe - (j + 1) >= min_seed_len)
        append = surv & ((curr_n == 0) | (sb != last_s))

        new_ovf = (push & (cnt >= CP)) | (emit & (count >= ME))
        push_w, emit_w = push & ~new_ovf, emit & ~new_ovf
        pl = push_w.nonzero().flatten()
        if pl.numel():
            col = cnt[pl]
            lists[0, pl, col], lists[1, pl, col], lists[2, pl, col] = wk[pl], ws[pl], i[pl]
        al = append.nonzero().flatten()
        if al.numel():
            col = curr_n[al]
            lists[3, al, col], lists[4, al, col], lists[5, al, col] = kb[al], sb[al], pe[al]
        el = emit_w.nonzero().flatten()
        if el.numel():
            slots[el, count[el]] = torch.stack([j[el] + 1, pe[el], pk[el], ps[el]], 1)
        count = count + emit_w.long()

        cnt_n = cnt + push_w.long()
        curr_n1 = curr_n + append.long()
        emitted1 = emitted | (die & (curr_n == 0))
        ptr1 = ptr + bwd_live.long()
        col_end = is_bwd & (ptr1 >= prev_n)
        col_next = col_end & (curr_n1 > 0)
        piv_end = (col_end & (curr_n1 == 0)) | (is_bwd & (prev_n == 0))
        ovf = ovf | new_ovf

        x_next = torch.maximum(ex, x + 1)
        new_x = torch.where(piv_end, x_next, torch.where(init_dead, x + 1, x))
        to_done = init_done | (piv_end & has_pivot) | (piv_end & (x_next >= ql)) | new_ovf
        to_init = (piv_end & ~to_done) | init_dead
        phase = torch.where(seed_ok, FWD, phase)
        phase = torch.where(stopf, BWD, phase)
        phase = torch.where(to_init, INIT, phase)
        phase = torch.where(to_done, DONE, phase)

        # col_next: prev <- curr
        lists[:3] = torch.where(col_next[None, :, None], lists[3:], lists[:3])

        i_old = i
        i = torch.where(seed_ok, x + 1, torch.where(growf, i + 1, i))
        j = torch.where(stopf, x - 1, torch.where(col_next, j - 1, j))
        ptr = torch.where(stopf | col_next, z, ptr1)
        prev_n = torch.where(stopf, cnt_n, torch.where(col_next, curr_n1, prev_n))
        curr_n = torch.where(stopf | col_next, z, curr_n1)
        cnt = torch.where(seed_ok, z, cnt_n)
        last_s = torch.where(append, sb, last_s)
        emitted = torch.where(stopf | col_next, f, emitted1)
        first = torch.where(stopf, True, first & ~col_next)
        ex = torch.where(stopf, i_old, ex)
        wk = torch.where(seed_ok, k0, torch.where(growf, kf, wk))
        wl = torch.where(seed_ok, l0, torch.where(growf, lf, wl))
        ws = torch.where(seed_ok, s0, torch.where(growf, sf, ws))
        x = new_x
    res.count.copy_(count)
    res.ovf.copy_(ovf)
    res.loads.copy_(loads)
    res.steps.copy_(steps)
    res.slots.copy_(slots)
    return res


def fmi_smem1(tab: FmdTables, query, qlen, qrow=None, pivot=None, min_intv=None, *,
              min_seed_len: int) -> WalkOut:
    """The bwt_smem1 walk.  Without `qrow` one work item per read: every
    SMEM of length >= min_seed_len, pivot after pivot (pass 1, min_intv 1
    unless given).  With `qrow`, `pivot` and `min_intv` one work item per
    entry, on read qrow[w]: the first position at or after pivot[w] that
    seeds, one walk (pass 2).  Emits in each work item's walk order.

    Checks on the host before any build or launch.  CPU tensors take the
    plain version; CUDA tensors launch `gb_fmi_smem1` once on the current
    stream, without synchronising, and raise if the launch fails."""
    dev = query.device
    _check_query(query, qlen)
    _check_tables(tab, dev)
    B, L = query.shape
    if (pivot is None) != (qrow is None):
        raise ValueError("qrow and pivot come together (pass 2) or not at all (pass 1)")
    N = qrow.numel() if qrow is not None else B
    _check_items(N, dict(qrow=qrow, pivot=pivot, min_intv=min_intv), B, dev)
    if dev.type == "cpu":
        return fmi_smem1_reference(tab, query, qlen, qrow, pivot, min_intv,
                                   min_seed_len=min_seed_len)
    if dev.type != "cuda":
        raise ValueError(f"fmi_smem1 runs on cuda or cpu tensors, not {dev}")
    CP, ME = walk_caps(L)
    # one int32 past the outputs: the kernel's work counter
    full = torch.zeros(N * (SMEM1_HEAD + 4 * ME) + 1, dtype=_I32, device=dev)
    res = _walk_out(full[:-1], N, ME, SMEM1_HEAD)
    if N == 0:
        return res
    from genomicsbench_tpu_torch import _kernels

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.gb_fmi_smem1(tab.table.data_ptr(), query.data_ptr(), L, qlen.data_ptr(),
                              ptr(qrow), ptr(pivot), ptr(min_intv), N, int(pivot is not None),
                              min_seed_len, CP, ME, *_launch_consts(tab), full.data_ptr(),
                              None, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fmi smem1 kernel launch failed with cudaError {rc}")
    fmi_smem1.launches += 1
    return res


fmi_smem1.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: the pass-3 seed-strategy walk
# ---------------------------------------------------------------------------

def fmi_seed3_reference(tab: FmdTables, query, qlen, *, min_intv: int,
                        min_len: int) -> WalkOut:
    """The plain version of `fmi_seed3`: the state machine of JAX's
    `_pass3_jump_reg` (ops/fmi.py:2335-2455) over (B,) tensors, one loop
    turn per round until every read is done."""
    dev = query.device
    B, L = query.shape
    EM3 = seed3_cap(L, min_len)
    buf = torch.zeros(B * (SEED3_HEAD + 4 * EM3), dtype=_I32, device=dev)
    res = _walk_out(buf, B, EM3, SEED3_HEAD)
    if B == 0:
        return res
    rows = torch.arange(B, device=dev)
    ql = qlen.long()
    z = torch.zeros(B, dtype=_I64, device=dev)
    f = torch.zeros(B, dtype=torch.bool, device=dev)
    x, exr, ek, el, es, ee, count, loads, steps = (z.clone() for _ in range(9))
    done, alive, tail = ql < 1, f.clone(), f.clone()
    slots = torch.zeros((B, EM3, 4), dtype=_I64, device=dev)
    while bool((~done).any()):
        hop = ~alive & ~done
        pos = torch.where(alive, ee, x)
        nb_raw = query[rows, pos.clamp(0, L - 1)].long()
        nb = nb_raw.clamp(0, 3)

        # extension lanes: one forward base
        can = alive & (pos < ql) & (nb_raw < 4)
        l_n, k_n, s_n, ld = _ext_masked(tab, can, el, ek, es.clamp(min=0), 3 - nb)
        loads += ld
        steps += can.long()
        enter_tail = can & ~tail & (s_n < min_intv)
        exr2 = torch.where(enter_tail | (alive & ~can & ~tail), ee, exr)
        tail2 = tail | enter_tail
        istar = torch.maximum(exr2, x + min_len)
        stop = can & tail2 & (pos + 1 >= istar + 1)
        die = alive & ~can

        # emission at the stop
        sl = stop.nonzero().flatten()
        if sl.numel():
            slots[sl, count[sl].clamp(max=EM3 - 1)] = torch.stack(
                [x[sl], istar[sl], k_n[sl], s_n[sl]], 1)
        count = count + stop.long()
        x_after = torch.where(stop, istar + 1, torch.where(pos >= ql, ql, pos + 1))

        # hop lanes: an N advances x, else seed
        hop_n = hop & (x < ql) & (nb_raw >= 4)
        seed = hop & (x < ql) & (nb_raw < 4)
        k0, l0, s0 = _seed(tab, nb)
        tail0 = s0 < min_intv
        hop_done = hop & (x >= ql)

        ended = stop | die
        new_x = torch.where(ended, x_after, torch.where(hop_n, x + 1, x))
        new_done = done | hop_done | (ended & (x_after >= ql)) | (hop_n & (x + 1 >= ql))
        new_alive = torch.where(seed, True, torch.where(ended | hop_n, False, alive))
        tail = torch.where(seed, tail0, torch.where(ended, False, tail2))
        exr = torch.where(seed, torch.where(tail0, x, x + 1), exr2)
        ek = torch.where(seed, k0, torch.where(can, k_n, ek))
        el = torch.where(seed, l0, torch.where(can, l_n, el))
        es = torch.where(seed, torch.where(x < ql, s0, z), torch.where(can, s_n, es))
        ee = torch.where(seed, x + 1, torch.where(can, pos + 1, ee))
        x, done = new_x, new_done
        alive = new_alive & ~new_done
    res.count.copy_(count)
    res.loads.copy_(loads)
    res.steps.copy_(steps)
    res.slots.copy_(slots)
    return res


def fmi_seed3(tab: FmdTables, query, qlen, *, min_intv: int, min_len: int) -> WalkOut:
    """bwt_seed_strategy1 over every read: from x, extend to the floored end
    e(x) (floor min_intv), then on without the floor until the segment
    [x, i*] with i* = max(e(x), x + min_len) is covered; emit it with the
    interval of that tail (s may be 0) and hop to i* + 1.  An ambiguous
    base or the read's end stops a walk without emission.

    Checks on the host before any build or launch.  CPU tensors take the
    plain version; CUDA tensors launch `gb_fmi_seed3` once on the current
    stream, without synchronising, and raise if the launch fails."""
    dev = query.device
    _check_query(query, qlen)
    _check_tables(tab, dev)
    if min_len < 1:
        raise ValueError(f"min_len must be at least 1, got {min_len}")
    B, L = query.shape
    if dev.type == "cpu":
        return fmi_seed3_reference(tab, query, qlen, min_intv=min_intv, min_len=min_len)
    if dev.type != "cuda":
        raise ValueError(f"fmi_seed3 runs on cuda or cpu tensors, not {dev}")
    EM3 = seed3_cap(L, min_len)
    # one int32 past the outputs: the kernel's work counter
    full = torch.zeros(B * (SEED3_HEAD + 4 * EM3) + 1, dtype=_I32, device=dev)
    res = _walk_out(full[:-1], B, EM3, SEED3_HEAD)
    if B == 0:
        return res
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.gb_fmi_seed3(tab.table.data_ptr(), query.data_ptr(), L, qlen.data_ptr(), B,
                              int(min_intv), int(min_len), EM3, *_launch_consts(tab),
                              full.data_ptr(), None, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fmi seed3 kernel launch failed with cudaError {rc}")
    fmi_seed3.launches += 1
    return res


fmi_seed3.launches = 0


# ---------------------------------------------------------------------------
# SMEM assembly (the three passes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SmemResult:
    """Arrays of SMEMs: read id, query start m, query end n (inclusive: the
    reference prints [m, n+1], fmi.cpp:312-344), SA start k, size s."""

    rid: np.ndarray
    m: np.ndarray
    n: np.ndarray
    k: np.ndarray
    s: np.ndarray

    @property
    def count(self):
        return len(self.rid)

    def sorted_tuples(self, with_interval=False):
        cols = (self.rid, self.m, self.n, self.s) if with_interval else (
            self.rid, self.m, self.n)
        return sorted(zip(*(c.tolist() for c in cols)))


def _mk_smem(rid, m, n, k, s):
    return SmemResult(*(np.asarray(a, dtype=np.int64) for a in (rid, m, n, k, s)))


def _cat_smem(a: tuple, b: SmemResult | None) -> tuple:
    if b is None:
        return a
    return tuple(np.concatenate([x, y]) for x, y in zip(a, (b.rid, b.m, b.n, b.k, b.s)))


class _Fetch:
    """A device buffer on its way to the host: on the card one copy into a
    page-locked buffer behind an event; on the CPU the tensor itself."""

    def __init__(self, t: torch.Tensor, pinned: torch.Tensor | None):
        self.t = t
        self.host = t
        self.event = None
        if t.device.type == "cuda":
            self.host = pinned[:t.numel()].view(t.shape)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _Split:
    """The split of one `run`: with stats={"synchronize": True} each stage
    is waited for and its seconds added under its key; with stats=None
    nothing is recorded."""

    def __init__(self, stats, dev):
        self.stats = stats
        self.sync = bool(stats and stats.get("synchronize")) and dev.type == "cuda"
        self.t = time.perf_counter()

    def mark(self, key):
        if self.stats is None:
            return
        if self.sync:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.stats[key] = self.stats.get(key, 0.0) + now - self.t
        self.t = now


class FmiPipeline:
    """The device-resident index and the three-pass SMEM search over read
    batches, as fmi.cpp runs it per batch: pass 1 all SMEMs (min_intv 1),
    the parent filter (length >= split_len, s <= split_width), pass 2 the
    reseed from midpoints (min_intv = s + 1), pass 3 the seed strategy
    (min_len = minSeedLen + 1, emission when the interval drops under
    maxMemIntv).  The results equal the JAX package's `FmiPipeline`, pass by
    pass and in order.

    The index goes to the device once, in the constructor.  `run` uploads
    each batch's codes once (passes 1-3 read that copy) and launches the
    pass-1 walk and then the pass-3 walk, each followed by one fetch into a
    page-locked buffer, so pass 3 runs on the card while the host assembles
    pass 1 and runs pass 2 (its (qrow, pivot, min_intv) triples uploaded,
    one launch, one fetch).  Work items that overflow a walk's caps go
    through the e-table, one extension launch per pass that overflows."""

    def __init__(self, index: FmdIndex, min_seed_len: int = 19, split_width: int = 10,
                 max_mem_intv: int = 20, split_factor: float = 1.5, device="cuda"):
        self.device = resolve_device(device)
        self.index = index
        self.tables = index.device(self.device)
        self.min_seed_len = min_seed_len
        self.split_width = split_width
        self.max_mem_intv = max_mem_intv
        self.split_len = int(min_seed_len * split_factor + 0.499)
        self._qcache = None
        self._pinned = {}
        # the last pass 1 and pass 2: work items, and those that overflowed
        self.last_counts = {"pass1 overflowed reads": 0, "pass2 items": 0,
                            "pass2 overflowed items": 0}

    # ---------------------------------------------------------------- marshal
    def _pinned_buf(self, name, numel):
        if self.device.type != "cuda":
            return None
        buf = self._pinned.get(name)
        if buf is None or buf.numel() < numel:
            buf = torch.empty(max(numel, 1), dtype=_I32, pin_memory=True)
            self._pinned[name] = buf
        return buf

    def _fetch(self, name, t: torch.Tensor) -> _Fetch:
        return _Fetch(t, self._pinned_buf(name, t.numel()))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _put_query(self, query, qlen):
        """The batch's codes and lengths on the device, cached by identity:
        passes 1-3 read one copy."""
        c = self._qcache
        if c is not None and c[0] is query and c[1] is qlen:
            return c[2], c[3]
        q_d = self._to_device(np.asarray(query, np.uint8))
        ql_d = self._to_device(np.asarray(qlen, np.int32))
        self._qcache = (query, qlen, q_d, ql_d)
        return q_d, ql_d

    # ---------------------------------------------------------------- pieces
    @staticmethod
    def _sort_by_start(lane, m, n, k, s):
        """Canonical per-lane increasing-start order (the e-table order)."""
        if len(lane) == 0:
            return lane, m, n, k, s
        o = np.lexsort((m, lane))
        return lane[o], m[o], n[o], k[o], s[o]

    @staticmethod
    def _smem_mask(e, qlen, min_len):
        """The containment rule: an SMEM starts at b iff e_b > e_{b'} for
        every b' < b (e is non-decreasing), of length >= min_len."""
        B, L = e.shape
        pos = np.arange(L)[None, :]
        prev = np.concatenate([np.zeros((B, 1), e.dtype),
                               np.maximum.accumulate(e, axis=1)[:, :-1]], axis=1)
        return (e > prev) & (e - pos >= min_len) & (pos < qlen[:, None])

    @staticmethod
    def _slots(w: np.ndarray, N: int, cap: int, head: int, valid=None):
        """(item, m, end, k, s) of a fetched walk buffer's emits, item by
        item in emit order; items where `valid` is False contribute none."""
        count = w[:N].astype(np.int64)
        if valid is not None:
            count = np.where(valid, count, 0)
        slots = w[head * N:].reshape(N, cap, 4)
        item = np.repeat(np.arange(N), count)
        got = slots[item, _ragged_cols(count)].astype(np.int64)
        return item, got[:, 0], got[:, 1], got[:, 2], got[:, 3]

    def etable_lanes(self, items, min_intv, width):
        """The e-table's lanes on the device, (qrow, start, min_intv, max_e):
        every start 0..width-1 of each work item's read, with its floor."""
        n, dev = len(items), self.device
        it = self._to_device(np.asarray(items, np.int32))
        mi = self._to_device(np.asarray(min_intv, np.int32))
        return (it.repeat_interleave(width),
                torch.arange(width, dtype=_I32, device=dev).repeat(n),
                mi.repeat_interleave(width),
                torch.full((n * width,), 1 << 30, dtype=_I32, device=dev))

    def _etable_device(self, q_d, ql_d, items, min_intv):
        """The e-table of work items (rows `items` of the resident query,
        each with its floor): e, k, s as (n_items, L) int64, one extension
        launch and one fetch."""
        n, L = len(items), q_d.shape[1]
        out = fmi_extend(self.tables, q_d, ql_d, *self.etable_lanes(items, min_intv, L))
        got = self._fetch("etable", out).get().astype(np.int64)
        return got[0].reshape(n, L), got[1].reshape(n, L), got[2].reshape(n, L)

    def _e_table(self, query, qlen, min_intv_per_read):
        """e_b, k_b, s_b for every (read, position) lane: (B, L) int64."""
        q_d, ql_d = self._put_query(query, qlen)
        return self._etable_device(q_d, ql_d, np.arange(query.shape[0]), min_intv_per_read)

    def _pass1_etable(self, q_d, ql_d, items, qlen):
        e, k, s = self._etable_device(q_d, ql_d, items, np.ones(len(items), np.int32))
        mask = self._smem_mask(e, qlen[items], self.min_seed_len)
        r, m = np.nonzero(mask)
        return _mk_smem(np.asarray(items)[r], m, e[r, m] - 1, k[r, m], s[r, m])

    def _pass2_etable(self, q_d, ql_d, prid, plen, pivots, mintv):
        e, k, s = self._etable_device(q_d, ql_d, prid, mintv)
        mask = self._smem_mask(e, plen, self.min_seed_len)
        pos = np.arange(e.shape[1])[None, :]
        mask &= (pos <= pivots[:, None]) & (e > pivots[:, None])
        pi, m = np.nonzero(mask)
        return _mk_smem(prid[pi], m, e[pi, m] - 1, k[pi, m], s[pi, m])

    # ---------------------------------------------------------------- passes
    def _launch_pass1(self, q_d, ql_d, split):
        w = fmi_smem1(self.tables, q_d, ql_d, min_seed_len=self.min_seed_len)
        split.mark("pass1 kernel")
        fetch = self._fetch("pass1", w.buf)
        split.mark("pass1 fetch")
        return fetch

    def _collect_pass1(self, fetch, q_d, ql_d, qlen, split):
        B, L = q_d.shape
        _, ME = walk_caps(L)
        w = fetch.get()
        split.mark("pass1 fetch")
        ovf = w[B:2 * B] != 0
        self.last_counts["pass1 overflowed reads"] = int(ovf.sum())
        item, m, e, k, s = self._slots(w, B, ME, SMEM1_HEAD, valid=~ovf)
        split.mark("pass1 assembly")
        parts = (item, m, e - 1, k, s)
        sub = np.nonzero(ovf)[0]
        if len(sub):   # slot-cap overflow: those reads through the e-table
            parts = _cat_smem(parts, self._pass1_etable(q_d, ql_d, sub, qlen))
            split.mark("pass1 e-table")
        out = _mk_smem(*self._sort_by_start(*parts))
        split.mark("pass1 assembly")
        return out

    def pass1(self, query, qlen):
        """All SMEMs of length >= min_seed_len (min_intv 1), read-major and
        start-ascending."""
        q_d, ql_d = self._put_query(query, qlen)
        split = _Split(None, self.device)
        fetch = self._launch_pass1(q_d, ql_d, split)
        return self._collect_pass1(fetch, q_d, ql_d, np.asarray(qlen), split)

    def pass2_items(self, parents: SmemResult):
        """The reseed's work items (read, pivot, min_intv) from the pass-1
        SMEMs of length >= split_len and s <= split_width (fmi.cpp:231-254)."""
        sel = np.nonzero((parents.n + 1 - parents.m >= self.split_len)
                         & (parents.s <= self.split_width))[0]
        return (parents.rid[sel].astype(np.int64),
                (parents.m[sel] + parents.n[sel] + 1) >> 1, parents.s[sel] + 1)

    def _pass2(self, q_d, ql_d, qlen, parents: SmemResult, split):
        prid, pivots, mintv = self.pass2_items(parents)
        self.last_counts["pass2 items"] = len(prid)
        self.last_counts["pass2 overflowed items"] = 0
        if len(prid) == 0:
            return _mk_smem([], [], [], [], [])
        plen = np.asarray(qlen)[prid]
        P, L = len(prid), q_d.shape[1]
        qrow_d = self._to_device(prid.astype(np.int32))
        piv_d = self._to_device(pivots.astype(np.int32))
        mi_d = self._to_device(mintv.astype(np.int32))
        split.mark("pass2 marshal and upload")
        w = fmi_smem1(self.tables, q_d, ql_d, qrow_d, piv_d, mi_d,
                      min_seed_len=self.min_seed_len)
        split.mark("pass2 kernel")
        got = self._fetch("pass2", w.buf).get()
        split.mark("pass2 fetch")
        _, ME = walk_caps(L)
        ovf = got[P:2 * P] != 0
        self.last_counts["pass2 overflowed items"] = int(ovf.sum())
        pi, m, e, k, s = self._slots(got, P, ME, SMEM1_HEAD, valid=~ovf)
        parts = (prid[pi], m, e - 1, k, s)
        sub = np.nonzero(ovf)[0]
        if len(sub):
            parts = _cat_smem(parts, self._pass2_etable(q_d, ql_d, prid[sub], plen[sub],
                                                        pivots[sub], mintv[sub]))
            split.mark("pass2 e-table")
        out = _mk_smem(*self._sort_by_start(*parts))
        split.mark("pass2 assembly")
        return out

    def pass2(self, query, qlen, parents: SmemResult):
        """The reseed: from the midpoint of each long rare pass-1 SMEM, the
        SMEMs covering it with min_intv = s + 1."""
        q_d, ql_d = self._put_query(query, qlen)
        return self._pass2(q_d, ql_d, qlen, parents, _Split(None, self.device))

    def _launch_pass3(self, q_d, ql_d, split):
        w = fmi_seed3(self.tables, q_d, ql_d, min_intv=self.max_mem_intv,
                      min_len=self.min_seed_len + 1)
        split.mark("pass3 kernel")
        fetch = self._fetch("pass3", w.buf)
        split.mark("pass3 fetch")
        return fetch

    def _collect_pass3(self, fetch, B, L, split):
        w = fetch.get()
        split.mark("pass3 fetch")
        EM3 = seed3_cap(L, self.min_seed_len + 1)
        out = _mk_smem(*self._slots(w, B, EM3, SEED3_HEAD))
        split.mark("pass3 assembly")
        return out

    def pass3(self, query, qlen):
        """bwt_seed_strategy1 emissions, read by read in hop order."""
        q_d, ql_d = self._put_query(query, qlen)
        split = _Split(None, self.device)
        fetch = self._launch_pass3(q_d, ql_d, split)
        return self._collect_pass3(fetch, *q_d.shape, split)

    def run(self, query, qlen, stats=None):
        """All three passes; returns (pass1, pass2, pass3, total_count).
        With stats={"synchronize": True}, every stage is waited for and its
        seconds added to `stats` under its name (the split)."""
        split = _Split(stats, self.device)
        qlen = np.asarray(qlen)
        q_d, ql_d = self._put_query(query, qlen)
        split.mark("upload")
        f1 = self._launch_pass1(q_d, ql_d, split)
        f3 = self._launch_pass3(q_d, ql_d, split)
        p1 = self._collect_pass1(f1, q_d, ql_d, qlen, split)
        p2 = self._pass2(q_d, ql_d, qlen, p1, split)
        p3 = self._collect_pass3(f3, *q_d.shape, split)
        return p1, p2, p3, p1.count + p2.count + p3.count
