"""minimap2 anchor chaining DP (chain_dp) in PyTorch.

The port of genomicsbench_tpu/ops/chain.py.  Semantics: chain_dp of the
reference (benchmarks/chain/src/host_kernel.cpp:30-94) as the JAX package's
`_run_scan` fixes them (:271-494), bit-exact with it, the scalar oracle and
the goldens: for each anchor i, the predecessors j from i-1 down to the
window start (the two-pointer rule on the 64-bit x, capped at max_iter and,
when given, at i - window), the concave gap cost, the max_skip break, the
best predecessor (ties to the highest j), and the peak score.

Two versions of one function, `chain_dp`, over flat anchors (all reads
concatenated, read r at [offs[r], offs[r+1])):

* on the card, the hand-written CUDA kernel `csrc/chain.cu` (a read on a
  group of 8 lanes, four a warp, 4 candidates a lane, its recent anchors in
  a shared-memory ring, stopping at the max_skip break; see the note
  there), one launch for the whole batch;
* on the CPU, `chain_dp_reference`, the plain PyTorch version: one `step`
  of `_run_scan` per anchor index over an (active reads, window) tile in
  visit order, with the window starts from the host helper
  `compute_window_starts` (the kernel runs the two-pointer itself), the
  target marks of the max_skip rule from a `scatter_` and the floored
  n_skip walk in closed form from `cumsum`/`cummin`.  `chip_smoke.py` also runs it on the card to hold the
  kernel against it.

The gap cost is the reference's own double expression,
`(int)(((double)dd * 0.01) * (double)(float)avg_qspan)`: the card has f64,
so the JAX package's int32-limb fixed point and its host patch list
(`lin_constants`, `_lin_fixed`, needed there only because the TPU has no
f64) have no counterpart here.  avg_qspan travels as float32, as the
reference and the JAX package round it.

Both versions return flat int32 scores, parents (read-local indices, -1 for
none) and peaks, and per read the number of predecessor candidates visited
(int64): the data-dependent work that the kernel's bound counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.parallel.mesh import gather_rows, row_bounds

NEG = -(1 << 30)
MM_SEED_SEG_SHIFT = 48
MAX_DD_BITS = 22  # dd <= 2^22 (max_dist_x larger than this is rejected)
# Operations per visited candidate that chain_dp needs at the card's best
# form, for reads of one segment and one sid, not cdna, bw < 2^22 (the
# breakdown is in csrc/chain.cu); the kernel's bound counts them
CHAIN_INT32_OPS_PER_CANDIDATE = 22
CHAIN_F64_OPS_PER_CANDIDATE = 4
# The kernel's shared memory (csrc/chain.cu): four reads a warp, each a
# ring of 96 anchors of 28 bytes and a bitmap of its window's positions
# (three more for the quads' alignment), one 32-bit word per 32, rounded to
# 128 bytes and skewed by 16; a block holds at most SHARED_MAX bytes (a
# Hopper block's opt-in)
CHAIN_READS_PER_WARP = 4
CHAIN_RING_BYTES = 96 * 28
SHARED_MAX = 232_448


def compute_window_starts(x: np.ndarray, max_dist_x: int, max_iter: int) -> np.ndarray:
    """Exact st_i emulation (host_kernel.cpp:56-57).

    For sorted x (minimap2 anchors are x-sorted) the running two-pointer
    equals a searchsorted; the max_iter cap composes as max(ss_i, i-max_iter).
    """
    n = len(x)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    xs = x.astype(np.uint64)
    if np.all(xs[1:] >= xs[:-1]):
        ss = np.searchsorted(xs, xs - np.uint64(max_dist_x), side="left")
        ss = np.where(xs <= np.uint64(max_dist_x), 0, ss)
        st = np.maximum(ss, np.arange(n) - max_iter)
        return np.maximum(st, 0).astype(np.int32)
    st = 0
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        while st < i and int(xs[i]) > int(xs[st]) + max_dist_x:
            st += 1
        if i - st > max_iter:
            st = i - max_iter
        out[i] = st
    return out


def gap_linear(dd: torch.Tensor, avg_qspan) -> torch.Tensor:
    """The linear part of the gap cost, (int)(((double)dd * .01) *
    (double)(float)avg_qspan), for int dd >= 0 and float32 avg_qspan
    (a tensor that broadcasts against dd).  Truncation toward zero is the
    floor here."""
    avg = torch.as_tensor(avg_qspan, dtype=torch.float32, device=dd.device)
    return ((dd.to(torch.float64) * 0.01) * avg.to(torch.float64)).to(torch.int32)


@dataclasses.dataclass
class ChainBatchResult:
    scores: np.ndarray       # (R, N) int32, 0 past a read's n
    parents: np.ndarray      # (R, N) int32, -1 past a read's n
    peak_scores: np.ndarray  # (R, N) int32, 0 past a read's n
    n: np.ndarray            # (R,) anchors per read


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 they wrap to (two's complement)."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _ilog2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for integers 1 <= v < 2^53: the binary exponent of
    v as a float64, which holds such v exactly."""
    return torch.frexp(v.to(torch.float64)).exponent.to(v.dtype) - 1


def _host_offsets(offs: torch.Tensor, host_offs, n_anchors: int) -> np.ndarray:
    """offs on the host, checked: 0 first, nondecreasing, len(x) last."""
    h = np.asarray(offs.cpu() if host_offs is None else host_offs, dtype=np.int64)
    if h.shape != tuple(offs.shape):
        raise ValueError(f"host_offs has shape {h.shape}, offs {tuple(offs.shape)}")
    if h[0] != 0 or h[-1] != n_anchors:
        raise ValueError(f"offs must run from 0 to len(x) = {n_anchors}")
    if (np.diff(h) < 0).any():
        raise ValueError("offs must be nondecreasing")
    return h


def _max_window(h_offs: np.ndarray, max_iter: int, window: int) -> int:
    """An upper bound on the candidates of any anchor of the batch (the
    longest read less one, max_iter, window when given): the width of the
    kernel's bitmap of max_skip marks."""
    n_max = int(np.diff(h_offs).max()) if len(h_offs) > 1 else 0
    w = min(max(n_max - 1, 0), int(max_iter))
    return min(w, int(window)) if window > 0 else w


def _warp_shared_bytes(max_window: int) -> int:
    """The shared memory one warp of the kernel needs at a window of
    max_window candidates."""
    words = -(-(max_window + 3) // 32)
    return CHAIN_READS_PER_WARP * (-(-(CHAIN_RING_BYTES + 4 * words) // 128) * 128 + 16)


def _launch_order(h_offs: np.ndarray) -> np.ndarray:
    """The reads longest first (stable): the kernel's warp order, and the
    plain version's, whose active reads of a step are then a prefix."""
    return np.argsort(-np.diff(h_offs), kind="stable")


def _check_inputs(x, y, offs, avg_qspan, max_dist_x, max_dist_y, bw, n_segs) -> None:
    """Refuse tensors the kernel does not take, by what needs no wait for
    the device: device, dtype, dimensions, contiguity, lengths."""
    if offs.dim() != 1 or offs.numel() < 1:
        raise ValueError("offs must be one-dimensional with R+1 entries")
    R = offs.numel() - 1
    specs = [("x", x, torch.int64, x.numel()), ("y", y, torch.int64, x.numel()),
             ("offs", offs, torch.int64, R + 1),
             ("avg_qspan", avg_qspan, torch.float32, R),
             ("max_dist_x", max_dist_x, torch.int32, R),
             ("max_dist_y", max_dist_y, torch.int32, R),
             ("bw", bw, torch.int32, R), ("n_segs", n_segs, torch.int32, R)]
    for name, t, dtype, length in specs:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.numel() != length:
            raise ValueError(f"{name} must be one-dimensional of length {length}, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def chain_dp_reference(x, y, offs, avg_qspan, max_dist_x, max_dist_y, bw, n_segs,
                       max_iter: int = 5000, max_skip: int = 25,
                       is_cdna: bool = False, window: int = 0):
    """The plain PyTorch version of the kernel: `_run_scan`'s step
    (genomicsbench_tpu/ops/chain.py:314-441) per anchor index, over a tile
    of the reads that have anchor i, its columns the window in visit order
    (column p is candidate j = i-1-p).  Reads are taken longest first, so
    the active reads of step i are a prefix.  Returns (scores, parents,
    peak, visited) as `chain_dp` does."""
    dev = x.device
    total, R = x.numel(), offs.numel() - 1
    i32, i64 = torch.int32, torch.int64
    scores = torch.zeros(total, dtype=i32, device=dev)
    parents = torch.full((total,), -1, dtype=i32, device=dev)
    peak = torch.zeros(total, dtype=i32, device=dev)
    visited = torch.zeros(R, dtype=i64, device=dev)
    offs_h = offs.cpu().numpy()
    n_host = np.diff(offs_h)
    if total == 0:
        return scores, parents, peak, visited
    # window starts on the host (host_kernel.cpp:56-57 with the max_iter
    # cap), as the JAX package computes them; then the window cap
    x_h = x.cpu().numpy().view(np.uint64)
    mdx_h = max_dist_x.cpu().numpy()
    lo_h = np.concatenate([
        compute_window_starts(x_h[offs_h[r]:offs_h[r + 1]], int(mdx_h[r]), max_iter)
        for r in range(R)]).astype(np.int64)
    local = np.arange(total) - np.repeat(offs_h[:-1], n_host)
    if window > 0:
        lo_h = np.maximum(lo_h, local - window)
    width = local - lo_h                            # candidates of each anchor
    step_width = np.zeros(int(n_host.max()), np.int64)
    np.maximum.at(step_width, local, width)         # the widest window per step
    lo = torch.from_numpy(lo_h).to(dev)

    order_h = _launch_order(offs_h)
    order = torch.from_numpy(order_h).to(dev)
    n_desc = n_host[order_h]
    base = offs[:-1][order]
    mdx, mdy, bw_, nseg = (t[order].to(i64)[:, None]
                           for t in (max_dist_x, max_dist_y, bw, n_segs))
    avg = avg_qspan[order][:, None]
    pos, rid = x & 0xFFFFFFFF, (x >> 32) & 0xFFFFFFFF
    qpos = y & 0xFFFFFFFF
    span = (y >> 32) & 0xFF
    sid = (y >> MM_SEED_SEG_SHIFT) & 0xFF
    dd_max = (1 << MAX_DD_BITS) - 1

    for i in range(int(n_desc[0])):
        a = int((n_desc > i).sum())                 # reads with anchor i
        b = base[:a]
        cur = b + i
        w_i = i - lo[cur]
        q_span = span[cur][:, None]
        Wt = int(step_width[i])
        if Wt == 0:
            scores[cur] = q_span[:, 0].to(i32)
            peak[cur] = q_span[:, 0].to(i32)
            continue
        p = torch.arange(Wt, dtype=i64, device=dev)[None, :]
        j = i - 1 - p                                # (1, Wt) visit order
        in_win = p < w_i[:, None]
        gj = b[:, None] + j.clamp(min=0)
        dr = _wrap32(pos[cur][:, None] - pos[gj])
        dq = _wrap32(qpos[cur][:, None] - qpos[gj])
        same_rid = rid[gj] == rid[cur][:, None]
        same_sid = sid[gj] == sid[cur][:, None]
        dd = _wrap32((_wrap32(dr - dq)).abs())

        valid = in_win & same_rid
        valid &= ~((same_sid & (dr == 0)) | (dq <= 0))
        valid &= ~((same_sid & (dq > mdy[:a])) | (dq > mdx[:a]))
        valid &= ~(same_sid & (dd > bw_[:a]))
        if not is_cdna:
            valid &= ~((nseg[:a] > 1) & same_sid & (dr > mdy[:a]))

        sc0 = torch.minimum(torch.minimum(dq, dr), q_span)
        log_dd = torch.where(dd > 0, _ilog2(dd.clamp(min=1)), 0)
        # dd clipped to [0, 2^22) as the JAX package clips it; it changes
        # the cost only where a same-sid pair passes bw >= 2^22
        c_lin = gap_linear(dd.clamp(0, dd_max), avg[:a]).to(i64)
        diff_path = torch.ones_like(valid) if is_cdna else ~same_sid
        bonus = ~same_sid & (dr == 0)
        gap_anchor = c_lin + (log_dd >> 1)
        gap_diff = torch.where(bonus, 0, torch.where((dr > dq) | ~same_sid,
                                                     torch.minimum(c_lin, log_dd),
                                                     gap_anchor))
        gap = torch.where(diff_path, gap_diff, gap_anchor)
        sc = _wrap32(sc0 + (bonus & diff_path).to(i64) - gap
                     + scores[gj].to(i64))

        # max_skip: hit(p) when a valid candidate visited before p has its
        # parent at p (module docstring of the JAX package); marks past the
        # window fall into a dump column
        par = parents[gj].to(i64)
        hp = torch.where(valid & (par >= 0), i - 1 - par, Wt).clamp(max=Wt)
        hits = torch.zeros((a, Wt + 1), dtype=torch.bool, device=dev)
        hits.scatter_(1, hp, True)
        hits = hits[:, :Wt]

        masked = torch.where(valid, sc, NEG)
        before = torch.cat([torch.full((a, 1), NEG, dtype=i64, device=dev),
                            torch.cummax(masked, 1).values[:, :-1]], 1)
        running = torch.maximum(before, q_span)
        imp = valid & (sc > running)
        skip = valid & ~imp & hits
        e = skip.to(i64) - imp.to(i64)
        S = torch.cumsum(e, 1)
        nskip = S - torch.cummin(S, 1).values.clamp(max=0)
        brk = torch.where(skip & (nskip > max_skip), p, Wt).amin(1)
        live = valid & (p < brk[:, None])

        best = torch.where(live, sc, NEG).amax(1)
        max_f = torch.maximum(best, q_span[:, 0])
        arg = torch.where(live & (sc == max_f[:, None]), p, Wt).amin(1)
        max_j = torch.where(best > q_span[:, 0], i - 1 - arg, -1)
        pk = peak[b + max_j.clamp(min=0)].to(i64)
        scores[cur] = max_f.to(i32)
        parents[cur] = max_j.to(i32)
        peak[cur] = torch.where((max_j >= 0) & (pk > max_f), pk, max_f).to(i32)
        visited[order[:a]] += torch.where(brk < Wt, brk + 1, w_i)
    return scores, parents, peak, visited


def chain_dp(x, y, offs, avg_qspan, max_dist_x, max_dist_y, bw, n_segs,
             max_iter: int = 5000, max_skip: int = 25, is_cdna: bool = False,
             window: int = 0, *, host_offs=None):
    """chain_dp over the flat anchors of R reads.

    x, y (T,) int64 (the uint64 bit patterns of minimap2's anchors), offs
    (R+1,) int64 with read r at [offs[r], offs[r+1]); per read avg_qspan
    float32, max_dist_x / max_dist_y / bw / n_segs int32; all contiguous,
    on one device.  window 0 means no cap beyond the two-pointer rule and
    max_iter.  Returns flat int32 scores, parents (read-local, -1 for none)
    and peak (T,), and visited (R,) int64.

    The offsets are checked on the host before any launch: pass
    `host_offs` (a host copy) where a CUDA caller has one, or they are
    fetched.  The kernel's warps take the reads longest first, in an order
    computed from the checked host offsets.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream,
    without synchronising, and raises if the launch fails.  The kernel
    keeps a bitmap of each read's window in shared memory: a batch whose
    window (the longest read less one, max_iter, window) needs more than a
    block holds is refused with ValueError before the launch (past some
    440,000 candidates).
    """
    _check_inputs(x, y, offs, avg_qspan, max_dist_x, max_dist_y, bw, n_segs)
    for name, v in (("max_iter", max_iter), ("max_skip", max_skip), ("window", window)):
        if int(v) < 0 or int(v) >= (1 << 31):
            raise ValueError(f"{name} must lie in [0, 2^31), got {v}")
    h_offs = _host_offsets(offs, host_offs, x.numel())
    dev = x.device
    if dev.type == "cpu":
        return chain_dp_reference(x, y, offs, avg_qspan, max_dist_x, max_dist_y,
                                  bw, n_segs, max_iter, max_skip, is_cdna, window)
    if dev.type != "cuda":
        raise ValueError(f"chain_dp runs on cuda or cpu tensors, not {dev}")
    from genomicsbench_tpu_torch import _kernels

    max_window = _max_window(h_offs, max_iter, window)
    if _warp_shared_bytes(max_window) > SHARED_MAX:
        raise ValueError(f"a window of {max_window} candidates needs "
                         f"{_warp_shared_bytes(max_window)} bytes of shared memory a warp, "
                         f"more than the {SHARED_MAX} a block holds")
    lib = _kernels.load()
    R, T = offs.numel() - 1, x.numel()
    # pinned, so the copy waits for no earlier work on the stream
    order = torch.from_numpy(_launch_order(h_offs)).pin_memory().to(dev, non_blocking=True)
    scores, parents, peak = torch.empty((3, T), dtype=torch.int32, device=dev)
    visited = torch.empty(R, dtype=torch.int64, device=dev)
    if R == 0:
        return scores, parents, peak, visited
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gb_chain_dp(
            x.data_ptr(), y.data_ptr(), offs.data_ptr(), order.data_ptr(),
            avg_qspan.data_ptr(), max_dist_x.data_ptr(), max_dist_y.data_ptr(),
            bw.data_ptr(), n_segs.data_ptr(), R, int(max_iter), int(max_skip),
            int(bool(is_cdna)), int(window), max_window, scores.data_ptr(),
            parents.data_ptr(), peak.data_ptr(), visited.data_ptr(), None, stream)
    if rc != 0:
        raise RuntimeError(f"chain kernel launch failed with cudaError {rc}")
    chain_dp.launches += 1
    return scores, parents, peak, visited


chain_dp.launches = 0       # kernel launches, counted where they happen


@dataclasses.dataclass
class ChainDispatch:
    """One dispatched batch: the device outputs of `chain_dp`, not yet
    fetched, and the host layout to unpack them."""

    out: tuple          # (scores, parents, peak, visited) tensors
    ns: np.ndarray      # (R,) int32 anchors per read
    offs: np.ndarray    # (R+1,) int64


def _marshal(calls):
    """Flat host arrays of a list of AnchorCalls, packed into one byte
    buffer for one upload: (buffer, {name: (byte offset, dtype, length)},
    ns, offs)."""
    R = len(calls)
    ns = np.array([c.n for c in calls], dtype=np.int32)
    offs = np.zeros(R + 1, np.int64)
    np.cumsum(ns, out=offs[1:])
    T = int(offs[-1])
    for c in calls:
        if not 0 <= c.max_dist_x < (1 << MAX_DD_BITS):
            raise ValueError(f"max_dist_x must lie in [0, 2^{MAX_DD_BITS}), "
                             f"got {c.max_dist_x}")
    fields = [("x", np.int64, T), ("y", np.int64, T), ("offs", np.int64, R + 1),
              ("avg_qspan", np.float32, R),
              ("max_dist_x", np.int32, R), ("max_dist_y", np.int32, R),
              ("bw", np.int32, R), ("n_segs", np.int32, R)]
    layout, nbytes = {}, 0
    for name, dt, length in fields:
        layout[name] = (nbytes, dt, length)
        nbytes += -(-length * np.dtype(dt).itemsize // 8) * 8
    buf = np.empty(nbytes, np.uint8)

    def view(name):
        o, dt, length = layout[name]
        return buf[o:o + length * np.dtype(dt).itemsize].view(dt)

    if R:
        np.concatenate([np.asarray(c.x, np.uint64) for c in calls], out=view("x").view(np.uint64))
        np.concatenate([np.asarray(c.y, np.uint64) for c in calls], out=view("y").view(np.uint64))
    view("offs")[:] = offs
    view("avg_qspan")[:] = [np.float32(c.avg_qspan) for c in calls]
    for name in ("max_dist_x", "max_dist_y", "bw", "n_segs"):
        view(name)[:] = [getattr(c, name) for c in calls]
    return buf, layout, ns, offs


# chain_dp's tensor arguments, in order, as upload_calls names them
CHAIN_DP_INPUTS = ("x", "y", "offs", "avg_qspan", "max_dist_x", "max_dist_y", "bw",
                   "n_segs")


def upload_calls(calls, device):
    """Marshal AnchorCalls on the host and upload them in one transfer:
    ({name: tensor on `device`} of the CHAIN_DP_INPUTS, ns, host offs)."""
    buf, layout, ns, offs = _marshal(calls)
    up = torch.from_numpy(buf).to(resolve_device(device))
    tensors = {}
    for name, (o, dt, length) in layout.items():
        dt = np.dtype(dt)
        tensors[name] = up[o:o + length * dt.itemsize].view(getattr(torch, dt.name))
    return tensors, ns, offs


def _chain_dispatch(calls, window: int | None, max_iter: int, max_skip: int,
                    is_cdna: bool, device) -> ChainDispatch:
    """Marshal one batch on the host, upload it in one transfer and launch
    `chain_dp` once, without blocking."""
    t, ns, offs = upload_calls(calls, device)
    out = chain_dp(*(t[k] for k in CHAIN_DP_INPUTS), max_iter, max_skip, is_cdna,
                   window or 0, host_offs=offs)
    return ChainDispatch(out=out, ns=ns, offs=offs)


def _chain_collect(pending: ChainDispatch) -> ChainBatchResult:
    """One fetch of the flat outputs, unpacked into (R, N) planes."""
    scores, parents, peak, _ = pending.out
    flat = torch.cat([scores, parents, peak]).cpu().numpy()
    ns = pending.ns
    R, T = len(ns), int(pending.offs[-1])
    N = int(ns.max()) if R else 0
    mask = np.arange(N)[None, :] < ns[:, None]      # row-major = flat order
    planes = []
    for k, fill in enumerate((0, -1, 0)):
        plane = np.full((R, N), fill, np.int32)
        plane[mask] = flat[k * T:(k + 1) * T]
        planes.append(plane)
    return ChainBatchResult(scores=planes[0], parents=planes[1],
                            peak_scores=planes[2], n=ns)


def chain_batch(calls, window: int | None = None, max_iter: int = 5000,
                max_skip: int = 25, is_cdna: bool = False,
                device="cuda", mesh=None) -> ChainBatchResult:
    """Run chain_dp over a list of AnchorCall records: one upload, one
    kernel launch and one fetch on the card; the plain version with
    device="cpu".

    With `mesh` (parallel.mesh.Mesh; `device` is then the mesh's), the
    reads shard over its "data" axis, a multiple of which their count must
    be (ValueError): each rank chains its block of reads and the planes,
    padded to the batch's widest read, are gathered in rank order, so every
    rank returns the one-card result."""
    if mesh is not None:
        lo, hi = row_bounds(mesh, len(calls))
        part = chain_batch(calls[lo:hi], window, max_iter, max_skip, is_cdna, mesh.device)
        ns = gather_rows(mesh, torch.from_numpy(part.n)).cpu().numpy()
        N = int(ns.max()) if len(ns) else 0
        planes = np.stack([np.pad(a, ((0, 0), (0, N - a.shape[1])), constant_values=fill)
                           for a, fill in ((part.scores, 0), (part.parents, -1),
                                           (part.peak_scores, 0))], axis=1)
        got = gather_rows(mesh, torch.from_numpy(planes)).cpu().numpy()
        return ChainBatchResult(scores=got[:, 0], parents=got[:, 1], peak_scores=got[:, 2],
                                n=ns)
    return _chain_collect(_chain_dispatch(calls, window, max_iter, max_skip,
                                          is_cdna, device))
