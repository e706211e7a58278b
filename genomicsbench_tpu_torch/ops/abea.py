"""Adaptive banded event alignment (abea, f5c align) in PyTorch.

The port of genomicsbench_tpu/ops/abea.py.  Semantics: f5c's src/align.c:
169-548 (align) and src/events.c (scrappie event detection), in the
reference's accelerator recipe (ALIGN_KERNEL_FLOAT): float32 scores and
transition constants rounded from float64.

Host part (numpy, copied with its float and double mixing): the windowed
t-statistics and event building of `detect_events`, with the sequential
peak state machine in the port's own C++ (`native/peaks.cpp`), the k-mer
ranks and the pore model.

Device part: two functions over one uploaded batch (`upload_reads`), each
in two versions:

* `abea_fill`: the adaptive banded fill, band after band, with the 2-bit
  traces, each band's lower-left event index and the best (event, last
  k-mer) cell; on the card the hand-written kernel `gb_abea_fill` of
  `csrc/abea.cu` (one warp per read, the band's emission inputs carried in
  registers, the reads taken longest first), on the CPU
  `abea_fill_reference`,
  JAX's step function (abea.py:298-406) over (B, 100) tensors with one
  host loop over the bands;
* `abea_backtrack`: the walk back over the traces to the (k-mer, event)
  pairs, with the float32 Kahan sum of the emission terms and the longest
  event gap; on the card `gb_abea_backtrack` (four reads a warp, longest
  first, on 8 lanes each, their walkers stepping in lockstep over 64-band
  trace tiles staged in shared memory), on the CPU
  `abea_backtrack_reference` (abea.py:442-481 over (B,)).

Every float operation of both versions rounds once, in the order the JAX
code writes it (no fused multiply-add), so the kernels equal the plain
versions bit for bit, and the pairs equal the reference's float-mode build
(tests/golden/abea_align.*).  The JAX package runs the same order, but
XLA on the CPU contracts a*b + c into FMAs, so its float best scores differ
from these in the last bits; its traces, pairs and QC flags do not on the
tests' inputs (tests/test_torch_abea.py).

The two versions share one layout: reads flat at per-read offsets, each
read's own n_events + n_kmers bands (no batch-wide padding), its traces at
25 bytes per band, and its pairs written at the end of a slot of
n_events + n_kmers pairs.  `align_batch` uploads once, launches each kernel
once and fetches once; the QC gates (abea.py:600-606) run on the host,
vectorised.  With `mesh` (the JAX package's argument) the reads shard
over the mesh's "data" axis and each rank's pairs are gathered in rank
order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.parallel.mesh import gather_rows, row_bounds

BW = 100          # ALN_BANDWIDTH (f5c.h:28)
KMER = 6
N_MODEL = 4 ** KMER
FROM_D, FROM_U, FROM_L = 0, 1, 2
LOG_NORM = np.float32(-0.918938)
N_PARAMS = 6      # per read: scale, shift, lp_skip, lp_stay, lp_step, lp_trim
# Steps of the Kahan update with a zero term after a read's walk: the JAX
# scan runs at least three past the longest walk possible (its max_steps is
# n_events + n_kmers + 2 or more, a walk at most n_events + n_kmers - 1),
# and the sum settles within two
TAIL_STEPS = 3
# Operations of the fill by type, for its bound (csrc/abea.cu): per cell
# inside a read's matrix, per k-mer (its emission terms, once) and per
# event
ABEA_FP32_OPS_PER_CELL = 16
ABEA_INT32_OPS_PER_CELL = 8
ABEA_FP32_OPS_PER_KMER = 3
ABEA_INT32_OPS_PER_KMER = 2
ABEA_INT32_OPS_PER_EVENT = 1
# QC gates (align.c:514-532)
MIN_AVG_LOG_EMISSION = -5.0
MAX_GAP_THRESHOLD = 50

_U8, _I32, _I64, _F32 = torch.uint8, torch.int32, torch.int64, torch.float32


# ---------------------------------------------------------------------------
# event detection (host)
# ---------------------------------------------------------------------------

def compute_tstat(sums, sumsqs, n, w):
    """events.c:305-360 with C's double/float mixing."""
    tstat = np.zeros(n, np.float32)
    if n < 2 * w or w < 2:
        return tstat
    i = np.arange(w, n - w + 1)
    sum1 = sums[i] - np.where(i > w, sums[i - w], 0.0)
    sumsq1 = sumsqs[i] - np.where(i > w, sumsqs[i - w], 0.0)
    sum2_f = (sums[i + w] - sums[i]).astype(np.float32)
    sumsq2_f = (sumsqs[i + w] - sumsqs[i]).astype(np.float32)
    wf32 = np.float32(w)
    wf = np.float64(wf32)
    mean1 = (sum1 / wf).astype(np.float32)          # double div -> float
    mean2 = sum2_f / wf32                           # float div (C: float/float)
    # C mixes float sub-products into the double accumulation:
    # (double)(sumsq1/w) - (float)(mean1*mean1) + (float)(sumsq2/w)
    #                    - (float)(mean2*mean2)
    cv = (
        sumsq1 / wf
        - (mean1 * mean1).astype(np.float64)
        + (sumsq2_f / wf32).astype(np.float64)
        - (mean2 * mean2).astype(np.float64)
    ).astype(np.float32)
    cv = np.maximum(cv, np.float32(np.finfo(np.float32).tiny))
    delta = mean2 - mean1                           # float subtraction
    t = (np.abs(delta.astype(np.float64))
         / np.sqrt((cv / wf32).astype(np.float64))).astype(np.float32)
    tstat[w : n - w + 1] = t
    return tstat


def detect_events(raw: np.ndarray,
                  window_length1=3, window_length2=6,
                  threshold1=1.4, threshold2=9.0, peak_height=0.2):
    """events.c:505-545; returns (start, length, mean, stdv) arrays."""
    from genomicsbench_tpu_torch import native

    raw = np.asarray(raw, np.float32)
    n = len(raw)
    sums = np.zeros(n + 1, np.float64)
    sumsqs = np.zeros(n + 1, np.float64)
    np.cumsum(raw.astype(np.float64), out=sums[1:])
    # C squares in float (data[i]*data[i]) before the double accumulation
    np.cumsum((raw * raw).astype(np.float64), out=sumsqs[1:])
    t1 = compute_tstat(sums, sumsqs, n, window_length1)
    t2 = compute_tstat(sums, sumsqs, n, window_length2)
    peaks = native.peak_detector(t1, t2, window_length1, window_length2,
                                 np.float32(threshold1), np.float32(threshold2),
                                 np.float32(peak_height))
    # create_events (events.c:469-503): boundaries 0, peaks..., n, with the
    # scalar loop's per-element float32 operation order
    pk = peaks[(peaks > 0) & (peaks < n)]
    bounds = np.concatenate([[0], pk, [n]]).astype(np.int64)
    s, e = bounds[:-1], bounds[1:]
    ln = (e - s).astype(np.float32)
    mean = (sums[e] - sums[s]).astype(np.float32) / ln
    var = (sumsqs[e] - sumsqs[s]).astype(np.float32) / ln - mean * mean
    stdv = np.sqrt(np.maximum(var, np.float32(0.0)))
    return (s, ln, mean.astype(np.float32), stdv.astype(np.float32))


# ---------------------------------------------------------------------------
# pore model
# ---------------------------------------------------------------------------

_RANK = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T


def kmer_ranks(seq_codes: np.ndarray, k: int = KMER):
    """Base-4 big-endian ranks of all k-mers of a 0..3-coded sequence."""
    n = len(seq_codes) - k + 1
    r = np.zeros(max(n, 0), np.int32)
    c = np.asarray(seq_codes).astype(np.int32)
    for j in range(k):
        r = (r << 2) | c[j : j + n]
    return r


def synthetic_model(seed=0, n=N_MODEL):
    """A stand-in 6-mer pore model (the real r9.4 table ships with ONT
    software; any table of positive stdvs exercises identical code paths)."""
    rng = np.random.default_rng(seed)
    level_mean = rng.uniform(60.0, 140.0, n).astype(np.float32)
    level_stdv = rng.uniform(1.0, 4.0, n).astype(np.float32)
    return level_mean, level_stdv


def load_model_tsv(path):
    """nanopolish/f5c-style model file: kmer\tlevel_mean\tlevel_stdv..."""
    mean = np.zeros(N_MODEL, np.float32)
    stdv = np.ones(N_MODEL, np.float32)
    with open(path) as f:
        for line in f:
            if line.startswith("#") or line.startswith("kmer"):
                continue
            parts = line.split()
            r = 0
            for ch in parts[0].encode():
                r = (r << 2) | _RANK[ch]
            mean[r] = float(parts[1])
            stdv[r] = float(parts[2])
    return mean, stdv


# ---------------------------------------------------------------------------
# marshal and upload
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReadTables:
    """One batch of reads on one device, as `upload_reads` makes it: read
    b's k-mer ranks at [k_off[b], k_off[b+1]) of `ranks`, its event means at
    [e_off[b], e_off[b+1]) of `events`, its bands (n_kmers + n_events, after
    the two initial ones) and its pair slot at [band_off[b], band_off[b+1]);
    `params` (B, 6): scale, shift, lp_skip, lp_stay, lp_step, lp_trim;
    `model` (3, 4096): level mean, stdv and log stdv; `order` (B,) int32:
    the reads by band count, longest first (`longest_first`), the order the
    fill and backtrack kernels start them in.  `host` holds numpy copies of the three
    offset arrays and of `order`, which the wrappers check."""

    ranks: torch.Tensor
    events: torch.Tensor
    k_off: torch.Tensor
    e_off: torch.Tensor
    band_off: torch.Tensor
    params: torch.Tensor
    model: torch.Tensor
    order: torch.Tensor
    host: dict

    @property
    def n_reads(self) -> int:
        return self.k_off.numel() - 1

    @property
    def n_bands(self) -> int:
        return self.ranks.numel() + self.events.numel()


@dataclasses.dataclass
class FillResult:
    """What the fill leaves on the device for the backtrack: the 2-bit
    traces (25 bytes per band, cell 4j + i at bits 2i of byte j), each
    band's lower-left event index, trace1 (B, 100), and per read the best
    (event, last k-mer) score and its event."""

    traces: torch.Tensor
    bll_e: torch.Tensor
    trace1: torch.Tensor
    best: torch.Tensor
    best_ev: torch.Tensor


def transition_params(n_kmers, n_events, scalings) -> np.ndarray:
    """(B, 6) float32 per-read scale, shift and log transition constants,
    in the reference's accelerator recipe (ALIGN_KERNEL_FLOAT,
    f5cmisc.cuh:23 / align.cu:290-293): f32 events_per_kmer and p_stay,
    f32 lp_* rounded from f64 log/exp, as the JAX package's align_batch
    computes them (abea.py:532-544)."""
    B = len(n_kmers)
    with np.errstate(divide="ignore", invalid="ignore"):
        epk = n_events.astype(np.float32) / n_kmers.astype(np.float32)
        one = np.float32(1.0)
        p_stay = one - one / (epk + one)
        lp_skip = np.float32(np.log(np.float64(np.float32(1e-10))))
        lp_stay = np.log(p_stay.astype(np.float64)).astype(np.float32)
        lp_step = np.log(1.0 - np.exp(np.float64(lp_skip))
                         - np.exp(lp_stay.astype(np.float64))).astype(np.float32)
    out = np.empty((B, N_PARAMS), np.float32)
    out[:, 0] = scalings[:, 0]
    out[:, 1] = scalings[:, 1]
    out[:, 2] = lp_skip
    out[:, 3] = lp_stay
    out[:, 4] = lp_step
    out[:, 5] = np.float32(np.log(0.01))
    return out


def longest_first(band_off) -> np.ndarray:
    """The reads by band count, longest first (ties in read order), as
    int32: the order the fill and backtrack kernels start their warps in."""
    return np.argsort(-np.diff(np.asarray(band_off, np.int64)), kind="stable").astype(np.int32)


def _marshal(sequences, event_means, model_mean, model_stdv, scalings):
    """The batch as one host byte buffer for one upload: (buffer, {name:
    (byte offset, dtype, length)}, host copies of the offsets)."""
    B = len(sequences)
    if len(event_means) != B or np.shape(scalings) != (B, 2):
        raise ValueError(f"{B} sequences need {B} event arrays and (B, 2) scalings, got "
                         f"{len(event_means)} and {np.shape(scalings)}")
    model_mean = np.asarray(model_mean)
    model_stdv = np.asarray(model_stdv)
    if model_mean.shape != (N_MODEL,) or model_stdv.shape != (N_MODEL,):
        raise ValueError(f"the pore model must have {N_MODEL} k-mers, got "
                         f"{model_mean.shape} and {model_stdv.shape}")
    seq_len = np.fromiter((len(s) for s in sequences), np.int64, B)
    if (seq_len < KMER).any():
        raise ValueError(f"a sequence is shorter than one {KMER}-mer")
    codes = np.concatenate([np.asarray(s) for s in sequences]) if B else np.zeros(0, np.int64)
    if codes.size and (codes.min() < 0 or codes.max() > 3):
        raise ValueError("sequences must be coded 0..3 (A, C, G, T)")
    n_kmers = seq_len - KMER + 1
    n_events = np.fromiter((len(e) for e in event_means), np.int64, B)
    k_off = np.zeros(B + 1, np.int64)
    np.cumsum(n_kmers, out=k_off[1:])
    e_off = np.zeros(B + 1, np.int64)
    np.cumsum(n_events, out=e_off[1:])
    band_off = k_off + e_off
    NK, NE = int(k_off[-1]), int(e_off[-1])

    fields = [("ranks", np.int32, NK), ("events", np.float32, NE), ("k_off", np.int64, B + 1),
              ("e_off", np.int64, B + 1), ("band_off", np.int64, B + 1),
              ("params", np.float32, B * N_PARAMS), ("model", np.float32, 3 * N_MODEL),
              ("order", np.int32, B)]
    layout, nbytes = {}, 0
    for name, dt, length in fields:
        layout[name] = (nbytes, dt, length)
        nbytes += -(-length * np.dtype(dt).itemsize // 8) * 8
    buf = np.empty(nbytes, np.uint8)

    def view(name):
        o, dt, length = layout[name]
        return buf[o:o + length * np.dtype(dt).itemsize].view(dt)

    # every read's k-mers at once: the ranks of the concatenated sequences,
    # less the KMER - 1 that start before each read's end and cross it
    c = codes.astype(np.int32)
    n_all = max(len(c) - KMER + 1, 0)
    r = c[:n_all] << (2 * (KMER - 1))
    for j in range(1, KMER):
        r |= c[j:j + n_all] << (2 * (KMER - 1 - j))
    keep = np.ones(n_all, bool)
    keep[(np.cumsum(seq_len)[:-1, None] - np.arange(1, KMER)).ravel()] = False
    view("ranks")[:] = r[keep]
    if NE:
        view("events")[:] = np.concatenate([np.asarray(e, np.float32) for e in event_means])
    view("k_off")[:] = k_off
    view("e_off")[:] = e_off
    view("band_off")[:] = band_off
    view("params")[:] = transition_params(n_kmers, n_events,
                                          np.asarray(scalings, np.float32)).ravel()
    model = view("model").reshape(3, N_MODEL)
    model[0] = model_mean.astype(np.float32)
    model[1] = model_stdv.astype(np.float32)
    model[2] = np.log(model_stdv.astype(np.float64)).astype(np.float32)
    order = view("order")
    order[:] = longest_first(band_off)
    return buf, layout, dict(k_off=k_off, e_off=e_off, band_off=band_off, order=order.copy())


def _upload(buf, layout, host, device) -> ReadTables:
    """One copy of a marshalled buffer to `device`, cut into the tables."""
    up = torch.from_numpy(buf).to(resolve_device(device))
    t = {}
    for name, (o, dt, length) in layout.items():
        dt = np.dtype(dt)
        t[name] = up[o:o + length * dt.itemsize].view(getattr(torch, dt.name))
    t["params"] = t["params"].view(-1, N_PARAMS)
    t["model"] = t["model"].view(3, N_MODEL)
    return ReadTables(**t, host=host)


def upload_reads(sequences, event_means, model_mean, model_stdv, scalings,
                 device) -> ReadTables:
    """Marshal the reads (0..3-coded sequences, float32 event means, (B, 2)
    [scale, shift]) and the pore model on the host and upload them in one
    transfer."""
    return _upload(*_marshal(sequences, event_means, model_mean, model_stdv, scalings),
                   device)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check_tensor(name, x, dev, dtype, shape):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, ranks on {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tables(t: ReadTables) -> None:
    """Refuse tables the kernels do not take, by what needs no wait for the
    device: devices, dtypes, shapes, contiguity, and on the host copies the
    offsets."""
    dev = t.ranks.device
    B = t.k_off.numel() - 1
    if t.ranks.dim() != 1 or t.events.dim() != 1 or B < 0:
        raise ValueError("ranks, events and the offsets must be one-dimensional")
    NK, NE = t.ranks.numel(), t.events.numel()
    for name, dtype, shape in (("ranks", _I32, (NK,)), ("events", _F32, (NE,)),
                               ("k_off", _I64, (B + 1,)), ("e_off", _I64, (B + 1,)),
                               ("band_off", _I64, (B + 1,)), ("params", _F32, (B, N_PARAMS)),
                               ("model", _F32, (3, N_MODEL)), ("order", _I32, (B,))):
        _check_tensor(name, getattr(t, name), dev, dtype, shape)
    h = {k: np.asarray(t.host.get(k)) for k in ("k_off", "e_off", "band_off")}
    for name, total in (("k_off", NK), ("e_off", NE), ("band_off", NK + NE)):
        if h[name].shape != (B + 1,):
            raise ValueError(f"host {name} must have {B + 1} entries")
        if h[name][0] != 0 or h[name][-1] != total:
            raise ValueError(f"{name} must run from 0 to {total}")
        if (np.diff(h[name]) < 0).any():
            raise ValueError(f"{name} must be nondecreasing")
    if not np.array_equal(h["band_off"], h["k_off"] + h["e_off"]):
        raise ValueError("band_off must count n_kmers + n_events bands per read")
    if (np.diff(h["k_off"]) < 1).any():
        raise ValueError("every read needs at least one k-mer")
    order = np.asarray(t.host.get("order"))
    if order.shape != (B,) or (B and (order.min() < 0 or order.max() >= B
                                      or (np.bincount(order, minlength=B) != 1).any())):
        raise ValueError(f"order must be a permutation of the {B} reads")


def _check_fill(t: ReadTables, f: FillResult) -> None:
    dev, B, NB = t.ranks.device, t.n_reads, t.n_bands
    for name, dtype, shape in (("traces", _U8, (NB * BW // 4,)), ("bll_e", _I32, (NB,)),
                               ("trace1", _U8, (B, BW)), ("best", _F32, (B,)),
                               ("best_ev", _I32, (B,))):
        _check_tensor(name, getattr(f, name), dev, dtype, shape)


# ---------------------------------------------------------------------------
# fill
# ---------------------------------------------------------------------------

def _pad1(x):
    """x with one zero appended: the index a masked gather points at."""
    return torch.cat([x, x.new_zeros(1)])


def _emission(x, scale, shift, mean, stdv, log_stdv):
    """abea.py:244-246, each op rounding once: (x - (scale*mean + shift)) /
    stdv, then -0.918938 - log_stdv + (-0.5*a)*a."""
    a = (x - (scale * mean + shift)) / stdv
    return (torch.tensor(LOG_NORM, device=x.device) - log_stdv) + (-0.5 * a) * a


def abea_fill_reference(t: ReadTables) -> FillResult:
    """The plain PyTorch version of the fill kernel: JAX's step function
    (abea.py:298-406) over (B, 100) tensors, one host loop over the bands
    of the longest read.  A read's bands past its own n_kmers + n_events
    are neither kept nor let into its best."""
    dev = t.ranks.device
    B, NB = t.n_reads, t.n_bands
    trace1 = torch.zeros((B, BW), dtype=_U8, device=dev)
    trace1[:, BW // 2] = FROM_U
    if B == 0:
        return FillResult(torch.zeros(0, dtype=_U8, device=dev),
                          torch.zeros(0, dtype=_I32, device=dev), trace1,
                          torch.zeros(0, device=dev), torch.zeros(0, dtype=_I32, device=dev))
    hbw = BW // 2
    nk = t.k_off[1:] - t.k_off[:-1]
    ne = t.e_off[1:] - t.e_off[:-1]
    scale, shift, lp_skip, lp_stay, lp_step, lp_trim = (c[:, None] for c in t.params.T)
    ranks, events = _pad1(t.ranks), _pad1(t.events)
    model = t.model.T.contiguous()                            # (4096, 3): one gather
    offs = torch.arange(BW, device=dev)[None, :]
    neg = torch.tensor(float("-inf"), device=dev)
    neg_col = neg.expand(B, 1)
    codes = [torch.tensor(c, dtype=_U8, device=dev) for c in (FROM_D, FROM_U, FROM_L)]
    prev2 = torch.where(offs == hbw, 0.0, neg).expand(B, BW)
    prev = torch.where(offs == hbw, lp_trim, neg)
    be_p = torch.full((B,), hbw - 1, dtype=_I64, device=dev)
    bk_p = torch.full((B,), -1 - hbw, dtype=_I64, device=dev)
    be, bk = be_p + 1, bk_p.clone()
    best = torch.full((B,), float("-inf"), device=dev)
    best_ev = torch.zeros(B, dtype=_I64, device=dev)

    def check(band, e, k, best, best_ev, live=True):
        off = (nk - 1) - k
        evi = e - off
        valid = (off >= 0) & (off < BW) & (evi >= 0) & (evi < ne) & live
        v = band.gather(1, off.clamp(0, BW - 1)[:, None])[:, 0]
        s = v + (ne - evi).to(_F32) * lp_trim[:, 0]
        better = valid & (s > best)
        return torch.where(better, s, best), torch.where(better, evi, best_ev)

    best, best_ev = check(prev2, be_p, bk_p, best, best_ev)
    best, best_ev = check(prev, be, bk, best, best_ev)
    # every band of every read goes into (S, B) staging planes, S the longest
    # read's count; its own bands are gathered into the flat layout at the end
    nb_host = np.diff(t.host["band_off"])
    S = int(nb_host.max())
    stage_tr = torch.empty((S, B, BW // 4), dtype=_U8, device=dev)
    stage_be = torch.empty((S, B), dtype=_I64, device=dev)
    nb = t.band_off[1:] - t.band_off[:-1]
    e0, k0 = t.e_off[:-1], t.k_off[:-1]
    odd = [torch.tensor(v, device=dev) for v in (False, True)]
    for s in range(S):
        ll, ur = prev[:, 0], prev[:, BW - 1]
        right = torch.where(torch.isneginf(ll) & torch.isneginf(ur), odd[s % 2], ll < ur)
        nbe, nbk = be + ~right, bk + right
        # neighbours: the previous band shifted by a cell, -inf shifted in
        rc = right[:, None]
        p_up = torch.cat([prev[:, 1:], neg_col], 1)           # cell o + 1
        p_dn = torch.cat([neg_col, prev[:, :-1]], 1)          # cell o - 1
        up = torch.where(rc, p_up, prev)
        left = torch.where(rc, prev, p_dn)
        r2 = (right + (bk - bk_p))[:, None]                   # rights over the last two moves
        diag = torch.where(r2 == 0, torch.cat([neg_col, prev2[:, :-1]], 1),
                           torch.where(r2 == 1, prev2, torch.cat([prev2[:, 1:], neg_col], 1)))
        # cells with event nbe - o in [0, ne) and k-mer nbk + o in [0, nk)
        lo = torch.maximum(nbe - ne + 1, -nbk)[:, None]
        hi = torch.minimum(nbe, nk - 1 - nbk)[:, None]
        valid = (offs >= lo) & (offs <= hi)
        x = events[((e0 + nbe)[:, None] - offs).clamp(0, events.numel() - 1)]
        r = ranks[((k0 + nbk)[:, None] + offs).clamp(0, ranks.numel() - 1)].long()
        mdl = model[r & (N_MODEL - 1)]
        lp_e = _emission(x, scale, shift, mdl[..., 0], mdl[..., 1], mdl[..., 2])
        s_d = (diag + lp_step) + lp_e
        s_u = (up + lp_stay) + lp_e
        s_l = left + lp_skip
        mx = torch.maximum(s_d, s_u)
        mx2 = torch.maximum(mx, s_l)
        frm = torch.where(mx2 == s_l, codes[FROM_L],
                          torch.where(mx == s_u, codes[FROM_U], codes[FROM_D]))
        band = torch.where(valid, mx2, neg)
        frm = frm * valid
        # the trim cell, k-mer -1 at o = -1 - nbk, where its event is in range
        ot = -1 - nbk
        trim = (offs == ot[:, None]) & ((ot <= nbe) & (ot >= nbe - ne + 1))[:, None]
        band = torch.where(trim, lp_trim * (nbe - ot + 1).to(_F32)[:, None], band)
        frm = torch.where(trim, codes[FROM_U], frm)

        f4 = frm.view(B, BW // 4, 4)
        stage_tr[s] = f4[..., 0] | (f4[..., 1] << 2) | (f4[..., 2] << 4) | (f4[..., 3] << 6)
        stage_be[s] = nbe
        best, best_ev = check(band, nbe, nbk, best, best_ev, nb > s)
        prev2, prev = prev, band
        be_p, bk_p, be, bk = be, bk, nbe, nbk
    read = torch.repeat_interleave(torch.arange(B, device=dev), nb, output_size=NB)
    band_no = torch.arange(NB, device=dev) - t.band_off[:-1][read]
    traces = stage_tr[band_no, read]
    bll_e_out = stage_be[band_no, read].to(_I32)
    return FillResult(traces.view(-1), bll_e_out, trace1, best, best_ev.to(_I32))


def abea_fill(t: ReadTables) -> FillResult:
    """The banded fill of every read in the batch.

    Checks the tables on the host before any build or launch.  CPU tables
    take the plain version; CUDA tables launch the kernel once on the
    current stream, without synchronising, and raise if the launch fails."""
    _check_tables(t)
    dev = t.ranks.device
    if dev.type == "cpu":
        return abea_fill_reference(t)
    if dev.type != "cuda":
        raise ValueError(f"abea_fill runs on cuda or cpu tensors, not {dev}")
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    B, NB = t.n_reads, t.n_bands
    f = FillResult(torch.empty(NB * BW // 4, dtype=_U8, device=dev),
                   torch.empty(NB, dtype=_I32, device=dev),
                   torch.empty((B, BW), dtype=_U8, device=dev),
                   torch.empty(B, dtype=_F32, device=dev),
                   torch.empty(B, dtype=_I32, device=dev))
    if B == 0:
        return f
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gb_abea_fill(t.ranks.data_ptr(), t.events.data_ptr(), t.k_off.data_ptr(),
                              t.e_off.data_ptr(), t.band_off.data_ptr(), t.params.data_ptr(),
                              t.model.data_ptr(), t.order.data_ptr(), B, f.traces.data_ptr(),
                              f.bll_e.data_ptr(), f.trace1.data_ptr(), f.best.data_ptr(),
                              f.best_ev.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"abea fill kernel launch failed with cudaError {rc}")
    abea_fill.launches += 1
    return f


abea_fill.launches = 0      # kernel launches, counted where they happen


# ---------------------------------------------------------------------------
# backtrack
# ---------------------------------------------------------------------------

def abea_backtrack_reference(t: ReadTables, f: FillResult) -> torch.Tensor:
    """The plain PyTorch version of the backtrack kernel: abea.py:442-481
    over (B,), one host loop over the longest walk and the Kahan tail.
    Returns the kernel's int32 buffer: (B, 4) headers (pair count, sum of
    the emission terms as float bits, longest event gap, best as float
    bits), then 2 x (sum of the bands) pairs, read b's in forward order
    ending at band_off[b+1], every other slot -1."""
    dev = t.ranks.device
    B, NB = t.n_reads, t.n_bands
    out = torch.full((4 * B + 2 * NB,), -1, dtype=_I32, device=dev)
    if B == 0:
        return out
    pairs = torch.cat([out[4 * B:].view(NB, 2), out.new_full((1, 2), -1)])   # + a pad row
    nk = t.k_off[1:] - t.k_off[:-1]
    scale, shift = t.params[:, 0], t.params[:, 1]
    ranks, events = _pad1(t.ranks), _pad1(t.events)
    traces = _pad1(f.traces)
    bll_e = _pad1(f.bll_e)
    alive = torch.isfinite(f.best)
    k = nk - 1
    e = torch.where(alive, f.best_ev.long(), -1)
    zero_f = torch.zeros(B, dtype=_F32, device=dev)
    sum_em, comp = zero_f.clone(), zero_f.clone()
    gap = torch.zeros(B, dtype=_I64, device=dev)
    max_gap, n, tail = gap.clone(), gap.clone(), gap.clone()
    end = t.band_off[1:]
    for _ in range(int(np.diff(t.host["band_off"]).max()) + TAIL_STEPS):
        active = alive & (k >= 0) & (e >= 0)
        kc, ec = k.clamp(min=0), e.clamp(min=0)
        pairs[torch.where(active, end - 1 - n, NB)] = torch.stack([k, e], 1).to(_I32)
        r = ranks[torch.where(active, t.k_off[:-1] + kc, ranks.numel() - 1)].long()
        r = r & (N_MODEL - 1)
        x = events[torch.where(active, t.e_off[:-1] + ec, events.numel() - 1)]
        term = torch.where(active, _emission(x, scale, shift, t.model[0][r], t.model[1][r],
                                             t.model[2][r]), zero_f)
        y = term - comp                                        # Kahan
        s = sum_em + y
        upd = alive & (active | (tail < TAIL_STEPS))
        comp = torch.where(upd, (s - sum_em) - y, comp)
        sum_em = torch.where(upd, s, sum_em)
        tail = torch.where(active, tail, tail + 1)
        band = torch.where(active, t.band_off[:-1] + ec + kc, NB)    # band (e + 1) + (k + 1) - 2
        off = (bll_e[band].long() - ec).clamp(0, BW - 1)
        byte = traces[torch.where(active, band * (BW // 4) + (off >> 2), traces.numel() - 1)]
        frm = (byte.long() >> (2 * (off & 3))) & 3
        k = torch.where(active & (frm != FROM_U), k - 1, k)
        e = torch.where(active & (frm != FROM_L), e - 1, e)
        gap = torch.where(active, torch.where(frm == FROM_L, gap + 1, 0), gap)
        max_gap = torch.maximum(max_gap, gap)
        n = n + active.long()
    out[4 * B:] = pairs[:NB].reshape(-1)
    hdr = out[:4 * B].view(B, 4)
    hdr[:, 0] = n.to(_I32)
    hdr[:, 1] = sum_em.view(_I32)
    hdr[:, 2] = max_gap.to(_I32)
    hdr[:, 3] = f.best.view(_I32)
    return out


def abea_backtrack(t: ReadTables, f: FillResult) -> torch.Tensor:
    """The walk back over every read's traces: the int32 buffer that
    `abea_backtrack_reference` describes.

    Checks the tables and the fill's outputs on the host before any build
    or launch.  CPU tensors take the plain version; CUDA tensors launch the
    kernel once on the current stream, without synchronising, and raise if
    the launch fails.  The kernel stages the traces and corners by 16-byte
    copies: their pointers must be 16-byte aligned (the fill's own outputs
    always are), else ValueError."""
    _check_tables(t)
    _check_fill(t, f)
    dev = t.ranks.device
    if dev.type == "cpu":
        return abea_backtrack_reference(t, f)
    if dev.type != "cuda":
        raise ValueError(f"abea_backtrack runs on cuda or cpu tensors, not {dev}")
    if f.traces.data_ptr() % 16 or f.bll_e.data_ptr() % 16:
        raise ValueError("the backtrack kernel reads the traces and bll_e in 16-byte "
                         "pieces: both must be so aligned")
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    B = t.n_reads
    out = torch.full((4 * B + 2 * t.n_bands,), -1, dtype=_I32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gb_abea_backtrack(t.ranks.data_ptr(), t.events.data_ptr(), t.k_off.data_ptr(),
                                   t.e_off.data_ptr(), t.band_off.data_ptr(),
                                   t.params.data_ptr(), t.model.data_ptr(), t.order.data_ptr(),
                                   f.traces.data_ptr(), f.bll_e.data_ptr(), f.best.data_ptr(),
                                   f.best_ev.data_ptr(), B, out.data_ptr(), None, stream)
    if rc != 0:
        raise RuntimeError(f"abea backtrack kernel launch failed with cudaError {rc}")
    abea_backtrack.launches += 1
    return out


abea_backtrack.launches = 0


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AbeaResult:
    pairs: list        # per read: (n, 2) int32 array of (kmer_idx, event_idx)
    failed: list       # per read: bool (QC)


def _fetch(out: torch.Tensor) -> np.ndarray:
    """One copy of the backtrack's buffer to the host (page-locked from
    the card)."""
    if out.device.type == "cpu":
        return out.numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out)
    return host.numpy()


def _collect(t: ReadTables, flat: np.ndarray) -> AbeaResult:
    """The QC gates of abea.py:588-606 on the fetched buffer, vectorised:
    a read fails if its best score is not finite, its average log emission
    (float64, over at least one pair) is below -5, its pairs do not span
    k-mers 0 .. n_kmers - 1, or an event gap passes 50."""
    B, NB = t.n_reads, t.n_bands
    hdr = flat[:4 * B].reshape(B, 4)
    pairs = flat[4 * B:].reshape(NB, 2)
    n = hdr[:, 0].astype(np.int64)
    sum_em = hdr[:, 1].view(np.float32)
    max_gap = hdr[:, 2]
    best = hdr[:, 3].view(np.float32)
    nk = np.diff(t.host["k_off"])
    end = t.host["band_off"][1:]
    has = n > 0
    first_k = np.where(has, pairs[np.where(has, end - n, 0), 0], -1)
    last_k = np.where(has, pairs[np.where(has, end - 1, 0), 0], -1)
    avg = sum_em.astype(np.float64) / np.maximum(n, 1)
    spanned = has & (first_k == 0) & (last_k == nk - 1)
    failed = (~np.isfinite(best) | (avg < MIN_AVG_LOG_EMISSION) | ~spanned
              | (max_gap > MAX_GAP_THRESHOLD))
    empty = np.zeros((0, 2), np.int32)
    out = [empty if f else pairs[s - c:s] for f, s, c in zip(failed.tolist(), end.tolist(),
                                                             n.tolist())]
    return AbeaResult(pairs=out, failed=failed.tolist())


def align_batch(sequences, event_means, model_mean, model_stdv, scalings,
                device="cuda", mesh=None) -> AbeaResult:
    """sequences: list of 0..3-coded arrays; event_means: list of f32
    arrays; scalings: (B, 2) [scale, shift]; the pore model's 4,096 level
    means and stdvs.  Returns per-read aligned (kmer, event) pairs after QC,
    align.c semantics, as the JAX package's align_batch.

    One upload, one launch of each kernel, one fetch; the plain versions
    with device="cpu".  With `mesh` (parallel.mesh.Mesh; `device` is then
    the mesh's) the reads shard over its "data" axis, a multiple of which B
    must be (ValueError), the pore model on every rank; each rank aligns its
    block and the pair counts, QC flags and pairs are gathered in rank
    order, so every rank returns the one-card result."""
    if mesh is not None:
        lo, hi = row_bounds(mesh, len(sequences))
        part = align_batch(sequences[lo:hi], event_means[lo:hi], model_mean, model_stdv,
                           np.asarray(scalings, np.float32).reshape(-1, 2)[lo:hi],
                           device=mesh.device)
        counts = gather_rows(mesh, torch.tensor([len(q) for q in part.pairs],
                                                dtype=torch.int64)).cpu().numpy()
        failed = gather_rows(mesh, torch.tensor(part.failed, dtype=torch.bool)).cpu().numpy()
        flat = np.concatenate(part.pairs) if part.pairs else np.zeros((0, 2), np.int32)
        flat = gather_rows(mesh, torch.from_numpy(np.ascontiguousarray(flat, np.int32)))
        pairs = np.split(flat.cpu().numpy(), np.cumsum(counts)[:-1]) if len(counts) else []
        return AbeaResult(pairs=pairs, failed=failed.tolist())
    dev = resolve_device(device)
    if len(sequences) == 0:
        return AbeaResult(pairs=[], failed=[])
    t = upload_reads(sequences, event_means, model_mean, model_stdv, scalings, dev)
    return _collect(t, _fetch(abea_backtrack(t, abea_fill(t))))
