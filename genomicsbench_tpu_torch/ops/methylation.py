"""f5c call-methylation: the CpG profile-HMM forward pass in PyTorch.

The port of genomicsbench_tpu/ops/methylation.py.  Semantics: f5c's
methylation mode (src/hmm.c:305-527 profile_hmm_fill_generic_r9 with its
flanks and block transitions, src/meth.c:359-659 the CpG calling of one
read), as the JAX package computes it.

Host part (numpy, copied): the ACGMT alphabet and its k-mer ranks, the
CG -> MG rewriting, the synthetic 5^6 CpG model, the block transitions, the
flanks, the NumPy oracle in float32 and float64, `find_event_bounds`,
`ScoredSite` and `methylation_frequency`.

Device part: one function, `meth_forward`, the forward score of every
(CpG group, sequence variant) instance of a batch, in two versions: on the
card the hand-written kernel `gb_meth_forward` of `csrc/meth.cu` (one warp
per instance), on the CPU `meth_forward_reference`, JAX's `_phmm_meth_scan`
(ops/methylation.py:241-307) over (G, K) tensors with one host loop over
the event rows.

`call_methylation_batch` takes every read at once: the CpG scan, the
groups, their event bounds and both variants' k-mer ranks are numpy passes
over all reads, and the instances go to the device in one page-locked
upload, one launch and one page-locked fetch behind an event.  The JAX
package scores one read per call (`call_methylation_for_read`, kept here
as the one-read form).

One intended difference: a group's event rows are the |e2 - e1| + 1 events
from e1 towards e2, in either direction, as meth.c takes them.  The JAX
package slices `event_means[e1 : e2 + stride : stride]`, which is empty for
a reversed range that ends at event 0, and then raises IndexError.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.ops.abea import _check_tensor

KMER = 6
ALPHABET = "ACGMT"  # rank order (hmm.c:21-37)
RANK = {c: i for i, c in enumerate(ALPHABET)}
NUM_KMER_METH = 5**KMER  # 15625

TRANS_START_TO_CLIP = 0.5
TRANS_CLIP_SELF = 0.9
P_SKIP, P_BAD, P_SKIP_SELF = 0.0025, 0.001, 0.3
HAF_ALLOW_PRE_CLIP, HAF_ALLOW_POST_CLIP = 1, 2
MAX_EVENT_TO_BP_RATIO = 20  # f5cmisc.h:10
MIN_SEPARATION = 10  # meth.c:542
LOG_INV_SQRT_2PI = np.float32(-0.918938)
NEG_INF = -np.inf

NEG = -1e30             # the kernel's sentinel (JAX ops/methylation.py:247)
MAX_BLOCKS = 256        # k-mer blocks of one instance: 8 per lane of a warp
N_PARAMS = 16           # per read: scale shift var log_var, 10 transitions, 2 pad
TRANSITIONS = ("lp_mk", "lp_mb", "lp_mm_self", "lp_mm_next", "lp_bb", "lp_bk",
               "lp_bm_next", "lp_bm_self", "lp_kk", "lp_km")
# The operations the forward pass needs, for the kernel's bound
# (csrc/meth.cu).  Per (row, block) cell: seven logaddexp (four for M, one
# for B, one for u, one for K), eleven adds and the emission.  A logaddexp
# is max, sub and add around expf and log1pf; built for sm_90a, expf is 6
# FP32 instructions and one MUFU.EX2, log1pf 19 FP32 (its polynomial, no
# MUFU), and the emission's IEEE division 5 FP32 and one MUFU.RCP beside
# its sub, two mul and two sub (chip_smoke.py `[meth kernel]` counts them
# in the SASS of each function alone).  Per row, with both clip flags:
# the pre flank's logaddexp at block 0 and the end state's three and one
# add.  Per block, once: the level planes' two mul and two add.
METH_FP32_PER_LA = 3 + 6 + 19
METH_MUFU_PER_LA = 1
METH_LA_PER_CELL = 7
METH_FP32_OPS_PER_CELL = METH_LA_PER_CELL * METH_FP32_PER_LA + 11 + 5 + 5
METH_MUFU_OPS_PER_CELL = METH_LA_PER_CELL * METH_MUFU_PER_LA + 1
METH_LA_PER_ROW = 1 + 3
METH_FP32_OPS_PER_ROW = METH_LA_PER_ROW * METH_FP32_PER_LA + 1
METH_MUFU_OPS_PER_ROW = METH_LA_PER_ROW * METH_MUFU_PER_LA
METH_FP32_OPS_PER_BLOCK = 4

_I16, _I32, _I64, _F32, _U8 = torch.int16, torch.int32, torch.int64, torch.float32, torch.uint8


# ------------------------------------------------------------ sequence utils
def disambiguate(seq: str) -> str:
    """meth.c disambiguate: upper-case, non-ACGT -> first possible symbol
    ('A' for N)."""
    return "".join(c if c in "ACGT" else "A" for c in seq.upper())


def methylate(seq: str) -> str:
    """CG -> MG (meth.c:359-380)."""
    out = list(seq)
    i = 0
    while i < len(out) - 1:
        if out[i] == "C" and out[i + 1] == "G":
            out[i] = "M"
            i += 2
        else:
            i += 1
    return "".join(out)


_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "M": "G"}


def reverse_complement_meth(seq: str) -> str:
    """Reverse complement preserving MG recognition sites as MG
    (meth.c:387-430)."""
    n = len(seq)
    out = ["A"] * n
    i, j = 0, n - 1
    while i < n:
        if i + 1 < n and seq[i] == "M" and seq[i + 1] == "G":
            out[j] = "G"
            out[j - 1] = "M"
            j -= 2
            i += 2
        else:
            out[j] = _COMP.get(seq[i], "T")
            j -= 1
            i += 1
    return "".join(out)


def meth_kmer_rank(seq: str, ki: int, k: int = KMER) -> int:
    """Lexicographic rank over ACGMT (hmm.c:40-53)."""
    r = 0
    for c in seq[ki : ki + k]:
        r = r * 5 + RANK[c]
    return r


# ACGMT rank of each byte; any other byte raises in meth_kmer_ranks (JAX's
# RANK[c] raises KeyError there)
_RANK_OF = np.full(256, -1, np.int64)
for _c, _r in RANK.items():
    _RANK_OF[ord(_c)] = _r


def _window_ranks(codes: np.ndarray, k: int = KMER) -> np.ndarray:
    """Base-5 big-endian ranks of every k-window of `codes` (0..4)."""
    n = max(len(codes) - k + 1, 0)
    r = np.zeros(n, np.int64)
    for j in range(k):
        r = r * 5 + codes[j : j + n]
    return r


def meth_kmer_ranks(seq: str, rc_seq: str, rc: bool, k: int = KMER) -> np.ndarray:
    """Per-kmer ranks as the fill routine computes them (hmm.c:377-394):
    forward reads index m_seq[ki..], reverse reads index
    m_rc_seq[len-ki-k..].  One numpy pass over the windows."""
    n = len(seq) - k + 1
    src = rc_seq if rc else seq
    codes = _RANK_OF[np.frombuffer(src.encode(), np.uint8)] if src else np.zeros(0, np.int64)
    if (codes < 0).any():
        raise KeyError(f"a base outside {ALPHABET!r}")
    if rc:      # window len - ki - k of rc_seq, for ki = 0 .. n - 1
        w = _window_ranks(codes[len(seq) - (n + k - 1):], k) if n > 0 else codes[:0]
        return w[::-1].astype(np.int32)
    return _window_ranks(codes[:n + k - 1], k).astype(np.int32) if n > 0 else np.zeros(
        n, np.int32)


def synthetic_cpg_model(seed=0):
    """Random but deterministic 5^6 CpG model (level mean/stdv) for tests
    and environments without the f5c model table."""
    rng = np.random.default_rng(seed)
    mean = (rng.normal(90, 12, NUM_KMER_METH)).astype(np.float32)
    stdv = (rng.uniform(1.0, 3.0, NUM_KMER_METH)).astype(np.float32)
    return mean, stdv


# ---------------------------------------------------------------- transitions
def _block_transitions(events_per_base: float, dtype):
    p_stay = 1.0 - 1.0 / events_per_base
    p_mk, p_mb, p_mm_self = P_SKIP, P_BAD, p_stay
    p_mm_next = 1.0 - p_mm_self - p_mk - p_mb
    p_bb = P_BAD
    p_bk = p_bm_next = p_bm_self = (1.0 - p_bb) / 3
    p_kk = P_SKIP_SELF
    p_km = 1.0 - p_kk
    names = dict(
        lp_mk=p_mk, lp_mb=p_mb, lp_mm_self=p_mm_self, lp_mm_next=p_mm_next,
        lp_bb=p_bb, lp_bk=p_bk, lp_bm_next=p_bm_next, lp_bm_self=p_bm_self,
        lp_kk=p_kk, lp_km=p_km,
    )
    return {k: dtype(np.log(np.float32(v))) for k, v in names.items()}


def _flanks(n_events: int, dtype):
    """make_pre_flanking / make_post_flanking (hmm.c:132-229); background
    emission fixed at -3.0."""
    pre = np.zeros(n_events + 1, dtype)
    pre[0] = dtype(np.log(1 - TRANS_START_TO_CLIP))
    if n_events >= 1:
        pre[1] = dtype(
            np.log(TRANS_START_TO_CLIP) + -3.0 + np.log(1 - TRANS_CLIP_SELF)
        )
    for i in range(2, n_events + 1):
        pre[i] = dtype(np.log(TRANS_CLIP_SELF) + -3.0) + pre[i - 1]
    post = np.zeros(n_events, dtype)
    post[n_events - 1] = dtype(np.log(1 - TRANS_START_TO_CLIP))
    if n_events > 1:
        post[n_events - 2] = dtype(
            np.log(TRANS_START_TO_CLIP) + -3.0 + np.log(1 - TRANS_CLIP_SELF)
        )
        for i in range(n_events - 3, -1, -1):
            post[i] = dtype(np.log(TRANS_CLIP_SELF) + -3.0) + post[i + 1]
    return pre, post


def flank_table(n: int) -> np.ndarray:
    """The float32 flank of `_flanks` as one table of n values: pre[j] and
    post[E - 1 - j] of any E follow the same float32 recurrence from
    log(0.5), so row r of an instance of E rows takes pre = table[r - 1]
    and post = table[E - r], bit for bit."""
    out = np.empty(max(n, 2), np.float32)
    out[0] = np.float32(np.log(1 - TRANS_START_TO_CLIP))
    out[1] = np.float32(np.log(TRANS_START_TO_CLIP) + -3.0 + np.log(1 - TRANS_CLIP_SELF))
    out[2:] = np.float32(np.log(TRANS_CLIP_SELF) + -3.0)
    np.add.accumulate(out[1:], out=out[1:])       # sequential float32 sums
    return out[:n]


def read_params(scalings, events_per_base) -> np.ndarray:
    """(R, 16) float32 per read: scale, shift, var, float32 log(var), the ten
    block transitions of `_block_transitions(epb, float32)` in JAX's bt_arr
    order (ops/methylation.py:329-330), two zeros.  Vectorised over reads
    with the same float64 and float32 steps."""
    sc = np.asarray(scalings, np.float32).reshape(-1, 3)
    epb = np.asarray(events_per_base, np.float64).reshape(-1)
    R = len(sc)
    with np.errstate(divide="ignore", invalid="ignore"):
        p_stay = 1.0 - 1.0 / epb
        p_mm_next = 1.0 - p_stay - P_SKIP - P_BAD
    p_b3 = (1.0 - P_BAD) / 3
    probs = dict(lp_mk=P_SKIP, lp_mb=P_BAD, lp_mm_self=p_stay, lp_mm_next=p_mm_next,
                 lp_bb=P_BAD, lp_bk=p_b3, lp_bm_next=p_b3, lp_bm_self=p_b3,
                 lp_kk=P_SKIP_SELF, lp_km=1.0 - P_SKIP_SELF)
    out = np.zeros((R, N_PARAMS), np.float32)
    out[:, :3] = sc
    with np.errstate(divide="ignore", invalid="ignore"):
        out[:, 3] = np.log(sc[:, 2])
        for j, name in enumerate(TRANSITIONS):
            v = np.broadcast_to(np.asarray(probs[name], np.float64), (R,))
            out[:, 4 + j] = np.log(v.astype(np.float32))
    return out


# --------------------------------------------------------------------- oracle
def profile_hmm_score_oracle(
    kmer_ranks, event_means, scale, shift, var, model_mean, model_stdv,
    events_per_base, flags=HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP,
    dtype=np.float64,
):
    """Forward score (profile_hmm_fill_generic_r9 + ForwardOutput).

    kmer_ranks (K,) int; event_means (E,) float32 ALREADY in row order
    (the caller applies event_stride, i.e. reversed for rc reads).
    dtype=float64 matches the reference's double add_logs; float32 is the
    kernel contract."""
    la = np.logaddexp
    K = len(kmer_ranks)
    E = len(event_means)
    bt = _block_transitions(events_per_base, dtype)
    pre, post = _flanks(E, dtype)
    gp_mean = (np.float32(scale) * model_mean[kmer_ranks] + np.float32(shift)).astype(np.float32)
    gp_stdv = (model_stdv[kmer_ranks] * np.float32(var)).astype(np.float32)
    gp_log_stdv = (np.log(model_stdv[kmer_ranks]) + np.float32(np.log(np.float32(var)))).astype(np.float32)

    M = np.full(K, NEG_INF, dtype)
    B = np.full(K, NEG_INF, dtype)
    Kst = np.full(K, NEG_INF, dtype)
    lp_end = dtype(NEG_INF)
    for row in range(1, E + 1):
        ev = np.float32(event_means[row - 1])
        a = (ev - gp_mean) / gp_stdv
        lp_em = (LOG_INV_SQRT_2PI - gp_log_stdv + np.float32(-0.5) * a * a).astype(np.float32)
        Mn = np.full(K, NEG_INF, dtype)
        Bn = np.full(K, NEG_INF, dtype)
        Kn = np.full(K, NEG_INF, dtype)
        for b in range(K):
            s = bt["lp_mm_self"] + M[b]
            s = la(s, bt["lp_mm_next"] + (M[b - 1] if b else NEG_INF))
            s = la(s, bt["lp_bm_self"] + B[b])
            s = la(s, bt["lp_bm_next"] + (B[b - 1] if b else NEG_INF))
            s = la(s, bt["lp_km"] + (Kst[b - 1] if b else NEG_INF))
            if b == 0 and (row == 1 or (flags & HAF_ALLOW_PRE_CLIP)):
                s = la(s, pre[row - 1])
            Mn[b] = s + dtype(lp_em[b])
            Bn[b] = la(bt["lp_mb"] + M[b], bt["lp_bb"] + B[b])
            u = la(
                bt["lp_mk"] + (Mn[b - 1] if b else NEG_INF),
                bt["lp_bk"] + (Bn[b - 1] if b else NEG_INF),
            )
            Kn[b] = la(u, bt["lp_kk"] + (Kn[b - 1] if b else NEG_INF))
        if (flags & HAF_ALLOW_POST_CLIP) or row == E:
            for state in (Mn, Bn, Kn):
                lp_end = la(lp_end, state[K - 1] + post[row - 1])
        M, B, Kst = Mn, Bn, Kn
    return float(lp_end)


# ------------------------------------------------------------ device tables
@dataclasses.dataclass
class MethTables:
    """One batch of profile-HMM instances on one device.  Instance g scores
    the k-mer ranks at [rank_off[g], rank_off[g+1]) of `ranks` (int16,
    0..15624) against the events ev_first[g], ev_first[g] +- 1, ...,
    ev_last[g] of `events` (its rows, in that order), with the scalings and
    transitions of row read[g] of `params` (R, 16).  `model` (3, 15625):
    the CpG model's level means, stdvs and float32 log stdvs; `flank`: the
    `flank_table` of the longest instance.  `host` holds numpy copies of
    rank_off, ev_first, ev_last and read, which the wrapper checks."""

    ranks: torch.Tensor
    rank_off: torch.Tensor
    ev_first: torch.Tensor
    ev_last: torch.Tensor
    read: torch.Tensor
    events: torch.Tensor
    params: torch.Tensor
    model: torch.Tensor
    flank: torch.Tensor
    host: dict

    @property
    def n_instances(self) -> int:
        return self.rank_off.numel() - 1


_FIELDS = (("ranks", np.int16), ("rank_off", np.int64), ("ev_first", np.int64),
           ("ev_last", np.int64), ("read", np.int32), ("events", np.float32),
           ("params", np.float32), ("model", np.float32), ("flank", np.float32))


def _model_table(model_mean, model_stdv) -> np.ndarray:
    mean = np.asarray(model_mean, np.float32)
    stdv = np.asarray(model_stdv, np.float32)
    if mean.shape != (NUM_KMER_METH,) or stdv.shape != (NUM_KMER_METH,):
        raise ValueError(f"the CpG model must have {NUM_KMER_METH} k-mers, got "
                         f"{mean.shape} and {stdv.shape}")
    return np.stack([mean, stdv, np.log(stdv)])


def upload_instances(ranks, rank_off, ev_first, ev_last, read, events, params, model_mean,
                     model_stdv, device, stats=None) -> MethTables:
    """The instances as `MethTables` on `device`: every array packed into one
    host buffer (page-locked for the card) and copied in one upload."""
    dev = resolve_device(device)
    ranks = np.asarray(ranks)
    if ranks.size and (ranks.min() < 0 or ranks.max() >= NUM_KMER_METH):
        raise ValueError(f"k-mer ranks must lie in 0..{NUM_KMER_METH - 1}")
    rank_off = np.asarray(rank_off, np.int64)
    ev_first = np.asarray(ev_first, np.int64)
    ev_last = np.asarray(ev_last, np.int64)
    n_rows = np.abs(ev_last - ev_first) + 1
    arrays = dict(ranks=ranks, rank_off=rank_off, ev_first=ev_first, ev_last=ev_last,
                  read=read, events=events, params=params,
                  model=_model_table(model_mean, model_stdv),
                  flank=flank_table(int(n_rows.max()) if len(n_rows) else 1))
    layout, nbytes = {}, 0
    for name, dt in _FIELDS:
        a = np.asarray(arrays[name])
        layout[name] = (nbytes, dt, a.shape)
        nbytes += -(-a.size * np.dtype(dt).itemsize // 16) * 16
    pinned = dev.type == "cuda"
    buf = torch.empty(max(nbytes, 16), dtype=_U8, pin_memory=pinned)
    host = buf.numpy()
    for name, (o, dt, shape) in layout.items():
        a = np.asarray(arrays[name])
        host[o:o + a.size * np.dtype(dt).itemsize].view(dt)[:] = a.reshape(-1)
    t0 = time.perf_counter()
    up = buf.to(dev, non_blocking=pinned)
    t = {}
    for name, (o, dt, shape) in layout.items():
        n = int(np.prod(shape))
        t[name] = up[o:o + n * np.dtype(dt).itemsize].view(getattr(torch, np.dtype(dt).name)
                                                           ).view(shape)
    rank_range = (int(ranks.min()), int(ranks.max())) if ranks.size else (0, 0)
    tables = MethTables(**t, host=dict(rank_off=rank_off, ev_first=ev_first, ev_last=ev_last,
                                       read=np.asarray(read, np.int32), rank_range=rank_range))
    if stats is not None:
        if pinned:
            torch.cuda.synchronize(dev)
        stats["upload"] = time.perf_counter() - t0
        stats["upload_bytes"] = nbytes
    tables._buf = buf       # the page-locked source stays alive until the copy is done
    return tables


def _check_tables(t: MethTables) -> None:
    """Refuse tables the kernel does not take, from what needs no wait for
    the device: devices, dtypes, shapes, contiguity, and on the host copies
    the offsets, the rank range, the event range and the read rows."""
    dev = t.ranks.device
    G = t.rank_off.numel() - 1
    NR, NE, R = t.ranks.numel(), t.events.numel(), t.params.shape[0] if t.params.dim() else 0
    if t.ranks.dim() != 1 or t.events.dim() != 1 or t.rank_off.dim() != 1 or G < 0:
        raise ValueError("ranks, events and rank_off must be one-dimensional")
    for name, dtype, shape in (("ranks", _I16, (NR,)), ("rank_off", _I64, (G + 1,)),
                               ("ev_first", _I64, (G,)), ("ev_last", _I64, (G,)),
                               ("read", _I32, (G,)), ("events", _F32, (NE,)),
                               ("params", _F32, (R, N_PARAMS)),
                               ("model", _F32, (3, NUM_KMER_METH)),
                               ("flank", _F32, (t.flank.numel(),))):
        _check_tensor(name, getattr(t, name), dev, dtype, shape)
    h = t.host
    off = np.asarray(h.get("rank_off"))
    if off.shape != (G + 1,) or off[0] != 0 or off[-1] != NR:
        raise ValueError(f"rank_off must run from 0 to {NR} over {G + 1} entries")
    nk = np.diff(off)
    if (nk < 1).any():
        raise ValueError("every instance needs at least one k-mer")
    if (nk > MAX_BLOCKS).any():
        raise ValueError(f"an instance has {int(nk.max())} k-mers; the kernel takes at most "
                         f"{MAX_BLOCKS}")
    first, last = np.asarray(h.get("ev_first")), np.asarray(h.get("ev_last"))
    read = np.asarray(h.get("read"))
    if first.shape != (G,) or last.shape != (G,) or read.shape != (G,):
        raise ValueError(f"host ev_first, ev_last and read must have {G} entries")
    if G and (min(first.min(), last.min()) < 0 or max(first.max(), last.max()) >= NE):
        raise ValueError(f"an instance's events lie outside the {NE} uploaded")
    if G and (read.min() < 0 or read.max() >= R):
        raise ValueError(f"an instance's read lies outside the {R} rows of params")
    lo, hi = h.get("rank_range", (-1, -1))
    if NR and (lo < 0 or hi >= NUM_KMER_METH):
        raise ValueError(f"k-mer ranks must lie in 0..{NUM_KMER_METH - 1}")
    rows = np.abs(last - first) + 1
    if G and t.flank.numel() < rows.max():
        raise ValueError(f"the flank table holds {t.flank.numel()} rows, an instance "
                         f"{int(rows.max())}")


# ----------------------------------------------------------------- forward
def _la(a, b):
    """logaddexp as XLA computes it: max + log1p(exp(-|a - b|))."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def meth_forward_reference(t: MethTables, flags=HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP):
    """The plain PyTorch version of the kernel: JAX's `_phmm_meth_scan`
    (ops/methylation.py:241-307) over (G, K) tensors, with its -1e30
    sentinel, shift1, masks and an associative scan of the K state along the
    blocks (Hillis-Steele over JAX's `combine`), one host loop over the
    rows.  Returns (G,) float32 scores."""
    dev = t.ranks.device
    G = t.n_instances
    out = torch.full((G,), NEG, dtype=_F32, device=dev)
    if G == 0:
        return out
    nk = t.rank_off[1:] - t.rank_off[:-1]
    Kp = int(np.diff(t.host["rank_off"]).max())
    blocks = torch.arange(Kp, device=dev)
    kmask = blocks[None, :] < nk[:, None]
    r = t.ranks[(t.rank_off[:-1, None] + blocks[None, :]).clamp(max=max(t.ranks.numel() - 1, 0))]
    r = torch.where(kmask, r.long(), 0)
    p = t.params[t.read.long()]
    scale, shift, var, log_var = (p[:, i:i + 1] for i in range(4))
    (lp_mk, lp_mb, lp_mm_self, lp_mm_next, lp_bb, lp_bk, lp_bm_next, lp_bm_self, lp_kk,
     lp_km) = (p[:, 4 + i:5 + i] for i in range(10))
    gp_mean = torch.where(kmask, scale * t.model[0][r] + shift, 0.0)
    gp_stdv = torch.where(kmask, t.model[1][r] * var, 1.0)
    gp_log_stdv = torch.where(kmask, t.model[2][r] + log_var, 0.0)
    neg = torch.tensor(NEG, dtype=_F32, device=dev)

    def shift1(x):          # x[b - 1], NEG at b = 0
        return torch.cat([neg.expand(G, 1), x[:, :-1]], 1)

    step = torch.where(t.ev_last >= t.ev_first, 1, -1)
    n_rows = (t.ev_last - t.ev_first).abs() + 1
    M = neg.expand(G, Kp).clone()
    B, K = M.clone(), M.clone()
    lp_end = neg.expand(G).clone()
    last = blocks[None, :] == (nk - 1)[:, None]
    for row in range(1, int(np.abs(t.host["ev_last"] - t.host["ev_first"]).max()) + 2):
        live = row <= n_rows
        ev_row = t.events[torch.where(live, t.ev_first + (row - 1) * step, 0)]
        pre_row = t.flank[row - 1]
        post_row = t.flank[(n_rows - row).clamp(min=0)]
        a = (ev_row[:, None] - gp_mean) / gp_stdv
        lp_em = (LOG_INV_SQRT_2PI.item() - gp_log_stdv) - (0.5 * a) * a
        s = _la(lp_mm_self + M, lp_mm_next + shift1(M))
        s = _la(s, lp_bm_self + B)
        s = _la(s, lp_bm_next + shift1(B))
        s = _la(s, lp_km + shift1(K))
        soft = neg.expand(G, Kp).clone()
        if flags & HAF_ALLOW_PRE_CLIP or row == 1:
            soft[:, 0] = pre_row
        s = _la(s, soft)
        Mn = s + lp_em
        Bn = _la(lp_mb + M, lp_bb + B)
        u = _la(lp_mk + shift1(Mn), lp_bk + shift1(Bn))
        u = torch.where(kmask, u, neg)
        sk = lp_kk.expand(G, Kp)
        d = 1
        while d < Kp:       # inclusive scan: (u, s)[b] = combine((u, s)[b - d], (u, s)[b])
            u_prev = torch.cat([neg.expand(G, d), u[:, :-d]], 1)
            s_prev = torch.cat([torch.zeros(G, d, dtype=_F32, device=dev), sk[:, :-d]], 1)
            has = blocks >= d
            u = torch.where(has, _la(u, sk + u_prev), u)
            sk = torch.where(has, s_prev + sk, sk)
            d *= 2
        Kn = torch.where(kmask, u, neg)
        Mn = torch.where(kmask, Mn, neg)
        Bn = torch.where(kmask, Bn, neg)

        def pick(X):
            return torch.where(last, X, neg).amax(1)

        contrib = _la(_la(pick(Mn), pick(Bn)), pick(Kn)) + post_row
        end_ok = live if flags & HAF_ALLOW_POST_CLIP else live & (row == n_rows)
        lp_end = torch.where(end_ok, _la(lp_end, contrib), lp_end)
        M = torch.where(live[:, None], Mn, M)
        B = torch.where(live[:, None], Bn, B)
        K = torch.where(live[:, None], Kn, K)
    return lp_end


def meth_forward(t: MethTables, flags=HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP):
    """The forward score of every instance: (G,) float32.

    Checks the tables on the host before any build or launch.  CPU tables
    take the plain version; CUDA tables launch the kernel once on the
    current stream, without synchronising, and raise if the launch fails."""
    _check_tables(t)
    if flags not in (0, 1, 2, 3):
        raise ValueError(f"flags must be a combination of HAF_ALLOW_PRE_CLIP and "
                         f"HAF_ALLOW_POST_CLIP, got {flags}")
    dev = t.ranks.device
    if dev.type == "cpu":
        return meth_forward_reference(t, flags)
    if dev.type != "cuda":
        raise ValueError(f"meth_forward runs on cuda or cpu tensors, not {dev}")
    from genomicsbench_tpu_torch import _kernels

    lib = _kernels.load()
    G = t.n_instances
    out = torch.empty(G, dtype=_F32, device=dev)
    if G == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gb_meth_forward(t.ranks.data_ptr(), t.rank_off.data_ptr(),
                                 t.ev_first.data_ptr(), t.ev_last.data_ptr(),
                                 t.read.data_ptr(), t.events.data_ptr(), t.params.data_ptr(),
                                 t.model.data_ptr(), t.flank.data_ptr(), G, int(flags),
                                 out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"meth forward kernel launch failed with cudaError {rc}")
    meth_forward.launches += 1
    return out


meth_forward.launches = 0       # kernel launches, counted where they happen


def _fetch(out: torch.Tensor) -> np.ndarray:
    """One copy of the scores to the host: page-locked from the card,
    behind an event."""
    if out.device.type == "cpu":
        return out.numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()


def upload_profile_instances(instances, model_mean, model_stdv, device) -> MethTables:
    """`profile_hmm_score_batch`'s instances (dicts: kmer_ranks, event_means
    in row order, scale, shift, var, events_per_base) as MethTables on
    `device`, each instance its own row of params."""
    G = len(instances)
    ranks = [np.asarray(i["kmer_ranks"], np.int64).reshape(-1) for i in instances]
    evs = [np.asarray(i["event_means"], np.float32).reshape(-1) for i in instances]
    if any(len(e) == 0 for e in evs):
        raise ValueError("every instance needs at least one event")
    rank_off = np.zeros(G + 1, np.int64)
    np.cumsum([len(r) for r in ranks], out=rank_off[1:])
    ev_off = np.zeros(G + 1, np.int64)
    np.cumsum([len(e) for e in evs], out=ev_off[1:])
    params = read_params([[i["scale"], i["shift"], i["var"]] for i in instances],
                         [i["events_per_base"] for i in instances])
    return upload_instances(np.concatenate(ranks), rank_off, ev_off[:-1], ev_off[1:] - 1,
                            np.arange(G, dtype=np.int32), np.concatenate(evs), params,
                            model_mean, model_stdv, device)


def profile_hmm_score_batch(instances, model_mean, model_stdv,
                            flags=HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP, device="cuda"):
    """Batched scoring.  instances: list of dicts with keys kmer_ranks (K,),
    event_means (E,) in row order, scale, shift, var, events_per_base.
    Returns (G,) float32 scores: one upload, one launch, one fetch."""
    dev = resolve_device(device)
    if len(instances) == 0:
        return np.zeros(0, np.float32)
    t = upload_profile_instances(instances, model_mean, model_stdv, dev)
    return _fetch(meth_forward(t, flags)).copy()


# ----------------------------------------------------------- per-read calling
@dataclasses.dataclass(slots=True)
class ScoredSite:
    """meth.c ScoredSite."""

    start_position: int
    end_position: int
    n_cpg: int
    sequence: str
    ll_unmethylated: float
    ll_methylated: float

    @property
    def ll_ratio(self):
        return self.ll_methylated - self.ll_unmethylated


def scored_sites_from_dicts(site_maps) -> list[dict]:
    """The port's site maps from the JAX package's, each ScoredSite given as
    `dataclasses.asdict` (same field names; an unknown field raises
    TypeError): a list of {start_position: ScoredSite}."""
    return [{int(k): ScoredSite(**dict(v)) for k, v in m.items()} for m in site_maps]


def find_event_bounds(aln_ref_pos, aln_event_idx, ref_start: int, ref_stop: int):
    """find_by_ref_bounds over the (ref position, event idx) alignment:
    first/last alignment records inside [ref_start, ref_stop]."""
    sel = (aln_ref_pos >= ref_start) & (aln_ref_pos <= ref_stop)
    if not sel.any():
        return None
    idx = np.nonzero(sel)[0]
    return int(aln_event_idx[idx[0]]), int(aln_event_idx[idx[-1]])


# disambiguated ACGT code (A0 C1 G2 T4, the ACGMT ranks) of each byte of an
# upper-cased sequence: anything but C, G and T is A
_DISAMB = np.zeros(256, np.int8)
_DISAMB[ord("C")], _DISAMB[ord("G")], _DISAMB[ord("T")] = 1, 2, 4
_CODE_CHARS = np.frombuffer(ALPHABET.encode(), np.uint8)
_COMP_CODE = np.array([4, 2, 1, 2, 0], np.int8)     # A->T C->G G->C M->G T->A
_KEY_SHIFT = 34                                     # (read << 34) | ref position


def _ragged(starts, lens):
    """The indices start[i] .. start[i] + len[i] - 1 of every run, in order."""
    lens = np.asarray(lens, np.int64)
    return np.repeat(np.asarray(starts, np.int64) - (np.cumsum(lens) - lens),
                     lens) + np.arange(int(lens.sum()))


@dataclasses.dataclass
class _Groups:
    """The scored CpG groups of a batch of reads, with their instances
    (2 per group: the reference and its CG -> MG variant)."""

    read: np.ndarray        # (N,) read of each group
    first: np.ndarray       # first and last CpG site, read coordinates
    last: np.ndarray
    n_cpg: np.ndarray
    tables: dict            # upload_instances' arrays but for the model


def _event_bounds(reads, r, cs, ce):
    """(found, e1, e2) of groups (read r, calling window [cs, ce]):
    `find_event_bounds` for every group at once, by one binary search over
    all reads' alignments keyed (read << 34) | reference position; a read
    whose alignment is not in ascending reference order (or not in
    0 .. 2^34) takes `find_event_bounds` group by group."""
    R, N = len(reads), len(r)
    rp = [np.asarray(rd["aln_ref_pos"], np.int64).reshape(-1) for rd in reads]
    ev = [np.asarray(rd["aln_event_idx"], np.int64).reshape(-1) for rd in reads]
    n = np.fromiter((len(p) for p in rp), np.int64, R)
    rp_all = np.concatenate(rp) if R else np.zeros(0, np.int64)
    ev_all = np.concatenate(ev) if R else np.zeros(0, np.int64)
    owner = np.repeat(np.arange(R), n)
    bad = (rp_all < 0) | (rp_all >= 1 << _KEY_SHIFT)
    bad[1:] |= (np.diff(rp_all) < 0) & (owner[1:] == owner[:-1])
    ok = np.bincount(owner[bad], minlength=R) == 0
    # an unsorted read's keys all sit at its own floor, so they never mislead
    # the search of another read's window
    keys = (owner << _KEY_SHIFT) | np.where(ok[owner], rp_all, 0)
    found = np.zeros(N, bool)
    e1 = np.zeros(N, np.int64)
    e2 = np.zeros(N, np.int64)
    fast = ok[r] & (cs >= 0) & (ce < (1 << _KEY_SHIFT))
    base = r[fast] << _KEY_SHIFT
    lo = np.searchsorted(keys, base | cs[fast], "left")
    hi = np.searchsorted(keys, base | ce[fast], "right") - 1
    hit = lo <= hi
    idx = np.nonzero(fast)[0]
    found[idx] = hit
    e1[idx[hit]] = ev_all[lo[hit]]
    e2[idx[hit]] = ev_all[hi[hit]]
    for g in np.nonzero(~fast)[0]:
        got = find_event_bounds(rp[r[g]], ev[r[g]], int(cs[g]), int(ce[g]))
        if got is not None:
            found[g], (e1[g], e2[g]) = True, got
    return found, e1, e2


def _build_groups(reads) -> tuple[_Groups, list[bytes]]:
    """The CpG scan, grouping, gates, event bounds and both variants' k-mer
    ranks of meth.c:501-659 for every read at once (JAX
    `call_methylation_for_read`, ops/methylation.py:388-431), as numpy
    passes.  Returns the groups and each read's disambiguated sequence."""
    R = len(reads)
    seqs = [disambiguate_bytes(rd["ref_seq"]) for rd in reads]
    lens = np.fromiter((len(s) for s in seqs), np.int64, R)
    seq_off = np.zeros(R + 1, np.int64)
    np.cumsum(lens, out=seq_off[1:])
    flat = _DISAMB[np.frombuffer(b"".join(seqs), np.uint8)] if R else np.zeros(0, np.int8)
    # CpG sites: C then G inside one read
    is_cg = (flat[:-1] == 1) & (flat[1:] == 2)
    ends = seq_off[1:-1] - 1
    is_cg[ends[ends < len(is_cg)]] = False
    cg = np.nonzero(is_cg)[0]
    site_read = np.searchsorted(seq_off, cg, "right") - 1
    site = cg - seq_off[site_read]
    # groups: a new one at each read's first site or a gap over MIN_SEPARATION
    new = np.ones(len(cg), bool)
    new[1:] = (site_read[1:] != site_read[:-1]) | (site[1:] - site[:-1] > MIN_SEPARATION)
    g_start = np.nonzero(new)[0]
    g_end = np.append(g_start[1:], len(cg))[:len(g_start)] - 1
    gr = site_read[g_start]
    first, last = site[g_start], site[g_end]
    n_cpg = g_end - g_start + 1
    keep = (first - MIN_SEPARATION > MIN_SEPARATION) & (last - first <= 200)
    gr, first, last, n_cpg = gr[keep], first[keep], last[keep], n_cpg[keep]
    start_pos = np.fromiter((int(rd["ref_start_pos"]) for rd in reads), np.int64, R)
    cs = first - MIN_SEPARATION + start_pos[gr]
    ce = last + MIN_SEPARATION + start_pos[gr]
    found, e1, e2 = _event_bounds(reads, gr, cs, ce)
    d = np.abs(e2 - e1)
    ratio = d / np.maximum(1, ce - cs)
    keep = found & ~((d <= 10) | (ratio > MAX_EVENT_TO_BP_RATIO))
    gr, first, last, n_cpg, e1, e2 = (a[keep] for a in (gr, first, last, n_cpg, e1, e2))
    N = len(gr)

    # the events of the reads with a group, flat
    used = np.unique(gr)
    n_ev = np.zeros(R, np.int64)
    ev_arrays = {}
    for i in used.tolist():
        ev_arrays[i] = np.asarray(reads[i]["event_means"], np.float32).reshape(-1)
        n_ev[i] = len(ev_arrays[i])
    ev_off = np.zeros(R + 1, np.int64)
    np.cumsum(n_ev, out=ev_off[1:])
    if N and ((np.minimum(e1, e2) < 0).any() or (np.maximum(e1, e2) >= n_ev[gr]).any()):
        raise ValueError("an alignment record's event index lies outside its read's events")
    events = (np.concatenate([ev_arrays[i] for i in used.tolist()]) if len(used)
              else np.zeros(0, np.float32))

    # both variants of each group's subsequence, instance 2g the reference,
    # 2g + 1 its CG -> MG rewrite (JAX's order), as codes 0..4 (ACGMT)
    sub_lo = first - MIN_SEPARATION
    sub_hi = np.minimum(last + MIN_SEPARATION + 1, lens[gr])
    L = np.repeat(sub_hi - sub_lo, 2)
    run_start = np.cumsum(L) - L
    v = flat[_ragged(np.repeat(seq_off[gr] + sub_lo, 2), L)]
    inner = np.ones(len(v), bool)           # not an instance's last position
    inner[run_start + L - 1] = False
    odd = np.repeat(np.tile(np.array([False, True]), N), L)
    cg = (v[:-1] == 1) & (v[1:] == 2) & inner[:-1]
    v[:-1][cg & odd[:-1]] = 3
    # reverse reads take the ranks of reverse_complement_meth(variant), in
    # reverse window order: each base complemented at its mirror position,
    # an MG site mirrored as MG
    rc = np.fromiter((bool(rd.get("rc", False)) for rd in reads), bool, R)
    inst_read = np.repeat(gr, 2)
    inst_rc = rc[inst_read]
    if inst_rc.any():
        run = np.repeat(np.arange(2 * N), L)
        r_sel = inst_rc[run]
        mirror = 2 * run_start[run] + L[run] - 1 - np.arange(len(v))
        src = v.copy()
        src[mirror[r_sel]] = _COMP_CODE[v[r_sel]]
        mg = np.zeros(len(v), bool)
        mg[:-1] = (v[:-1] == 3) & (v[1:] == 2) & inner[:-1] & r_sel[:-1]
        src[mirror[mg] - 1] = 3
    else:
        src = v
    n_k = L - KMER + 1
    n_win = max(len(src) - KMER + 1, 0)
    win = src[:n_win].astype(np.int16)
    for j in range(1, KMER):
        win = win * 5 + src[j:j + n_win]
    kidx = _ragged(run_start, n_k)
    if inst_rc.any():
        krun = np.repeat(np.arange(2 * N), n_k)
        back = inst_rc[krun]
        kidx[back] = (2 * run_start[krun] + n_k[krun] - 1 - kidx)[back]
    ranks = win[kidx]
    rank_off = np.zeros(2 * N + 1, np.int64)
    np.cumsum(n_k, out=rank_off[1:])

    # instance rows, and the reads' parameters
    row_read = np.searchsorted(used, inst_read).astype(np.int32)
    ev_first = ev_off[inst_read] + np.repeat(e1, 2)
    ev_last = ev_off[inst_read] + np.repeat(e2, 2)
    params = read_params([reads[i]["scalings3"] for i in used.tolist()],
                         [reads[i]["events_per_base"] for i in used.tolist()])
    tables = dict(ranks=ranks, rank_off=rank_off, ev_first=ev_first, ev_last=ev_last,
                  read=row_read, events=events, params=params)
    return _Groups(gr, first, last, n_cpg, tables), seqs


def disambiguate_bytes(seq: str) -> bytes:
    """`disambiguate(seq)` as ASCII bytes, one numpy pass."""
    b = np.frombuffer(seq.upper().encode("ascii", "replace"), np.uint8)
    return _CODE_CHARS[_DISAMB[b]].tobytes()


def _sites(groups: _Groups, seqs, reads, scores) -> list[dict]:
    """Each read's {start_position: ScoredSite} in group order."""
    out = [{} for _ in reads]
    if len(groups.read) == 0:
        return out
    start_pos = np.fromiter((int(rd["ref_start_pos"]) for rd in reads), np.int64, len(reads))
    shift = start_pos[groups.read]
    text = {r: seqs[r].decode() for r in np.unique(groups.read).tolist()}
    s = scores.astype(np.float64).reshape(-1, 2)
    for r, f, l, sp, ep, n, unmeth, meth in zip(
            groups.read.tolist(), groups.first.tolist(), groups.last.tolist(),
            (groups.first + shift).tolist(), (groups.last + shift).tolist(),
            groups.n_cpg.tolist(), s[:, 0].tolist(), s[:, 1].tolist()):
        out[r][sp] = ScoredSite(sp, ep, n, text[r][f - KMER + 1:l + KMER], unmeth, meth)
    return out


def instance_cells(tables) -> int:
    """The (row, block) cells of a batch's instances: K x E summed."""
    off = np.asarray(tables["rank_off"])
    return int((np.diff(off) * (np.abs(np.asarray(tables["ev_last"])
                                       - np.asarray(tables["ev_first"])) + 1)).sum())


def _upload_groups(groups, cpg_model_mean, cpg_model_stdv, device, stats=None) -> MethTables:
    tb = groups.tables
    return upload_instances(tb["ranks"], tb["rank_off"], tb["ev_first"], tb["ev_last"],
                            tb["read"], tb["events"], tb["params"], cpg_model_mean,
                            cpg_model_stdv, device, stats=stats)


def upload_reads(reads, cpg_model_mean, cpg_model_stdv, device) -> MethTables:
    """The instances of `call_methylation_batch(reads, ...)` as MethTables on
    `device`, in one upload (two per scored CpG group, the reference then
    its CG -> MG variant)."""
    return _upload_groups(_build_groups(reads)[0], cpg_model_mean, cpg_model_stdv,
                          resolve_device(device))


def call_methylation_batch(reads, cpg_model_mean, cpg_model_stdv, device="cuda", stats=None):
    """meth.c:501-659 for every read at once.

    reads: list of dicts with `call_methylation_for_read`'s arguments:
    ref_seq, ref_start_pos, aln_ref_pos, aln_event_idx (the read's event
    alignment in reference coordinates), event_means, scalings3 (scale,
    shift, var), events_per_base and rc.  Returns, per read, a dict
    start_position -> ScoredSite in group order, as JAX's.

    Every read's instances go to the device in one upload, one launch and
    one fetch.  `stats`, if a dict, gets the seconds of each part
    ("instances", "upload", "kernel", "fetch", "rows"; each part waits for
    the device when timed), "instances_n", "cells" and "groups"."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    groups, seqs = _build_groups(reads)
    G = 2 * len(groups.read)
    if stats is not None:
        stats["instances"] = time.perf_counter() - t0
        stats["instances_n"] = G
        stats["groups"] = len(groups.read)
        stats["cells"] = instance_cells(groups.tables)
    if G == 0:
        return [{} for _ in reads]
    t = _upload_groups(groups, cpg_model_mean, cpg_model_stdv, dev, stats)
    t1 = time.perf_counter()
    out = meth_forward(t)
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats["kernel"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    scores = _fetch(out)
    t3 = time.perf_counter()
    sites = _sites(groups, seqs, reads, scores)
    if stats is not None:
        stats["fetch"] = t3 - t2
        stats["rows"] = time.perf_counter() - t3
    return sites


def call_methylation_for_read(
    ref_seq: str, ref_start_pos: int, aln_ref_pos, aln_event_idx,
    event_means, scalings3, cpg_model_mean, cpg_model_stdv,
    events_per_base: float, rc: bool = False, device="cuda",
):
    """meth.c:501-659 for one read, the JAX package's signature:
    `call_methylation_batch` of one read.  Returns dict start_position ->
    ScoredSite."""
    return call_methylation_batch([dict(
        ref_seq=ref_seq, ref_start_pos=ref_start_pos, aln_ref_pos=aln_ref_pos,
        aln_event_idx=aln_event_idx, event_means=event_means, scalings3=scalings3,
        events_per_base=events_per_base, rc=rc)], cpg_model_mean, cpg_model_stdv,
        device=device)[0]


def event_space_reads(results, sequences) -> tuple[list[int], list[dict]]:
    """The `call_methylation_batch` reads of event-space call-methylation
    (JAX cli.py:549-566): every read that passed eventalign, its own
    sequence as the reference from 0, its event alignment and the event
    means that eventalign_reads(keep_aux=True) kept.  Returns (the reads'
    indices, the reads)."""
    idx, reads = [], []
    for b, r in enumerate(results):
        if r.flag != 0 or r.alignment is None:
            continue
        codes = np.minimum(np.asarray(sequences[b]), 3).astype(np.int64)
        idx.append(b)
        reads.append(dict(ref_seq=np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode(),
                          ref_start_pos=0, aln_ref_pos=r.alignment.ref_position,
                          aln_event_idx=r.alignment.event_idx, event_means=r.events[0],
                          scalings3=r.scalings, events_per_base=r.events_per_base, rc=False))
    return idx, reads


def methylation_frequency(site_maps, call_threshold: float = 2.5):
    """meth-freq (main.c:53; nanopolish calculate_methylation_frequency):
    aggregate per-read ScoredSite maps into per-site called frequencies.
    Sites with |ll_ratio| < call_threshold are ambiguous and skipped."""
    agg: dict = {}
    for sm in site_maps:
        for pos, ss in sm.items():
            rec = agg.setdefault(
                pos, dict(called=0, methylated=0, n_cpg=ss.n_cpg,
                          end=ss.end_position, seq=ss.sequence)
            )
            if abs(ss.ll_ratio) < call_threshold:
                continue
            rec["called"] += 1
            if ss.ll_ratio > 0:
                rec["methylated"] += 1
    out = []
    for pos in sorted(agg):
        rec = agg[pos]
        freq = rec["methylated"] / rec["called"] if rec["called"] else 0.0
        out.append(dict(start=pos, end=rec["end"], n_cpg=rec["n_cpg"],
                        called_sites=rec["called"],
                        called_sites_methylated=rec["methylated"],
                        methylated_frequency=freq, sequence=rec["seq"]))
    return out
