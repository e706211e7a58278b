"""f5c eventalign: scaling estimate, post-align, recalibration, QC gates and
the eventalign TSV, around the ABEA kernels of ops/abea.py.

The port's copy of genomicsbench_tpu/ops/eventalign.py:43-330, event-space
mode (f5c eventalign without -b/-g):

* `estimate_scalings_mom`  — method-of-moments shift/scale from event
  means vs model k-mer levels (align.c:49-97).
* `postalign`              — aligned (kmer, event) pairs -> base-to-event
  map + events_per_base + expanded event_alignment with M/E states
  (align.c:550-654).
* `recalibrate`            — weighted least-squares shift/scale (+var)
  over M-state events via 2x2 normal equations; requires >= 200 M
  states (align.c:657-760).
* QC gates                 — FAILED_CALIBRATION (not recalibrated or
  var > MIN_CALIBRATION_VAR = 2.5, f5cmisc.h:9, f5c.c:1296-1304),
  FAILED_ALIGNMENT (f5c.c:1315), FAILED_QUALITY_CHK
  (events_per_base > 5.0, f5c.c:1320-1325).
* `event_alignment_to_cigar` — event-space CIGAR (eventalign.c:1665-1736).
* `emit_eventalign_tsv`    — the output TSV (eventalign.c:1651-1662 header,
  1853-1941 rows), scale_events mode.
* `eventalign_reads`       — the per-batch process_db orchestration
  (f5c.c:1497: detect -> scale -> ABEA on the device -> postalign ->
  recalibrate -> QC -> TSV rows), with an optional batching profile.

These stages are O(n_events) per read and stay on the host in numpy, with
the reference's float/double mixing.  `keep_aux` keeps, for each passing
read, the inputs of the reference-coordinate realignment
(ops/ref_align.py) and of call-methylation: its base-to-event map and its
events.  The JAX package's `eventalign_pipeline` (its load/process/output
overlap) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.ops import abea as abea_ops
from genomicsbench_tpu_torch.ops.abea import KMER, kmer_ranks

MIN_CALIBRATION_VAR = 2.5  # f5cmisc.h:9
MIN_EVENTS_TO_RESCALE = 200  # align.c:679
MAX_EVENTS_PER_BASE = 5.0  # f5c.c:1320

FAILED_CALIBRATION = 1 << 0  # f5c.h read_stat flags
FAILED_ALIGNMENT = 1 << 1
FAILED_QUALITY_CHK = 1 << 2

_BASES = "ACGT"


# ----------------------------------------------------------------- scalings
def estimate_scalings_mom(seq_codes, event_means, model_mean):
    """Method-of-moments (scale, shift) per read (align.c:49-97), as a
    float32 pair in the order align_batch takes."""
    ranks = kmer_ranks(np.asarray(seq_codes))
    levels = model_mean[ranks].astype(np.float64)
    ev = np.asarray(event_means, np.float64)
    shift = ev.mean() - levels.mean()
    scale = np.mean((ev - shift) ** 2) / np.mean(levels**2)
    return np.float32(scale), np.float32(shift)


# ----------------------------------------------------------------- postalign
@dataclasses.dataclass
class EventAlignment:
    """Expanded per-kmer event alignment (align.c event_alignment_t)."""

    ref_position: np.ndarray  # (n,) int32 kmer index
    event_idx: np.ndarray  # (n,) int32
    hmm_state: np.ndarray  # (n,) uint8, ord('M') or ord('E')


def postalign(pairs, n_kmers: int, seq_ranks):
    """align.c:550-654.  pairs: (n,2) (kmer_idx, event_idx), ascending
    kmer order (the ABEA backtrack output).  Returns
    (EventAlignment, base_to_event_map (n_kmers,2), events_per_base)."""
    b2e = np.full((n_kmers, 2), -1, np.int32)
    pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
    if len(pairs) == 0:
        return EventAlignment(*[np.zeros(0, d) for d in (np.int32, np.int32, np.uint8)]), b2e, 0.0
    k_idx, e_idx = pairs[:, 0], pairs[:, 1]
    # the reference iterates events in the alignment's order; dedup
    # consecutive identical event indices
    keep = np.ones(len(pairs), bool)
    keep[1:] = e_idx[1:] != e_idx[:-1]
    for k, e in zip(k_idx[keep], e_idx[keep]):
        if b2e[k, 0] == -1:
            b2e[k, 0] = e
        b2e[k, 1] = e
    events_per_base = float(e_idx.max() - e_idx.min()) / n_kmers

    ranks = np.asarray(seq_ranks)
    ref_pos, ev, st = [], [], []
    prev_rank = -1
    for ki in range(n_kmers):
        s, t = b2e[ki]
        if s == -1:
            continue
        lo, hi = (s, t) if s <= t else (t, s)
        r = int(ranks[ki])
        for e in range(lo, hi + 1):
            ref_pos.append(ki)
            ev.append(e)
            st.append(ord("M") if prev_rank != r else ord("E"))
            prev_rank = r
    return (
        EventAlignment(
            np.array(ref_pos, np.int32), np.array(ev, np.int32), np.array(st, np.uint8)
        ),
        b2e,
        events_per_base,
    )


# -------------------------------------------------------------- recalibrate
def recalibrate(event_means, aln: EventAlignment, seq_ranks, model_mean, model_stdv):
    """align.c:657-760 weighted least squares.  Returns
    (recalibrated, scale, shift, var)."""
    m = aln.hmm_state == ord("M")
    if int(m.sum()) < MIN_EVENTS_TO_RESCALE:
        return False, np.float32(0), np.float32(0), np.float32(1.0)
    ranks = np.asarray(seq_ranks)[aln.ref_position]
    mu = model_mean[ranks].astype(np.float64)
    sd = model_stdv[ranks].astype(np.float64)
    e = np.asarray(event_means, np.float64)[aln.event_idx]
    iv = 1.0 / (sd * sd)
    mm, ee, ivm = mu[m], e[m], iv[m]
    a00, a01, a11 = ivm.sum(), (mm * ivm).sum(), (mm * mm * ivm).sum()
    b0, b1 = (ee * ivm).sum(), (mm * ee * ivm).sum()
    div = a00 * a11 - a01 * a01
    shift = -(a01 * b1 - a11 * b0) / div
    scale = (a00 * b1 - a01 * b0) / div
    yi = (ee - shift - scale * mm) / sd[m]
    var = np.sqrt((yi * yi).sum() / len(mm))
    return True, np.float32(scale), np.float32(shift), np.float32(var)


# -------------------------------------------------------------------- cigar
BAM_CMATCH, BAM_CINS, BAM_CDEL, BAM_CSOFT_CLIP = 0, 1, 2, 4
_CIGAR_CHARS = "MIDNSHP=X"


def event_alignment_to_cigar(aln: EventAlignment):
    """eventalign.c:1665-1736; returns list of (length, op_char)."""
    if len(aln.ref_position) == 0:
        return []
    out = []
    if aln.event_idx[0] > 0:
        out.append([int(aln.event_idx[0]), BAM_CSOFT_CLIP])
    out.append([1, BAM_CMATCH])
    prev_r, prev_e = int(aln.ref_position[0]), int(aln.event_idx[0])
    for r, e in zip(aln.ref_position[1:], aln.event_idx[1:]):
        r_step, e_step = abs(int(r) - prev_r), abs(int(e) - prev_e)
        if r_step == 1 and e_step == 1:
            inc = [1, BAM_CMATCH]
        elif r_step > 1:
            out.append([r_step - 1, BAM_CDEL])
            inc = [1, BAM_CMATCH]
        else:
            inc = [1, BAM_CINS]
        if out[-1][1] == inc[1]:
            out[-1][0] += inc[0]
        else:
            out.append(inc)
        prev_r, prev_e = int(r), int(e)
    return [(n, _CIGAR_CHARS[op]) for n, op in out]


# ---------------------------------------------------------------------- TSV
TSV_HEADER = (
    "contig\tposition\treference_kmer\tread_index\tstrand\t"
    "event_index\tevent_level_mean\tevent_stdv\tevent_length\t"
    "model_kmer\tmodel_mean\tmodel_stdv\tstandardized_level"
)


def _kmer_str(seq_codes, ki):
    return "".join(_BASES[int(c)] for c in seq_codes[ki : ki + KMER])


def emit_eventalign_tsv(
    fp, aln: EventAlignment, seq_codes, event_means, event_stdvs, event_lengths,
    scalings3, model_mean, model_stdv, read_index=0, sample_rate=4000.0,
):
    """Row emitter (eventalign.c:1853-1941).  scalings3 = (scale, shift,
    var).  Writes reference-format rows to fp in event-space and
    scale_events mode: contig "read", the event mean scaled to model space
    ((mean - shift) / scale, eventalign.c:1804-1811) and standardized_level
    = (event_mean - model_mean) / (sqrt(var) * model_stdv)."""
    scale, shift, var = (float(x) for x in scalings3)
    ranks = kmer_ranks(np.asarray(seq_codes))
    sqrt_var = np.sqrt(var)
    for rp, ei in zip(aln.ref_position, aln.event_idx):
        rp, ei = int(rp), int(ei)
        kmer = _kmer_str(seq_codes, rp)
        r = int(ranks[rp])
        ev_mean = (float(event_means[ei]) - shift) / scale
        ev_stdv = float(event_stdvs[ei])
        dur = float(event_lengths[ei]) / sample_rate
        mmean, mstdv = float(model_mean[r]), float(model_stdv[r])
        std_lvl = (ev_mean - mmean) / (sqrt_var * mstdv)
        fp.write(
            f"read\t{rp}\t{kmer}\t{read_index}\tt\t"
            f"{ei}\t{ev_mean:.2f}\t{ev_stdv:.3f}\t{dur:.5f}\t"
            f"{kmer}\t{mmean:.2f}\t{mstdv:.2f}\t{std_lvl:.2f}\n"
        )


# ------------------------------------------------------------ full pipeline
@dataclasses.dataclass
class ReadResult:
    flag: int  # 0 = OK, else FAILED_* bits
    scalings: tuple  # (scale, shift, var) after recalibration
    events_per_base: float
    alignment: EventAlignment | None
    # populated only with eventalign_reads(keep_aux=True), for passing reads
    b2e: object = None           # (n_kmers, 2) base-to-event map
    events: object = None        # (mean, stdv, length) float32 arrays


def _eventalign_batch(raw_signals, sequences, model_mean, model_stdv, tsv_fp,
                      sample_rate, read_indices, device, keep_aux=False):
    """One device batch of process_db: detect, scale, align, then per read
    postalign, recalibrate, QC and the TSV rows of the passing reads."""
    events = [abea_ops.detect_events(r) for r in raw_signals]
    scalings = np.zeros((len(sequences), 2), np.float32)
    for b, (seq, ev) in enumerate(zip(sequences, events)):
        scalings[b] = estimate_scalings_mom(seq, ev[2], model_mean)
    res = abea_ops.align_batch(sequences, [e[2] for e in events], model_mean, model_stdv,
                               scalings, device=device)
    out = []
    for b, seq in enumerate(sequences):
        if res.failed[b] or len(res.pairs[b]) == 0:
            out.append(ReadResult(FAILED_ALIGNMENT, (0, 0, 1.0), 0.0, None))
            continue
        ranks = kmer_ranks(np.asarray(seq))
        aln, b2e, epb = postalign(res.pairs[b], len(seq) - KMER + 1, ranks)
        ok, scale, shift, var = recalibrate(events[b][2], aln, ranks, model_mean, model_stdv)
        sc3 = (float(scale), float(shift), float(var))
        if not ok or var > MIN_CALIBRATION_VAR:
            out.append(ReadResult(FAILED_CALIBRATION, sc3, epb, None))
            continue
        if epb > MAX_EVENTS_PER_BASE:
            out.append(ReadResult(FAILED_QUALITY_CHK, sc3, epb, None))
            continue
        if tsv_fp is not None:
            emit_eventalign_tsv(tsv_fp, aln, seq, events[b][2], events[b][3], events[b][1],
                                (scale, shift, var), model_mean, model_stdv,
                                read_index=read_indices[b], sample_rate=sample_rate)
        aux = dict(b2e=b2e, events=(events[b][2], events[b][3], events[b][1])) if keep_aux else {}
        out.append(ReadResult(0, sc3, epb, aln, **aux))
    return out


def eventalign_reads(raw_signals, sequences, model_mean, model_stdv, tsv_fp=None,
                     sample_rate=4000.0, profile=None, keep_aux=False, device="cuda"):
    """Per-batch process_db (f5c.c:1497): event detection -> MoM scaling
    -> ABEA on the device -> postalign -> recalibrate -> QC -> TSV.

    raw_signals: list of f32 raw-signal arrays; sequences: list of 0..3
    coded read sequences.  Returns list[ReadResult]; writes the TSV header
    and the rows of the passing reads if tsv_fp is given.  With keep_aux,
    each passing read's result also holds its base-to-event map and its
    events (mean, stdv, length).

    Without a `profile` all reads go to the device as one batch.  With a
    profile (config.AbeaRunProfile, the f5c --profile analog), reads go in
    order of length into batches of at most batch_size reads and
    batch_size_bases bases, and reads longer than ultra_thresh into batches
    of their own; the rows carry each read's input index."""
    dev = resolve_device(device)
    if len(raw_signals) != len(sequences):
        raise ValueError(f"{len(raw_signals)} signals for {len(sequences)} sequences")
    if profile is None:
        batches = [list(range(len(sequences)))]
    else:
        ultra = [len(s) > profile.ultra_thresh for s in sequences]
        order = sorted(range(len(sequences)), key=lambda i: (ultra[i], len(sequences[i])))
        batches, bases = [], 0
        for i in order:
            n = len(sequences[i])
            if not batches or (len(batches[-1]) >= profile.batch_size
                               or bases + n > profile.batch_size_bases
                               or ultra[i] != ultra[batches[-1][0]]):
                batches.append([])
                bases = 0
            batches[-1].append(i)
            bases += n
    if tsv_fp is not None and batches:
        tsv_fp.write(TSV_HEADER + "\n")
    results: list = [None] * len(sequences)
    for idx in batches:
        sub = _eventalign_batch([raw_signals[i] for i in idx], [sequences[i] for i in idx],
                                model_mean, model_stdv, tsv_fp, sample_rate, idx, dev,
                                keep_aux)
        for i, r in zip(idx, sub):
            results[i] = r
    return results
