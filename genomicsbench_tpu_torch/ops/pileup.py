"""Pileup counts matrix: medaka's counts (benchmarks/pileup), in the port.

The port's copy of genomicsbench_tpu/ops/pileup.py.  Semantics,
medaka_counts.c:298-478 (calculate_pileup):
* columns are (major reference position, minor insertion index) pairs; a
  position gets a column only if a read covers it, and the longest
  insertion anchored there opens that many minor columns
  (medaka_counts.c:362-381);
* features are "acgtACGTdD" (FEATLEN 10, medaka_counts.h:63-66): forward
  bases at 4..7, reverse at 0..3, deletions at FWD_DEL 9 / REV_DEL 8;
* reads need mapq >= min_mapq (1, medaka_bamiter.c:21) and none of the
  unmapped, secondary, QC-fail, duplicate and supplementary flags; inserted
  base j goes to minor column j; ambiguity codes are not counted;
* quality strata: qstrat = max(0, min(qual, num_homop) - 1) picks one of
  num_homop feature planes (medaka_counts.c:448-455).

`pileup_counts` is host code, as in the JAX package, and has three routes:
* an indexed reader (`IndexedBam`) with one dtype: the host library parses
  the region's BAI chunks into arrays and increments the matrix in place
  during its CIGAR walk (native.pileup_matrix); an int32 matrix;
* an indexed reader with num_dtypes > 1: the host library's event stream
  (native.pileup_events), then one key per observation and a histogram; an
  int64 matrix.  As in the JAX package, without `dtype_of` every count lands
  in dtype plane 0;
* `dtype_of`, `weibull_summation`, or a reader without the indexed arrays
  (`BamFile`): the per-record walk (`_read_events`); an int64 matrix.

`_count_keys` is the device stage: a sort of the histogram's keys on the
card (`torch.sort`) and a run-length encode on the host.  The inputs are a
BAM reader and a region string; nothing crosses from the JAX package but
the file.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from genomicsbench_tpu_torch import native, resolve_device

FEATLEN = 10
FWD_DEL = 9
REV_DEL = 8
# UNMAP SECONDARY QCFAIL DUP SUPPL
FILTERED = 4 | 256 | 512 | 1024 | 2048

# When set to a list, the event route's histogram appends (keys, size), so
# that the device sort-reduce (_count_keys) can be timed on the same keys.
DEBUG_KEYS = None


@dataclasses.dataclass
class PileupResult:
    matrix: np.ndarray   # (n_cols, FEATLEN * num_dtypes * num_homop) int32 or int64
    major: np.ndarray    # (n_cols,) reference positions
    minor: np.ndarray    # (n_cols,) insertion indices

    @property
    def n_cols(self):
        return len(self.major)

    def text(self):
        """print_pileup_data-style dump: pos, minor, counts."""
        lines = []
        for i in range(self.n_cols):
            row = "\t".join(str(int(v)) for v in self.matrix[i])
            lines.append(f"{int(self.major[i])}\t{int(self.minor[i])}\t{row}")
        return "\n".join(lines) + "\n"


def _read_events(rec, start, end, num_homop):
    """One record's pileup observations as arrays (pos, minor j, feature,
    qual, qidx), qidx the query index (-1 for deletions) at which the
    Weibull route reads its WL/WK values; one vectorised step per CIGAR op."""
    ps, js, fs, qs, qx = [], [], [], [], []
    rp = rec.pos
    qp = 0
    rev = rec.is_reverse
    has_q = len(rec.qual) > 0
    prev_aligned = False
    for op, ln in rec.cigar:
        if op in "M=X":
            pos = np.arange(rp, rp + ln)
            sel = (pos >= start) & (pos < end)
            base = rec.seq[qp : qp + ln]
            sel &= base <= 3
            if sel.any():
                idx = np.nonzero(sel)[0]
                ps.append(pos[idx])
                js.append(np.zeros(len(idx), np.int64))
                fs.append(base[idx].astype(np.int64) + (0 if rev else 4))
                qs.append(rec.qual[qp + idx].astype(np.int64) if has_q
                          else np.zeros(len(idx), np.int64))
                qx.append(qp + idx)
            rp += ln
            qp += ln
            prev_aligned = True
        elif op == "I":
            anchor = rp - 1
            # mpileup anchors an insertion at the preceding reference column.
            # medaka's max_ins loop (medaka_counts.c:364-367) counts p->indel
            # whether that column is a deletion or a refskip and whatever the
            # inserted bases are, so the minor columns exist even when no
            # count lands in them: a width-only marker (feature -1) records
            # that.  Counts (:417-424) come only from aligned anchors and
            # A/C/G/T bases.
            if anchor >= rec.pos and start <= anchor < end:
                ps.append(np.array([anchor], np.int64))
                js.append(np.array([ln], np.int64))
                fs.append(np.array([-1], np.int64))
                qs.append(np.zeros(1, np.int64))
                qx.append(np.full(1, -1, np.int64))
                if prev_aligned:
                    base = rec.seq[qp : qp + ln]
                    sel = base <= 3
                    if sel.any():
                        idx = np.nonzero(sel)[0]
                        ps.append(np.full(len(idx), anchor, np.int64))
                        js.append(idx + 1)
                        fs.append(base[idx].astype(np.int64) + (0 if rev else 4))
                        qs.append(rec.qual[qp + idx].astype(np.int64) if has_q
                                  else np.zeros(len(idx), np.int64))
                        qx.append(qp + idx)
            # an insertion leaves the previous aligned state as it was
            qp += ln
        elif op == "D":
            pos = np.arange(rp, rp + ln)
            sel = (pos >= start) & (pos < end)
            if sel.any():
                idx = np.nonzero(sel)[0]
                ps.append(pos[idx])
                js.append(np.zeros(len(idx), np.int64))
                fs.append(np.full(len(idx), FWD_DEL if not rev else REV_DEL, np.int64))
                qs.append(np.zeros(len(idx), np.int64))
                qx.append(np.full(len(idx), -1, np.int64))
            rp += ln
            prev_aligned = False
        elif op == "N":
            rp += ln          # refskip: covers, counts nothing
            prev_aligned = False
        elif op == "S":
            qp += ln
        # H and P consume nothing
    if not ps:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    return (np.concatenate(ps), np.concatenate(js), np.concatenate(fs),
            np.concatenate(qs), np.concatenate(qx))


def _weibull_fractions(scale, shape, num_homop):
    """medaka_counts.c:262-268: the Weibull CDF's mass in each homopolymer bin."""
    x = np.arange(1, num_homop + 1, dtype=np.float64)
    a = ((x - 1) / scale) ** shape
    b = (x / scale) ** shape
    return np.maximum(0.0, -np.exp(-a) * np.expm1(a - b))


def _parse_region(region: str):
    """"chr:start-end" (1-based, inclusive, as hts_parse_reg reads it) ->
    (chrom, 0-based start, end)."""
    chrom, se = region.rsplit(":", 1)
    s, e = se.split("-")
    return chrom, int(s) - 1, int(e)


def _selected_chunks(bam, chrom, start, end, min_mapq):
    """The region's (soa, buf, hit) batches, `hit` cut to the reads that pass
    the mapq and flag filters (buf keeps the arrays' buffer alive)."""
    for soa, buf, hit in bam.fetch_soa_chunks(chrom, start, end):
        hit = hit[(soa["mapq"][hit] >= min_mapq) & ((soa["flag"][hit] & FILTERED) == 0)]
        if len(hit):
            yield soa, buf, hit


def _in_place(bam, chrom, start, end, num_homop, min_mapq, stats):
    """The single-dtype indexed route: the host library counts in place."""
    t0 = time.perf_counter()
    chunks = list(_selected_chunks(bam, chrom, start, end, min_mapq))
    if stats is not None:
        stats["fetch_parse"] = time.perf_counter() - t0
    # int32 counts (depth stays far below 2^31), as the JAX package returns
    matrix, major, minor = native.pileup_matrix([(soa, hit) for soa, _, hit in chunks],
                                                start, end, num_homop, stats=stats)
    return PileupResult(matrix, major, minor)


def _events_indexed(bam, chrom, start, end, num_homop, min_mapq, covered, max_ins):
    """The indexed route's observations from the host library's event stream:
    [(pos, j, encoded feature)] int32 triples; marks covered positions and
    the insertion widths in place."""
    events = []
    cov_diff = np.zeros(len(covered) + 1, np.int64)
    for soa, _buf, hit in _selected_chunks(bam, chrom, start, end, min_mapq):
        pos_a, j_a, feat_a, q_a = native.pileup_events(soa, hit, start, end)
        wm = feat_a < 0  # width-only insertion markers
        if wm.any():
            covered[pos_a[wm].astype(np.int64) - start] = True
            np.maximum.at(max_ins, pos_a[wm].astype(np.int64) - start, j_a[wm].astype(np.int64))
            pos_a, j_a, feat_a, q_a = pos_a[~wm], j_a[~wm], feat_a[~wm], q_a[~wm]
        if len(pos_a):
            if num_homop > 1:
                enc = feat_a + FEATLEN * np.where(
                    feat_a < 8, np.maximum(0, np.minimum(q_a, num_homop) - 1), 0)
            else:
                enc = feat_a
            events.append((pos_a, j_a, enc))
        lo = np.maximum(soa["pos"][hit], start) - start
        hi = np.minimum(soa["end_pos"][hit], end) - start
        ok = hi > lo
        np.add.at(cov_diff, lo[ok], 1)
        np.add.at(cov_diff, hi[ok], -1)
    covered |= np.cumsum(cov_diff[:-1]) > 0
    return events


def _events_records(bam, chrom, start, end, num_homop, min_mapq, dtype_of, weibull_summation,
                    covered, max_ins):
    """The per-record route's observations: ([(pos, j, encoded feature)],
    [(pos, j, base feature index, Weibull fractions)]); marks covered
    positions and the insertion widths in place."""
    events, wb_events = [], []
    for rec in bam.fetch(chrom, start, end):
        if rec.mapq < min_mapq or (rec.flag & FILTERED):
            continue
        dtype = dtype_of(rec) if dtype_of else 0
        wl = rec.get_array_tag("WL") if weibull_summation else None
        wk = rec.get_array_tag("WK") if weibull_summation else None
        pos_a, j_a, feat_a, q_a, qx_a = _read_events(rec, start, end, num_homop)
        wm = feat_a < 0  # width-only insertion markers
        if wm.any():
            covered[pos_a[wm] - start] = True
            np.maximum.at(max_ins, pos_a[wm] - start, j_a[wm])
            pos_a, j_a, feat_a, q_a, qx_a = (
                pos_a[~wm], j_a[~wm], feat_a[~wm], q_a[~wm], qx_a[~wm])
        if len(pos_a):
            is_base = feat_a < 8
            if weibull_summation:
                wb_sel = is_base & (qx_a >= 0)
                for pos, j, feat, qidx in zip(pos_a[wb_sel], j_a[wb_sel], feat_a[wb_sel],
                                              qx_a[wb_sel]):
                    base_idx = int(feat) + FEATLEN * num_homop * dtype
                    if wl is None or wk is None or qidx >= len(wl) or qidx >= len(wk):
                        frac = np.zeros(num_homop)
                    else:
                        frac = _weibull_fractions(float(wl[qidx]), float(wk[qidx]), num_homop)
                    wb_events.append((int(pos), int(j), base_idx, 10000.0 * frac))
                keep = ~wb_sel
            else:
                keep = np.ones(len(pos_a), bool)
            if num_homop > 1:
                qstrat = np.where(is_base, np.maximum(0, np.minimum(q_a, num_homop) - 1), 0)
            else:
                qstrat = np.zeros(len(pos_a), np.int64)
            enc = feat_a + FEATLEN * qstrat + FEATLEN * num_homop * dtype
            events.append((pos_a[keep], j_a[keep], enc[keep]))
        # coverage: every reference position the alignment spans (D and N too)
        lo, hi = max(rec.pos, start), min(rec.end_pos(), end)
        if hi > lo:
            covered[lo - start : hi - start] = True
    return events, wb_events


def pileup_counts(bam, region: str, num_dtypes: int = 1, num_homop: int = 1,
                  min_mapq: int = 1, dtype_of=None, weibull_summation: bool = False,
                  stats: dict | None = None) -> PileupResult:
    """The counts matrix of `region` ("chr:start-end", 1-based inclusive)
    from a BAM reader (`io.bam.IndexedBam` or `io.bam.BamFile`).

    weibull_summation (medaka_counts.c:440-447): a base observation adds
    10000 times the read's Weibull homopolymer fraction (from its WL/WK aux
    tags) into every qstrat bin instead of a stratified +1; missing tags add
    zeros, as the reference does.  Fractions accumulate in float64 and are
    truncated once at the end (the C code truncates each add into a size_t;
    the two agree whenever the products are exact).  With a dict as
    `stats`, the in-place route records its seconds there (fetch_parse,
    extents, accumulate).  Host code: it takes no device."""
    chrom, start, end = _parse_region(region)
    plane = FEATLEN * num_dtypes * num_homop
    span = max(end - start, 0)
    covered = np.zeros(span, bool)
    max_ins = np.zeros(span, np.int64)
    wb_events = []
    if dtype_of is None and not weibull_summation and hasattr(bam, "fetch_soa_chunks"):
        if num_dtypes == 1:
            return _in_place(bam, chrom, start, end, num_homop, min_mapq, stats)
        # the in-place count has no dtype plane stride: say so instead of
        # taking the slower event route quietly
        print("[pileup] num_dtypes=%d: native in-place fast path requires a single dtype; "
              "using the event-stream path" % num_dtypes, file=sys.stderr)
        events = _events_indexed(bam, chrom, start, end, num_homop, min_mapq, covered, max_ins)
    else:
        events, wb_events = _events_records(bam, chrom, start, end, num_homop, min_mapq,
                                            dtype_of, weibull_summation, covered, max_ins)
    if events:
        ev_pos = np.concatenate([t[0] for t in events])
        ev_j = np.concatenate([t[1] for t in events])
        ev_enc = np.concatenate([t[2] for t in events])
    else:
        ev_pos = ev_j = ev_enc = np.zeros(0, np.int64)
    if len(ev_pos) == 0 and not wb_events and not covered.any():
        return PileupResult(np.zeros((0, plane), np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.int64))

    # the longest insertion per covered position: only insertion events
    # (j > 0) matter, so the scatter-max runs over that subset
    if len(ev_pos):
        covered[ev_pos - start] = True
        ins = np.nonzero(ev_j)[0]
        if len(ins):
            np.maximum.at(max_ins, ev_pos[ins] - start, ev_j[ins])
    for pos, j, _f, _fr in wb_events:
        covered[pos - start] = True
        max_ins[pos - start] = max(max_ins[pos - start], j)
    positions = np.nonzero(covered)[0] + start
    widths = max_ins[covered] + 1
    base_cols = np.concatenate([[0], np.cumsum(widths)])[:-1]
    major = np.repeat(positions.astype(np.int64), widths)
    n_cols = len(major)
    minor = np.arange(n_cols, dtype=np.int64) - np.repeat(base_cols, widths)

    # a position's columns are contiguous, so col = base_col[pos] + j
    col_lut = np.full(span, -1, np.int64)
    col_lut[covered] = base_cols
    if len(ev_pos):
        keys = (col_lut[ev_pos - start] + ev_j) * plane + ev_enc
        if DEBUG_KEYS is not None:
            DEBUG_KEYS.append((keys, n_cols * plane))
        # the keys are the matrix's flat indices: a host histogram is the
        # exact count (_count_keys, the device sort-reduce, pays only when
        # the matrix is used on the card)
        matrix = np.bincount(keys, minlength=n_cols * plane).astype(np.int64)
    else:
        matrix = np.zeros(n_cols * plane, np.int64)
    if wb_events:
        fmat = np.zeros(n_cols * plane, np.float64)
        for pos, j, base_idx, frac in wb_events:
            col = (col_lut[pos - start] + j) * plane + base_idx
            fmat[col : col + FEATLEN * len(frac) : FEATLEN] += frac
        matrix += fmat.astype(np.int64)
    return PileupResult(matrix.reshape(n_cols, plane), np.asarray(major, np.int64),
                        np.asarray(minor, np.int64))


_KEY_PAD = np.iinfo(np.int32).max


def _count_keys(keys: np.ndarray, device="cuda"):
    """The distinct keys of a histogram and their counts: the keys sorted on
    `device` (int64, padded to a multiple of 128 with int32's max, as the
    JAX package pads), the padding dropped, then the run-length encode on
    the host.  Keys must lie below int32's max (the JAX package asserts it);
    an empty input gives two empty arrays."""
    dev = resolve_device(device)
    keys = np.asarray(keys)
    n = len(keys)
    if n and int(keys.max()) >= _KEY_PAD:
        raise ValueError(f"_count_keys: key {int(keys.max())} overflows the int32 key space")
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    buf = torch.full((-(-n // 128) * 128,), _KEY_PAD, dtype=torch.int64, device=dev)
    buf[:n] = torch.from_numpy(np.ascontiguousarray(keys, np.int64)).to(dev)
    s = torch.sort(buf).values[:n].cpu().numpy()
    _count_keys.launches += 1
    starts = np.concatenate([[0], np.nonzero(s[1:] != s[:-1])[0] + 1])
    counts = np.diff(np.concatenate([starts, [n]]))
    return s[starts], counts


_count_keys.launches = 0
