"""Reference-coordinate event alignment — f5c eventalign's `-b/-g` mode.

After the ABEA kernel aligns raw-signal events to the READ sequence,
f5c's eventalign output mode re-aligns those events onto the REFERENCE:
it walks the read's BAM cigar into (ref_pos, read_pos) aligned pairs
(get_aligned_segments_two_params, eventalign.c:1109-1180), then runs a
segment-by-segment PSR9 profile-HMM Viterbi alignment of the events
against ~100bp reference windows (align_read_to_ref,
eventalign.c:1261-1540), emitting genome-coordinate rows with
reference/model kmers (model kmer reverse-complemented for reverse-
strand mappings).

The port's copy of genomicsbench_tpu/ops/ref_align.py.  This module is
that outer loop; the per-segment Viterbi runs in the port's host library
(native.psr9_viterbi, `native/psr9.cpp`, the JAX package's
gb_psr9_viterbi copied and built without FMA contraction) with the
reference's float semantics.  Structure: the control flow is the parity
surface and follows the reference's sequencing; containers are numpy
arrays and python ints.  `emit_ref_alignment_tsv` computes its float32
columns for all rows at once in numpy, with the C's float and double
steps, and formats each row as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from genomicsbench_tpu_torch import native

KMER = 6
ALIGN_STRIDE = 100   # reference bases aligned per segment
OUTPUT_STRIDE = 50   # event alignments emitted per segment

_AMBIG_FIRST = {  # getPossibleSymbols(c)[0] (eventalign.c:1040-1076)
    "M": "A", "R": "A", "W": "A", "S": "C", "Y": "C", "K": "G",
    "V": "A", "H": "A", "D": "A", "B": "C", "N": "A",
}
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def disambiguate(seq: str) -> str:
    """Upper-case and map IUPAC ambiguity codes to their first possible
    symbol (the reference's disambiguate)."""
    up = seq.upper()
    return "".join(_AMBIG_FIRST.get(c, c) for c in up)


def reverse_complement(seq: str) -> str:
    """Reference reverse_complement: rank_dna maps any non-ACGT to rank
    0, whose complement is 'T' (inputs are disambiguated first)."""
    return "".join(_COMP.get(c, "T") for c in reversed(seq))


@dataclasses.dataclass
class RefAlignmentRow:
    """One event_alignment_t (f5c.h:163-190)."""

    ref_position: int
    ref_kmer: str
    event_idx: int
    rc: bool
    hmm_state: str   # 'M' / 'B' / 'K' (K never emitted)
    model_kmer: str


def aligned_pairs_from_cigar(cigar_ops, cigar_lens, pos: int):
    """BAM cigar -> list of aligned segments, each an (N, 2) int64 array
    of (ref_pos, read_pos) pairs (get_aligned_segments_two_params with
    read_stride=1; BAM_CREF_SKIP starts a new segment).  Vectorized per
    cigar OP (a per-base python walk was the hot loop for long reads)."""
    segments = [[]]
    read_pos = 0
    ref_pos = int(pos)
    for op, ln in zip(cigar_ops, cigar_lens):
        op, ln = int(op), int(ln)
        if op in (0, 7, 8):      # M / = / X: emit the aligned run
            ar = np.arange(ln, dtype=np.int64)
            segments[-1].append(
                np.stack([ref_pos + ar, read_pos + ar], axis=1))
            read_pos += ln
            ref_pos += ln
        elif op == 2:            # D
            ref_pos += ln
        elif op == 3:            # N: end segment, start a new one
            segments.append([])
            ref_pos += ln
        elif op in (1, 4):       # I / S
            read_pos += ln
        elif op == 5:            # H
            pass
        else:  # P and beyond: the reference asserts here too
            raise ValueError(f"unhandled cigar op {op}")
    return [np.concatenate(s, axis=0) if s
            else np.zeros((0, 2), np.int64) for s in segments]


def _get_closest_event_to(k_idx: int, b2e: np.ndarray) -> int:
    """meth.c get_closest_event_to: nearest kmer (within 1000) whose
    event range is populated, preferring the downward scan."""
    n = len(b2e)
    stop_before = max(0, k_idx - 1000)
    stop_after = min(k_idx + 1000, n - 1)

    def next_event(start, stop, stride):
        while start != stop:
            if 0 <= start < n and b2e[start, 0] != -1:
                return int(b2e[start, 0])
            start += stride
        return -1

    before = next_event(k_idx, stop_before, -1)
    after = next_event(k_idx, stop_after, 1)
    return after if before == -1 else before


def _get_end_pair(pairs: np.ndarray, ref_pos_max: int, pair_idx: int) -> int:
    """Index of the highest ref_pos <= ref_pos_max, scanning from
    pair_idx (eventalign.c get_end_pair)."""
    while pair_idx < len(pairs):
        if pairs[pair_idx, 0] > ref_pos_max:
            return pair_idx - 1
        pair_idx += 1
    return len(pairs) - 1


def align_read_to_ref(
    ref_seq: str, ref_offset: int, cigar_ops, cigar_lens, pos: int,
    is_rev: bool, read_length: int, b2e: np.ndarray, ev_mean: np.ndarray,
    scalings3, model_mean, model_stdv, events_per_base: float,
    region_start: int = -1, region_end: int = -1, k: int = KMER,
):
    """The align_read_to_ref outer loop (eventalign.c:1261-1540).

    ref_seq: reference bases covering [ref_offset, bam end_pos) as a
    string; b2e: (n_kmers, 2) base-to-event map from postalign.
    Returns list[RefAlignmentRow]."""
    scale, shift, var = (float(x) for x in scalings3)
    ref_seq = disambiguate(ref_seq)
    rc_ref_seq = reverse_complement(ref_seq)
    out: list[RefAlignmentRow] = []

    for pairs in aligned_pairs_from_cigar(cigar_ops, cigar_lens, pos):
        if region_start != -1 and region_end != -1:
            keep = (pairs[:, 0] >= region_start) & (pairs[:, 0] <= region_end)
            pairs = pairs[keep]
        # trim to the max kmer index (trailing pairs only)
        max_kmer_idx = read_length - k
        idx = len(pairs) - 1
        while idx >= 0 and pairs[idx, 1] > max_kmer_idx:
            idx -= 1
        pairs = pairs[: idx + 1]
        if len(pairs) == 0:
            return out  # the reference RETURNS here, not continues

        do_base_rc = bool(is_rev)
        input_rc = do_base_rc  # rc_flags[0], strand 0

        read_kidx_start = int(pairs[0, 1])
        read_kidx_end = int(pairs[-1, 1])
        if do_base_rc:
            read_kidx_start = read_length - read_kidx_start - k
            read_kidx_end = read_length - read_kidx_end - k
        if read_kidx_start < 0 or read_kidx_end < 0:
            raise ValueError("a cigar pair lies past the read's last k-mer")

        first_event = _get_closest_event_to(read_kidx_start, b2e)
        last_event = _get_closest_event_to(read_kidx_end, b2e)
        forward = first_event < last_event

        curr_start_event = first_event
        curr_start_ref = int(pairs[0, 0])
        curr_pair_idx = 0

        while (forward and curr_start_event < last_event) or (
                not forward and curr_start_event > last_event):
            end_pair_idx = _get_end_pair(
                pairs, curr_start_ref + ALIGN_STRIDE, curr_pair_idx)
            curr_end_ref = int(pairs[end_pair_idx, 0])
            curr_end_read = int(pairs[end_pair_idx, 1])
            if do_base_rc:
                curr_end_read = read_length - curr_end_read - k
            if curr_end_read < 0:
                raise ValueError("a cigar pair lies past the read's last k-mer")

            s = curr_start_ref - ref_offset
            l = curr_end_ref - curr_start_ref + 1
            fwd_subseq = ref_seq[s:s + l]
            rc_subseq = rc_ref_seq[len(ref_seq) - s - l: len(ref_seq) - s]
            if len(fwd_subseq) < 2 * k:
                break

            input_event_stop_idx = _get_closest_event_to(curr_end_read, b2e)
            if abs(curr_start_event - input_event_stop_idx) < 2:
                break
            event_stride = 1 if curr_start_event < input_event_stop_idx else -1

            ev_idx_arr, kmer_idx_arr, state_arr = native.psr9_viterbi(
                fwd_subseq.encode(), rc_subseq.encode(), ev_mean,
                scale, shift, var, model_mean, model_stdv, events_per_base,
                curr_start_event, input_event_stop_idx, event_stride,
                input_rc, k=k)

            num_output = 0
            last_section = end_pair_idx == len(pairs) - 1
            last_event_output = 0
            last_ref_kmer_output = 0
            for ev_i, km_i, st in zip(ev_idx_arr, kmer_idx_arr, state_arr):
                if not (num_output < OUTPUT_STRIDE or last_section):
                    break
                st = chr(st)
                ev_i, km_i = int(ev_i), int(km_i)
                if st != "K" and ev_i != curr_start_event:
                    ref_position = curr_start_ref + km_i
                    rel = ref_position - ref_offset
                    ref_kmer = ref_seq[rel:rel + k]
                    if st == "B":
                        model_kmer = "N" * k
                    elif input_rc:
                        model_kmer = rc_subseq[
                            len(rc_subseq) - km_i - k: len(rc_subseq) - km_i]
                    else:
                        model_kmer = fwd_subseq[km_i:km_i + k]
                    out.append(RefAlignmentRow(
                        ref_position=ref_position, ref_kmer=ref_kmer,
                        event_idx=ev_i, rc=do_base_rc, hmm_state=st,
                        model_kmer=model_kmer))
                    last_event_output = ev_i
                    last_ref_kmer_output = ref_position
                    num_output += 1

            curr_start_event = last_event_output
            curr_start_ref = last_ref_kmer_output
            curr_pair_idx = _get_end_pair(pairs, curr_start_ref, curr_pair_idx)
            if num_output == 0:
                break
    return out


def _kmer_rank(kmer: str, k: int = KMER) -> int:
    r = 0
    for i in range(k):
        c = kmer[k - i - 1]
        v = 1 if c == "C" else 2 if c == "G" else 3 if c == "T" else 0
        r += v << (i << 1)
    return r


def emit_ref_alignment_tsv(
    fp, rows, ev_mean, ev_stdv, ev_length, scalings3, model_mean,
    model_stdv, read_index: int, ref_name: str, sample_rate: float = 4000.0,
    scale_events: bool = True, k: int = KMER,
):
    """emit_event_alignment_tsv (eventalign.c:1853-1941), genome-
    coordinate mode: float math mirrors the C exactly (float32 ops,
    printed as promoted doubles), for every row at once."""
    if not rows:
        return
    scale, shift, var = (np.float32(x) for x in scalings3)
    mm = np.asarray(model_mean, np.float32)
    ms = np.asarray(model_stdv, np.float32)
    sqrt_var = np.sqrt(np.float64(var))
    sr32 = np.float32(sample_rate)
    ei = np.fromiter((r.event_idx for r in rows), np.int64, len(rows))
    event_mean = np.asarray(ev_mean, np.float32)[ei]
    event_stdv = np.asarray(ev_stdv, np.float32)[ei]
    # C divides in float (get_duration_seconds), prints the promotion
    duration = np.asarray(ev_length, np.float32)[ei] / sr32
    rank = np.fromiter((_kmer_rank(r.model_kmer, k) for r in rows), np.int64, len(rows))
    bad = np.fromiter((r.hmm_state == "B" for r in rows), bool, len(rows))
    if scale_events:
        event_mean = (event_mean - shift) / scale
        model_mean_v = np.where(bad, np.float32(0.0), mm[rank])
        model_stdv_v = np.where(bad, np.float32(0.0), ms[rank])
    else:
        model_mean_v = np.where(bad, np.float32(0.0), scale * mm[rank] + shift)
        model_stdv_v = np.where(bad, np.float32(0.0), ms[rank] * var)
    # C: float numerator, double denominator (sqrt promotes)
    with np.errstate(divide="ignore", invalid="ignore"):
        standard_level = (event_mean - model_mean_v).astype(np.float64) / (
            sqrt_var * model_stdv_v.astype(np.float64))
    cols = zip(rows, event_mean.tolist(), event_stdv.tolist(), duration.tolist(),
               model_mean_v.tolist(), model_stdv_v.tolist(), standard_level.tolist())
    fp.write("".join(
        f"{ref_name}\t{row.ref_position}\t{row.ref_kmer}\t{read_index}\tt\t"
        f"{row.event_idx}\t{em:.2f}\t{es:.3f}\t{du:.5f}\t"
        f"{row.model_kmer}\t{mmv:.2f}\t{msv:.2f}\t{sl:.2f}\n"
        for row, em, es, du, mmv, msv, sl in cols))


def ref_rows_to_sam_record(rows, read_name: str, ref_id: int, mapq: int):
    """Event-space alignment record (emit_event_alignment_sam,
    eventalign.c:1731-1800): qname `<read>.template`, pos = the first
    row's reference position, an EVENT cigar over (ref_position,
    event_idx) steps (insertions = event stays, deletions = reference
    jumps), zero-length SEQ/QUAL, and an `ES:i` aux tag carrying the
    event stride.  Returns an io.bam.BamRecord (serialized by
    write_bam into the BAM container — the binary form of the SAM the
    reference emits)."""
    import struct as _struct
    import types as _types

    from genomicsbench_tpu_torch.io.bam import BamRecord
    from genomicsbench_tpu_torch.ops.eventalign import event_alignment_to_cigar

    if not rows:
        return None
    rp = np.array([r.ref_position for r in rows], np.int64)
    ev = np.array([r.event_idx for r in rows], np.int64)
    cig = event_alignment_to_cigar(
        _types.SimpleNamespace(ref_position=rp, event_idx=ev))
    stride = 1 if rows[0].event_idx < rows[-1].event_idx else -1
    return BamRecord(
        name=read_name + ".template",
        flag=16 if rows[0].rc else 0,
        ref_id=ref_id, pos=int(rows[0].ref_position), mapq=mapq,
        cigar=[(op, n) for n, op in cig],
        seq=np.zeros(0, np.uint8), qual=np.zeros(0, np.uint8),
        tags=b"ESi" + _struct.pack("<i", stride),
    )
