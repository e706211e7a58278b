// Pileup's CIGAR walks (medaka_counts.c:383-459): the port's copy of
// gb_pileup_events, gb_pileup_extents and gb_pileup_accumulate from
// genomicsbench_tpu/native/gbingest.cpp.  Each walks the selected records of
// a gb_bam_parse SoA batch.
//
// gb_pileup_events emits one (ref_pos, minor_j, feature, qual) observation
// per counted base or deletion, region-clipped, plus a width-only marker
// (feature -1) per anchored insertion; two passes, the out_* pointers null
// to count.  gb_pileup_extents and gb_pileup_accumulate count in place:
// pass 1 gives the coverage diffs and each position's longest insertion,
// the caller lays out the matrix columns, pass 2 walks the CIGARs again and
// increments the matrix cells.
//
// A plain C ABI, loaded with ctypes by native/__init__.py.

#include <cstdint>

extern "C" {

// ---- event stream (the num_dtypes > 1 route)

int64_t gb_pileup_events(
    const int32_t* pos, const int32_t* flag, const int32_t* n_cig,
    const int64_t* cig_off, const uint32_t* cigars, const int64_t* seq_off,
    const uint8_t* seqs, const uint8_t* quals,
    const int64_t* hit, int64_t n_hit, int64_t start, int64_t end,
    int32_t* out_pos, int32_t* out_j, int32_t* out_feat, int32_t* out_q) {
    int64_t n_ev = 0;
    const bool count_only = out_pos == nullptr;
    for (int64_t h = 0; h < n_hit; h++) {
        int64_t r = hit[h];
        int64_t rp = pos[r];
        int64_t qp = 0;
        const bool rev = (flag[r] & 16) != 0;
        const int32_t strand_add = rev ? 0 : 4;
        const int32_t del_feat = rev ? 8 : 9;  // REV_DEL / FWD_DEL
        const uint8_t* sq = seqs + seq_off[r];
        const uint8_t* ql = quals + seq_off[r];
        bool prev_aligned = false;
        const uint32_t* cg = cigars + cig_off[r];
        for (int32_t c = 0; c < n_cig[r]; c++) {
            uint32_t op = cg[c] & 15;
            int64_t ln = cg[c] >> 4;
            if (op == 0 || op == 7 || op == 8) {  // M / = / X
                int64_t lo = rp < start ? start : rp;
                int64_t hi = rp + ln < end ? rp + ln : end;
                for (int64_t p = lo; p < hi; p++) {
                    uint8_t b = sq[qp + (p - rp)];
                    if (b > 3) continue;
                    if (!count_only) {
                        out_pos[n_ev] = (int32_t)p;
                        out_j[n_ev] = 0;
                        out_feat[n_ev] = b + strand_add;
                        out_q[n_ev] = ql[qp + (p - rp)];
                    }
                    n_ev++;
                }
                rp += ln;
                qp += ln;
                prev_aligned = true;
            } else if (op == 1) {  // I
                int64_t anchor = rp - 1;
                if (anchor >= start && anchor < end && anchor >= pos[r]) {
                    // width-only marker: the reference max_ins counts
                    // p->indel even on deletion/refskip anchors and for
                    // ambiguity-code bases (medaka_counts.c:364-367)
                    if (!count_only) {
                        out_pos[n_ev] = (int32_t)anchor;
                        out_j[n_ev] = (int32_t)ln;
                        out_feat[n_ev] = -1;
                        out_q[n_ev] = 0;
                    }
                    n_ev++;
                    if (prev_aligned) {
                        for (int64_t i = 0; i < ln; i++) {
                            uint8_t b = sq[qp + i];
                            if (b > 3) continue;
                            if (!count_only) {
                                out_pos[n_ev] = (int32_t)anchor;
                                out_j[n_ev] = (int32_t)(i + 1);
                                out_feat[n_ev] = b + strand_add;
                                out_q[n_ev] = ql[qp + i];
                            }
                            n_ev++;
                        }
                    }
                }
                qp += ln;
            } else if (op == 2) {  // D
                int64_t lo = rp < start ? start : rp;
                int64_t hi = rp + ln < end ? rp + ln : end;
                for (int64_t p = lo; p < hi; p++) {
                    if (!count_only) {
                        out_pos[n_ev] = (int32_t)p;
                        out_j[n_ev] = 0;
                        out_feat[n_ev] = del_feat;
                        out_q[n_ev] = 0;
                    }
                    n_ev++;
                }
                rp += ln;
                prev_aligned = false;
            } else if (op == 3) {  // N
                rp += ln;
                prev_aligned = false;
            } else if (op == 4) {  // S
                qp += ln;
            }  // H/P consume nothing
        }
    }
    return n_ev;
}


// ---- in-place accumulation (the single-dtype route)

void gb_pileup_extents(
    const int32_t* pos, const int32_t* flag, const int32_t* n_cig,
    const int64_t* cig_off, const uint32_t* cigars,
    const int64_t* hit, int64_t n_hit, int64_t start, int64_t end,
    int32_t* max_ins, int64_t* cov_diff) {
    for (int64_t h = 0; h < n_hit; h++) {
        int64_t r = hit[h];
        int64_t rp = pos[r];
        const int64_t rp0 = rp;
        const uint32_t* cg = cigars + cig_off[r];
        for (int32_t c = 0; c < n_cig[r]; c++) {
            uint32_t op = cg[c] & 15;
            int64_t ln = cg[c] >> 4;
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) {
                rp += ln;  // consumes reference
            } else if (op == 1) {  // I: width marker at the anchor
                int64_t anchor = rp - 1;
                if (anchor >= rp0 && anchor >= start && anchor < end &&
                    max_ins[anchor - start] < ln)
                    max_ins[anchor - start] = (int32_t)ln;
            }
        }
        int64_t lo = rp0 < start ? start : rp0;
        int64_t hi = rp < end ? rp : end;
        if (hi > lo) { cov_diff[lo - start]++; cov_diff[hi - start]--; }
    }
}

void gb_pileup_accumulate(
    const int32_t* pos, const int32_t* flag, const int32_t* n_cig,
    const int64_t* cig_off, const uint32_t* cigars, const int64_t* seq_off,
    const uint8_t* seqs, const uint8_t* quals,
    const int64_t* hit, int64_t n_hit, int64_t start, int64_t end,
    int32_t num_homop, const int64_t* base_cols, int32_t* matrix) {
    const int32_t featlen = 10;
    const int64_t plane = (int64_t)featlen * num_homop;
    for (int64_t h = 0; h < n_hit; h++) {
        int64_t r = hit[h];
        int64_t rp = pos[r];
        const int64_t rp0 = rp;
        int64_t qp = 0;
        const bool rev = (flag[r] & 16) != 0;
        const int32_t strand_add = rev ? 0 : 4;
        const int32_t del_feat = rev ? 8 : 9;
        const uint8_t* sq = seqs + seq_off[r];
        const uint8_t* ql = quals + seq_off[r];
        bool prev_aligned = false;
        const uint32_t* cg = cigars + cig_off[r];
        for (int32_t c = 0; c < n_cig[r]; c++) {
            uint32_t op = cg[c] & 15;
            int64_t ln = cg[c] >> 4;
            if (op == 0 || op == 7 || op == 8) {  // M / = / X
                int64_t lo = rp < start ? start : rp;
                int64_t hi = rp + ln < end ? rp + ln : end;
                for (int64_t p = lo; p < hi; p++) {
                    uint8_t b = sq[qp + (p - rp)];
                    if (b > 3) continue;
                    int32_t q = num_homop > 1 ?
                        (int32_t)ql[qp + (p - rp)] : 0;
                    int32_t qstrat = num_homop > 1
                        ? (q < num_homop ? (q > 0 ? q - 1 : 0) : num_homop - 1)
                        : 0;
                    matrix[base_cols[p - start] * plane
                           + featlen * qstrat + b + strand_add]++;
                }
                rp += ln;
                qp += ln;
                prev_aligned = true;
            } else if (op == 1) {  // I
                int64_t anchor = rp - 1;
                if (prev_aligned && anchor >= rp0 && anchor >= start &&
                    anchor < end) {
                    for (int64_t i = 0; i < ln; i++) {
                        uint8_t b = sq[qp + i];
                        if (b > 3) continue;
                        int32_t q = num_homop > 1 ? (int32_t)ql[qp + i] : 0;
                        int32_t qstrat = num_homop > 1
                            ? (q < num_homop ? (q > 0 ? q - 1 : 0)
                                             : num_homop - 1)
                            : 0;
                        matrix[(base_cols[anchor - start] + i + 1) * plane
                               + featlen * qstrat + b + strand_add]++;
                    }
                }
                qp += ln;
            } else if (op == 2) {  // D
                int64_t lo = rp < start ? start : rp;
                int64_t hi = rp + ln < end ? rp + ln : end;
                for (int64_t p = lo; p < hi; p++)
                    matrix[base_cols[p - start] * plane + del_feat]++;
                rp += ln;
                prev_aligned = false;
            } else if (op == 3) {  // N
                rp += ln;
                prev_aligned = false;
            } else if (op == 4) {  // S
                qp += ln;
            }
        }
    }
}


}  // extern "C"
