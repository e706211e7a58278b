// BAM record batch parse: the port's copy of gb_bam_scan and gb_bam_parse
// from genomicsbench_tpu/native/gbingest.cpp (the htslib bam_read1 analog
// that feeds the region readers, debruijn.cpp:1519-1536 and
// medaka_bamiter.c).  Two-pass SoA protocol over a decompressed BAM stream:
// gb_bam_scan sizes the arrays, gb_bam_parse fills them.  Sequence nibbles
// decode straight to the 0..4 codes (A C G T, anything else 4).
//
// A plain C ABI, loaded with ctypes by native/__init__.py.

#include <cstdint>
#include <cstring>

extern "C" {

// 4-bit "=ACMGRSVTWYHKDBN" nibble -> code (A=0 C=1 G=2 T=3, other=4)
static const uint8_t NIB2CODE[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                     3, 4, 4, 4, 4, 4, 4, 4};

// Count records from `off`; totals[0..2] = total cigar ops, seq bases,
// name bytes (without NULs).  Returns record count (truncated tail ignored).
int64_t gb_bam_scan(const uint8_t* raw, int64_t n, int64_t off,
                    int64_t* totals) {
    int64_t cnt = 0, tc = 0, ts = 0, tn = 0;
    while (off + 4 <= n) {
        int32_t bs;
        memcpy(&bs, raw + off, 4);
        if (bs < 32 || off + 4 + bs > n) break;
        const uint8_t* b = raw + off + 4;
        uint8_t l_rn = b[8];
        uint16_t n_cig;
        memcpy(&n_cig, b + 12, 2);
        int32_t l_seq;
        memcpy(&l_seq, b + 16, 4);
        cnt++;
        tc += n_cig;
        ts += l_seq;
        tn += l_rn - 1;
        off += 4 + bs;
    }
    totals[0] = tc;
    totals[1] = ts;
    totals[2] = tn;
    return cnt;
}

// Fill SoA arrays sized by gb_bam_scan.  cig_off/seq_off/name_off/tag_off
// carry n_rec+1 prefix offsets (tag offsets index into `raw` itself).
// end_pos = pos + sum of reference-consuming cigar ops (M/D/N/=/X).
int64_t gb_bam_parse(const uint8_t* raw, int64_t n, int64_t off,
                     int32_t* ref_id, int32_t* pos, int32_t* flag,
                     int32_t* mapq, int32_t* n_cig, int64_t* cig_off,
                     uint32_t* cigars, int32_t* l_seq, int64_t* seq_off,
                     uint8_t* seqs, uint8_t* quals, int32_t* name_len,
                     int64_t* name_off, uint8_t* names, int32_t* end_pos,
                     int64_t* tag_beg, int64_t* tag_end) {
    int64_t r = 0, co = 0, so = 0, no = 0;
    while (off + 4 <= n) {
        int32_t bs;
        memcpy(&bs, raw + off, 4);
        if (bs < 32 || off + 4 + bs > n) break;
        const uint8_t* b = raw + off + 4;
        memcpy(&ref_id[r], b, 4);
        memcpy(&pos[r], b + 4, 4);
        uint8_t l_rn = b[8];
        mapq[r] = b[9];
        uint16_t nc16, fl16;
        memcpy(&nc16, b + 12, 2);
        memcpy(&fl16, b + 14, 2);
        int32_t ls;
        memcpy(&ls, b + 16, 4);
        n_cig[r] = nc16;
        flag[r] = fl16;
        l_seq[r] = ls;
        cig_off[r] = co;
        seq_off[r] = so;
        name_off[r] = no;
        name_len[r] = l_rn - 1;
        const uint8_t* p = b + 32;
        memcpy(names + no, p, l_rn - 1);
        no += l_rn - 1;
        p += l_rn;
        int32_t refspan = 0;
        for (int c = 0; c < nc16; c++) {
            uint32_t v;
            memcpy(&v, p + 4 * c, 4);
            cigars[co + c] = v;
            uint32_t op = v & 15;  // MIDNSHP=X: M,D,N,=,X consume reference
            if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                refspan += (int32_t)(v >> 4);
        }
        co += nc16;
        end_pos[r] = pos[r] + refspan;
        p += 4 * nc16;
        for (int32_t i = 0; i < ls; i++) {
            uint8_t nib = (i & 1) ? (p[i >> 1] & 15) : (p[i >> 1] >> 4);
            seqs[so + i] = NIB2CODE[nib];
        }
        p += (ls + 1) / 2;
        memcpy(quals + so, p, ls);
        p += ls;
        so += ls;
        tag_beg[r] = (int64_t)(p - raw);
        tag_end[r] = off + 4 + bs;
        r++;
        off += 4 + bs;
    }
    cig_off[r] = co;
    seq_off[r] = so;
    name_off[r] = no;
    return r;
}


}  // extern "C"
