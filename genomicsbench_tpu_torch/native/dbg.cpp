// de Bruijn window graphs (Platypus debruijn.cpp:1262-1367 and
// DeBruijnGraph_AddEdge:888-920): the port's copy of gb_dbg_mentions,
// dbg_to5_table/dbg_to5, dbg_build_impl, gb_dbg_build and
// gb_dbg_build_ranged from genomicsbench_tpu/native/gbingest.cpp.
//
// gb_dbg_mentions emits, per read position whose (k+1)-span is all A/C/G/T
// with its least quality >= min_qual, the two node k-mer keys (2-bit
// packed), the (k+1)-base edge key and the span weight (loadReadIntoGraph,
// debruijn.cpp:1322-1367); two passes, the out_* pointers null to count.
//
// gb_dbg_build / gb_dbg_build_ranged build every window's graph in one call:
// per window an epoch-stamped open-addressing table upserts each mention as
// it is generated (insertion order is first-mention order), then the nodes
// come out in ascending key order and the edges in first-mention order, both
// re-encoded to base-5 keys.  Capacity protocol: the caller preallocates the
// node and edge outputs; if they are too small the call keeps counting
// without writing and returns -1 with the totals in node_off[n_windows] and
// edge_off[n_windows].  A window whose reference slice holds an N is flagged
// in skip_n and left to the caller.
//
// A plain C ABI, loaded with ctypes by native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" {

int64_t gb_dbg_mentions(
    const uint8_t* seqs, const int32_t* quals, const int64_t* offs,
    const int64_t* lens, int64_t n_reads, int32_t k, int32_t min_qual,
    int64_t* out_key1, int64_t* out_key2, int64_t* out_ekey,
    int32_t* out_w, int32_t* out_t, int32_t* out_c) {
    const bool count_only = out_key1 == nullptr;
    const int64_t mask = ((int64_t)1 << (2 * k)) - 1;
    int64_t n_out = 0;
    for (int64_t r = 0; r < n_reads; r++) {
        const uint8_t* s = seqs + offs[r];
        const int32_t* q = quals + offs[r];
        const int64_t L = lens[r];
        const int64_t nE = L - k - 1;
        if (nE <= 0) continue;
        // rolling key over k+1 bases + rolling validity/min-qual window
        int64_t key = 0;
        int64_t last_bad = -1;   // last position with base > 3
        for (int64_t i = 0; i < L; i++) {
            key = ((key << 2) | (s[i] <= 3 ? s[i] : 0)) & (((int64_t)1 << (2 * (k + 1))) - 1);
            if (s[i] > 3) last_bad = i;
            const int64_t c = i - k;  // span [c, c+k] just completed
            if (c < 0 || c >= nE) continue;
            if (last_bad >= c) continue;
            int32_t mq = q[c];
            for (int64_t j = c + 1; j <= c + k; j++)
                if (q[j] < mq) mq = q[j];
            if (mq < min_qual) continue;
            if (!count_only) {
                out_ekey[n_out] = key;              // (k+1)-mer: (key1<<2)|nb
                out_key1[n_out] = (key >> 2) & mask;
                out_key2[n_out] = key & mask;
                out_w[n_out] = mq;
                out_t[n_out] = (int32_t)r;
                out_c[n_out] = (int32_t)c;
            }
            n_out++;
        }
    }
    return n_out;
}

}  // extern "C"

namespace {


// 8-digit chunk table for the 2-bit -> base-5 key re-encode: T[x] is the
// base-5 value of x's eight 2-bit digits (< 5^8 = 390625, fits uint32).
// The per-digit loop was O(k) per emitted node/edge — measurable at the
// ~5M nodes a chromosome-scale build emits.
static const uint32_t* dbg_to5_table() {
    static const std::vector<uint32_t> t = [] {
        std::vector<uint32_t> v(1 << 16);
        for (uint32_t x = 0; x < (1u << 16); x++) {
            uint32_t out = 0;
            for (int shift = 14; shift >= 0; shift -= 2)
                out = out * 5 + ((x >> shift) & 3);
            v[x] = out;
        }
        return v;
    }();
    return t.data();
}

static inline int64_t dbg_to5(int64_t key2bit, int32_t k, const uint32_t* T) {
    int64_t out = 0;
    int32_t lead = k & 7;           // partial most-significant chunk
    int32_t pos = k - lead;         // digits below it
    if (lead)
        out = T[(key2bit >> (2 * pos)) & (((int64_t)1 << (2 * lead)) - 1)];
    while (pos > 0) {
        pos -= 8;
        out = out * 390625 + T[(key2bit >> (2 * pos)) & 0xFFFF];
    }
    return out;
}

// read_lo/read_hi are per-window [lo, hi) row ranges into the shared read
// SoA with stride `lohi_stride` (1 for plain arrays, 2 when lo/hi are the
// even/odd halves of one interleaved buffer).  Ranges may OVERLAP — the
// same physical read row can belong to many windows, which is exactly the
// 750 bp-shift window tiling (Platypus assemRegionShift): the Python side
// no longer has to duplicate every read's bytes per window.
static int64_t dbg_build_impl(
    const uint8_t* refs, const int64_t* ref_offs, const int64_t* ref_lens,
    const int64_t* ref_starts, int64_t n_windows,
    const uint8_t* seqs, const int32_t* quals, const int64_t* offs,
    const int64_t* lens, const int64_t* read_lo, const int64_t* read_hi,
    int64_t lohi_stride,
    int32_t k, int32_t min_qual,
    int64_t node_cap, int64_t edge_cap,
    int64_t* node_off, int64_t* edge_off, uint8_t* skip_n,
    int64_t* node_keys5, int64_t* colours, int64_t* weights,
    int64_t* positions,
    int64_t* edge_start5, int64_t* edge_succ5, int64_t* edge_weight) {
    const uint8_t REFC = 1, READC = 2;
    const uint32_t* T5 = dbg_to5_table();
    int64_t p5k1 = 1;  // 5^(k-1): succ key = (start % 5^(k-1)) * 5 + base
    for (int32_t i = 0; i < k - 1; i++) p5k1 *= 5;
    const int64_t mask = ((int64_t)1 << (2 * k)) - 1;
    const int64_t emask = ((int64_t)1 << (2 * (k + 1))) - 1;
    // Epoch-stamped open-addressing accumulators: each mention is upserted
    // as it is generated — no materialized mention stream and no radix sort
    // over all ~20 mentions/bp; per window only the DISTINCT groups (~4k
    // for a 1.5 kb window at 30x) are sorted for output.  Insertion order
    // IS first-mention order, so edge output needs no sort at all and a
    // node group's position/colour seed is simply whatever the first
    // upsert stored.
    std::vector<int64_t> nkey, nws, npos_, ekey, ews;
    std::vector<int32_t> nep, eep;          // epoch stamps
    std::vector<uint8_t> ncol_;
    std::vector<int32_t> nlive, elive;      // occupied slots, insertion order
    std::vector<std::pair<int64_t, int32_t>> nsorted;
    size_t ncap_tab = 0, ecap_tab = 0;
    int32_t epoch = 0;
    int64_t n_total = 0, e_total = 0;
    bool overflow = false;
    for (int64_t wid = 0; wid < n_windows; wid++) {
        node_off[wid] = n_total;
        edge_off[wid] = e_total;
        const uint8_t* ref = refs + ref_offs[wid];
        const int64_t rl = ref_lens[wid];
        const int64_t nE = rl - k - 1;
        bool has_n = false;
        if (rl >= k + 1)  // mirror ops/dbg.py: keys 0..nE checked -> bases 0..rl-2
            for (int64_t i = 0; i + 1 < rl; i++)
                if (ref[i] > 3) { has_n = true; break; }
        skip_n[wid] = has_n ? 1 : 0;
        if (has_n) continue;
        // table sizing: distinct groups <= mentions; mention upper bound
        // from the spans in range (the per-read loop is ~60 iterations)
        int64_t span_bound = nE > 0 ? nE : 0;
        for (int64_t r = read_lo[wid * lohi_stride];
             r < read_hi[wid * lohi_stride]; r++)
            if (lens[r] > k + 1) span_bound += lens[r] - k - 1;
        if (span_bound >= ((int64_t)1 << 24))
            return -2;  // mentions per window > 16M (format cap)
        size_t want_n = 64, want_e = 64;
        while ((int64_t)want_n < 4 * span_bound + 4) want_n <<= 1;
        while ((int64_t)want_e < 2 * span_bound + 4) want_e <<= 1;
        if (want_n > ncap_tab) {
            ncap_tab = want_n;
            nkey.resize(ncap_tab); nws.resize(ncap_tab);
            npos_.resize(ncap_tab); ncol_.resize(ncap_tab);
            nep.assign(ncap_tab, 0);
        }
        if (want_e > ecap_tab) {
            ecap_tab = want_e;
            ekey.resize(ecap_tab); ews.resize(ecap_tab);
            eep.assign(ecap_tab, 0);
        }
        epoch++;
        nlive.clear(); elive.clear();
        const uint64_t nmaskh = want_n - 1, emaskh = want_e - 1;
        const int nsh = 64 - __builtin_ctzll(want_n);
        const int esh = 64 - __builtin_ctzll(want_e);
        auto node_upsert = [&](int64_t kk, int64_t w, uint8_t c, int64_t pos) {
            uint64_t h = ((uint64_t)kk * 0x9E3779B97F4A7C15ull) >> nsh;
            for (;; h = (h + 1) & nmaskh) {
                if (nep[h] != epoch) {
                    nep[h] = epoch; nkey[h] = kk; nws[h] = w;
                    ncol_[h] = c; npos_[h] = pos;
                    nlive.push_back((int32_t)h);
                    return;
                }
                if (nkey[h] == kk) { nws[h] += w; ncol_[h] |= c; return; }
            }
        };
        auto edge_upsert = [&](int64_t kk, int64_t w) {
            uint64_t h = ((uint64_t)kk * 0x9E3779B97F4A7C15ull) >> esh;
            for (;; h = (h + 1) & emaskh) {
                if (eep[h] != epoch) {
                    eep[h] = epoch; ekey[h] = kk; ews[h] = w;
                    elive.push_back((int32_t)h);
                    return;
                }
                if (ekey[h] == kk) { ews[h] += w; return; }
            }
        };
        if (nE > 0) {
            int64_t key = 0;  // rolling k-mer ending at i
            for (int64_t i = 0; i < k - 1; i++) key = (key << 2) | ref[i];
            for (int64_t c = 0; c < nE; c++) {
                key = ((key << 2) | ref[c + k - 1]) & mask;
                const int64_t ekk = ((key << 2) | ref[c + k]) & emask;
                node_upsert(key, 1, REFC, ref_starts[wid] + c);
                node_upsert(ekk & mask, 1, REFC, ref_starts[wid] + c + 1);
                edge_upsert(ekk, 1);
            }
        }
        for (int64_t r = read_lo[wid * lohi_stride];
             r < read_hi[wid * lohi_stride]; r++) {
            const uint8_t* s = seqs + offs[r];
            const int32_t* q = quals + offs[r];
            const int64_t L = lens[r];
            const int64_t nE2 = L - k - 1;
            if (nE2 <= 0) continue;
            int64_t key = 0;
            int64_t last_bad = -1;
            // sliding min of q over [c, c+k] via monotonic deque: the naive
            // inner loop was O(k) per k-mer (~half the whole build)
            static thread_local std::vector<int32_t> dq;
            dq.clear(); dq.resize(L);
            int64_t dh = 0, dt = 0;
            for (int64_t i = 0; i < L; i++) {
                while (dt > dh && q[dq[dt - 1]] >= q[i]) dt--;
                dq[dt++] = (int32_t)i;
                key = ((key << 2) | (s[i] <= 3 ? s[i] : 0)) & emask;
                if (s[i] > 3) last_bad = i;
                const int64_t c = i - k;
                if (c < 0 || c >= nE2) continue;
                if (dq[dh] < c) dh++;  // window [c, c+k] slides by one
                if (last_bad >= c) continue;
                int32_t mq = q[dq[dh]];
                if (mq < min_qual) continue;
                node_upsert((key >> 2) & mask, mq, READC, -1);
                node_upsert(key & mask, mq, READC, -1);
                edge_upsert(key, mq);
            }
        }
        // ---- node output: ascending key order (the Python formulation
        // sorts mentions by (window, key) and reduces) — sort only the
        // ~4k distinct groups, not the mention stream
        nsorted.clear();
        for (int32_t h : nlive) nsorted.emplace_back(nkey[h], h);
        std::sort(nsorted.begin(), nsorted.end());
        for (const auto& [kk, h] : nsorted) {
            if (!overflow && n_total < node_cap) {
                node_keys5[n_total] = dbg_to5(kk, k, T5);
                colours[n_total] = ncol_[h];
                weights[n_total] = nws[h];
                positions[n_total] = npos_[h];
            } else if (n_total >= node_cap) overflow = true;
            n_total++;
        }
        // ---- edge output: first-mention order == insertion order, so no
        // sort.  Platypus's 4-slot successor cap (DeBruijnGraph_AddEdge,
        // debruijn.cpp:888-920) can never bind after the reduce: an edge
        // key is (prefix<<2)|base with a 2-bit base, so a prefix has at
        // most 4 distinct edge groups.
        for (int32_t h : elive) {
            const int64_t kk = ekey[h];
            if (!overflow && e_total < edge_cap) {
                const int64_t s5 = dbg_to5((kk >> 2) & mask, k, T5);
                edge_start5[e_total] = s5;
                edge_succ5[e_total] = (s5 % p5k1) * 5 + (kk & 3);
                edge_weight[e_total] = std::min<int64_t>(ews[h], INT32_MAX);
            } else if (e_total >= edge_cap) overflow = true;
            e_total++;
        }
    }
    node_off[n_windows] = n_total;
    edge_off[n_windows] = e_total;
    return overflow ? -1 : 0;
}


}  // namespace

extern "C" {

int64_t gb_dbg_build(
    const uint8_t* refs, const int64_t* ref_offs, const int64_t* ref_lens,
    const int64_t* ref_starts, int64_t n_windows,
    const uint8_t* seqs, const int32_t* quals, const int64_t* offs,
    const int64_t* lens, const int64_t* read_off_w,  // per-window read range
    int32_t k, int32_t min_qual,
    int64_t node_cap, int64_t edge_cap,
    int64_t* node_off, int64_t* edge_off, uint8_t* skip_n,
    int64_t* node_keys5, int64_t* colours, int64_t* weights,
    int64_t* positions,
    int64_t* edge_start5, int64_t* edge_succ5, int64_t* edge_weight) {
    // contiguous (non-overlapping) ranges: lo = read_off_w[w], hi = [w+1]
    return dbg_build_impl(refs, ref_offs, ref_lens, ref_starts, n_windows,
                          seqs, quals, offs, lens,
                          read_off_w, read_off_w + 1, 1,
                          k, min_qual, node_cap, edge_cap,
                          node_off, edge_off, skip_n,
                          node_keys5, colours, weights, positions,
                          edge_start5, edge_succ5, edge_weight);
}

// Ranged variant: read_lo/read_hi are independent per-window [lo, hi) row
// ranges into ONE shared read SoA; ranges may overlap (a read in several
// windows is stored once).  This is the chromosome-scale entry — the
// caller passes its reads sorted by start position and each window is a
// contiguous slice, so marshalling is O(n_windows), not O(total mentions).
int64_t gb_dbg_build_ranged(
    const uint8_t* refs, const int64_t* ref_offs, const int64_t* ref_lens,
    const int64_t* ref_starts, int64_t n_windows,
    const uint8_t* seqs, const int32_t* quals, const int64_t* offs,
    const int64_t* lens, const int64_t* read_lo, const int64_t* read_hi,
    int32_t k, int32_t min_qual,
    int64_t node_cap, int64_t edge_cap,
    int64_t* node_off, int64_t* edge_off, uint8_t* skip_n,
    int64_t* node_keys5, int64_t* colours, int64_t* weights,
    int64_t* positions,
    int64_t* edge_start5, int64_t* edge_succ5, int64_t* edge_weight) {
    return dbg_build_impl(refs, ref_offs, ref_lens, ref_starts, n_windows,
                          seqs, quals, offs, lens, read_lo, read_hi, 1,
                          k, min_qual, node_cap, edge_cap,
                          node_off, edge_off, skip_n,
                          node_keys5, colours, weights, positions,
                          edge_start5, edge_succ5, edge_weight);
}


}  // extern "C"
