// The partial-order-alignment graph engine of the poa path, host code: the
// port's own copy of genomicsbench_tpu/native/gbingest.cpp:842-1151
// (poa_add_edge, gb_poa_fuse, poa_topo, gb_poa_export, gb_poa_export_packed,
// gb_poa_decode_path, gb_poa_consensus), integer code copied with its
// tie-breaks.  The kernels of csrc/poa.cu do the O(N*Q) DP; this is the
// O(N) per-round pointer work around it.

#include <algorithm>
#include <cstdint>
#include <functional>
#include <queue>
#include <vector>

// Partial-order-alignment graph engine (the spoa Graph analog; semantics are
// the bit-exact contract of genomicsbench_tpu/oracle/poa.py — AddAlignment
// ring fusion, Kahn topo order with ring-column grouping, heaviest-bundle
// consensus).  This code is the O(N) per-round host pointer work (graph
// mutation, topo export, consensus).
//
// Graph state lives in caller-owned flat arrays (one set per window):
//   base      (cap)      uint8   node base codes
//   ring      (cap*3)    int32   aligned-column co-members, insertion order
//   ring_n    (cap)      uint8   members used (<=3: bases in a column differ)
//   in_head/in_tail/out_head (cap) int32  edge-list heads (-1 = none)
//   indeg     (cap)      int32   distinct-pred count (export p_pad sizing)
//   e_src/e_dst/e_w/e_nin/e_nout (ecap) int32  edge pool
// in-edge lists keep INSERTION order (consensus tie-breaks depend on it);
// out-edge lists are unordered sets (existence checks / topo decrements).

static int32_t poa_add_edge(int32_t u, int32_t v, int32_t w,
                            int32_t* out_head, int32_t* in_head,
                            int32_t* in_tail, int32_t* indeg,
                            int32_t* e_src, int32_t* e_dst, int32_t* e_w,
                            int32_t* e_nin, int32_t* e_nout,
                            int64_t* n_edges, int64_t ecap) {
    for (int32_t e = out_head[u]; e >= 0; e = e_nout[e]) {
        if (e_dst[e] == v) { e_w[e] += w; return 0; }
    }
    if (*n_edges >= ecap) return -1;
    int32_t e = (int32_t)(*n_edges)++;
    e_src[e] = u; e_dst[e] = v; e_w[e] = w;
    e_nout[e] = out_head[u]; out_head[u] = e;
    e_nin[e] = -1;
    if (in_tail[v] >= 0) e_nin[in_tail[v]] = e; else in_head[v] = e;
    in_tail[v] = e;
    indeg[v] += 1;
    return 0;
}

extern "C" {

// Fuse one aligned sequence into the graph (spoa Graph::AddAlignment).
// aln_node/aln_q: alignment pairs, -1 = None.  Returns new node count,
// or -1 on capacity overflow.
int64_t gb_poa_fuse(uint8_t* base, int32_t* ring, uint8_t* ring_n,
                    int32_t* out_head, int32_t* in_head, int32_t* in_tail,
                    int32_t* indeg,
                    int32_t* e_src, int32_t* e_dst, int32_t* e_w,
                    int32_t* e_nin, int32_t* e_nout,
                    int64_t* n_nodes, int64_t* n_edges,
                    int64_t cap, int64_t ecap,
                    const int32_t* aln_node, const int32_t* aln_q,
                    int64_t aln_len, const uint8_t* seq, int32_t weight) {
    int64_t n = *n_nodes;
    int32_t prev = -1;
    for (int64_t t = 0; t < aln_len; t++) {
        int32_t qpos = aln_q[t];
        if (qpos < 0) continue;  // graph gap: sequence skips this node
        uint8_t b = seq[qpos];
        int32_t node_id = aln_node[t];
        int32_t nid = -1;
        if (node_id < 0) {
            if (n >= cap) return -1;
            nid = (int32_t)n++;
            base[nid] = b; ring_n[nid] = 0;
            out_head[nid] = in_head[nid] = in_tail[nid] = -1; indeg[nid] = 0;
        } else if (base[node_id] == b) {
            nid = node_id;
        } else {
            for (int r = 0; r < ring_n[node_id]; r++) {
                int32_t m = ring[node_id * 3 + r];
                if (base[m] == b) { nid = m; break; }
            }
            if (nid < 0) {  // new ring member, column = node_id + its ring
                if (n >= cap) return -1;
                nid = (int32_t)n++;
                base[nid] = b;
                out_head[nid] = in_head[nid] = in_tail[nid] = -1;
                indeg[nid] = 0;
                int nr = ring_n[node_id];
                ring[nid * 3 + 0] = node_id;
                for (int r = 0; r < nr && r < 2; r++)
                    ring[nid * 3 + 1 + r] = ring[node_id * 3 + r];
                ring_n[nid] = (uint8_t)(1 + (nr < 2 ? nr : 2));
                // append nid to every column member's ring
                if (ring_n[node_id] < 3)
                    ring[node_id * 3 + ring_n[node_id]++] = nid;
                for (int r = 0; r < nr; r++) {
                    int32_t m = ring[node_id * 3 + r];
                    if (m != nid && ring_n[m] < 3)
                        ring[m * 3 + ring_n[m]++] = nid;
                }
            }
        }
        // oracle: every consecutive chosen pair gets an edge (incl. the
        // degenerate u == u case, mirrored exactly)
        if (prev >= 0 &&
            poa_add_edge(prev, nid, weight, out_head, in_head, in_tail,
                         indeg, e_src, e_dst, e_w, e_nin, e_nout,
                         n_edges, ecap) < 0)
            return -1;
        prev = nid;
    }
    *n_nodes = n;
    return n;
}

// Kahn topological order with ring-column grouping (oracle topo_order).
// order_out must hold n entries.  Work arrays ind_tmp (n) are internal.
static int64_t poa_topo(const int32_t* ring, const uint8_t* ring_n,
                        const int32_t* out_head, const int32_t* e_dst,
                        const int32_t* e_nout, const int32_t* indeg,
                        int64_t n, int32_t* order_out) {
    std::vector<int32_t> ind(indeg, indeg + n);
    std::vector<uint8_t> seen(n, 0);
    std::priority_queue<int32_t, std::vector<int32_t>,
                        std::greater<int32_t>> ready;
    for (int64_t i = 0; i < n; i++) if (ind[i] == 0) ready.push((int32_t)i);
    int64_t cnt = 0;
    while (!ready.empty()) {
        int32_t u = ready.top(); ready.pop();
        if (seen[u]) continue;
        int32_t group[4]; int gn = 0;
        group[gn++] = u;
        for (int r = 0; r < ring_n[u]; r++) {
            int32_t m = ring[u * 3 + r];
            if (ind[m] == 0 && !seen[m]) group[gn++] = m;
        }
        for (int g = 0; g < gn; g++) {
            int32_t x = group[g];
            seen[x] = 1; order_out[cnt++] = x;
            for (int32_t e = out_head[x]; e >= 0; e = e_nout[e]) {
                if (--ind[e_dst[e]] == 0 && !seen[e_dst[e]])
                    ready.push(e_dst[e]);
            }
        }
    }
    return cnt == n ? cnt : -1;  // -1: cycle
}

// Topo order + fixed-shape DP export (oracle export_graph_arrays).
// Returns n, or -(max_indegree) if p_pad is too small.
int64_t gb_poa_export(const uint8_t* base, const int32_t* ring,
                      const uint8_t* ring_n, const int32_t* out_head,
                      const int32_t* in_head, const int32_t* e_src,
                      const int32_t* e_nin, const int32_t* e_nout,
                      const int32_t* e_dst, const int32_t* indeg,
                      int64_t n, int64_t n_pad, int64_t p_pad,
                      int32_t* order_out, int32_t* base_out,
                      int32_t* pred_out, uint8_t* pmask_out,
                      uint8_t* sink_out) {
    if (poa_topo(ring, ring_n, out_head, e_dst, e_nout, indeg, n,
                 order_out) < 0)
        return -1;
    std::vector<int32_t> rank(n);
    for (int64_t r = 0; r < n; r++) rank[order_out[r]] = (int32_t)r + 1;
    std::vector<int32_t> pr;
    for (int64_t r = 0; r < n; r++) {
        int32_t nid = order_out[r];
        base_out[r] = base[nid];
        pr.clear();
        for (int32_t e = in_head[nid]; e >= 0; e = e_nin[e])
            pr.push_back(rank[e_src[e]]);
        std::sort(pr.begin(), pr.end());
        if (pr.empty()) pr.push_back(0);  // virtual start row
        if ((int64_t)pr.size() > p_pad) return -(int64_t)pr.size();
        for (size_t p = 0; p < pr.size(); p++) {
            pred_out[r * p_pad + (int64_t)p] = pr[p];
            pmask_out[r * p_pad + (int64_t)p] = 1;
        }
        sink_out[r] = (out_head[nid] < 0) ? 1 : 0;
    }
    return n;
}

// Topo order + DEVICE-PACKED export: writes straight into the batch
// upload planes of ops/poa.py `_marshal` — basep u8 (sink in bit 7) and
// predp u16 pred ranks with the 0xFFFF no-slot sentinel.  Skips the
// intermediate int32 pred/pmask arrays + numpy where/astype per window
// per MSA round (the marshal phase at racon scale).  Caller pre-fills
// basep_out with 0 and predp_out with 0xFFFF (row slices of the batch
// planes).  Returns n; -(indeg) if p_pad too small; -1 on cycle.
int64_t gb_poa_export_packed(const uint8_t* base, const int32_t* ring,
                             const uint8_t* ring_n, const int32_t* out_head,
                             const int32_t* in_head, const int32_t* e_src,
                             const int32_t* e_nin, const int32_t* e_nout,
                             const int32_t* e_dst, const int32_t* indeg,
                             int64_t n, int64_t n_pad, int64_t p_pad,
                             int32_t* order_out, uint8_t* basep_out,
                             uint16_t* predp_out) {
    (void)n_pad;
    if (poa_topo(ring, ring_n, out_head, e_dst, e_nout, indeg, n,
                 order_out) < 0)
        return -1;
    std::vector<int32_t> rank(n);
    for (int64_t r = 0; r < n; r++) rank[order_out[r]] = (int32_t)r + 1;
    std::vector<int32_t> pr;
    for (int64_t r = 0; r < n; r++) {
        int32_t nid = order_out[r];
        basep_out[r] = (uint8_t)(base[nid] | (out_head[nid] < 0 ? 0x80 : 0));
        pr.clear();
        for (int32_t e = in_head[nid]; e >= 0; e = e_nin[e])
            pr.push_back(rank[e_src[e]]);
        std::sort(pr.begin(), pr.end());
        if (pr.empty()) pr.push_back(0);  // virtual start row
        if ((int64_t)pr.size() > p_pad) return -(int64_t)pr.size();
        for (size_t p = 0; p < pr.size(); p++)
            predp_out[r * p_pad + (int64_t)p] = (uint16_t)pr[p];
    }
    return n;
}

// 4-bit path-code decoder (csrc/poa.cu gb_poa_backtrack, codes form):
// the device backtrack ships one nibble per aligned pair, in BACKWARD
// order — nibble < p_pad: M move consuming pred slot `nibble`;
// < 2*p_pad: F move on slot nibble-p_pad; == 2*p_pad: query-only
// column (E / gap run / r0 — identical decode).  Reconstructs
// forward-order (an, aq) with the host-resident predp row (u16 pred
// RANKS, 0xFFFF = empty slot -> virtual start 0) + topo order — an 8x
// smaller fetch than int32 entries.
void gb_poa_decode_path(const uint32_t* packed, int64_t plen,
                        int32_t best_rank, int32_t qlen,
                        const uint16_t* predp, int64_t p_pad,
                        const int32_t* order,
                        int32_t* an, int32_t* aq) {
    int32_t r = best_rank, j = qlen;
    for (int64_t t = 0; t < plen; t++) {
        int code = (int)((packed[t >> 3] >> ((t & 7) * 4)) & 0xF);
        int64_t o = plen - 1 - t;
        if (code < (int)p_pad) {            // M + pred slot
            an[o] = order[r - 1];
            aq[o] = j - 1;
            uint16_t pv = predp[(int64_t)(r - 1) * p_pad + code];
            r = (pv == 0xFFFF) ? 0 : (int32_t)pv;
            j--;
        } else if (code < (int)(2 * p_pad)) {  // F + pred slot
            an[o] = order[r - 1];
            aq[o] = -1;
            uint16_t pv = predp[(int64_t)(r - 1) * p_pad + (code - p_pad)];
            r = (pv == 0xFFFF) ? 0 : (int32_t)pv;
        } else {                            // query-only column
            an[o] = -1;
            aq[o] = j - 1;
            j--;
        }
    }
}

// Heaviest-bundle consensus (oracle consensus): topo scan picking per
// node the max-weight in-edge (ties: higher bundle score, then smaller
// topo rank, first-seen wins), backtrack from the best sink (global
// best overrides).  Returns consensus length.
int64_t gb_poa_consensus(const uint8_t* base, const int32_t* ring,
                         const uint8_t* ring_n, const int32_t* out_head,
                         const int32_t* in_head, const int32_t* e_src,
                         const int32_t* e_w, const int32_t* e_nin,
                         const int32_t* e_nout, const int32_t* e_dst,
                         const int32_t* indeg, int64_t n,
                         int32_t* cons_out) {
    if (n == 0) return 0;
    std::vector<int32_t> order(n);
    if (poa_topo(ring, ring_n, out_head, e_dst, e_nout, indeg, n,
                 order.data()) < 0)
        return -1;
    std::vector<int32_t> rank(n);
    for (int64_t r = 0; r < n; r++) rank[order[r]] = (int32_t)r;
    std::vector<int64_t> score(n, 0);
    std::vector<int32_t> bpred(n, -1);
    for (int64_t r = 0; r < n; r++) {
        int32_t nid = order[r];
        int64_t best_w = -1; int32_t best_p = -1;
        for (int32_t e = in_head[nid]; e >= 0; e = e_nin[e]) {
            int32_t pn = e_src[e]; int64_t w = e_w[e];
            bool take;
            if (best_p < 0) take = true;
            else if (w > best_w) take = true;
            else if (w == best_w &&
                     (score[pn] > score[best_p] ||
                      (score[pn] == score[best_p] &&
                       rank[pn] < rank[best_p]))) take = true;
            else take = false;
            if (take) { best_w = w; best_p = pn; }
        }
        if (best_p >= 0) { score[nid] = best_w + score[best_p]; bpred[nid] = best_p; }
    }
    // start: best sink by (score, -rank); global best overrides if greater
    int32_t start = -1, best_all = -1;
    for (int64_t r = 0; r < n; r++) {
        int32_t nid = order[r];
        if (out_head[nid] < 0) {
            if (start < 0 || score[nid] > score[start] ||
                (score[nid] == score[start] && rank[nid] < rank[start]))
                start = nid;
        }
        if (best_all < 0 || score[nid] > score[best_all] ||
            (score[nid] == score[best_all] && rank[nid] < rank[best_all]))
            best_all = nid;
    }
    if (start < 0) start = best_all;
    if (score[best_all] > score[start]) start = best_all;
    int64_t len = 0;
    for (int32_t cur = start; cur >= 0; cur = bpred[cur]) cons_out[len++] = base[cur];
    for (int64_t i = 0; i < len / 2; i++) {
        int32_t tmp = cons_out[i];
        cons_out[i] = cons_out[len - 1 - i];
        cons_out[len - 1 - i] = tmp;
    }
    return len;
}

}  // extern "C"
