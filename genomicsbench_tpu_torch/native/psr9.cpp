// PSR9 profile-HMM Viterbi alignment of one segment of events to a
// reference window: the inner loop of f5c eventalign's align_read_to_ref
// (eventalign.c:345-910), host code.
//
// The port's copy of `gb_psr9_viterbi` of the JAX package's host library
// (genomicsbench_tpu/native/gbingest.cpp:1955-2143), unchanged.  It stays on
// the host, as it does in the JAX package, and is built with
// -ffp-contract=off (native/__init__.py), so that g++ contracts no
// multiply-add into an FMA and every float operation rounds as written.
//
// Restructured from the reference's single (rows x 3*blocks) matrix into
// three per-state planes (M/B/K) over kmer blocks; the recurrence, the
// float/double promotion behavior (C promotes the log() doubles before
// truncating to float on store), the movement tie rule (later movement
// index wins ties), and the backtrack walk mirror the reference.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

int64_t gb_psr9_viterbi(
    const char* fwd_seq, const char* rc_seq, int64_t seq_len,
    const float* ev_mean, int64_t n_events_total,
    float scale, float shift, float var,
    const float* model_mean, const float* model_stdv,  // 4^k entries
    double events_per_base,
    int64_t e_start, int64_t e_end, int64_t event_stride, int64_t rc,
    int64_t k,
    int32_t* out_event_idx, int32_t* out_kmer_idx, uint8_t* out_state,
    int64_t cap) {
    const int64_t n_kmers = seq_len - k + 1;
    if (n_kmers < 1) return 0;
    const int64_t n_events =
        (e_end > e_start ? e_end - e_start : e_start - e_end) + 1;
    if (n_events < 2) return 0;
    const int64_t n_rows = n_events + 1;
    (void)n_events_total;

    // block transitions (identical for every kmer; kept scalar).
    // p_stay is computed in double and truncated on store, like the
    // reference's `float p_stay = 1 - (1 / read_events_per_base)`
    const float p_stay = (float)(1.0 - 1.0 / events_per_base);
    const float p_skip = 0.0025f, p_bad = 0.001f;
    const float p_bad_self = p_bad, p_skip_self = 0.3f;
    const float lp_mm_self = (float)log(p_stay);
    const float lp_mb = (float)log(p_bad);
    const float lp_mk = (float)log(p_skip);
    const float lp_mm_next =
        (float)log(1.0f - p_stay - p_skip - p_bad);
    const float lp_bb = (float)log(p_bad_self);
    const float third = (1.0f - p_bad_self) / 3.0f;
    const float lp_bk = (float)log(third), lp_bm_next = (float)log(third),
                lp_bm_self = (float)log(third);
    const float lp_kk = (float)log(p_skip_self);
    const float lp_km = (float)log(1.0f - p_skip_self);
    const float NEG_INF = -INFINITY;

    // kmer ranks over the segment (rc: walk the rc sequence backward)
    std::vector<uint32_t> rank(n_kmers);
    for (int64_t ki = 0; ki < n_kmers; ki++) {
        const char* sub = rc ? rc_seq + seq_len - ki - k : fwd_seq + ki;
        uint32_t r = 0;
        for (int64_t i = 0; i < k; i++) {
            char b = sub[k - i - 1];
            uint32_t v = b == 'C' ? 1 : b == 'G' ? 2 : b == 'T' ? 3 : 0;
            r += v << (i << 1);
        }
        rank[ki] = r;
    }

    // pre/post flank vectors (eventalign.c:75-146; log() is double, the
    // additions promote to double, the store truncates to float)
    std::vector<float> pre_flank(n_events + 1), post_flank(n_events);
    pre_flank[0] = (float)log(1 - 0.5);
    if (n_events >= 1)
        pre_flank[1] = (float)(log(0.5) + -3.0f + log(1 - 0.9));
    for (int64_t i = 2; i < n_events + 1; i++)
        pre_flank[i] = (float)(log(0.9) + -3.0f + (double)pre_flank[i - 1]);
    post_flank[n_events - 1] = (float)log(1 - 0.5);
    if (n_events > 1) {
        post_flank[n_events - 2] =
            (float)(log(0.5) + -3.0f + log(1 - 0.9));
        for (int64_t i = n_events - 3; i >= 0; i--)
            post_flank[i] =
                (float)(log(0.9) + -3.0f + (double)post_flank[i + 1]);
    }

    // per-state planes over (rows x n_kmers) + movement planes
    const int64_t NK = n_kmers;
    std::vector<float> M(n_rows * NK, NEG_INF), B(n_rows * NK, NEG_INF),
        K(n_rows * NK, NEG_INF);
    std::vector<uint8_t> Mv(n_rows * NK), Bv(n_rows * NK), Kv(n_rows * NK);
    const float lp_sm = 0.0f, lp_ms = 0.0f;
    (void)lp_ms;  // end-state bookkeeping doesn't drive the backtrack
    for (int64_t row = 1; row < n_rows; row++) {
        const int64_t event_idx = e_start + (row - 1) * event_stride;
        const float* Mp = &M[(row - 1) * NK];
        const float* Bp = &B[(row - 1) * NK];
        const float* Kp = &K[(row - 1) * NK];
        float* Mc = &M[row * NK];
        float* Bc = &B[row * NK];
        float* Kc = &K[row * NK];
        const float log_var = (float)log(var);
        for (int64_t b = 0; b < NK; b++) {
            const uint32_t r = rank[b];
            const float gp_mean = scale * model_mean[r] + shift;
            const float gp_stdv = model_stdv[r] * var;
            // CACHED_LOG semantics (f5c.h:67): both logs are cached as
            // floats and added as floats (model.c:52, align.c:749)
            const float gp_log_stdv = (float)log(model_stdv[r]) + log_var;
            const float a = (ev_mean[event_idx] - gp_mean) / gp_stdv;
            const float lp_emission_m =
                -0.918938f - gp_log_stdv + (-0.5f * a * a);

            // movement order (eventalign.c:49-57): SAME_M, PREV_M,
            // SAME_B, PREV_B, PREV_K, SOFT; ties -> later index
            float sc[6];
            // state MATCH
            sc[0] = lp_mm_self + Mp[b];
            sc[1] = b > 0 ? lp_mm_next + Mp[b - 1] : NEG_INF;
            sc[2] = lp_bm_self + Bp[b];
            sc[3] = b > 0 ? lp_bm_next + Bp[b - 1] : NEG_INF;
            sc[4] = b > 0 ? lp_km + Kp[b - 1] : NEG_INF;
            sc[5] = (b == 0 && event_idx == e_start)
                        ? lp_sm + pre_flank[row - 1]
                        : NEG_INF;
            float mx = sc[0];
            uint8_t from = 0;
            for (int i = 1; i < 6; i++) {
                mx = sc[i] > mx ? sc[i] : mx;
                from = mx == sc[i] ? (uint8_t)i : from;
            }
            Mc[b] = mx + lp_emission_m;
            Mv[row * NK + b] = from;

            // state BAD_EVENT (emission 0)
            sc[0] = lp_mb + Mp[b];
            sc[1] = NEG_INF;
            sc[2] = lp_bb + Bp[b];
            sc[3] = NEG_INF;
            sc[4] = NEG_INF;
            sc[5] = NEG_INF;
            mx = sc[0];
            from = 0;
            for (int i = 1; i < 6; i++) {
                mx = sc[i] > mx ? sc[i] : mx;
                from = mx == sc[i] ? (uint8_t)i : from;
            }
            Bc[b] = mx;
            Bv[row * NK + b] = from;

            // state KMER_SKIP (same-row previous block, no emission)
            sc[0] = NEG_INF;
            sc[1] = b > 0 ? lp_mk + Mc[b - 1] : NEG_INF;
            sc[2] = NEG_INF;
            sc[3] = b > 0 ? lp_bk + Bc[b - 1] : NEG_INF;
            sc[4] = b > 0 ? lp_kk + Kc[b - 1] : NEG_INF;
            sc[5] = NEG_INF;
            mx = sc[0];
            from = 0;
            for (int i = 1; i < 6; i++) {
                mx = sc[i] > mx ? sc[i] : mx;
                from = mx == sc[i] ? (uint8_t)i : from;
            }
            Kc[b] = mx;
            Kv[row * NK + b] = from;

        }
    }
    // the reference asserts the final MATCH cell is reachable; bail out
    // cleanly on infeasible inputs (its callers guarantee feasibility)
    if (M[(n_rows - 1) * NK + (NK - 1)] == NEG_INF) return 0;

    // backtrack (eventalign.c:808-886): ALWAYS starts from the MATCH
    // state of the last kmer block at the final row (the end-cell
    // tracking in the reference is not consulted); emitted reversed,
    // then flipped to forward order
    int64_t n_out = 0;
    int64_t row = n_rows - 1;
    int64_t kmer_idx = NK - 1;
    int32_t st = 2;  // PSR9_MATCH
    while (row > 0) {
        const int64_t event_idx = e_start + (row - 1) * event_stride;
        if (n_out >= cap) return -1;
        const char state_char = st == 0 ? 'K' : st == 1 ? 'B' : 'M';
        out_event_idx[n_out] = (int32_t)event_idx;
        out_kmer_idx[n_out] = (int32_t)kmer_idx;
        out_state[n_out] = (uint8_t)state_char;
        n_out++;
        const uint8_t mv = (st == 0 ? Kv : st == 1 ? Bv : Mv)[row * NK + kmer_idx];
        const int32_t cur = st;
        if (mv == 5) break;  // HMT_FROM_SOFT
        switch (mv) {
            case 0: st = 2; break;                   // FROM_SAME_M
            case 1: kmer_idx -= 1; st = 2; break;    // FROM_PREV_M
            case 2: st = 1; break;                   // FROM_SAME_B
            case 3: kmer_idx -= 1; st = 1; break;    // FROM_PREV_B
            case 4: kmer_idx -= 1; st = 0; break;    // FROM_PREV_K
        }
        if (cur != 0) row -= 1;  // kmer-skip is silent (no event)
    }
    // reverse in place to forward order
    for (int64_t i = 0, j = n_out - 1; i < j; i++, j--) {
        int32_t t0 = out_event_idx[i]; out_event_idx[i] = out_event_idx[j]; out_event_idx[j] = t0;
        t0 = out_kmer_idx[i]; out_kmer_idx[i] = out_kmer_idx[j]; out_kmer_idx[j] = t0;
        uint8_t t1 = out_state[i]; out_state[i] = out_state[j]; out_state[j] = t1;
    }
    return n_out;
}

}  // extern "C"
