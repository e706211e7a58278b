// Linear-time suffix array by induced sorting (SA-IS), the host side of the
// FM-index build.  The port's own copy of sais_core and gb_sais
// (genomicsbench_tpu/native/gbingest.cpp:1160-1278), with their tie order:
// a unique sentinel smaller than every symbol is appended internally, so on
// tied prefixes the shorter suffix sorts first (the implicit-$ convention of
// bwa).  Integer work only, so the compiler's flags cannot change a result.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// s must end in a unique smallest sentinel at position n-1; values in [0, K)
void sais_core(const int32_t* s, int32_t* sa, int32_t n, int32_t K) {
    std::vector<bool> stype(n);
    stype[n - 1] = true;
    for (int32_t i = n - 2; i >= 0; i--)
        stype[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && stype[i + 1]);
    auto is_lms = [&](int32_t i) { return i > 0 && stype[i] && !stype[i - 1]; };

    std::vector<int32_t> bkt_start(K), bkt_end(K);
    {
        std::vector<int32_t> cnt(K, 0);
        for (int32_t i = 0; i < n; i++) cnt[s[i]]++;
        int32_t acc = 0;
        for (int32_t c = 0; c < K; c++) {
            bkt_start[c] = acc;
            acc += cnt[c];
            bkt_end[c] = acc;
        }
    }

    auto induce = [&](const std::vector<int32_t>& lms_order) {
        std::fill(sa, sa + n, -1);
        std::vector<int32_t> e(bkt_end);
        for (int32_t j = (int32_t)lms_order.size() - 1; j >= 0; j--) {
            int32_t i = lms_order[j];
            sa[--e[s[i]]] = i;
        }
        std::vector<int32_t> b(bkt_start);
        for (int32_t k = 0; k < n; k++) {
            int32_t j = sa[k];
            if (j > 0 && !stype[j - 1]) sa[b[s[j - 1]]++] = j - 1;
        }
        std::vector<int32_t> e2(bkt_end);
        for (int32_t k = n - 1; k >= 0; k--) {
            int32_t j = sa[k];
            if (j > 0 && stype[j - 1]) sa[--e2[s[j - 1]]] = j - 1;
        }
    };

    std::vector<int32_t> lms;
    for (int32_t i = 0; i < n; i++)
        if (is_lms(i)) lms.push_back(i);
    induce(lms);

    // name the LMS substrings in SA order
    std::vector<int32_t> name(n, -1);
    int32_t n_names = 0, prev = -1;
    for (int32_t k = 0; k < n; k++) {
        int32_t i = sa[k];
        if (!is_lms(i)) continue;
        if (prev >= 0) {
            int32_t a = prev, b = i;
            bool same = true;
            for (int32_t d = 0;; d++) {
                if (s[a + d] != s[b + d] || stype[a + d] != stype[b + d]) {
                    same = false;
                    break;
                }
                if (d > 0 && (is_lms(a + d) || is_lms(b + d))) {
                    same = is_lms(a + d) && is_lms(b + d);
                    break;
                }
            }
            if (!same) n_names++;
        }
        name[i] = n_names;
        prev = i;
    }
    int32_t m = (int32_t)lms.size();
    std::vector<int32_t> s1(m), sa1(m);
    for (int32_t i = 0, j = 0; i < n; i++)
        if (name[i] >= 0) s1[j++] = name[i];
    std::vector<int32_t>().swap(name);

    if (n_names + 1 < m) {
        sais_core(s1.data(), sa1.data(), m, n_names + 1);
    } else {
        for (int32_t i = 0; i < m; i++) sa1[s1[i]] = i;
    }
    std::vector<int32_t> lms_sorted(m);
    for (int32_t i = 0; i < m; i++) lms_sorted[i] = lms[sa1[i]];
    induce(lms_sorted);
}

}  // namespace

// Suffix array of codes s (values in [0, K)); writes n entries to out.
// Returns n, or -1 when n is too large for int32 positions.
extern "C" int64_t gb_sais(const uint8_t* s, int64_t n, int32_t K, int32_t* out) {
    if (n <= 0) return 0;
    if (n >= (1ll << 31) - 2) return -1;
    std::vector<int32_t> t(n + 1);
    for (int64_t i = 0; i < n; i++) t[i] = (int32_t)s[i] + 1;
    t[n] = 0;  // sentinel
    std::vector<int32_t> sa(n + 1);
    sais_core(t.data(), sa.data(), (int32_t)n + 1, K + 2);
    // drop the sentinel suffix (always first)
    for (int64_t i = 0; i < n; i++) out[i] = sa[i + 1];
    return n;
}
