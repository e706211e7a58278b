// CTC prefix beam search over a read's posteriors: the basecaller's decoder
// (the fast_ctc_decode analog the reference basecaller links as a Rust
// extension, basecall.py:28), host code.
//
// The port's copy of `gb_ctc_beam_search` and its `PrefixNode` of the JAX
// package's host library (genomicsbench_tpu/native/gbingest.cpp:1294-1393),
// unchanged.  Semantics mirror the JAX package's Python loop
// (models/basecaller.py:291-343), which the port keeps as the plain version
// `beam_search_reference`: blank = class 0, sub-threshold symbols skipped,
// blank-only frames collapsed, per-frame renormalization, stable top-k
// (ties keep the first-inserted candidate).  Built with -ffp-contract=off
// (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {
// child[s-1] holds the node id reached by appending symbol s (1..8) —
// direct slots instead of a hash map: the alphabet is tiny and the child
// lookup sits in the innermost per-beam loop.
struct PrefixNode { int32_t parent; int32_t symbol; int32_t child[8]; };
}

extern "C" {

// probs: (T, L) row-major float32.  Writes <= out_cap symbols (1-based class
// ids) to out_seq; returns the decoded length (or -1 on overflow).
int64_t gb_ctc_beam_search(const float* probs, int64_t T, int32_t L,
                           int32_t beamsize, float threshold,
                           int32_t* out_seq, int64_t out_cap) {
    if (L > 9) return -1;  // 8 non-blank symbols max (nanopore uses 4)
    std::vector<PrefixNode> tree;
    tree.push_back({-1, -1, {-1, -1, -1, -1, -1, -1, -1, -1}});
    struct Beam { int32_t node; double pb, pnb; };
    std::vector<Beam> beams{{0, 1.0, 0.0}};

    struct Cand { int32_t node; double pb, pnb; };
    std::vector<Cand> cands;
    // per-frame node -> candidate index, generation-stamped (O(1) merge
    // instead of a linear edge-cache scan per add)
    std::vector<int32_t> cand_of;   // grows with the tree
    std::vector<int32_t> cand_gen;
    int32_t gen = 0;

    bool pending_blank_run = false;
    for (int64_t t = 0; t < T; t++) {
        const float* row = probs + t * L;
        float max_sym = 0.0f;
        for (int32_t s = 1; s < L; s++) max_sym = std::max(max_sym, row[s]);
        if (max_sym < threshold) { pending_blank_run = true; continue; }
        if (pending_blank_run) {
            for (auto& b : beams) { b.pb = b.pb + b.pnb; b.pnb = 0.0; }
            pending_blank_run = false;
        }

        cands.clear();
        gen++;
        if (cand_of.size() < tree.size() + 64) {
            cand_of.resize(tree.size() + 256, -1);
            cand_gen.resize(tree.size() + 256, 0);
        }
        auto add = [&](int32_t node, double pb, double pnb) {
            if (cand_gen[node] == gen) {
                Cand& c = cands[cand_of[node]];
                c.pb += pb; c.pnb += pnb; return;
            }
            cand_gen[node] = gen;
            cand_of[node] = (int32_t)cands.size();
            cands.push_back({node, pb, pnb});
        };
        auto child = [&](int32_t node, int32_t sym) -> int32_t {
            int32_t c = tree[node].child[sym - 1];
            if (c >= 0) return c;
            PrefixNode nn{node, sym, {-1, -1, -1, -1, -1, -1, -1, -1}};
            tree.push_back(nn);
            int32_t id = (int32_t)tree.size() - 1;
            tree[node].child[sym - 1] = id;
            return id;
        };

        for (auto& b : beams) {
            double p_tot = b.pb + b.pnb;
            add(b.node, (double)row[0] * p_tot, 0.0);  // blank
            int32_t last = tree[b.node].symbol;
            for (int32_t s = 1; s < L; s++) {
                double p = row[s];
                if (p < threshold) continue;
                if (last == s) {
                    add(b.node, 0.0, p * b.pnb);             // repeat absorbed
                    add(child(b.node, s), 0.0, p * b.pb);    // new copy after blank
                } else {
                    add(child(b.node, s), 0.0, p * p_tot);
                }
            }
        }
        std::stable_sort(cands.begin(), cands.end(),
                         [](const Cand& a, const Cand& b)
                         { return a.pb + a.pnb > b.pb + b.pnb; });
        size_t k = std::min((size_t)beamsize, cands.size());
        double norm = 1.0 / std::max(cands[0].pb + cands[0].pnb, 1e-300);
        beams.clear();
        for (size_t i = 0; i < k; i++)
            beams.push_back({cands[i].node, cands[i].pb * norm, cands[i].pnb * norm});
    }

    // best beam
    const Beam* best = &beams[0];
    for (auto& b : beams)
        if (b.pb + b.pnb > best->pb + best->pnb) best = &b;
    // walk prefix backwards
    std::vector<int32_t> rev;
    for (int32_t n = best->node; n > 0; n = tree[n].parent)
        rev.push_back(tree[n].symbol);
    if ((int64_t)rev.size() > out_cap) return -1;
    for (size_t i = 0; i < rev.size(); i++)
        out_seq[i] = rev[rev.size() - 1 - i];
    return (int64_t)rev.size();
}

}  // extern "C"
