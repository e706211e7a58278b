// minimap2 anchor chaining DP (chain_dp) for Hopper.
//
// Replaces the device loop of the JAX package's chain path,
// genomicsbench_tpu/ops/chain.py `_run_scan` (:271-494), reached through
// `_chain_scan` (:209) and `_chain_scan_packed` (:502).  It computes what
// `_run_scan`, the scalar oracle (oracle/chain.py:70-131) and the port's
// plain version `chain_dp_reference` (ops/chain.py) compute, bit for bit:
// the two-pointer window start on the 64-bit x with the max_iter cap (and
// i - window when a window is given), the validity rules, the gap cost with
// its linear part in f64, the max_skip break, the best predecessor (ties to
// the highest j) and the peak.  It is not a copy of the TPU formulation,
// which evaluates a whole fixed-width window per step: this kernel visits
// the candidates in the oracle's order, 32 at a time, and stops at the
// break, so its work is the candidates the oracle visits.
//
// Bound.  The floor is integer-ALU work per visited candidate: the
// operations the oracle's loop body needs at the card's best form, one op
// per instruction, with a DPX 3-way min and `__vibmax_s32` (the max and its
// predicate) one op each as in csrc/bsw.cu, and compares chained into one
// predicate by ISETP's combining input at no extra cost.  Choices that are
// uniform over a read (n_segs, is_cdna, max_dist_x and max_dist_y, bw) are
// settled once per read and cost nothing per candidate; a chunk whose 32
// candidates all share the anchor's sid takes the same-sid gap, behind a
// warp vote.  So the count is that of a read with n_segs = 1, not cdna,
// one sid, bw < 2^22, which chip_smoke.py checks the main path's data is
// (CHAIN_INT32_OPS_PER_CANDIDATE and CHAIN_F64_OPS_PER_CANDIDATE in
// ops/chain.py):
//   dr, dq (32-bit differences)                       2 IADD
//   dd = |dr - dq|                                    2 IADD, IABS
//   same rid; same sid ((y_i ^ y_j) & sid mask)       3 ISETP, LOP3, ISETP
//   dr == 0, dq <= 0, dq > min(mdx, mdy), dd > bw     4 ISETP, chained
//   sc0 = min(dq, dr, q_span)                         1 __vimin3_s32
//   log_dd (FLO of dd | 1: 0 for dd == 0)             2 LOP, FLO
//   gap = c_lin + (log_dd >> 1)                       1 LEA.HI
//   sc = sc0 - gap + score[j]                         1 IADD3
//   walk: sc > max_f and max_f                        1 __vibmax_s32
//         max_j                                       1 SEL
//         hit: targets[j] == i, and not improving     1 ISETP
//         n_skip + 1 on a skip                        1 IADD, predicated
//         n_skip = max(n_skip - 1, 0) on an improvement
//                                                     1 __viaddmax_s32, pred.
//         n_skip > max_skip, the break                1 ISETP
//   -------------------------------------------------------------------
//   int32 in all                                     22
//   c_lin: I2F.F64, DMUL, DMUL, F2I.F64               4 f64
// The dd clip at 2^22 drops out with bw < 2^22 (a valid same-sid pair has
// dd <= bw).  Loads, stores (the target mark), loop control and the
// per-anchor and per-read work (window start, the three stores, the vote)
// are left out, so the bound is a floor.  The rates are the card's int32
// rate without tensor cores, 64 lanes per SM x 132 SMs x the SM clock, and
// its f64 rate (64 FP64 lanes per SM, the same product); bytes are the
// anchors read once (16 per anchor plus 36 per read) and the three int32
// outputs and the per-read count written once.  chip_smoke.py counts the
// visited candidates of the run's own data.
//
// Design.  One warp per read; warp w of the grid takes read order[w], which
// the host sorts longest first so the long reads start in the first wave.
// For anchor i the warp walks its candidates j = i-1 down to the window
// start in chunks of 32, lane l taking j = i-1-32c-l.  A chunk
//   1. computes each lane's validity and score (scores[j] and parents[j]
//      were written by this warp in earlier iterations);
//   2. marks targets[parents[j]] = i for its valid lanes (the oracle's own
//      targets array, a per-anchor int32 scratch), then __syncwarp();
//   3. reads hit(j) = targets[j] == i.  A mark comes from some valid
//      j' in (j, i), visited before j, since parents[j'] < j'; marks from
//      lanes below the break land only on candidates never visited, so
//      writing the whole chunk's marks first changes nothing;
//   4. resolves the walk in visit order with shuffles: the running max_f
//      before each lane (an exclusive max-scan seeded with the carry), the
//      improvements, the skip events, and the floored n_skip walk in closed
//      form, n_l = S_l - min(-n_0, min_{q<=l} S_q) over the prefix sums S of
//      +1 per skip and -1 per improvement, n_0 the carry;
//   5. stops at the first lane whose skip takes n_skip past max_skip.
// max_f and max_j come from the last improvement before the break: an
// improvement is strictly above everything visited before it, so the last
// one is the earliest-visited maximum, as the oracle's strict > keeps it.
// Lane 0 writes scores[i], parents[i] and peak[i]; a __syncwarp() orders
// them before the next anchor's loads.  Every branch the warp takes is
// uniform.
//
// Left for later: the candidates' x, y, score and parent in shared memory
// as a ring (they are reloaded from L1/L2 for every anchor that sees them);
// the serial n_skip walk over the ballot bits in place of two scans; a
// persistent grid.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxDd = (1 << 22) - 1;   // the JAX package's clip of dd

__global__ void __launch_bounds__(32 * kWarpsPerBlock) chain_warp_kernel(
    const uint64_t* __restrict__ xs, const uint64_t* __restrict__ ys,
    const int64_t* __restrict__ offs, const int64_t* __restrict__ order,
    const float* __restrict__ avg_all, const int32_t* __restrict__ mdx_all,
    const int32_t* __restrict__ mdy_all, const int32_t* __restrict__ bw_all,
    const int32_t* __restrict__ nsegs_all, int64_t n_reads, int max_iter,
    int max_skip, int is_cdna, int window, int32_t* targets, int32_t* scores,
    int32_t* parents, int32_t* peak, int64_t* visited_out) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  if (w >= n_reads) return;
  const int64_t r = order[w];
  const int64_t base = offs[r];
  const int n = static_cast<int>(offs[r + 1] - base);
  const uint64_t* x = xs + base;
  const uint64_t* y = ys + base;
  int32_t* tg = targets + base;
  int32_t* sco = scores + base;
  int32_t* par = parents + base;
  int32_t* pk = peak + base;
  const double avg = static_cast<double>(avg_all[r]);
  const int mdx = mdx_all[r], mdy = mdy_all[r], bw = bw_all[r];
  const int n_segs = nsegs_all[r];

  for (int k = lane; k < n; k += 32) tg[k] = -1;
  __syncwarp();

  int st = 0;               // the two-pointer, with the max_iter cap
  int64_t visited = 0;
  for (int i = 0; i < n; ++i) {
    const uint64_t xi = x[i], yi = y[i];
    // host_kernel.cpp:56-57 on the unsigned 64-bit x (mdx >= 0)
    while (st < i && xi > x[st] && xi - x[st] > static_cast<uint64_t>(mdx)) ++st;
    if (i - st > max_iter) st = i - max_iter;
    const int lo = (window > 0 && i - window > st) ? i - window : st;
    const int wn = i - lo;  // candidates in the window
    const uint32_t pos_i = static_cast<uint32_t>(xi);
    const uint32_t rid_i = static_cast<uint32_t>(xi >> 32);
    const uint32_t q_i = static_cast<uint32_t>(yi);
    const int span_i = static_cast<int>((yi >> 32) & 0xff);
    const uint32_t sid_i = static_cast<uint32_t>((yi >> 48) & 0xff);

    int max_f = span_i;     // the running max, seeded with q_span
    int max_j = -1;
    int nskip = 0;
    int done = wn;          // candidates visited
    for (int c0 = 0; c0 < wn; c0 += 32) {
      const int p = c0 + lane;
      const int j = i - 1 - p;
      bool valid = false;
      int sc = 0;
      if (p < wn) {
        const uint64_t xj = x[j], yj = y[j];
        const int dr = static_cast<int>(pos_i - static_cast<uint32_t>(xj));
        const int dq = static_cast<int>(q_i - static_cast<uint32_t>(yj));
        const bool same_sid = sid_i == static_cast<uint32_t>((yj >> 48) & 0xff);
        const int d = static_cast<int>(static_cast<uint32_t>(dr) -
                                       static_cast<uint32_t>(dq));
        const int dd = d < 0 ? static_cast<int>(0u - static_cast<uint32_t>(d)) : d;
        valid = rid_i == static_cast<uint32_t>(xj >> 32) &&
                !((same_sid && dr == 0) || dq <= 0) &&
                !((same_sid && dq > mdy) || dq > mdx) &&
                !(same_sid && dd > bw) &&
                (is_cdna || !(n_segs > 1 && same_sid && dr > mdy));
        if (valid) {
          const int sc0 = min(min(dq, dr), span_i);
          const int log_dd = dd > 0 ? 31 - __clz(dd) : 0;
          const int ddc = min(max(dd, 0), kMaxDd);
          // the reference's double expression; two multiplies, no FMA
          const int c_lin = static_cast<int>(__dmul_rn(
              __dmul_rn(static_cast<double>(ddc), 0.01), avg));
          const bool bonus = !same_sid && dr == 0;
          const int gap_anchor = c_lin + (log_dd >> 1);
          int gap = gap_anchor;
          if (is_cdna || !same_sid)
            gap = bonus ? 0
                        : ((dr > dq || !same_sid) ? min(c_lin, log_dd) : gap_anchor);
          sc = static_cast<int>(static_cast<uint32_t>(sc0) +
                                static_cast<uint32_t>(bonus ? 1 : 0) -
                                static_cast<uint32_t>(gap) +
                                static_cast<uint32_t>(sco[j]));
          const int pj = par[j];
          if (pj >= 0) tg[pj] = i;
        }
      }
      __syncwarp();
      const bool hit = valid && tg[j] == i;

      // running max before each lane: exclusive max-scan, seeded by max_f
      int incl = valid ? sc : INT_MIN;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = INT_MIN;
      const bool imp = valid && sc > max(max_f, excl);
      const bool skip = valid && !imp && hit;
      // floored n_skip walk: prefix sums S and their prefix minimum M
      int S = skip ? 1 : (imp ? -1 : 0);
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(kFull, S, s);
        if (lane >= s) S += v;
      }
      int M = S;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(kFull, M, s);
        if (lane >= s) M = min(M, v);
      }
      const int nl = S - min(-nskip, M);
      const unsigned brk = __ballot_sync(kFull, skip && nl > max_skip);
      const int blane = brk ? __ffs(brk) - 1 : 32;
      unsigned imps = __ballot_sync(kFull, imp);
      if (blane < 32) imps &= (1u << blane) - 1u;
      if (imps) {
        const int last = 31 - __clz(imps);
        max_f = __shfl_sync(kFull, sc, last);
        max_j = i - 1 - (c0 + last);
      }
      if (blane < 32) {
        done = c0 + blane + 1;
        break;
      }
      nskip = __shfl_sync(kFull, nl, 31);
    }
    if (lane == 0) {
      sco[i] = max_f;
      par[i] = max_j;
      const int pkj = max_j >= 0 ? pk[max_j] : 0;
      pk[i] = (max_j >= 0 && pkj > max_f) ? pkj : max_f;
    }
    visited += done;
    __syncwarp();
  }
  if (lane == 0) visited_out[r] = visited;
}

}  // namespace

// x, y (T,) u64 anchors of all reads, read r at [offs[r], offs[r+1]) (offs
// (R+1,) i64); order (R,) i64, the reads in launch order; per read avg_qspan
// f32 and max_dist_x, max_dist_y, bw, n_segs i32.  window 0 means no cap.
// targets (T,) i32 is scratch; scores, parents (read-local, -1 for none),
// peak (T,) i32 and visited (R,) i64 are written.  Launches on `stream`,
// does not synchronise, and returns the CUDA error of the launch (0 on
// success).
extern "C" int gb_chain_dp(
    const void* x, const void* y, const void* offs, const void* order,
    const void* avg_qspan, const void* max_dist_x, const void* max_dist_y,
    const void* bw, const void* n_segs, int64_t n_reads, int max_iter,
    int max_skip, int is_cdna, int window, void* targets, void* scores,
    void* parents, void* peak, void* visited, void* stream) {
  if (n_reads <= 0) return 0;
  if (max_iter < 0 || max_skip < 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_reads + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chain_warp_kernel<<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<const uint64_t*>(y),
      static_cast<const int64_t*>(offs), static_cast<const int64_t*>(order),
      static_cast<const float*>(avg_qspan), static_cast<const int32_t*>(max_dist_x),
      static_cast<const int32_t*>(max_dist_y), static_cast<const int32_t*>(bw),
      static_cast<const int32_t*>(n_segs), n_reads, max_iter, max_skip, is_cdna,
      window, static_cast<int32_t*>(targets), static_cast<int32_t*>(scores),
      static_cast<int32_t*>(parents), static_cast<int32_t*>(peak),
      static_cast<int64_t*>(visited));
  return static_cast<int>(cudaGetLastError());
}
