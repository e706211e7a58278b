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
// settled once per read and cost nothing per candidate.  So the count is
// that of a read with n_segs = 1, not cdna, one sid, bw < 2^22, which
// chip_smoke.py checks the main path's data is
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
//         hit: the mark of j, and not improving       1 ISETP
//         n_skip + 1 on a skip                        1 IADD, predicated
//         n_skip = max(n_skip - 1, 0) on an improvement
//                                                     1 __viaddmax_s32, pred.
//         n_skip > max_skip, the break                1 ISETP
//   -------------------------------------------------------------------
//   int32 in all                                     22
//   c_lin: I2F.F64, DMUL, DMUL, F2I.F64               4 f64
// The dd clip at 2^22 drops out with bw < 2^22 (a valid same-sid pair has
// dd <= bw).  Loads, the marks, loop control and the per-anchor and
// per-read work (window start, scans, the result) are left out, so the
// bound is a floor.  The rates are the card's int32 rate without tensor
// cores, 64 lanes per SM x 132 SMs x the SM clock, and its f64 rate (64
// FP64 lanes per SM, the same product); bytes are the anchors read once
// (16 per anchor plus 36 per read) and the three int32 outputs and the
// per-read count written once.  chip_smoke.py counts the visited
// candidates of the run's own data.  The longest read also sets a latency
// floor: its anchors, one after the other, times the dependent path of one
// anchor's step (a ring load, one candidate's arithmetic, its f64 chain,
// the fold of a lane's four, the group's scans and the result's store),
// which chip_smoke.py reckons and prints.
//
// Design.  A read runs on a group of kG = 8 lanes, four reads a warp; lane
// l of a group holds kR = 4 candidates of the visit order, an aligned quad
// of anchors: for anchor i, with qd = (i - 1) / 4, chunk c's lane l holds
// j = 4 (qd - 8c - l) + 3 - k, k = 0..3 in visit order, at the virtual
// position t = 32c + 4l + k = p + off, p = i - 1 - j the visit position
// and off = 3 - (i - 1) % 4 (the first quad's slots past i - 1 hold no
// candidate).  A block is one warp (its shared memory, 4 x 2.9 KB on the
// main path, then fits 18 warps an SM where blocks of four would fit 16);
// warp w takes reads order[4w .. 4w + 3] of the host's longest-first
// order, so a warp's reads have similar lengths; the loop over anchors is
// warp-uniform (to the warp's longest read), and a group whose read has
// ended idles.  A chunk
//   1. loads each lane's quad and computes its candidates' validity and
//      scores.  The candidates come from a ring in shared memory of the
//      read's last kRing = 96 anchors, seven int32 fields (pos, rid, qpos,
//      y >> 32, score, parent, peak) in arrays of their own, so a lane's
//      quad is one 16-byte load a field, and the group's eight lanes read
//      128 consecutive bytes, free of bank conflicts (the four groups'
//      rings are skewed by 16 bytes for the anchor's own broadcast loads).
//      The ring is filled 32 anchors at a time, coalesced, from registers
//      loaded a block ahead; it holds the block of 32 the anchor is in and
//      the 64 before it, and a deeper candidate reads the same values from
//      global memory (x and y from the input, score and parent from the
//      outputs, which the group writes back from the ring coalesced, a
//      block at a time), so the result is exact for any window;
//   2. marks the max_skip targets: a valid candidate whose parent j' lies
//      in the window marks j', at virtual position 4 qd + 3 - j', past its
//      own.  Marks inside the chunk are a 32-bit mask OR-reduced over the
//      group (three xor shuffles); marks past the chunk go, only when the
//      group goes on to the next chunk, into a bitmap of the window's
//      virtual positions in shared memory (one word a chunk, cleared after
//      an anchor that wrote it).  There is no scratch in global memory and
//      no store->load of it on an anchor's chain; hit(j) is its mark bit;
//   3. resolves the walk in visit order: each lane folds its four
//      candidates in registers, the group combines the lanes by segmented
//      shuffles (width 8): an exclusive max-scan of the lanes' maxima
//      seeded with the carry max_f gives each lane its running max, so the
//      lane finds its improvements and skips serially; the floored n_skip
//      walk is n_p = S_p - min(-n_0, min_{q<=p} S_q) over the prefix sums S
//      of +1 per skip and -1 per improvement, n_0 the carry, from one
//      segmented scan of the lanes' (sum, prefix minimum) pairs;
//   4. stops at the first skip that takes n_skip past max_skip (a ballot
//      masked to the group).  max_f and max_j come from the last
//      improvement before the break: an improvement is strictly above
//      everything visited before it, so the last one is the
//      earliest-visited maximum, as the oracle's strict > keeps it.
// Lane 0 of the group writes the anchor's score, parent and peak into the
// ring; a __syncwarp() orders them before the next anchor's loads.
//
// The two-pointer runs on the 64-bit x alone, so it is kept off the
// anchor's chain: the group's 8 lanes hold x[st] .. x[st + 7], loaded an
// anchor ahead (after the previous anchor's window start), and one ballot
// advances st by the leading lanes whose anchors lie more than max_dist_x
// before x_i (another round of 8 when all do); then the max_iter cap and
// the window cap.  Every loop a warp runs to the end with shuffles and
// ballots in it is warp-uniform (__any_sync).
//
// Left for later: the n_skip scan skipped for a chunk without skips; the
// two-pointer's loads from the ring where the window is shallow; a
// persistent grid.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kG = 8;                    // lanes a read
constexpr int kR = 4;                    // candidates a lane: an aligned quad of anchors
constexpr int kChunk = kG * kR;          // 32 candidates a chunk
constexpr int kGroups = 32 / kG;         // reads a warp
constexpr int kRing = 96;                // anchors a read's ring holds
constexpr int kQuads = kRing / kR;
constexpr int kFill = 32;                // anchors one fill brings
constexpr int kMinWarpsPerSm = 18;       // at most 112 registers a thread
constexpr int kFields = 7;               // pos, rid, qpos, y >> 32, score, parent, peak
constexpr int kRingBytes = kRing * 4 * kFields;
constexpr int kMaxDd = (1 << 22) - 1;    // the JAX package's clip of dd

// bytes of one group's ring and bitmap, rounded to 128 and skewed by 16 so
// that the four groups' rings start on different banks
__host__ __device__ __forceinline__ int group_bytes(int bm_words) {
  return ((kRingBytes + bm_words * 4 + 127) & ~127) + 16;
}

__global__ void __launch_bounds__(32, kMinWarpsPerSm) chain_group_kernel(
    const uint64_t* __restrict__ xs, const uint64_t* __restrict__ ys,
    const int64_t* __restrict__ offs, const int64_t* __restrict__ order,
    const float* __restrict__ avg_all, const int32_t* __restrict__ mdx_all,
    const int32_t* __restrict__ mdy_all, const int32_t* __restrict__ bw_all,
    const int32_t* __restrict__ nsegs_all, int64_t n_reads, int max_iter, int max_skip,
    int is_cdna, int window, int bm_words, int32_t* scores, int32_t* parents,
    int32_t* peak, int64_t* visited_out, int64_t* ring_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int grp = lane / kG, gl = lane % kG;
  const int gshift = grp * kG;
  const int64_t rr = static_cast<int64_t>(blockIdx.x) * kGroups + grp;
  const int64_t r = rr < n_reads ? order[rr] : -1;
  const int64_t base = r >= 0 ? offs[r] : 0;
  const int n = r >= 0 ? static_cast<int>(offs[r + 1] - base) : 0;
  const uint64_t* x = xs + base;
  const uint64_t* y = ys + base;
  int32_t* sco = scores + base;
  int32_t* par = parents + base;
  int32_t* pk = peak + base;
  const double avg = r >= 0 ? static_cast<double>(avg_all[r]) : 0.0;
  const int mdx = r >= 0 ? mdx_all[r] : 0, mdy = r >= 0 ? mdy_all[r] : 0;
  const int bw = r >= 0 ? bw_all[r] : 0, n_segs = r >= 0 ? nsegs_all[r] : 1;
  const uint64_t umdx = static_cast<uint64_t>(mdx);
  const int mdxy = min(mdx, mdy);
  const bool plain = !is_cdna && n_segs <= 1 && bw <= kMaxDd;   // one segment, not cdna

  // the read's ring: seven int32 fields of kRing slots (anchor a at slot a
  // % kRing), then the bitmap of the max_skip marks
  int32_t* ring = reinterpret_cast<int32_t*>(smem + grp * group_bytes(bm_words));
  uint32_t* rpos = reinterpret_cast<uint32_t*>(ring);
  uint32_t* rrid = rpos + kRing;
  uint32_t* rq = rrid + kRing;
  uint32_t* ryh = rq + kRing;          // y >> 32: span, and the sid at bits 16-23
  int32_t* rsc = reinterpret_cast<int32_t*>(ryh + kRing);
  int32_t* rpar = rsc + kRing;
  int32_t* rpk = rpar + kRing;
  uint32_t* bits = reinterpret_cast<uint32_t*>(rpk + kRing);

  // the next block of 32 anchors, lane gl's quad 4 gl .. 4 gl + 3, loaded a
  // block ahead into registers and stored into the ring at the block's start
  uint64_t nx[kR], ny[kR];
  auto load_block = [&](int a0) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int a = a0 + kR * gl + k;
      nx[k] = a < n ? __ldg(x + a) : 0;
      ny[k] = a < n ? __ldg(y + a) : 0;
    }
  };
  auto store_block = [&](int a0) {
    const int s = a0 % kRing + kR * gl;
    reinterpret_cast<uint4*>(rpos + s)[0] = make_uint4(
        static_cast<uint32_t>(nx[0]), static_cast<uint32_t>(nx[1]),
        static_cast<uint32_t>(nx[2]), static_cast<uint32_t>(nx[3]));
    reinterpret_cast<uint4*>(rrid + s)[0] = make_uint4(
        static_cast<uint32_t>(nx[0] >> 32), static_cast<uint32_t>(nx[1] >> 32),
        static_cast<uint32_t>(nx[2] >> 32), static_cast<uint32_t>(nx[3] >> 32));
    reinterpret_cast<uint4*>(rq + s)[0] = make_uint4(
        static_cast<uint32_t>(ny[0]), static_cast<uint32_t>(ny[1]),
        static_cast<uint32_t>(ny[2]), static_cast<uint32_t>(ny[3]));
    reinterpret_cast<uint4*>(ryh + s)[0] = make_uint4(
        static_cast<uint32_t>(ny[0] >> 32), static_cast<uint32_t>(ny[1] >> 32),
        static_cast<uint32_t>(ny[2] >> 32), static_cast<uint32_t>(ny[3] >> 32));
  };
  // the results of anchors [a0, a0 + 32) from the ring to the outputs
  auto flush = [&](int a0) {
    const int s0 = a0 % kRing;
#pragma unroll
    for (int m = 0; m < kFill / kG; ++m) {
      const int a = a0 + gl + kG * m, s = s0 + gl + kG * m;
      if (a < n) {
        sco[a] = rsc[s];
        par[a] = rpar[s];
        pk[a] = rpk[s];
      }
    }
  };

  for (int k = gl; k < bm_words; k += kG) bits[k] = 0;
  load_block(0);
  const int n_max = __reduce_max_sync(kFull, n);
  int st = 0;                 // the two-pointer, with the max_iter cap
  uint64_t xpre = n > 0 ? __ldg(x + min(gl, n - 1)) : 0;     // x[st + gl]
  int64_t visited = 0, loaded = 0, deep = 0;
  int slot = 0;               // i % kRing
  for (int i = 0; i < n_max; ++i) {
    if ((i & (kFill - 1)) == 0) {
      if (i > 0) flush(i - kFill);
      store_block(i);         // into the slots of anchors i - 96 .. i - 65
      load_block(i + kFill);
      __syncwarp();
    }
    const bool active = i < n;
    const uint32_t pos_i = rpos[slot], rid_i = rrid[slot], q_i = rq[slot];
    const uint32_t yh_i = ryh[slot];
    const uint64_t xi = (static_cast<uint64_t>(rid_i) << 32) | pos_i;
    // host_kernel.cpp:56-57 on the unsigned 64-bit x (mdx >= 0), 8 at a
    // time (a group whose st has stopped takes no part in another group's
    // round: its x[st + gl] are stale)
    bool go = active;
    unsigned all;             // the ballot of every group's lanes
    do {
      const bool c = go && st + gl < i && xi > xpre && xi - xpre > umdx;
      all = __ballot_sync(kFull, c);
      const unsigned b = (all >> gshift) & 0xffu;
      const int adv = __ffs(~b) - 1;
      st += adv;
      go = adv == kG;
      if (go) xpre = __ldg(x + min(st + gl, n - 1));
    } while (__vcmpeq4(all, kFull) != 0);   // a group whose 8 lanes all advanced
    if (i - st > max_iter) st = i - max_iter;
    const int lo = (window > 0 && i - window > st) ? i - window : st;
    const int wn = active ? i - lo : 0;   // candidates in the window
    if (active) xpre = __ldg(x + min(st + gl, n - 1));        // the next anchor's
    const int span_i = static_cast<int>(yh_i & 0xff);
    const uint32_t sid_i = (yh_i >> 16) & 0xff;
    // quads: chunk c's lane l holds the anchors of quad qd - 8c - l, that is
    // j = 4 (qd - 8c - l) + 3 - k for k = 0..3 in visit order, at virtual
    // position t = 32c + 4l + k = p + off (p = i - 1 - j the visit position;
    // the first quad's positions before off hold no candidate)
    const int qd = (i - 1) >> 2;
    const int off = 3 - ((i - 1) & 3);
    const int ring_lo = (i & ~(kFill - 1)) - 2 * kFill;   // j >= ring_lo lies in the ring

    int max_f = span_i;       // the running max, seeded with q_span
    int max_j = -1;
    int nskip = 0;
    int done = wn;            // candidates visited
    bool live = wn > 0;
    bool wrote = false;       // marks went into the bitmap
    int c0 = 0;               // the chunk's first virtual position
    bool more, again;
    do {
      const bool here = live;   // the group has candidates in this chunk
      const int quad = qd - (c0 >> 2) - gl;
      const int j0 = kR * quad + 3;      // the lane's first candidate
      int sc[kR], far[kR];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        sc[k] = 0;
        far[k] = -1;
      }
      unsigned val = 0;       // bit k: candidate k is valid
      unsigned mk = 0;        // bit u: a mark at virtual position c0 + u
      int mloc = INT_MIN;
      const int cnt = here ? max(0, min(j0, i - 1) - max(j0 - kR + 1, lo) + 1) : 0;
      if (cnt > 0) {
        uint4 vpos, vrid, vq, vyh;
        int4 vsc, vpar;
        if (kR * quad >= ring_lo) {
          const int s = (quad % kQuads) * kR;
          vpos = reinterpret_cast<const uint4*>(rpos + s)[0];
          vrid = reinterpret_cast<const uint4*>(rrid + s)[0];
          vq = reinterpret_cast<const uint4*>(rq + s)[0];
          vyh = reinterpret_cast<const uint4*>(ryh + s)[0];
          vsc = reinterpret_cast<const int4*>(rsc + s)[0];
          vpar = reinterpret_cast<const int4*>(rpar + s)[0];
        } else {
          const int a = kR * quad;
          uint64_t gx[kR], gy[kR];
          int gs[kR], gp[kR];
#pragma unroll
          for (int k = 0; k < kR; ++k) {
            gx[k] = a + k >= lo ? __ldg(x + a + k) : 0;
            gy[k] = a + k >= lo ? __ldg(y + a + k) : 0;
            gs[k] = a + k >= lo ? sco[a + k] : 0;
            gp[k] = a + k >= lo ? par[a + k] : -1;
          }
          deep += cnt;
          vpos = make_uint4(static_cast<uint32_t>(gx[0]), static_cast<uint32_t>(gx[1]),
                            static_cast<uint32_t>(gx[2]), static_cast<uint32_t>(gx[3]));
          vrid = make_uint4(static_cast<uint32_t>(gx[0] >> 32), static_cast<uint32_t>(gx[1] >> 32),
                            static_cast<uint32_t>(gx[2] >> 32), static_cast<uint32_t>(gx[3] >> 32));
          vq = make_uint4(static_cast<uint32_t>(gy[0]), static_cast<uint32_t>(gy[1]),
                          static_cast<uint32_t>(gy[2]), static_cast<uint32_t>(gy[3]));
          vyh = make_uint4(static_cast<uint32_t>(gy[0] >> 32), static_cast<uint32_t>(gy[1] >> 32),
                           static_cast<uint32_t>(gy[2] >> 32), static_cast<uint32_t>(gy[3] >> 32));
          vsc = make_int4(gs[0], gs[1], gs[2], gs[3]);
          vpar = make_int4(gp[0], gp[1], gp[2], gp[3]);
        }
        const uint32_t qpos[kR] = {vpos.w, vpos.z, vpos.y, vpos.x};   // j descending
        const uint32_t qrid[kR] = {vrid.w, vrid.z, vrid.y, vrid.x};
        const uint32_t qq[kR] = {vq.w, vq.z, vq.y, vq.x};
        const uint32_t qyh[kR] = {vyh.w, vyh.z, vyh.y, vyh.x};
        const int qsc[kR] = {vsc.w, vsc.z, vsc.y, vsc.x};
        const int qpar[kR] = {vpar.w, vpar.z, vpar.y, vpar.x};
        // a valid candidate: its score, and its mark
        auto keep = [&](int k, int score) {
          sc[k] = score;
          val |= 1u << k;
          mloc = max(mloc, score);
          const int pj = qpar[k];
          if (pj >= lo) {                 // a mark inside the window
            const int m = kR * qd + 3 - pj;   // its virtual position, > t
            if (m < c0 + kChunk)
              mk |= 1u << (m - c0);
            else
              far[k] = m;
          }
        };
        // a quad of the anchor's sid in a read of one segment, not cdna, bw
        // < 2^22: the same-sid rules alone (the main path's every quad)
        const bool one_sid =
            plain && (((qyh[0] ^ yh_i) | (qyh[1] ^ yh_i) | (qyh[2] ^ yh_i) | (qyh[3] ^ yh_i)) &
                      0xff0000u) == 0;
        if (one_sid) {
#pragma unroll
          for (int k = 0; k < kR; ++k) {
            const int j = j0 - k;
            const int dr = static_cast<int>(pos_i - qpos[k]);
            const int dq = static_cast<int>(q_i - qq[k]);
            const int d = static_cast<int>(static_cast<uint32_t>(dr) -
                                           static_cast<uint32_t>(dq));
            const int dd = d < 0 ? static_cast<int>(0u - static_cast<uint32_t>(d)) : d;
            if (j >= lo && j < i && rid_i == qrid[k] && dr != 0 && dq > 0 && dq <= mdxy &&
                dd <= bw) {
              const int log_dd = dd > 0 ? 31 - __clz(dd) : 0;
              const int c_lin = static_cast<int>(__dmul_rn(
                  __dmul_rn(static_cast<double>(max(dd, 0)), 0.01), avg));
              keep(k, static_cast<int>(static_cast<uint32_t>(min(min(dq, dr), span_i)) -
                                       static_cast<uint32_t>(c_lin + (log_dd >> 1)) +
                                       static_cast<uint32_t>(qsc[k])));
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kR; ++k) {
            const int j = j0 - k;
            if (j >= lo && j < i) {
              const int dr = static_cast<int>(pos_i - qpos[k]);
              const int dq = static_cast<int>(q_i - qq[k]);
              const bool same_sid = sid_i == ((qyh[k] >> 16) & 0xff);
              const int d = static_cast<int>(static_cast<uint32_t>(dr) -
                                             static_cast<uint32_t>(dq));
              const int dd = d < 0 ? static_cast<int>(0u - static_cast<uint32_t>(d)) : d;
              const bool valid = rid_i == qrid[k] &&
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
                keep(k, static_cast<int>(static_cast<uint32_t>(sc0) +
                                         static_cast<uint32_t>(bonus ? 1 : 0) -
                                         static_cast<uint32_t>(gap) +
                                         static_cast<uint32_t>(qsc[k])));
              }
            }
          }
        }
      }
      // the group's marks in this chunk, and those earlier chunks left here
#pragma unroll
      for (int s = 1; s < kG; s <<= 1) mk |= __shfl_xor_sync(kFull, mk, s, kG);
      if (here && c0 > 0) mk |= bits[c0 >> 5];

      // the running max before each lane: an exclusive max-scan, seeded
      int incl = mloc;
#pragma unroll
      for (int s = 1; s < kG; s <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, s, kG);
        if (gl >= s) incl = max(incl, v);
      }
      int run = __shfl_up_sync(kFull, incl, 1, kG);
      run = gl == 0 ? max_f : max(max_f, run);
      // the lane's walk: improvements, skips, and the prefix sums of +1 a
      // skip and -1 an improvement
      unsigned imp = 0, skip = 0;
      int ps[kR];
      int s_loc = 0, m_loc = INT_MAX;
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const bool v = (val >> k) & 1u;
        const bool im = v && sc[k] > run;
        if (v) run = max(run, sc[k]);
        const bool sk = v && !im && ((mk >> (gl * kR + k)) & 1u);
        imp |= static_cast<unsigned>(im) << k;
        skip |= static_cast<unsigned>(sk) << k;
        s_loc += (sk ? 1 : 0) - (im ? 1 : 0);
        ps[k] = s_loc;
        m_loc = min(m_loc, s_loc);
      }
      // (sum, prefix minimum) over the lanes: (s1, m1) then (s2, m2) is
      // (s1 + s2, min(m1, s1 + m2))
      int S = s_loc, M = m_loc;
#pragma unroll
      for (int s = 1; s < kG; s <<= 1) {
        const int sv = __shfl_up_sync(kFull, S, s, kG);
        const int mv = __shfl_up_sync(kFull, M, s, kG);
        if (gl >= s) {
          M = min(mv, sv + M);
          S = sv + S;
        }
      }
      const int O = S - s_loc;                      // the lanes before's sum
      int X = __shfl_up_sync(kFull, M, 1, kG);      // and their prefix minimum
      X = gl == 0 ? INT_MAX : X;
      int brk = kR;                                 // the lane's first break
      int nlast = 0;
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int Sk = O + ps[k];
        X = min(X, Sk);
        const int nk = Sk - min(-nskip, X);
        if (brk == kR && ((skip >> k) & 1u) && nk > max_skip) brk = k;
        nlast = nk;
      }
      const unsigned bb = (__ballot_sync(kFull, brk < kR) >> gshift) & 0xffu;
      const int L = bb ? __ffs(bb) - 1 : kG;        // the group's breaking lane
      const int lim = gl < L ? kR : (gl == L ? brk : 0);
      int last = -1, vlast = 0;
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        if (k < lim && ((imp >> k) & 1u)) {
          last = k;
          vlast = sc[k];
        }
      }
      const unsigned ib = (__ballot_sync(kFull, last >= 0) >> gshift) & 0xffu;
      const int src = gshift + (ib ? 31 - __clz(ib) : 0);
      const int best_v = __shfl_sync(kFull, vlast, src);
      const int best_j = __shfl_sync(kFull, j0 - last, src);
      // the break's count of visited candidates, or the n_skip carry
      const int tail = __shfl_sync(kFull, L < kG ? c0 + gl * kR + brk + 1 - off : nlast,
                                   gshift + (L < kG ? L : kG - 1));
      if (here) {
        loaded += cnt;
        if (ib) {
          max_f = best_v;
          max_j = best_j;
        }
        if (L < kG) {
          done = tail;
          live = false;
        } else {
          nskip = tail;
          if (kR * (qd - (c0 >> 2)) - kChunk + 3 < lo) live = false;   // the window ends here
        }
      }
      more = live;
      if (more) {            // marks past this chunk, for the chunks to come
#pragma unroll
        for (int k = 0; k < kR; ++k)
          if (far[k] >= 0) atomicOr(bits + (far[k] >> 5), 1u << (far[k] & 31));
        wrote = true;
      }
      c0 += kChunk;
      again = __any_sync(kFull, more);
      if (again) __syncwarp();   // the far marks before the next chunk reads them
    } while (again);
    if (active) {
      visited += done;
      if (gl == 0) {
        rsc[slot] = max_f;
        rpar[slot] = max_j;
        int pkj = 0;
        if (max_j >= 0) pkj = max_j >= ring_lo ? rpk[max_j % kRing] : pk[max_j];
        rpk[slot] = (max_j >= 0 && pkj > max_f) ? pkj : max_f;
      }
      if (wrote)            // the bitmap words this anchor may have written
        for (int k = 1 + gl; k < (wn + off + 31) >> 5; k += kG) bits[k] = 0;
    }
    slot = slot + 1 == kRing ? 0 : slot + 1;
    __syncwarp();
  }
  if (n_max > 0) flush(((n_max - 1) / kFill) * kFill);
#pragma unroll
  for (int s = 1; s < kG; s <<= 1) {      // visited is the same in every lane
    loaded += __shfl_xor_sync(kFull, loaded, s, kG);
    deep += __shfl_xor_sync(kFull, deep, s, kG);
  }
  if (r >= 0 && gl == 0) {
    visited_out[r] = visited;
    if (ring_out != nullptr) {
      ring_out[2 * r] = loaded;
      ring_out[2 * r + 1] = deep;
    }
  }
}

}  // namespace

// x, y (T,) u64 anchors of all reads, read r at [offs[r], offs[r+1]) (offs
// (R+1,) i64); order (R,) i64, the reads in launch order; per read avg_qspan
// f32 and max_dist_x, max_dist_y, bw, n_segs i32.  window 0 means no cap.
// max_window is at least the largest count of candidates any anchor has
// (its window's width); it sizes the bitmap of the max_skip marks.  scores,
// parents (read-local, -1 for none), peak (T,) i32 and visited (R,) i64 are
// written; ring (R, 2) i64, where given, gets each read's candidates loaded
// and how many of them came from global memory past the ring.  Launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch
// (0 on success; cudaErrorInvalidValue for a negative count, and for a
// window whose bitmap a block cannot hold, which the wrapper refuses first).
extern "C" int gb_chain_dp(
    const void* x, const void* y, const void* offs, const void* order,
    const void* avg_qspan, const void* max_dist_x, const void* max_dist_y,
    const void* bw, const void* n_segs, int64_t n_reads, int max_iter,
    int max_skip, int is_cdna, int window, int max_window, void* scores,
    void* parents, void* peak, void* visited, void* ring, void* stream) {
  if (n_reads <= 0) return 0;
  if (max_iter < 0 || max_skip < 0 || window < 0 || max_window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bm_words = (max_window + 3 + 31) / 32;     // virtual positions up to wn + 2
  const int64_t warp_bytes = static_cast<int64_t>(kGroups) * group_bytes(bm_words);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (warp_bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  const int shared = static_cast<int>(warp_bytes);
  err = cudaFuncSetAttribute(chain_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chain_group_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n_reads + kGroups - 1) / kGroups;    // a warp each
  chain_group_kernel<<<static_cast<unsigned>(blocks), 32, shared,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<const uint64_t*>(y),
      static_cast<const int64_t*>(offs), static_cast<const int64_t*>(order),
      static_cast<const float*>(avg_qspan), static_cast<const int32_t*>(max_dist_x),
      static_cast<const int32_t*>(max_dist_y), static_cast<const int32_t*>(bw),
      static_cast<const int32_t*>(n_segs), n_reads, max_iter, max_skip, is_cdna, window,
      bm_words, static_cast<int32_t*>(scores), static_cast<int32_t*>(parents),
      static_cast<int32_t*>(peak), static_cast<int64_t*>(visited),
      static_cast<int64_t*>(ring));
  return static_cast<int>(cudaGetLastError());
}
