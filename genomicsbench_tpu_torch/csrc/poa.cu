// Partial-order alignment (poa, spoa) for Hopper: the graph-vs-query NW fill
// and its backtrack, two kernels.
//
// gb_poa_fill replaces the JAX package's `_poa_dp_core`
// (genomicsbench_tpu/ops/poa.py:264-385, compiled as `_poa_dp_packed` at
// :396) and gb_poa_backtrack its `_backtrack_batch` (:414-505).  Both compute
// what the port's plain versions `poa_fill_reference` and
// `poa_backtrack_reference` (ops/poa.py) compute, integer for integer.
//
// Fill.  One block per window, threads across the query columns, two
// adjacent columns a thread: thread t owns columns 2t and 2t + 1 of each tile
// of 2T columns (T threads, at most 512), so a window of qlen + 1 <= 1,024
// columns is one tile per row.  Rows are the window's nodes in topological
// order, and each block loops to its own window's n; the slab's blocks are
// issued longest window first (the slab comes sorted by its longest read,
// ascending).  A row reads up to p_pad predecessor rows of H, F1 and F2.
// Those rows are the chain: row r + 1 reads what row r has just written, so
// they live in a ring of the last R rows in shared memory (R from the
// wrapper: the largest power of two whose 12 (q_pad + 3) bytes a row fit in
// about 100 KB, at most 32; 8 at q_pad 1,024, so two blocks share an SM).  A
// predecessor of rank pv is read from the ring when (r0 + 1) - pv < R, else
// from a device scratch of (n + 1) x (qlen + 1) int32 per array at the
// window's offset.  Only the rows that some later node reads from beyond
// the ring are written there: the block marks them in a shared bitset by one
// parallel pass over its n x p_pad predecessor plane before the first row.
// The predecessor list of the next row is loaded while this row computes
// (one 4- or 8-byte load per 2 or 4 slots), and the slot loop is unrolled
// for p_pad 1, 2, 4 and 8 (a loop otherwise).  M, F1 and F2 take the first
// maximal predecessor slot, an empty slot counting as NEG at its own index,
// as JAX's masked argmax does.  The loop skips the empty slots (most nodes
// have one predecessor in slots of 2 or 4) and puts their NEG back after,
// where the live maximum is at or below NEG (a real value can be: column
// 0's diagonal is NEG + sub); both gap opens take one running maximum of
// the predecessors' H, since they subtract constants from it.  The
// query-gap pieces E1 and E2 are closed-form (El(j) = max_{k<j} clamp(GF(k)
// + k*el) - ol - j*el, the smallest k on a tie) by a block-wide exclusive
// max-scan over the key value << b | (2^b - 1 - k): warp shuffles over each
// thread's pair, then one shared-memory pass over the warp totals (a
// `redux` per warp), with a carry from tile to tile.  The clamp keeps the
// value within +-2^19, so where q_pad <= 2,048 the key fits int32 with b =
// 11 and orders exactly as the wide key does; above, b = 14 in int64.  (JAX
// packs the key into int32 with a multiplier of q_pad + 1, which wraps past
// qlen once q_pad >= 4096; neither key here wraps.)  The trace cell is
// JAX's uint16: 3-bit move (priority M > F1 > F2 > E1 > E2) and 13-bit aux
// (predecessor slot, or gap origin column), stored two a thread as one
// 4-byte word where the row's offset is even.  Two __syncthreads() a row
// at one tile (the scan's warp totals, double-buffered; then the row's
// ring writes before the next row reads them), one more per extra tile.
// The thread of column qlen keeps the best sink (smallest rank on a tie).
//
// Bound.  Per DP cell (node, column) at the card's int32 rate, counting what
// the recurrence needs at its best form, one instruction per operation:
//   per predecessor slot: the diagonal add, two open and two extend
//   subtractions (o + e folded), five running maxima with their slot
//   (compare and select each: 10), the slot test                     14
//   per cell: the substitution (compare, select), two extend-or-open
//   choices (compare, two selects each: 6), GF (2 max), two keys (add,
//   clamp as 2, shift-or: 4 each: 8), two running maxima (2), two E values
//   from the keys (shift, mask, two subtractions: 4 each: 8), H (2 max),
//   the move and aux by priority (5 compares, 8 selects: 13), the trace
//   cell (shift-or: 2) and two addresses                              45
// (POA_INT32_OPS_PER_SLOT and POA_INT32_OPS_PER_CELL = 40, rounded down, in
// ops/poa.py).  Bytes: the inputs once (planes, queries) and the traces,
// 2 per cell; the scratch rows are this design's, not the function's, and
// are left out, so the bound is a floor.  What the ring removes is latency,
// not bytes: each slot used to cost two dependent round trips to L2 on the
// row chain.
//
// Backtrack.  One warp per window, a block each, so a slab's windows
// spread over every SM.  The walk is a pointer chase: a node step reads
// the trace cell (r - 1, j), whose aux picks the predecessor slot whose
// rank is the next row, over at most n + qlen steps; reading both from
// device memory put two dependent round trips on each step, since the fill
// has just streamed the slab's traces (hundreds of MB) through L2.  Moves
// never raise r or j and predecessors lie a few ranks back, so a tile of
// kBtRows x kBtCols trace cells (and the same rows' predecessor slots,
// where p_pad <= kBtPredCap), anchored at the cell the walk reads next,
// carries the walk for tens of steps: lane 0 walks from shared memory and
// the warp loads the next tile when a node step's cell falls off it (a far
// predecessor, a long query gap).  The steps are those of JAX's lockstep
// walk, kept exactly (gap origin, aux clamp, kNoPred, query-only steps at
// r = 0).  It writes the entries rank * (q_pad + 1) + jcode (rank 0:
// query-only column; jcode 0: graph gap) or, when asked, the 4-bit code
// stream of native/poa.cpp's gb_poa_decode_path, eight nibbles to a word,
// in backward order, staged in shared memory and stored by the warp, then
// zeroes the rest of its row.  About 12 int32 operations a step (the move
// tests, the entry, the next rank, column and gap origin, the store;
// POA_BT_INT32_OPS_PER_STEP in ops/poa.py); its time is the longest
// walk's chain: a shared-memory step each (two dependent shared loads) and
// a tile load (one device round trip, all of the tile's cp.async in
// flight) every few tens of steps.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 29);
constexpr int kClamp = 1 << 19;
constexpr int kAuxBits = 13;
constexpr int kAuxMask = (1 << kAuxBits) - 1;
constexpr unsigned kNoPred = 0xFFFFu;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxQPad = 1 << kAuxBits;
constexpr int kShortKeyQPad = 2048;    // int32 E keys up to this q_pad
constexpr int kMaxShared = 232448;     // bytes a block may opt in to
constexpr int kBtRows = 64;           // trace rows a backtrack tile holds
constexpr int kBtCols = 64;           // trace columns a backtrack tile holds
constexpr int kBtChunks = kBtCols / 8 + 1;    // 16-byte chunks a tile row holds
constexpr int kBtPitch = 8 * kBtChunks;       // elements a tile row holds
constexpr int kBtPredCap = 32;        // p_pad up to this: the tile holds the predecessor slots
constexpr int kBtOut = 256;           // path words staged before the warp stores them
constexpr int kMoveM = 0, kMoveF1Open = 1, kMoveF1Ext = 2, kMoveF2Open = 3, kMoveF2Ext = 4,
              kMoveE1 = 5, kMoveE2 = 6;

struct Scores {
  int match, mism, o1, e1, o2, e2;   // gap penalties positive
};

// The E key, value << kBits | (2^kBits - 1 - column), in K.
template <typename K>
struct Key;

template <>
struct Key<int> {
  static constexpr int kBits = 11;
  static constexpr int kLow = (1 << kBits) - 1;
  static constexpr int kMin = INT_MIN;
  __device__ static int make(int v, int j) {
    return static_cast<int>(static_cast<unsigned>(v) << kBits) | (kLow - j);
  }
  __device__ static int value(int k) { return k >> kBits; }
  __device__ static int col(int k) { return kLow - (k & kLow); }
  __device__ static int warp_max(int x) { return __reduce_max_sync(kFull, x); }
};

template <>
struct Key<long long> {
  static constexpr int kBits = 14;
  static constexpr long long kLow = (1LL << kBits) - 1;
  static constexpr long long kMin = LLONG_MIN;
  __device__ static long long make(int v, int j) {
    return (static_cast<long long>(v) << kBits) | (kLow - j);
  }
  __device__ static int value(long long k) { return static_cast<int>(k >> kBits); }
  __device__ static int col(long long k) { return static_cast<int>(kLow - (k & kLow)); }
  __device__ static long long warp_max(long long x) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) x = max(x, __shfl_xor_sync(kFull, x, d));
    return x;
  }
};

// ints a ring row: two guard columns (column -1 reads NEG), then q_pad + 1
// columns rounded up to even, so a thread's pair is one 8-byte access
__host__ __device__ inline int ring_stride(int q_pad) { return ((q_pad + 2) & ~1) + 2; }

__host__ __device__ inline int64_t fill_shared_bytes(int ring, int n_pad, int q_pad) {
  return 12LL * ring * ring_stride(q_pad) + ((q_pad + 15) & ~15) + 4LL * ((n_pad + 32) >> 5);
}

__device__ __forceinline__ int gap_value(int gf, int j, int e) {
  return min(max(gf + j * e, -kClamp), kClamp);
}

// The P predecessor slots of one node, two to a 32-bit word: one 4-byte
// load for 2, 8-byte loads for 4 and 8, where the plane is 8-byte aligned.
template <int P>
__device__ __forceinline__ void load_slots(const uint16_t* row, bool vec,
                                           unsigned (&pw)[(P + 1) / 2]) {
  if constexpr (P >= 4) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < P / 4; ++k) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(row) + k);
        pw[2 * k] = x.x;
        pw[2 * k + 1] = x.y;
      }
      return;
    }
  } else if constexpr (P == 2) {
    if (vec) {
      pw[0] = __ldg(reinterpret_cast<const unsigned*>(row));
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < (P + 1) / 2; ++k) pw[k] = 0;
#pragma unroll
  for (int s = 0; s < P; ++s) pw[s / 2] |= static_cast<unsigned>(__ldg(row + s)) << (16 * (s & 1));
}

// The pieces of one column over the live slots: M, the H that F1 and F2
// open from, and F1 and F2 extended, each a value and its first slot.  The
// opens subtract a constant from the same H, so one running maximum serves
// both: F1's open is Hmax - o1 - e1 at slot Hi, F2's Hmax - o2 - e2 at the
// same slot.  `close` then puts back the empty slots, which JAX's masked
// argmax counts as NEG at their own index: a real value can lie at or below
// NEG (column 0's diagonal is NEG + sub), so the first empty slot e wins
// where the live maximum lies below NEG, or equals it at a later slot.
struct Pieces {
  int Mv = INT_MIN, Mi = 0, Hv = INT_MIN, Hi = 0, ex1 = INT_MIN, ex1i = 0, ex2 = INT_MIN,
      ex2i = 0;
  int op1 = 0, op1i = 0, op2 = 0, op2i = 0;   // set by `opens`
  __device__ __forceinline__ static void first_max(int v, int s, int& best, int& at) {
    if (v > best) {
      best = v;
      at = s;
    }
  }
  __device__ __forceinline__ static void with_empty(int e, int& best, int& at) {
    if (best < kNeg || (best == kNeg && e < at)) {
      best = kNeg;
      at = e;
    }
  }
  __device__ __forceinline__ void take(int hdiag, int h, int f1, int f2, int sub, int s,
                                       const Scores& sc) {
    first_max(hdiag + sub, s, Mv, Mi);
    first_max(h, s, Hv, Hi);
    first_max(f1 - sc.e1, s, ex1, ex1i);
    first_max(f2 - sc.e2, s, ex2, ex2i);
  }
  // the opens from the live slots' H (INT_MIN where no slot is live)
  __device__ __forceinline__ void opens(const Scores& sc) {
    const bool any = Hv != INT_MIN;
    op1 = any ? Hv - sc.o1 - sc.e1 : INT_MIN;
    op2 = any ? Hv - sc.o2 - sc.e2 : INT_MIN;
    op1i = op2i = Hi;
  }
  // the least of the five: the empty slots matter only where it is <= NEG
  __device__ __forceinline__ int low() const {
    return min(min(Mv, min(op1, ex1)), min(op2, ex2));
  }
  __device__ __forceinline__ void close(int e) {
    with_empty(e, Mv, Mi);
    with_empty(e, op1, op1i);
    with_empty(e, ex1, ex1i);
    with_empty(e, op2, op2i);
    with_empty(e, ex2, ex2i);
  }
};

// Two blocks of 512 threads an SM where the keys are int32 (64 registers a
// thread), one where they are int64, whose keys take twice the registers.
template <int P, typename K>
__global__ void __launch_bounds__(kMaxThreads, sizeof(K) == 4 ? 2 : 1) poa_fill_kernel(
    const uint8_t* __restrict__ basep, const uint16_t* __restrict__ predp,
    const int32_t* __restrict__ n_arr, const int8_t* __restrict__ seq,
    const int32_t* __restrict__ qlen_arr, const int64_t* __restrict__ cell_off,
    const int64_t* __restrict__ trace_off, int n_pad, int p_pad, int q_pad, int k0, int ring,
    Scores sc, int32_t* H, int32_t* F1, int32_t* F2, uint16_t* __restrict__ trace,
    int32_t* __restrict__ score_out, int32_t* __restrict__ best_rank_out) {
  using KT = Key<K>;
  constexpr int PA = P > 0 ? P : 1;
  extern __shared__ int4 smem[];
  __shared__ K s_tot[2][2][kMaxWarps];     // [tile parity][piece][warp]
  const int S = ring_stride(q_pad);
  int* ringH = reinterpret_cast<int*>(smem);    // [3][ring][S]: H, F1, F2
  int* ringF1 = ringH + ring * S;
  int* ringF2 = ringF1 + ring * S;
  int8_t* s_seq = reinterpret_cast<int8_t*>(ringF2 + ring * S);
  unsigned* s_far = reinterpret_cast<unsigned*>(s_seq + ((q_pad + 15) & ~15));
  const int64_t b = static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x;   // longest first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;
  const int pp_n = P > 0 ? P : p_pad;
  const int n = n_arr[b], qlen = qlen_arr[b], W = qlen + 1;
  const int rmask = ring - 1;
  // the scratch rows are written and read back by this block: plain loads
  int32_t* Hb = H + cell_off[b];
  int32_t* F1b = F1 + cell_off[b];
  int32_t* F2b = F2 + cell_off[b];
  const int64_t toff = trace_off[b];
  uint16_t* Tb = trace + toff;
  const uint8_t* bp = basep + b * n_pad;
  const uint16_t* pp = predp + b * static_cast<int64_t>(n_pad) * pp_n;

  for (int x = tid; x < (n + 32) >> 5; x += T) s_far[x] = 0;
  for (int x = tid; x < 3 * ring; x += T) {
    ringH[x * S] = kNeg;
    ringH[x * S + 1] = kNeg;
  }
  for (int j = tid; j < W; j += T) s_seq[j] = seq[b * q_pad + j];
  __syncthreads();
  // the ranks that some node reads from beyond the ring
  for (int x = tid; x < n * pp_n; x += T) {
    const unsigned pv = pp[x];
    if (pv != kNoPred && x / pp_n + 1 - static_cast<int>(pv) >= ring)
      atomicOr(&s_far[pv >> 5], 1u << (pv & 31));
  }
  __syncthreads();
  // virtual start row (rank 0): the leading query gap, convex cost
  const bool far0 = s_far[0] & 1u;
  for (int j = tid; j < W; j += T) {
    const int h0 = j == 0 ? 0 : max(-sc.o1 - j * sc.e1, -sc.o2 - j * sc.e2);
    ringH[2 + j] = h0;
    ringF1[2 + j] = kNeg;
    ringF2[2 + j] = kNeg;
    if (far0) {
      Hb[j] = h0;
      F1b[j] = kNeg;
      F2b[j] = kNeg;
    }
  }
  __syncthreads();

  const bool vec = (reinterpret_cast<uintptr_t>(predp) & 7) == 0;
  const int tiles = (W + 2 * T - 1) / (2 * T);
  int best_v = INT_MIN, best_r = 0;    // the best sink, kept by column qlen's thread
  int par = 0;
  constexpr int PW = (PA + 1) / 2;
  unsigned nxt[PW];
  if (P > 0 && n > 0) load_slots<PA>(pp, vec, nxt);
  int nbase = n > 0 ? bp[0] : 0;
  for (int r0 = 0; r0 < n; ++r0) {
    unsigned sl[PW];
#pragma unroll
    for (int k = 0; k < PW; ++k) sl[k] = nxt[k];
    const int bcode = nbase;
    if (r0 + 1 < n) {                  // the next row's list, while this one computes
      if (P > 0) load_slots<PA>(pp + static_cast<int64_t>(r0 + 1) * PA, vec, nxt);
      nbase = bp[r0 + 1];
    }
    const int base = bcode & 0x7F;
    const bool sink = (bcode & 0x80) != 0;
    const int rank = r0 + 1;
    const int wrow = (rank & rmask) * S + 2;
    const bool far_w = (s_far[rank >> 5] >> (rank & 31)) & 1u;
    const uint16_t* prow = pp + static_cast<int64_t>(r0) * pp_n;
    const bool t4 = ((toff + static_cast<int64_t>(r0) * W) & 1) == 0;
    K carry1 = KT::kMin, carry2 = KT::kMin;
    for (int tile = 0; tile < tiles; ++tile) {
      const int c0 = tile * 2 * T + 2 * tid, c1 = c0 + 1;
      const bool act0 = c0 < W, act1 = c1 < W;
      Pieces pc[2];
      if (act0) {
        const int sub0 = s_seq[c0] == base ? sc.match : sc.mism;
        const int sub1 = act1 && s_seq[c1] == base ? sc.match : sc.mism;
        int empty = pp_n;                // the first empty slot: the same in every thread
#pragma unroll
        for (int s = 0; s < (P > 0 ? P : p_pad); ++s) {
          const unsigned pv = P > 0 ? (sl[(s % PA) / 2] >> (16 * (s & 1))) & 0xFFFFu
                                    : __ldg(prow + s);
          if (pv == kNoPred) {
            empty = min(empty, s);
            continue;
          }
          int hm, h0, h1 = kNeg, fa0, fa1 = kNeg, fb0, fb1 = kNeg;
          if (rank - static_cast<int>(pv) < ring) {
            const int at = (static_cast<int>(pv) & rmask) * S + 2 + c0;
            const int2 hh = *reinterpret_cast<const int2*>(ringH + at);
            const int2 fa = *reinterpret_cast<const int2*>(ringF1 + at);
            const int2 fb = *reinterpret_cast<const int2*>(ringF2 + at);
            hm = ringH[at - 1];
            h0 = hh.x, h1 = hh.y, fa0 = fa.x, fa1 = fa.y, fb0 = fb.x, fb1 = fb.y;
          } else {
            const int64_t at = static_cast<int64_t>(pv) * W + c0;
            hm = c0 == 0 ? kNeg : Hb[at - 1];
            h0 = Hb[at];
            fa0 = F1b[at];
            fb0 = F2b[at];
            if (act1) {
              h1 = Hb[at + 1];
              fa1 = F1b[at + 1];
              fb1 = F2b[at + 1];
            }
          }
          pc[0].take(hm, h0, fa0, fb0, sub0, s, sc);
          pc[1].take(h0, h1, fa1, fb1, sub1, s, sc);
        }
        pc[0].opens(sc);
        pc[1].opens(sc);
        if (empty < pp_n && min(pc[0].low(), pc[1].low()) <= kNeg) {
          pc[0].close(empty);
          pc[1].close(empty);
        }
      }
      int F1v[2], F1i[2], F2v[2], F2i[2], GF[2];
      bool F1x[2], F2x[2];
      K ka[2], kb[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const Pieces& p = pc[c];
        F1x[c] = p.ex1 > p.op1;
        F1v[c] = F1x[c] ? p.ex1 : p.op1;
        F1i[c] = F1x[c] ? p.ex1i : p.op1i;
        F2x[c] = p.ex2 > p.op2;
        F2v[c] = F2x[c] ? p.ex2 : p.op2;
        F2i[c] = F2x[c] ? p.ex2i : p.op2i;
        GF[c] = max(p.Mv, max(F1v[c], F2v[c]));
        const int j = c0 + c;
        const bool on = c ? act1 : act0;
        ka[c] = on ? KT::make(gap_value(GF[c], j, sc.e1), j) : KT::kMin;
        kb[c] = on ? KT::make(gap_value(GF[c], j, sc.e2), j) : KT::kMin;
      }
      // block-wide exclusive max-scan of both keys over the thread pairs
      K ia = max(ka[0], ka[1]), ib = max(kb[0], kb[1]);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const K ua = __shfl_up_sync(kFull, ia, d);
        const K ub = __shfl_up_sync(kFull, ib, d);
        if (lane >= d) {
          ia = max(ia, ua);
          ib = max(ib, ub);
        }
      }
      K ea = __shfl_up_sync(kFull, ia, 1);
      K eb = __shfl_up_sync(kFull, ib, 1);
      if (lane == 0) ea = eb = KT::kMin;
      if (lane == 31) {
        s_tot[par][0][warp] = ia;
        s_tot[par][1][warp] = ib;
      }
      __syncthreads();
      const K pa = KT::warp_max(lane < warp ? s_tot[par][0][lane] : KT::kMin);
      const K pb = KT::warp_max(lane < warp ? s_tot[par][1][lane] : KT::kMin);
      K run_a[2], run_b[2];
      run_a[0] = max(max(ea, pa), carry1);
      run_b[0] = max(max(eb, pb), carry2);
      run_a[1] = max(run_a[0], ka[0]);
      run_b[1] = max(run_b[0], kb[0]);
      if (tiles > 1) {
        carry1 = max(carry1, KT::warp_max(lane < nwarps ? s_tot[par][0][lane] : KT::kMin));
        carry2 = max(carry2, KT::warp_max(lane < nwarps ? s_tot[par][1][lane] : KT::kMin));
      }
      par ^= 1;
      if (act0) {
        int Hr[2];
        unsigned cell[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = c0 + c;
          int E1 = kNeg, K1 = k0, E2 = kNeg, K2 = k0;
          if (j > 0) {
            E1 = KT::value(run_a[c]) - sc.o1 - j * sc.e1;
            K1 = KT::col(run_a[c]);
            E2 = KT::value(run_b[c]) - sc.o2 - j * sc.e2;
            K2 = KT::col(run_b[c]);
          }
          const int h = max(GF[c], max(E1, E2));
          int mv = kMoveE2, ps = K2;
          if (E1 == h) { mv = kMoveE1; ps = K1; }
          if (F2v[c] == h) { mv = F2x[c] ? kMoveF2Ext : kMoveF2Open; ps = F2i[c]; }
          if (F1v[c] == h) { mv = F1x[c] ? kMoveF1Ext : kMoveF1Open; ps = F1i[c]; }
          if (pc[c].Mv == h) { mv = kMoveM; ps = pc[c].Mi; }
          Hr[c] = h;
          cell[c] = static_cast<unsigned>((mv << kAuxBits) | ps);
          if (j == qlen) {
            const int v = sink ? h : kNeg;
            if (v > best_v) {
              best_v = v;
              best_r = r0;
            }
          }
        }
        // column c1 past qlen is written to the ring too and never read
        *reinterpret_cast<int2*>(ringH + wrow + c0) = make_int2(Hr[0], Hr[1]);
        *reinterpret_cast<int2*>(ringF1 + wrow + c0) = make_int2(F1v[0], F1v[1]);
        *reinterpret_cast<int2*>(ringF2 + wrow + c0) = make_int2(F2v[0], F2v[1]);
        if (far_w) {
          const int64_t at = static_cast<int64_t>(rank) * W + c0;
          Hb[at] = Hr[0];
          F1b[at] = F1v[0];
          F2b[at] = F2v[0];
          if (act1) {
            Hb[at + 1] = Hr[1];
            F1b[at + 1] = F1v[1];
            F2b[at + 1] = F2v[1];
          }
        }
        uint16_t* tp = Tb + static_cast<int64_t>(r0) * W + c0;
        if (act1 && t4) {
          *reinterpret_cast<unsigned*>(tp) = cell[0] | (cell[1] << 16);
        } else {
          tp[0] = static_cast<uint16_t>(cell[0]);
          if (act1) tp[1] = static_cast<uint16_t>(cell[1]);
        }
      }
    }
    __syncthreads();       // this row's ring entries before the next row reads them
  }
  if (tid == (qlen % (2 * T)) / 2) {
    score_out[b] = best_v;
    best_rank_out[b] = best_r + 1;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The bytes of the chunk of `n` uint16 elements from element e (e < total)
// that lie in an array of `total` elements; cp.async fills the rest with
// zeros.
__device__ __forceinline__ int chunk_bytes(int64_t e, int n, int64_t total) {
  return e + n <= total ? 2 * n : static_cast<int>(total - e) * 2;
}

// One warp per window.  Lane 0 walks from a tile of the traces in shared
// memory: trace rows r - kBtRows .. r - 1 and columns j - kBtCols + 1 .. j
// (from column 0 at most), anchored at the cell the walk reads next, and
// the same rows' predecessor slots where p_pad <= kBtPredCap (kPredTiled;
// else a node step loads its predecessor rank from the plane).  Moves
// never raise the row or the column, so the walk stays in the tile until a
// node step's cell lies below its first row or left of its first column (a
// far predecessor, a long query gap); then the warp loads the tile anew,
// anchored there, all of it in flight at once: 16-byte cp.async chunks,
// consecutive lanes on consecutive chunks of a row, each row stored from
// the 16-byte boundary at or before its first column (a cell's index adds
// its row's offset from that boundary); the predecessor rows, contiguous
// in the plane, by 4-byte words from the even element at or before the
// first.  Gap and query-only steps read no cell.  A step's loads and stores
// are unconditional (clamped where the step reads nothing) and its choices
// selects, since every branch on the lone lane's path costs the warp a
// reconvergence.  The entries (or their
// 4-bit codes, eight to a word, kCodes) are staged in shared memory and
// stored by the warp kBtOut words at a time, coalesced, then the rest of
// the row is zeroed.  `tiles`, where given, gets each window's tile loads.
template <bool kCodes, bool kPredTiled>
__global__ void __launch_bounds__(32) poa_backtrack_kernel(
    const uint16_t* __restrict__ predp, const uint16_t* __restrict__ trace,
    const int64_t* __restrict__ trace_off, const int32_t* __restrict__ qlen_arr,
    const int32_t* __restrict__ best_rank, int n_pad, int p_pad, int q_pad, int width,
    int32_t* __restrict__ path, int32_t* __restrict__ plen, int32_t* __restrict__ tiles) {
  __shared__ __align__(16) uint16_t tile[kBtRows][kBtPitch];
  __shared__ int32_t staged[kBtOut];
  extern __shared__ __align__(16) uint16_t pred_tile[];   // kBtRows x p_pad + 4
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int qlen = qlen_arr[b], W = qlen + 1, qw = q_pad + 1;
  const int64_t toff = trace_off[b], trace_total = trace_off[gridDim.x];
  const int64_t pbase = b * n_pad * p_pad;
  const int64_t pred_total = static_cast<int64_t>(gridDim.x) * n_pad * p_pad;
  int32_t* out = path + b * static_cast<int64_t>(width);
  int r = best_rank[b], j = qlen, gk = -1, t = 0;   // lane 0's walk
  uint32_t word = 0;
  int row0 = INT_MAX, col0 = INT_MAX;   // the tile's first row and column: none yet
  int c8 = 0;                           // (toff + col0) mod 8
  int plo = 0, p1 = 0;                  // the predecessor tile's first row, its parity
  int stored = 0, loads = 0;            // path words stored; tiles loaded
  while (true) {
    int need = 0;           // 0: the walk is over; 1: its next cell is off the tile; 2: staging full
    if (lane == 0) {
      while (r > 0 || j > 0) {
        const bool in_gap = gk >= 0;
        const bool on_node = !in_gap && r > 0;
        if (on_node && (r - 1 < row0 || j < col0)) {
          need = 1;
          break;
        }
        if ((kCodes ? t >> 3 : t) - stored >= kBtOut) {
          need = 2;
          break;
        }
        const int row = on_node ? r - 1 : row0;
        const int col = on_node ? j - col0 + ((c8 + row * W) & 7) : 0;
        const unsigned cell = tile[row - row0][col];
        const int mv = on_node ? static_cast<int>(cell >> kAuxBits) : 0;
        const int aux = on_node ? static_cast<int>(cell & kAuxMask) : 0;
        const bool is_m = on_node && mv == kMoveM;
        const bool is_e = on_node && (mv == kMoveE1 || mv == kMoveE2);
        const bool is_f = on_node && !is_m && !is_e;
        const bool moves = is_m || is_f;
        const int aux_c = min(aux, p_pad - 1);
        unsigned pv;
        if constexpr (kPredTiled)
          pv = pred_tile[moves ? (row - plo) * p_pad + aux_c + p1 : 0];
        else
          pv = __ldg(predp + pbase + (moves ? static_cast<int64_t>(row) * p_pad + aux_c : 0));
        const int j_new = is_f ? j : j - 1;      // every other step consumes a query base
        const int gk_tmp = is_e ? aux : gk;
        if constexpr (kCodes) {
          const int entry = is_m ? aux_c : is_f ? p_pad + aux_c : 2 * p_pad;
          word |= static_cast<uint32_t>(entry) << (4 * (t & 7));
          staged[(t >> 3) - stored] = static_cast<int32_t>(word);
          word = (t & 7) == 7 ? 0 : word;
        } else {
          staged[t - stored] = (moves ? r : 0) * qw + (is_f ? 0 : j);
        }
        r = moves ? (pv == kNoPred ? 0 : static_cast<int>(pv)) : r;
        gk = (in_gap || is_e) && j_new > gk_tmp ? gk_tmp : -1;
        j = j_new;
        ++t;
      }
    }
    need = __shfl_sync(kFull, need, 0);
    __syncwarp();
    if (need == 0) break;
    if (need == 2) {
      for (int i = lane; i < kBtOut; i += 32) out[stored + i] = staged[i];
      stored += kBtOut;
      __syncwarp();
      continue;
    }
    const int top = __shfl_sync(kFull, r, 0), right = __shfl_sync(kFull, j, 0);
    row0 = top - kBtRows;
    col0 = max(right - kBtCols + 1, 0);
    const int64_t base = toff + col0;
    c8 = static_cast<int>(base & 7);
    const int ncols = right - col0 + 1;
    const int rr0 = max(0, -row0);
    for (int it = lane; it < (kBtRows - rr0) * kBtChunks; it += 32) {
      const int rr = rr0 + it / kBtChunks, ch = it % kBtChunks;
      const int64_t first = base + static_cast<int64_t>(row0 + rr) * W;
      const int64_t e = (first & ~7LL) + 8 * ch;
      if (e < first + ncols)
        cp_async16(&tile[rr][8 * ch], trace + e, chunk_bytes(e, 8, trace_total));
    }
    if constexpr (kPredTiled) {
      plo = max(row0, 0);
      const int64_t first = pbase + static_cast<int64_t>(plo) * p_pad;
      p1 = static_cast<int>(first & 1);
      const int n_words = (p1 + (top - plo) * p_pad + 1) >> 1;
      for (int i = lane; i < n_words; i += 32) {
        const int64_t e = (first & ~1LL) + 2 * i;
        cp_async4(pred_tile + 2 * i, predp + e, chunk_bytes(e, 2, pred_total));
      }
    }
    cp_async_wait_all();
    ++loads;
    __syncwarp();
  }
  // the staged words (the last code word is staged as it fills), then the
  // row's zero tail
  const int total = __shfl_sync(kFull, kCodes ? (t + 7) >> 3 : t, 0);
  for (int i = stored + lane; i < total; i += 32) out[i] = staged[i - stored];
  for (int i = total + lane; i < width; i += 32) out[i] = 0;
  if (lane == 0) {
    plen[b] = t;
    if (tiles != nullptr) tiles[b] = loads;
  }
}

using BacktrackKernel = decltype(&poa_backtrack_kernel<false, false>);

using FillKernel = decltype(&poa_fill_kernel<0, int>);

// The fill's instance for a slab: the slot loop unrolled for p_pad 1, 2, 4
// and 8, int32 E keys up to q_pad 2,048; and the shared memory it may use.
FillKernel fill_kernel(int p_pad, int q_pad) {
  const bool wide = q_pad > kShortKeyQPad;
  switch (p_pad) {
    case 1: return wide ? poa_fill_kernel<1, long long> : poa_fill_kernel<1, int>;
    case 2: return wide ? poa_fill_kernel<2, long long> : poa_fill_kernel<2, int>;
    case 4: return wide ? poa_fill_kernel<4, long long> : poa_fill_kernel<4, int>;
    case 8: return wide ? poa_fill_kernel<8, long long> : poa_fill_kernel<8, int>;
    default: return wide ? poa_fill_kernel<0, long long> : poa_fill_kernel<0, int>;
  }
}

cudaError_t allow_shared(FillKernel kernel, int shared) {
  if (shared <= 48 * 1024) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace

// One slab of windows.  basep (B, n_pad) u8 (base code, sink in bit 7);
// predp (B, n_pad, p_pad) u16 predecessor ranks, 0xFFFF = no slot, each
// below its node's rank; n (B,) i32 nodes, 1..n_pad; seq (B, q_pad) i8 with
// lane 0 = -1 and the query in lanes 1..qlen; qlen (B,) i32 < q_pad <= 8192;
// cell_off (B + 1,) i64 offsets of each window's (n + 1) x (qlen + 1) cells
// in H, F1 and F2 (int32 scratch, written only for the rows read from beyond
// the ring); trace_off (B + 1,) i64 offsets of its n x (qlen + 1) uint16
// trace cells.  k0: the gap origin of column 0 (JAX's sentinel, from the
// host).  Penalties o1 e1 o2 e2 positive.  threads: a multiple of 32, at
// most 512.  ring: the rows of H, F1 and F2 kept in shared memory, a power
// of two.  Writes the traces, score and best_rank (B,) i32.  Launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch
// (0 on success).
extern "C" int gb_poa_fill(const void* basep, const void* predp, const void* n,
                           const void* seq, const void* qlen, const void* cell_off,
                           const void* trace_off, int64_t n_windows, int n_pad, int p_pad,
                           int q_pad, int k0, int match, int mism, int o1, int e1, int o2,
                           int e2, int threads, int ring, void* H, void* F1, void* F2,
                           void* trace, void* score, void* best_rank, void* stream) {
  if (n_windows <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || q_pad > kMaxQPad ||
      p_pad < 1 || n_windows > INT_MAX || ring < 1 || (ring & (ring - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t shared = fill_shared_bytes(ring, n_pad, q_pad);
  if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const FillKernel kernel = fill_kernel(p_pad, q_pad);
  const cudaError_t err = allow_shared(kernel, static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_windows), threads, static_cast<int>(shared),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(basep), static_cast<const uint16_t*>(predp),
      static_cast<const int32_t*>(n), static_cast<const int8_t*>(seq),
      static_cast<const int32_t*>(qlen), static_cast<const int64_t*>(cell_off),
      static_cast<const int64_t*>(trace_off), n_pad, p_pad, q_pad, k0, ring,
      Scores{match, mism, o1, e1, o2, e2}, static_cast<int32_t*>(H), static_cast<int32_t*>(F1),
      static_cast<int32_t*>(F2), static_cast<uint16_t*>(trace), static_cast<int32_t*>(score),
      static_cast<int32_t*>(best_rank));
  return static_cast<int>(cudaGetLastError());
}

// The fill blocks one SM holds at once for a slab of these shapes, into
// *blocks (registers, shared memory and threads together); returns the CUDA
// error (0 on success).
extern "C" int gb_poa_fill_occupancy(int n_pad, int p_pad, int q_pad, int threads, int ring,
                                     void* blocks) {
  const FillKernel kernel = fill_kernel(p_pad, q_pad);
  const int shared = static_cast<int>(fill_shared_bytes(ring, n_pad, q_pad));
  cudaError_t err = allow_shared(kernel, shared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(blocks), kernel,
                                                        threads, shared);
  return static_cast<int>(err);
}

// The tables of gb_poa_fill and its traces and best_rank.  Writes each
// window's path, `width` int32 words per window: entries rank*(q_pad+1) +
// jcode in backward order (codes == 0), or the 4-bit codes, eight to a
// word (codes != 0, p_pad <= 7), the rest of the row zero; plen (B,) i32,
// the entries' count; and, where `tiles` is not null, (B,) i32 the trace
// tiles each window's walk loaded.  The traces must be 16-byte aligned and
// the predecessor plane 4-byte aligned (cudaErrorMisalignedAddress else).
// Launches on `stream`, does not synchronise, and returns the CUDA error of
// the launch.
extern "C" int gb_poa_backtrack(const void* predp, const void* trace, const void* trace_off,
                                const void* qlen, const void* best_rank, int64_t n_windows,
                                int n_pad, int p_pad, int q_pad, int codes, int width,
                                void* path, void* plen, void* tiles, void* stream) {
  if (n_windows <= 0) return 0;
  if (n_windows > INT_MAX || p_pad < 1 || q_pad > kMaxQPad)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(trace) & 15) || (reinterpret_cast<uintptr_t>(predp) & 3))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool tiled = p_pad <= kBtPredCap;
  const BacktrackKernel kernel =
      codes ? (tiled ? poa_backtrack_kernel<true, true> : poa_backtrack_kernel<true, false>)
            : (tiled ? poa_backtrack_kernel<false, true> : poa_backtrack_kernel<false, false>);
  const int shared = tiled ? (kBtRows * p_pad + 4) * 2 : 0;
  kernel<<<static_cast<unsigned>(n_windows), 32, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(predp), static_cast<const uint16_t*>(trace),
      static_cast<const int64_t*>(trace_off), static_cast<const int32_t*>(qlen),
      static_cast<const int32_t*>(best_rank), n_pad, p_pad, q_pad, width,
      static_cast<int32_t*>(path), static_cast<int32_t*>(plen), static_cast<int32_t*>(tiles));
  return static_cast<int>(cudaGetLastError());
}
