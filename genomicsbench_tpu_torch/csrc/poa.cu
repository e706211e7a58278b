// Partial-order alignment (poa, spoa) for Hopper: the graph-vs-query NW fill
// and its backtrack, two kernels.
//
// gb_poa_fill replaces the JAX package's `_poa_dp_core`
// (genomicsbench_tpu/ops/poa.py:264-385, compiled as `_poa_dp_packed` at
// :396) and gb_poa_backtrack its `_backtrack_batch` (:414-505).  Both compute
// what the port's plain versions `poa_fill_reference` and
// `poa_backtrack_reference` (ops/poa.py) compute, integer for integer.
//
// Fill.  One block per window, threads across the query columns: thread t
// owns columns t, t + T, t + 2T, ... (T threads, at most 512), so a window of
// qlen + 1 <= T columns is one tile per row.  Rows are the window's nodes in
// topological order, and each block loops to its own window's n.  A row
// gathers up to p_pad predecessor rows of H, F1 and F2, which live in a
// device scratch of (n + 1) x (qlen + 1) int32 per array at the window's
// offset (row 0 is the virtual start), so a thread reads its own columns of
// the earlier rows, coalesced across the warp.  M, F1 and F2 take the first
// maximal predecessor slot, a slot without a predecessor counting as NEG, as
// JAX's masked argmax does.  The query-gap pieces E1 and E2 are closed-form
// (El(j) = max_{k<j} clamp(GF(k) + k*el) - ol - j*el, the smallest k on a
// tie) by a block-wide exclusive max-scan over the int64 key
// value << 14 | (2^14 - 1 - k): warp shuffles, then one shared-memory pass
// over the warp totals, with a carry from tile to tile.  JAX packs the key
// into int32 with a multiplier of q_pad + 1, which wraps past qlen once
// q_pad >= 4096; the int64 key orders every column this kernel computes the
// same way and never wraps.  The trace cell is JAX's uint16: 3-bit move
// (priority M > F1 > F2 > E1 > E2) and 13-bit aux (predecessor slot, or gap
// origin column).  One __syncthreads() per tile (the scan's warp totals,
// double-buffered) and one per row, after which the next row may read this
// row's writes.  The thread of column qlen keeps the best sink (smallest
// rank on a tie).
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
// 2 per cell; the scratch rows (12 bytes per cell) are this design's, not
// the function's, and are left out, so the bound is a floor.
//
// Backtrack.  One thread per window: the walk is a pointer chase, one
// dependent load of a trace cell per step and one of a predecessor rank per
// node step, over at most n + qlen steps.  It writes the entries
// rank * (q_pad + 1) + jcode (rank 0: query-only column; jcode 0: graph gap)
// or, when asked, the 4-bit code stream of native/poa.cpp's
// gb_poa_decode_path, eight nibbles to a word, in backward order, then
// zeroes the rest of its row.  About 12 int32 operations a step (the move
// tests, the entry, the next rank, column and gap origin, the store;
// POA_BT_INT32_OPS_PER_STEP in ops/poa.py); its time is the longest walk's
// chain of dependent loads, not its operations or bytes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 29);
constexpr int kClamp = 1 << 19;
constexpr int kKeyBits = 14;
constexpr long long kKeyLow = (1LL << kKeyBits) - 1;
constexpr int kAuxBits = 13;
constexpr int kAuxMask = (1 << kAuxBits) - 1;
constexpr unsigned kNoPred = 0xFFFFu;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxQPad = 1 << kAuxBits;
constexpr int kBacktrackThreads = 64;
constexpr int kMoveM = 0, kMoveF1Open = 1, kMoveF1Ext = 2, kMoveF2Open = 3, kMoveF2Ext = 4,
              kMoveE1 = 5, kMoveE2 = 6;

struct Scores {
  int match, mism, o1, e1, o2, e2;   // gap penalties positive
};

__device__ __forceinline__ long long lmax(long long a, long long b) { return a > b ? a : b; }

__device__ __forceinline__ long long gap_key(int gf, int j, int e) {
  const int v = min(max(gf + j * e, -kClamp), kClamp);
  return (static_cast<long long>(v) << kKeyBits) | (kKeyLow - j);
}

// the running maximum of a piece and its first slot
__device__ __forceinline__ void first_max(int v, int s, int& best, int& at) {
  if (s == 0 || v > best) {
    best = v;
    at = s;
  }
}

__global__ void __launch_bounds__(kMaxThreads) poa_fill_kernel(
    const uint8_t* __restrict__ basep, const uint16_t* __restrict__ predp,
    const int32_t* __restrict__ n_arr, const int8_t* __restrict__ seq,
    const int32_t* __restrict__ qlen_arr, const int64_t* __restrict__ cell_off,
    const int64_t* __restrict__ trace_off, int n_pad, int p_pad, int q_pad, int k0, Scores sc,
    int32_t* H, int32_t* F1, int32_t* F2, uint16_t* __restrict__ trace,
    int32_t* __restrict__ score_out, int32_t* __restrict__ best_rank_out) {
  __shared__ int8_t s_seq[kMaxQPad];
  __shared__ long long s_tot[2][2][kMaxWarps];   // [tile parity][piece][warp]
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;
  const int n = n_arr[b], qlen = qlen_arr[b], W = qlen + 1;
  // H, F1 and F2 are written and read back by this block: plain loads only
  int32_t* Hb = H + cell_off[b];
  int32_t* F1b = F1 + cell_off[b];
  int32_t* F2b = F2 + cell_off[b];
  uint16_t* Tb = trace + trace_off[b];
  const uint8_t* bp = basep + b * n_pad;
  const uint16_t* pp = predp + b * static_cast<int64_t>(n_pad) * p_pad;

  // virtual start row: the leading query gap, convex cost
  for (int j = tid; j < W; j += T) {
    s_seq[j] = seq[b * q_pad + j];
    Hb[j] = j == 0 ? 0 : max(-sc.o1 - j * sc.e1, -sc.o2 - j * sc.e2);
    F1b[j] = kNeg;
    F2b[j] = kNeg;
  }
  __syncthreads();

  const int tiles = (W + T - 1) / T;
  int best_v = INT_MIN, best_r = 0;    // the best sink, kept by column qlen's thread
  int par = 0;
  for (int r0 = 0; r0 < n; ++r0) {
    const int bcode = bp[r0];
    const int base = bcode & 0x7F;
    const bool sink = (bcode & 0x80) != 0;
    const uint16_t* prow = pp + static_cast<int64_t>(r0) * p_pad;
    const int64_t row = static_cast<int64_t>(r0 + 1) * W;
    long long carry1 = LLONG_MIN, carry2 = LLONG_MIN;
    for (int tile = 0; tile < tiles; ++tile) {
      const int j = tile * T + tid;
      const bool act = j < W;
      int Mv = 0, Mi = 0, F1v = 0, F1i = 0, F2v = 0, F2i = 0, GF = 0;
      bool F1x = false, F2x = false;
      long long key1 = LLONG_MIN, key2 = LLONG_MIN;
      if (act) {
        const int sub = s_seq[j] == base ? sc.match : sc.mism;
        int op1 = 0, op1i = 0, ex1 = 0, ex1i = 0, op2 = 0, op2i = 0, ex2 = 0, ex2i = 0;
        for (int s = 0; s < p_pad; ++s) {
          const unsigned pv = prow[s];
          int dg = kNeg, o1v = kNeg, x1v = kNeg, o2v = kNeg, x2v = kNeg;
          if (pv != kNoPred) {
            const int64_t at = static_cast<int64_t>(pv) * W + j;
            const int h = Hb[at];
            dg = (j == 0 ? kNeg : Hb[at - 1]) + sub;
            o1v = h - sc.o1 - sc.e1;
            o2v = h - sc.o2 - sc.e2;
            x1v = F1b[at] - sc.e1;
            x2v = F2b[at] - sc.e2;
          }
          first_max(dg, s, Mv, Mi);
          first_max(o1v, s, op1, op1i);
          first_max(x1v, s, ex1, ex1i);
          first_max(o2v, s, op2, op2i);
          first_max(x2v, s, ex2, ex2i);
        }
        F1x = ex1 > op1;
        F1v = F1x ? ex1 : op1;
        F1i = F1x ? ex1i : op1i;
        F2x = ex2 > op2;
        F2v = F2x ? ex2 : op2;
        F2i = F2x ? ex2i : op2i;
        GF = max(Mv, max(F1v, F2v));
        key1 = gap_key(GF, j, sc.e1);
        key2 = gap_key(GF, j, sc.e2);
      }
      // block-wide exclusive max-scan of both keys
      long long in1 = key1, in2 = key2;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long u1 = __shfl_up_sync(kFull, in1, d);
        const long long u2 = __shfl_up_sync(kFull, in2, d);
        if (lane >= d) {
          in1 = lmax(in1, u1);
          in2 = lmax(in2, u2);
        }
      }
      long long run1 = __shfl_up_sync(kFull, in1, 1);
      long long run2 = __shfl_up_sync(kFull, in2, 1);
      if (lane == 0) run1 = run2 = LLONG_MIN;
      if (lane == 31) {
        s_tot[par][0][warp] = in1;
        s_tot[par][1][warp] = in2;
      }
      __syncthreads();
      long long tot1 = carry1, tot2 = carry2;
      for (int w = 0; w < nwarps; ++w) {
        const long long a = s_tot[par][0][w], c = s_tot[par][1][w];
        if (w == warp) {
          run1 = lmax(run1, tot1);
          run2 = lmax(run2, tot2);
        }
        tot1 = lmax(tot1, a);
        tot2 = lmax(tot2, c);
      }
      carry1 = tot1;
      carry2 = tot2;
      par ^= 1;
      if (act) {
        int E1 = kNeg, K1 = k0, E2 = kNeg, K2 = k0;
        if (j > 0) {
          E1 = static_cast<int>(run1 >> kKeyBits) - sc.o1 - j * sc.e1;
          K1 = static_cast<int>(kKeyLow - (run1 & kKeyLow));
          E2 = static_cast<int>(run2 >> kKeyBits) - sc.o2 - j * sc.e2;
          K2 = static_cast<int>(kKeyLow - (run2 & kKeyLow));
        }
        const int Hr = max(GF, max(E1, E2));
        int mv = kMoveE2, ps = K2;
        if (E1 == Hr) { mv = kMoveE1; ps = K1; }
        if (F2v == Hr) { mv = F2x ? kMoveF2Ext : kMoveF2Open; ps = F2i; }
        if (F1v == Hr) { mv = F1x ? kMoveF1Ext : kMoveF1Open; ps = F1i; }
        if (Mv == Hr) { mv = kMoveM; ps = Mi; }
        Hb[row + j] = Hr;
        F1b[row + j] = F1v;
        F2b[row + j] = F2v;
        Tb[static_cast<int64_t>(r0) * W + j] = static_cast<uint16_t>((mv << kAuxBits) | ps);
        if (j == qlen) {
          const int v = sink ? Hr : kNeg;
          if (v > best_v) {
            best_v = v;
            best_r = r0;
          }
        }
      }
    }
    __syncthreads();       // this row's H, F1 and F2 before the next row reads them
  }
  if (tid == qlen % T) {
    score_out[b] = best_v;
    best_rank_out[b] = best_r + 1;
  }
}

__global__ void __launch_bounds__(kBacktrackThreads) poa_backtrack_kernel(
    const uint16_t* __restrict__ predp, const uint16_t* __restrict__ trace,
    const int64_t* __restrict__ trace_off, const int32_t* __restrict__ qlen_arr,
    const int32_t* __restrict__ best_rank, int64_t n_windows, int n_pad, int p_pad, int q_pad,
    int codes, int width, int32_t* __restrict__ path, int32_t* __restrict__ plen) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_windows) return;
  const int qlen = qlen_arr[b], W = qlen + 1, qw = q_pad + 1;
  const uint16_t* tb = trace + trace_off[b];
  const uint16_t* pp = predp + b * static_cast<int64_t>(n_pad) * p_pad;
  int32_t* out = path + b * width;
  int r = best_rank[b], j = qlen, gk = -1, t = 0;
  uint32_t word = 0;
  while (r > 0 || j > 0) {
    const bool in_gap = gk >= 0;
    const bool on_node = !in_gap && r > 0;
    int mv = 0, aux = 0;
    if (on_node) {
      const unsigned cell = __ldg(tb + static_cast<int64_t>(r - 1) * W + j);
      mv = static_cast<int>(cell >> kAuxBits);
      aux = static_cast<int>(cell & kAuxMask);
    }
    const bool is_m = on_node && mv == kMoveM;
    const bool is_e = on_node && (mv == kMoveE1 || mv == kMoveE2);
    const bool is_f = on_node && !is_m && !is_e;
    const int aux_c = min(aux, p_pad - 1);
    int entry;
    if (codes) entry = is_m ? aux_c : is_f ? p_pad + aux_c : 2 * p_pad;
    else entry = (is_m || is_f ? r : 0) * qw + (is_f ? 0 : j);
    const int j_new = is_f ? j : j - 1;      // every other step consumes a query base
    if (is_m || is_f) {
      const unsigned pv = __ldg(pp + static_cast<int64_t>(r - 1) * p_pad + aux_c);
      r = pv == kNoPred ? 0 : static_cast<int>(pv);
    }
    const int gk_tmp = is_e ? aux : gk;
    gk = (in_gap || is_e) && j_new > gk_tmp ? gk_tmp : -1;
    j = j_new;
    if (codes) {
      word |= static_cast<uint32_t>(entry) << (4 * (t & 7));
      if ((t & 7) == 7) {
        out[t >> 3] = static_cast<int32_t>(word);
        word = 0;
      }
    } else {
      out[t] = entry;
    }
    ++t;
  }
  int next = t;
  if (codes) {
    if (t & 7) out[t >> 3] = static_cast<int32_t>(word);
    next = (t + 7) >> 3;
  }
  for (int i = next; i < width; ++i) out[i] = 0;
  plen[b] = t;
}

}  // namespace

// One slab of windows.  basep (B, n_pad) u8 (base code, sink in bit 7);
// predp (B, n_pad, p_pad) u16 predecessor ranks, 0xFFFF = no slot, each
// below its node's rank; n (B,) i32 nodes, 1..n_pad; seq (B, q_pad) i8 with
// lane 0 = -1 and the query in lanes 1..qlen; qlen (B,) i32 < q_pad <= 8192;
// cell_off (B + 1,) i64 offsets of each window's (n + 1) x (qlen + 1) cells
// in H, F1 and F2 (int32 scratch); trace_off (B + 1,) i64 offsets of its
// n x (qlen + 1) uint16 trace cells.  k0: the gap origin of column 0 (JAX's
// sentinel, from the host).  Penalties o1 e1 o2 e2 positive.  threads: a
// multiple of 32, at most 512.  Writes the traces, score and best_rank (B,)
// i32.  Launches on `stream`, does not synchronise, and returns the CUDA
// error of the launch (0 on success).
extern "C" int gb_poa_fill(const void* basep, const void* predp, const void* n,
                           const void* seq, const void* qlen, const void* cell_off,
                           const void* trace_off, int64_t n_windows, int n_pad, int p_pad,
                           int q_pad, int k0, int match, int mism, int o1, int e1, int o2,
                           int e2, int threads, void* H, void* F1, void* F2, void* trace,
                           void* score, void* best_rank, void* stream) {
  if (n_windows <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || q_pad > kMaxQPad ||
      p_pad < 1 || n_windows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  poa_fill_kernel<<<static_cast<unsigned>(n_windows), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(basep), static_cast<const uint16_t*>(predp),
      static_cast<const int32_t*>(n), static_cast<const int8_t*>(seq),
      static_cast<const int32_t*>(qlen), static_cast<const int64_t*>(cell_off),
      static_cast<const int64_t*>(trace_off), n_pad, p_pad, q_pad, k0,
      Scores{match, mism, o1, e1, o2, e2}, static_cast<int32_t*>(H), static_cast<int32_t*>(F1),
      static_cast<int32_t*>(F2), static_cast<uint16_t*>(trace), static_cast<int32_t*>(score),
      static_cast<int32_t*>(best_rank));
  return static_cast<int>(cudaGetLastError());
}

// The tables of gb_poa_fill and its traces and best_rank.  Writes each
// window's path, `width` int32 words per window: entries rank*(q_pad+1) +
// jcode in backward order (codes == 0), or the 4-bit codes, eight to a
// word (codes != 0, p_pad <= 7), the rest of the row zero; and plen (B,)
// i32, the entries' count.  Launches on `stream`, does not synchronise, and
// returns the CUDA error of the launch.
extern "C" int gb_poa_backtrack(const void* predp, const void* trace, const void* trace_off,
                                const void* qlen, const void* best_rank, int64_t n_windows,
                                int n_pad, int p_pad, int q_pad, int codes, int width,
                                void* path, void* plen, void* stream) {
  if (n_windows <= 0) return 0;
  const int64_t blocks = (n_windows + kBacktrackThreads - 1) / kBacktrackThreads;
  poa_backtrack_kernel<<<static_cast<unsigned>(blocks), kBacktrackThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(predp), static_cast<const uint16_t*>(trace),
      static_cast<const int64_t*>(trace_off), static_cast<const int32_t*>(qlen),
      static_cast<const int32_t*>(best_rank), n_windows, n_pad, p_pad, q_pad, codes, width,
      static_cast<int32_t*>(path), static_cast<int32_t*>(plen));
  return static_cast<int>(cudaGetLastError());
}
