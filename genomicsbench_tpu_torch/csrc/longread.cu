// Long-read banded global alignment for Hopper: one read's banded
// Needleman-Wunsch score with linear gaps, the band cut into stripes of
// query columns that run as a pipeline of warps across the card's SMs.  One
// kernel:
//
//   gb_longread_nw  replaces the JAX package's `sharded_banded_nw` `step`
//                   and its `lax.scan` over target rows
//                   (genomicsbench_tpu/ops/longread.py:113-144) on one
//                   device: D = 1, no halo, the cummax over the whole band.
//
// The JAX package holds the band in its own coordinates: lane k of target
// row i is query position j = i + k - W / 2, and a row needs the whole row
// above (diag = H[i-1][k] + s, up = H[i-1][k+1] - gap) and a max-scan along
// itself for the left chain.  Here the same recurrence runs in (target i,
// query j) coordinates: cell (i, j) lies in the band where k = j - i + W / 2
// is in [0, W), and
//   H(i, j) = max(H(i-1, j-1) + s(q[j-1], t[i-1]), H(i-1, j) - gap,
//                 H(i, j-1) - gap),
// row 0 is -gap * j, and out-of-band cells and j < 0 are NEG.  The score is
// H(n, m), lane kend = m - n + W / 2, which the host checks lies in the
// band.  Every in-band cell with 0 <= j <= m is reachable from (0, 0) inside
// the band, so its score is real, at least -(n + m) max(|s|, gap), which the
// host holds above NEG / 2; the JAX thresholds (`> NEG // 2`) therefore mark
// exactly the cells outside the band.  Here a cell left of the band has its
// diagonal-and-up part set to NEG, so it holds exactly NEG; a cell's up
// input is NEG where the cell above lies right of the band; a cell right of
// the band may then hold any value, which only cells outside the band read.
// Int32 max and add are exact in any order, so the score equals the JAX
// package's and the oracle's.
//
// Design.  A stripe is kC = 128 query columns and belongs to one warp: lane
// l holds the four columns 4l .. 4l + 3 in registers and the warp walks the
// stripe's rows (those where the band meets it, about W + kC), lane l one
// row behind lane l - 1.  A step computes one row of a lane's four columns:
// the left input comes from lane l - 1's last column by one __shfl_up_sync,
// the up and diagonal inputs are the lane's own registers from its previous
// row, and each cell is two DPX ops (__viaddmax_s32) on the chain.  No
// barrier.  Each chunk of 32 steps makes only the tests its rows need: none
// in the stripe's middle (every lane's row live, every cell in the band),
// the up input's at the band's top edge, the diagonal-and-up part's at its
// bottom edge, all of them where lanes start and end and at row 0.  The
// chunk's steps are unrolled by 4, not 32: a stripe's first rows on an SM
// find its instruction cache cold, and 32 unrolled steps missed it.
// Lane 0's left input is stripe s - 1's last column: its lane 31 writes
// each row's value to global memory as one 64-bit word (value, s), so the
// word is its own flag, and stripe s reads 32 rows at a time, one a lane,
// two chunks ahead (a reader spins only where a word's tag is not yet s).
// Each block is one warp; warps take stripes in order from an atomic
// counter, so a stripe only ever waits on one that a running warp has taken,
// never on a block that may not be resident.  (Four warps a block handing
// the column on through a ring in shared memory ran slower on the card, so
// the hand-off is global memory's alone.)  The band's width sets no limit.
//
// Bound.  The rows of one stripe are a chain, and stripe s + 1 can start a
// row only after stripe s has finished it, about kC + 31 + 32 steps after
// stripe s started that row's band (the band moves one row a column; lane
// 31 lags lane 0 by 31; the reader takes 32 rows at a time).  So the
// critical path is about m (1 + 63 / kC) steps of one shuffle and eight
// dependent DPX ops, whatever the card's width; over the whole card the
// bound is the int32 operations (LONGREAD_OPS_PER_CELL per band cell in
// ops/longread.py) at 132 SMs x 64 lanes, which this design cannot reach.
// Bytes are negligible: the query and the target, read once, and one
// hand-off word a row a stripe.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCpl = 4;                // query columns a lane
constexpr int kC = 32 * kCpl;          // query columns a stripe: one warp
constexpr int kChunk = 32;             // steps a chunk; rows a hand-off read, one a lane
constexpr int kWarpsPerSM = 4;         // blocks (one warp each) launched per SM

struct Band {
  int m, n, W, W2, match, mismatch, gap;
};

__device__ __forceinline__ unsigned long long tagged(int v, unsigned tag) {
  return (static_cast<unsigned long long>(tag) << 32) | static_cast<unsigned>(v);
}

// One warp's stripe: its columns, the registers that carry a row to the
// next, and its hand-off words.  The warp runs in chunks of 32 steps; at a
// chunk's start lane l takes the hand-off word of lane 0's row in step l of
// the chunk, loaded two chunks earlier, and each step passes it to lane 0
// by a shuffle.
struct Stripe {
  const int* t;
  Band bd;
  int lane, s, first, last, rows, jl, lo, ulast;
  int qb[kCpl], row0[kCpl], hup[kCpl];
  int dgl = kNeg, hlast = kNeg, tb = -2;
  volatile unsigned long long* edge;
  unsigned long long nxt = 0, pre = 0;   // the next two chunks' words, in flight

  // stripe s - 1's word of row r (NEG past its last row), tagged s
  __device__ unsigned long long load(int r) const {
    return r >= 0 && r <= ulast ? edge[r] : tagged(kNeg, s);
  }
  __device__ int settle(unsigned long long v, int r) const {
    // the reader runs just behind the writer: poll without backing off
    while (static_cast<unsigned>(v >> 32) != static_cast<unsigned>(s)) v = edge[r];
    return static_cast<int>(v);
  }

  // H(r0 + lane, first column - 1)
  template <bool kIn>
  __device__ __forceinline__ int chunk_in(int r0) {
    if (!kIn) return kNeg;
    const int r = r0 + lane;
    const int v = settle(nxt, r);
    nxt = pre;
    pre = load(r + 2 * kChunk);
    return v;
  }

  // One step: lane l computes row first + stp - l of its columns, lane 0
  // with u on its left.  kAll: a generic step, every test made.  The others
  // hold where every lane's row is live, past row 0 and before the last:
  // kTop, where no cell has left the band at its bottom yet (a cell above
  // the band holds a value only cells above the band read, but is NEG as
  // the next row's up input); kBottom, where every cell has entered the
  // band (a cell below it, left of the band, must be NEG); kMid, every cell
  // in the band, no test.
  enum Kind { kAll, kTop, kBottom, kMid };
  template <int kKind>
  __device__ __forceinline__ void step(int stp, int u) {
    constexpr bool kLive = kKind != kAll;
    const int i = first + stp - lane;
    const bool act = kLive || (stp >= lane && i <= last);
    int x = __shfl_up_sync(kFull, hlast, 1);
    x = lane == 0 ? u : x;
    // this lane's base for its next row, i + 1
    const int tbn = kLive || (stp + 1 >= lane && i + 1 <= last && i >= 0) ? __ldg(t + i) : -2;
    const int d = i - lo;
    int left = x, diag = dgl;
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      int B = __viaddmax_s32(diag, qb[c] == tb ? bd.match : bd.mismatch, hup[c] - bd.gap);
      const bool valid = static_cast<unsigned>(d - c) < static_cast<unsigned>(bd.W);
      if (kKind == kAll) B = i == 0 ? row0[c] : B;
      if (kKind == kAll || kKind == kBottom) B = valid ? B : kNeg;
      const int h = __viaddmax_s32(left, -bd.gap, B);
      diag = hup[c];
      if (kKind == kAll)
        hup[c] = act ? (valid ? h : kNeg) : hup[c];
      else
        hup[c] = kKind == kTop && !valid ? kNeg : h;
      left = h;
    }
    dgl = act ? x : dgl;
    hlast = act ? left : hlast;
    if (act && lane == 31) edge[i] = tagged(left, static_cast<unsigned>(s + 1));
    tb = tbn;
  }

  template <int kKind>
  __device__ __forceinline__ void chunk(int base, int cu, int end) {
    // a few steps unrolled: the whole chunk unrolled misses the instruction
    // cache, whose lines a stripe's first rows on an SM find cold
#pragma unroll 4
    for (int k = 0; k < end; ++k) step<kKind>(base + k, __shfl_sync(kFull, cu, k));
  }

  // The rows of the stripe in chunks of 32 steps, each chunk with only the
  // tests its rows need.
  template <bool kIn>
  __device__ void run(int* out) {
    int u = kNeg;                    // H(first - 1, first column - 1)
    if (kIn) {
      u = settle(load(first - 1), first - 1);
      nxt = load(first + lane);
      pre = load(first + kChunk + lane);
    }
    dgl = lane == 0 ? u : kNeg;
    if (lane == 0 && first >= 1) tb = __ldg(t + first - 1);
    const int steps = rows + 31;
    const int lo0 = lo - lane * kCpl;                // lane 0's: the same in every lane
    // every lane live and past row 0, and lane 0's next row live (its base
    // is loaded a step ahead): steps live_lo .. live_hi
    const int live_lo = max(31, 32 - first), live_hi = rows - 2;
    // every cell has entered the band from above once lane 31's last column
    // has (row lo0 + 32 kCpl - 1); none has left it below while lane 0's
    // first has not (row lo0 + W - 1)
    const int top_done = lo0 + 32 * kCpl - 1 + 31 - first;
    const int bottom_from = lo0 + bd.W - first;
    for (int base = 0; base < steps; base += kChunk) {
      const int cu = chunk_in<kIn>(first + base);
      const int end = min(kChunk, steps - base), hi = base + end - 1;
      if (base < live_lo || hi > live_hi)
        chunk<kAll>(base, cu, end);
      else if (base >= top_done && hi < bottom_from)
        chunk<kMid>(base, cu, end);
      else if (hi < bottom_from)
        chunk<kTop>(base, cu, end);
      else if (base >= top_done)
        chunk<kBottom>(base, cu, end);
      else
        chunk<kAll>(base, cu, end);
    }
    // the end cell (n, m) is this stripe's last row where it holds column m
    if (last == bd.n) {
#pragma unroll
      for (int c = 0; c < kCpl; ++c)
        if (jl + c == bd.m) *out = hup[c];
    }
  }
};

// One warp a block.  Warps take stripes in order from the counter, so a
// stripe only ever waits on one that a running warp has taken.
__global__ void __launch_bounds__(32)
nw_kernel(const int* __restrict__ q, const int* __restrict__ t, Band bd, int stripes,
          int* counter, unsigned long long* edge, int* __restrict__ out) {
  const int lane = threadIdx.x;
  for (;;) {
    int s = 0;
    if (lane == 0) s = atomicAdd(counter, 1);
    s = __shfl_sync(kFull, s, 0);
    if (s >= stripes) return;
    const int j0 = s * kC;
    Stripe st;
    st.t = t;
    st.bd = bd;
    st.lane = lane;
    st.s = s;
    st.first = max(0, j0 + bd.W2 - bd.W + 1);
    st.last = min(bd.n, j0 + kC - 1 + bd.W2);
    if (st.last < st.first) continue;        // the band meets this stripe below row n
    st.rows = st.last - st.first + 1;
    st.jl = j0 + lane * kCpl;                // this lane's first column
    st.lo = st.jl + bd.W2 - bd.W + 1;        // the row where it enters the band
    st.ulast = s == 0 ? -1 : min(bd.n, j0 - 1 + bd.W2);   // stripe s - 1's last row
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      const int j = st.jl + c;
      st.qb[c] = j >= 1 && j <= bd.m ? __ldg(q + j - 1) : -1;
      st.row0[c] = -bd.gap * j;
      st.hup[c] = kNeg;
    }
    st.edge = edge;
    if (s > 0)
      st.run<true>(out);
    else
      st.run<false>(out);
  }
}

}  // namespace

// q (m,) and t (n,) int32 codes; W >= 1 with 0 <= m - n + W / 2 < W, and
// m + n + W and the scores small enough that every in-band score stays
// above NEG / 2 (the host checks all three).  scratch: n + 2 zeroed 64-bit
// words (the stripe counter, then one hand-off word per row).  out: one
// int32, the score.  Launches on `stream`, does not synchronise, and
// returns the CUDA error of the launch (0 on success).
extern "C" int gb_longread_nw(const void* q, const void* t, int m, int n, int W, int match,
                              int mismatch, int gap, void* scratch, void* out, void* stream) {
  if (W < 1 || m < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int kend = m - n + W / 2;
  if (kend < 0 || kend >= W) return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int stripes = m / kC + 1;
  const int blocks = stripes < kWarpsPerSM * sms ? stripes : kWarpsPerSM * sms;
  auto* words = static_cast<unsigned long long*>(scratch);
  nw_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const int*>(t),
      Band{m, n, W, W / 2, match, mismatch, gap}, stripes, reinterpret_cast<int*>(words),
      words + 1, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
