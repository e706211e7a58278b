// Nanopore adaptive banded event alignment (abea, f5c align) for Hopper:
// the banded fill and its backtrack, two kernels.
//
// gb_abea_fill replaces the JAX package's `_abea_scan`
// (genomicsbench_tpu/ops/abea.py:228-422) and gb_abea_backtrack its
// `_abea_backtrack_scan` (:427-492).  Both compute what the port's plain
// versions `abea_fill_reference` and `abea_backtrack_reference`
// (ops/abea.py) compute, bit for bit: every float operation is an
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn intrinsic in the order the
// JAX code writes it, so nvcc forms no FMA and each operation rounds once,
// as the reference's float-mode build (abea_gold_f32, no FMA) does.  The
// backtrack's Kahan sum stays in float32 with its compensation intact
// (intrinsics are never reassociated; the build has no -use_fast_math).
//
// Fill.  One warp per read, each warp its own block, one launch for the
// batch.  A band holds W = 100 cells on an anti-diagonal; lane l owns cells
// 4l .. 4l+3 (lanes 0-24 are live), so a lane's four 2-bit trace codes are
// one byte and a band's trace row is 25 consecutive byte stores.  The
// adaptive (Suzuki-Kasahara) move shifts the band's lower-left corner one
// event down or one k-mer right, so the up, left and diagonal neighbours
// of the previous two bands are the same lane's registers or a +-1 cell
// shift across the lane edge, one __shfl_up/down_sync each.  The move
// needs cells 0 and 99 of the previous band: two broadcasts.
//
// The emission inputs ride with the band.  Cell o of the band with corner
// (be, bk) scores event be - o against k-mer bk + o, so a right move gives
// cell o the k-mer of the old cell o + 1 and a down move gives it the
// event of the old cell o - 1: each lane holds, for its four cells, the
// event mean x and the k-mer's three terms, m = scale * mean + shift, stdv
// and c = log(1/sqrt(2 pi)) - log stdv, computed once per k-mer, and the
// move shifts them by a cell (in-lane moves, and one __shfl_down_sync per
// k-mer term or one __shfl_up_sync for the event across the lane edge).
// One k-mer enters at cell 99 on a right move and one event at cell 0 on a
// down move; both candidates of the next move are loaded a move ahead (the
// next k-mer's rank two moves ahead, since its terms need its rank), by
// warp-uniform loads through the read-only path, so no load sits on a
// band's chain and the pore model (48 KB) stays in L1/L2, not in shared
// memory.  The emission is c + (-0.5 a) a with a = (x - m) / stdv: the same
// intrinsics in the same order as computing it per cell, so bit for bit.
// Cells outside the read's matrix keep their in-range tests; a band whose
// 100 cells all lie inside (most of a read's bands) takes a path without
// them.  The cells are compiled for each move, right or down, so a cell's
// up and left neighbours and the two shuffles across the lane edge are
// fixed, and only the diagonal picks by the move before: one select a
// cell where there were four.
//
// Reads go longest first: the host sorts them by band count (`order`) and
// block i takes read order[i].  A warp leaves when its read is done and
// the next read's warp takes its place, so no block waits on its longest
// read and the last reads to start are the shortest.  Each read runs its
// own n_events + n_kmers bands.
//
// Bound.  Work per cell inside its read's matrix (event and k-mer in
// range; the band's other cells do no emission and are left out), one
// instruction per operation (no FMA):
//   emission  a = (x - m) / stdv; c + (-0.5 * a) * a        5 FP32 (one division)
//   scores    s_d, s_u (2 adds each), s_l (1 add)          5 FP32
//   two maxima, two compares, two selects                  6 FP32
//   event and k-mer index, 4 bound compares,
//   trace code shift and or                                 8 int32
// and per k-mer, once: m = scale * mean + shift and c      3 FP32
//   the rank mask and its address                          2 int32
// and per event, once: its address                         1 int32
// (ABEA_*_OPS_PER_CELL, _PER_KMER and _PER_EVENT in ops/abea.py).  The
// FP32 ops go at 128 lanes per SM and the int32 ones at 64, and the bound
// takes the slower of the two.  The division counts as one operation
// though it issues as several instructions, and the per-band steering,
// shuffles and stores are left out, so the bound is a floor.  Bytes: the events and ranks once,
// the model, one trace byte per 4 cells, one bll_e per band.
//
// Design (backtrack).  The walk from the best (event, last k-mer) cell is
// a pointer chase: each step reads its band's corner bll_e and then the
// trace byte that the corner picks, and moves to band - 1 (up or left) or
// band - 2 (diagonal), so it visits a read's bands in strictly decreasing
// order.  So the traces are staged as tiles of 64 bands (25-byte rows and
// the corners, 1,856 bytes at a 16-byte aligned start, by 16-byte cp.async)
// into shared memory, two buffers a read: the tile the walk is in and the
// one below it, whose load started when the walk entered the tile above.
// A warp takes four reads of the fill's longest-first `order`, one on each
// group of 8 lanes, and is a block of its own (19 KB of shared memory, 11
// warps an SM).  Lane 0 of a group walks its read in shared memory, two
// dependent shared loads a step, recording the path, (k-mer, event) a
// step, in a buffer of 128 steps with the longest event gap.  The four
// walkers step in lockstep, one instruction stream for four walks: in a
// round each live walker steps until it stops (its band below its tile,
// its buffer full, or its k-mer or event below 0), and the round ends when
// all four have stopped, so their stops are handled together (rounds that
// ended at the first walker's stop, with steps untested, measured 1.05 ms
// on the main path against 0.83).  At a stop the walker's group moves it into
// the tile below and stages the next, or computes the buffered steps'
// emission terms (each step's rank, event and model values; ranks and
// events walked monotonically down) and stores the pairs back to front
// into the read's slot of n_events + n_kmers pairs, coalesced, so they end
// in forward order at the slot's end; the walker then adds the terms into
// the float32 Kahan sum in walk order with the intrinsics the plain
// version's order gives.  After the walk the Kahan update runs kTailSteps
// more times with a zero term, as the JAX scan's padded steps do, which
// folds the compensation into the sum (it settles within two).  A header
// per read holds the pair count, the sum, the longest event gap and the
// best score.
//
// Bound (backtrack).  Bytes: per walk step one trace byte, one corner, a
// rank, an event, the rank's three model values and the pair written (33
// bytes), and per read its offsets, scale, shift, best and header.  The
// design stages more than that: 29 bytes for every band of the walk's span
// (the tiles' rows and corners), which chip_smoke.py prints beside the
// bound as the staged-bytes floor.  And a latency floor: the longest walk's
// tiles, each one device round trip if nothing overlapped, plus its steps
// of two dependent shared-memory loads.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kW = 100;                   // ALN_BANDWIDTH (f5c.h:28)
constexpr int kHalf = kW / 2;
constexpr int kLiveLanes = kW / 4;        // 25 lanes of 4 cells
constexpr int kModel = 4096;              // 6-mer pore model
constexpr int kParams = 6;                // scale shift lp_skip lp_stay lp_step lp_trim
constexpr int kFillBlocksPerSm = 28;      // one warp each: at most 72 registers a thread
constexpr int kBtG = 8;                   // backtrack lanes a read
constexpr int kBtReads = 32 / kBtG;       // backtrack reads a warp (and a block)
constexpr int kBtTile = 64;               // bands a staged backtrack tile holds
constexpr int kBtPath = 128;              // walk steps staged between term batches
constexpr int kBtMinWarps = 11;           // backtrack warps an SM, by shared memory
constexpr int kBtPerLane = kBtPath / kBtG;   // buffered steps a lane turns into terms
constexpr int kTailSteps = 3;
constexpr unsigned kFromD = 0, kFromU = 1, kFromL = 2;
constexpr float kLogNorm = -0x1.d67f0ap-1f;   // float32(-0.918938)

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// torch.maximum and jnp.maximum: a NaN operand gives NaN.  Which NaN does
// not matter: a NaN cell is never a best score and compares unequal to
// every score, as in the plain version
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A k-mer's emission terms: its scaled level mean, its stdv and
// log(1/sqrt(2 pi)) - its log stdv
struct Kmer {
  float m, sd, c;
};

__device__ __forceinline__ Kmer kmer_terms(const float* __restrict__ model, int32_t rank,
                                           float scale, float shift) {
  const int r = rank & (kModel - 1);
  return {__fadd_rn(__fmul_rn(scale, __ldg(model + r)), shift), __ldg(model + kModel + r),
          __fsub_rn(kLogNorm, __ldg(model + 2 * kModel + r))};
}

// abea.py:244-246: (x - (scale * mean + shift)) / stdv, then
// -0.918938 - log_stdv + (-0.5 * a) * a, each op rounding once
__device__ __forceinline__ float emission(float x, float m, float sd, float c) {
  const float a = __fdiv_rn(__fsub_rn(x, m), sd);
  return __fadd_rn(c, __fmul_rn(__fmul_rn(-0.5f, a), a));
}

__device__ __forceinline__ float pick(const float (&v)[4], int j) {
  return j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
}

__global__ void __launch_bounds__(32, kFillBlocksPerSm) abea_fill_kernel(
    const int32_t* __restrict__ ranks, const float* __restrict__ events,
    const int64_t* __restrict__ k_off, const int64_t* __restrict__ e_off,
    const int64_t* __restrict__ band_off, const float* __restrict__ params,
    const float* __restrict__ model, const int32_t* __restrict__ order,
    uint8_t* __restrict__ traces, int32_t* __restrict__ bll_e_out,
    uint8_t* __restrict__ trace1, float* __restrict__ best_out,
    int32_t* __restrict__ best_ev_out) {
  const int lane = threadIdx.x;
  const int64_t b = order[blockIdx.x];    // longest reads first
  const int32_t* rk = ranks + k_off[b];
  const float* ev = events + e_off[b];
  const int nk = static_cast<int>(k_off[b + 1] - k_off[b]);
  const int ne = static_cast<int>(e_off[b + 1] - e_off[b]);
  const int64_t b0 = band_off[b];
  const int nb = static_cast<int>(band_off[b + 1] - b0);   // nk + ne, checked by the host
  const float* p = params + b * kParams;
  const float scale = p[0], shift = p[1], lp_skip = p[2], lp_stay = p[3],
              lp_step = p[4], lp_trim = p[5];
  const float ninf = neg_inf();
  // a k-mer's rank and an event's mean, or 0 outside the read (their cells
  // are outside the matrix and never emit)
  auto rank_at = [&](int k) { return k >= 0 && k < nk ? __ldg(rk + k) : 0; };
  auto event_at = [&](int e) { return e >= 0 && e < ne ? __ldg(ev + e) : 0.0f; };

  for (int o = lane; o < kW; o += 32) trace1[b * kW + o] = o == kHalf ? kFromU : kFromD;

  const int o0 = 4 * lane;
  const bool live_lane = lane < kLiveLanes;
  float prev[4], prev2[4];                // bands i-1 and i-2
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    prev2[j] = o0 + j == kHalf ? 0.0f : ninf;
    prev[j] = o0 + j == kHalf ? lp_trim : ninf;
  }
  const int be_p = kHalf - 1;              // band 0's lower-left (event, k-mer)
  int bk_p = -1 - kHalf;
  int be = kHalf, bk = -1 - kHalf;          // band 1's
  // band 1's emission inputs: cell o scores event be - o against k-mer bk + o
  float x[4];
  Kmer km[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = event_at(be - (o0 + j));
    km[j] = kmer_terms(model, rank_at(bk + o0 + j), scale, shift);
  }
  // what enters on the next move: k-mer kin at cell 99 on a right move,
  // event ein at cell 0 on a down move; and the rank of k-mer kin + 1
  int kin = bk + kW, ein = be + 1;
  Kmer k_next = kmer_terms(model, rank_at(kin), scale, shift);
  int32_t r_after = rank_at(kin + 1);
  float x_next = event_at(ein);
  float best = ninf;
  int best_ev = 0;

  // the best (event, last k-mer) search over a band's cell of k-mer nk - 1
  auto check = [&](const float (&band)[4], int e, int k) {
    const int off = (nk - 1) - k;
    const int evi = e - off;
    if (off >= 0 && off < kW && evi >= 0 && evi < ne) {      // uniform
      const float v = __shfl_sync(kFull, pick(band, off & 3), off >> 2);
      const float sc = __fadd_rn(v, __fmul_rn(static_cast<float>(ne - evi), lp_trim));
      if (sc > best) {
        best = sc;
        best_ev = evi;
      }
    }
  };
  check(prev2, be_p, bk_p);
  check(prev, be, bk);

  for (int s = 0; s < nb; ++s) {
    const float ll = __shfl_sync(kFull, prev[0], 0);
    const float ur = __shfl_sync(kFull, prev[3], kLiveLanes - 1);
    const bool right = (ll == ninf && ur == ninf) ? (s & 1) == 1 : ll < ur;
    const int nbe = right ? be : be + 1;
    const int nbk = right ? bk + 1 : bk;
    const bool right_before = bk != bk_p;             // the move before this one

    float cur[4];
    unsigned code = 0;
    // one band's cells.  `kInside`: all 100 lie in the read's matrix;
    // `kRight`: a right move.  `edge` and `edge2` are the previous two
    // bands' cells across the lane edge: cell o0 + 4 after a right move,
    // o0 - 1 after a down move
    auto cells = [&](auto inside_tag, auto right_tag, float edge, float edge2) {
      constexpr bool kInside = decltype(inside_tag)::value;
      constexpr bool kRight = decltype(right_tag)::value;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + j;
        float up, left, diag;
        if constexpr (kRight) {           // up: cell o + 1; diag: o or o + 1
          const float p_up1 = j < 3 ? prev[j < 3 ? j + 1 : 3] : edge;
          const float q_up1 = j < 3 ? prev2[j < 3 ? j + 1 : 3] : edge2;
          up = o == kW - 1 ? ninf : p_up1;
          left = prev[j];
          diag = right_before ? (o == kW - 1 ? ninf : q_up1) : prev2[j];
        } else {                          // left: cell o - 1; diag: o - 1 or o
          const float p_dn1 = j > 0 ? prev[j > 0 ? j - 1 : 0] : edge;
          const float q_dn1 = j > 0 ? prev2[j > 0 ? j - 1 : 0] : edge2;
          up = prev[j];
          left = o == 0 ? ninf : p_dn1;
          diag = right_before ? prev2[j] : (o == 0 ? ninf : q_dn1);
        }

        auto score = [&](float& v, unsigned& frm) {
          const float lp_e = emission(x[j], km[j].m, km[j].sd, km[j].c);
          const float s_d = __fadd_rn(__fadd_rn(diag, lp_step), lp_e);
          const float s_u = __fadd_rn(__fadd_rn(up, lp_stay), lp_e);
          const float s_l = __fadd_rn(left, lp_skip);
          const float mx = nan_max(s_d, s_u);
          frm = mx == s_u ? kFromU : kFromD;
          v = nan_max(mx, s_l);
          if (v == s_l) frm = kFromL;
        };
        float v = ninf;
        unsigned frm = kFromD;
        if constexpr (kInside) {
          score(v, frm);          // lanes 25-31 score too; nothing reads them
        } else {
          const int evi = nbe - o, kmi = nbk + o;
          const bool ev_in = evi >= 0 && evi < ne;
          if (live_lane && ev_in && kmi >= 0 && kmi < nk) {
            score(v, frm);
          } else if (live_lane && ev_in && kmi == -1) {       // the trim cell
            v = __fmul_rn(lp_trim, static_cast<float>(evi + 1));
            frm = kFromU;
          }
        }
        cur[j] = v;
        code |= frm << (2 * j);
      }
    };
    const bool inside = nbk >= 0 && nbk + (kW - 1) < nk && nbe >= kW - 1 && nbe < ne;

    // the emission inputs follow the move (warp-uniform), then the cells
    if (right) {          // cell o takes cell o + 1's k-mer; k-mer kin enters at cell 99
      const float m = __shfl_down_sync(kFull, km[0].m, 1);
      const float sd = __shfl_down_sync(kFull, km[0].sd, 1);
      const float c = __shfl_down_sync(kFull, km[0].c, 1);
      km[0] = km[1];
      km[1] = km[2];
      km[2] = km[3];
      km[3] = lane == kLiveLanes - 1 ? k_next : Kmer{m, sd, c};
      k_next = kmer_terms(model, r_after, scale, shift);
      ++kin;
      r_after = rank_at(kin + 1);
      const float p_next = __shfl_down_sync(kFull, prev[0], 1);    // cell o0 + 4
      const float q_next = __shfl_down_sync(kFull, prev2[0], 1);
      if (inside)
        cells(std::true_type{}, std::true_type{}, p_next, q_next);
      else
        cells(std::false_type{}, std::true_type{}, p_next, q_next);
    } else {              // cell o takes cell o - 1's event; event ein enters at cell 0
      const float e = __shfl_up_sync(kFull, x[3], 1);
      x[3] = x[2];
      x[2] = x[1];
      x[1] = x[0];
      x[0] = lane == 0 ? x_next : e;
      ++ein;
      x_next = event_at(ein);
      const float p_last = __shfl_up_sync(kFull, prev[3], 1);      // cell o0 - 1
      const float q_last = __shfl_up_sync(kFull, prev2[3], 1);
      if (inside)
        cells(std::true_type{}, std::false_type{}, p_last, q_last);
      else
        cells(std::false_type{}, std::false_type{}, p_last, q_last);
    }

    if (live_lane) traces[(b0 + s) * kLiveLanes + lane] = static_cast<uint8_t>(code);
    if (lane == 0) bll_e_out[b0 + s] = nbe;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      prev2[j] = prev[j];
      prev[j] = cur[j];
    }
    bk_p = bk;
    be = nbe;
    bk = nbk;
    check(prev, be, bk);
  }
  if (lane == 0) {
    best_out[b] = best;
    best_ev_out[b] = best_ev;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One staged tile of the backtrack: the traces and corners of bands
// 64q .. 64q + 63
struct __align__(16) BtTile {
  uint8_t trace[kBtTile * kLiveLanes];
  int32_t bll_e[kBtTile];
};

// One read's shared memory in the backtrack: two tiles and the path
// buffer, 16 bytes of skew so that the four reads of a warp sit on
// different banks
struct __align__(16) BtRead {
  BtTile tile[2];
  int2 path[kBtPath];
  int4 skew;
};

// Four reads a warp (a group of kBtG = 8 lanes each, reads order[4w ..
// 4w + 3], longest first), a warp a block.  Lane 0 of each group walks its
// read; the four walkers step in lockstep, each until its band leaves its
// tile, its path buffer fills or its walk ends, and the round ends when all
// four have stopped.  A walker at a stop has its group's 8 lanes move it
// into the tile below (staged
// when it entered the one above) and stage the next, or compute the
// buffered steps' terms and pairs, which the walker then adds into the
// Kahan sum in walk order.  `tiles`, where given, gets the tiles each walk
// stepped into.
__global__ void __launch_bounds__(32, kBtMinWarps) abea_backtrack_kernel(
    const int32_t* __restrict__ ranks, const float* __restrict__ events,
    const int64_t* __restrict__ k_off, const int64_t* __restrict__ e_off,
    const int64_t* __restrict__ band_off, const float* __restrict__ params,
    const float* __restrict__ model, const int32_t* __restrict__ order,
    const uint8_t* __restrict__ traces, const int32_t* __restrict__ bll_e,
    const float* __restrict__ best, const int32_t* __restrict__ best_ev, int64_t n_reads,
    int32_t* __restrict__ out, int32_t* __restrict__ tiles) {
  __shared__ BtRead rd[kBtReads];
  const int lane = threadIdx.x, grp = lane / kBtG, gl = lane % kBtG;
  const int leader = grp * kBtG;
  const bool walker = gl == 0;
  const int64_t rr = static_cast<int64_t>(blockIdx.x) * kBtReads + grp;
  const int64_t b = rr < n_reads ? order[rr] : -1;
  BtRead& me = rd[grp];
  const int32_t* rk = b >= 0 ? ranks + k_off[b] : ranks;
  const float* ev = b >= 0 ? events + e_off[b] : events;
  const int nk = b >= 0 ? static_cast<int>(k_off[b + 1] - k_off[b]) : 0;
  const int64_t b0 = b >= 0 ? band_off[b] : 0, end = b >= 0 ? band_off[b + 1] : 0;
  const int64_t n_bands = band_off[n_reads];
  const float scale = b >= 0 ? params[b * kParams] : 0.0f;
  const float shift = b >= 0 ? params[b * kParams + 1] : 0.0f;
  const float bst = b >= 0 ? best[b] : 0.0f;
  int2* pairs = reinterpret_cast<int2*>(out + 4 * n_reads);   // (k-mer, event)

  // tile qq into buf by the group's lanes: 100 chunks of trace rows, 16 of
  // corners; the bytes past the arrays' ends are zero
  auto stage = [&](BtTile& buf, int64_t qq) {
    for (int c = gl; c < (kBtTile * kLiveLanes + 4 * kBtTile) / 16; c += kBtG) {
      if (c < kBtTile * kLiveLanes / 16) {
        const int64_t e0 = qq * kBtTile * kLiveLanes + 16 * c;
        const int64_t rem = n_bands * kLiveLanes - e0;
        const int nb = rem >= 16 ? 16 : rem > 0 ? static_cast<int>(rem) : 0;
        cp_async16(buf.trace + 16 * c, traces + (nb ? e0 : 0), nb);
      } else {
        const int c4 = c - kBtTile * kLiveLanes / 16;
        const int64_t e0 = qq * kBtTile + 4 * c4;
        const int64_t rem = n_bands - e0;
        const int nb = rem >= 4 ? 16 : rem > 0 ? static_cast<int>(4 * rem) : 0;
        cp_async16(buf.bll_e + 4 * c4, bll_e + (nb ? e0 : 0), nb);
      }
    }
    cp_async_commit();
  };

  bool alive = b >= 0 && isfinite(bst);   // group-uniform: the read has a walk
  int k = nk - 1, e = alive ? best_ev[b] : 0;   // the walker's walk
  int64_t q = 0;
  int rel = 0, cur = 0, t = 0, n = 0, gap = 0, max_gap = 0, walked = 0;
  float sum = 0.0f, comp = 0.0f;
  if (alive) {
    const int64_t band0 = b0 + (e + k);   // band (e + 1) + (k + 1), less the 2 initial
    q = band0 / kBtTile;
    rel = static_cast<int>(band0 - q * kBtTile);   // the band in its tile
    stage(me.tile[0], q);
    if (q > 0) stage(me.tile[1], q - 1);
    else cp_async_commit();
    cp_async_wait<1>();
    walked = 1;
  }
  __syncwarp();
  while (__any_sync(kFull, alive)) {
    // each live walker steps until it stops; the round ends when all have
    if (walker && alive) {
      const BtTile& tl = me.tile[cur];
      while (rel >= 0 && t < kBtPath && k >= 0 && e >= 0) {
        me.path[t++] = make_int2(k, e);
        const int off = min(max(tl.bll_e[rel] - e, 0), kW - 1);
        const unsigned frm =
            (tl.trace[rel * kLiveLanes + (off >> 2)] >> (2 * (off & 3))) & 3u;
        const int dk = frm != kFromU, de = frm != kFromL;
        k -= dk;
        e -= de;
        rel -= dk + de;
        gap = frm == kFromL ? gap + 1 : 0;
        max_gap = max(max_gap, gap);
      }
    }
    // a walker at a stop: 1 its band left its tile; 2 its path buffer is
    // full; 3 its walk is over
    int need = 0;
    if (walker && alive) need = (k < 0 || e < 0) ? 3 : t == kBtPath ? 2 : 1;
    need = __shfl_sync(kFull, need, leader);
    t = __shfl_sync(kFull, t, leader);
    // a term batch stalls the whole warp on its loads: the reads whose
    // buffers are half full or more join one that must flush
    const bool any_full = __any_sync(kFull, need >= 2);    // every lane votes
    const bool flush = need >= 2 || (any_full && 2 * t >= kBtPath);
    __syncwarp();                  // the walkers' path entries
    if (flush) {                   // the buffered steps' terms and pairs
      // a lane's steps gl, gl + 8, ...: every rank and event load issued
      // before any is used, then every model load, so a batch costs two
      // dependent round trips, not two a step
      int2 ke[kBtPerLane];
      int32_t rank[kBtPerLane];
      float xv[kBtPerLane], mm[kBtPerLane], msd[kBtPerLane], mls[kBtPerLane];
#pragma unroll
      for (int u = 0; u < kBtPerLane; ++u)
        ke[u] = gl + kBtG * u < t ? me.path[gl + kBtG * u] : make_int2(0, 0);
#pragma unroll
      for (int u = 0; u < kBtPerLane; ++u) {
        rank[u] = __ldg(rk + ke[u].x) & (kModel - 1);
        xv[u] = __ldg(ev + ke[u].y);
      }
#pragma unroll
      for (int u = 0; u < kBtPerLane; ++u) {
        mm[u] = __ldg(model + rank[u]);
        msd[u] = __ldg(model + kModel + rank[u]);
        mls[u] = __ldg(model + 2 * kModel + rank[u]);
      }
#pragma unroll
      for (int u = 0; u < kBtPerLane; ++u) {
        const int s = gl + kBtG * u;
        if (s < t) {
          pairs[end - 1 - (n + s)] = ke[u];
          const float m = __fadd_rn(__fmul_rn(scale, mm[u]), shift);
          const float c = __fsub_rn(kLogNorm, mls[u]);
          me.path[s].x = __float_as_int(emission(xv[u], m, msd[u], c));
        }
      }
    }
    __syncwarp();
    if (flush && walker) {
      for (int s = 0; s < t; ++s) {   // Kahan, in walk order
        const float y = __fsub_rn(__int_as_float(me.path[s].x), comp);
        const float tt = __fadd_rn(sum, y);
        comp = __fsub_rn(__fsub_rn(tt, sum), y);
        sum = tt;
      }
    }
    if (flush) {
      n += t;
      t = 0;
    }
    if (need == 3) alive = false;
    if (need == 1) {       // into the tile below, and stage the one below it
      cp_async_wait<0>();
      --q;
      rel += kBtTile;
      cur ^= 1;
      ++walked;
    }
    __syncwarp();
    if (need == 1 && q > 0) stage(me.tile[cur ^ 1], q - 1);
  }
  cp_async_wait<0>();
  if (b >= 0 && walker) {
    if (isfinite(bst)) {
      for (int i = 0; i < kTailSteps; ++i) {  // the scan's steps past the walk: a zero term
        const float y = __fsub_rn(0.0f, comp);
        const float tt = __fadd_rn(sum, y);
        comp = __fsub_rn(__fsub_rn(tt, sum), y);
        sum = tt;
      }
    }
    int32_t* hdr = out + 4 * b;
    hdr[0] = n;
    hdr[1] = __float_as_int(sum);
    hdr[2] = max_gap;
    hdr[3] = __float_as_int(bst);
    if (tiles != nullptr) tiles[b] = walked;
  }
}

}  // namespace

// Reads: k-mer ranks (i32), read b's at [k_off[b], k_off[b+1]); event means
// (f32) at [e_off[b], e_off[b+1]); band_off (i64, B + 1) with band_off[b+1] -
// band_off[b] = n_kmers + n_events, read b's bands after the two initial
// ones; params (B, 6) f32: scale, shift, lp_skip, lp_stay, lp_step, lp_trim;
// model (3, 4096) f32: level mean, stdv, log stdv; order (i32, B): a
// permutation of the reads, the order their warps start in (longest
// first).  Writes the 2-bit traces (25 bytes per band, cell 4j + i at bits
// 2i of byte j), each band's lower-left event index bll_e (i32), trace1
// (B, 100) u8, best (B,) f32 and best_ev (B,) i32, all indexed by the read.
// Launches on `stream`, does not synchronise, and returns the CUDA error of
// the launch (0 on success).
extern "C" int gb_abea_fill(const void* ranks, const void* events, const void* k_off,
                            const void* e_off, const void* band_off, const void* params,
                            const void* model, const void* order, int64_t n_reads,
                            void* traces, void* bll_e, void* trace1, void* best,
                            void* best_ev, void* stream) {
  if (n_reads <= 0) return 0;
  abea_fill_kernel<<<static_cast<unsigned>(n_reads), 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranks), static_cast<const float*>(events),
      static_cast<const int64_t*>(k_off), static_cast<const int64_t*>(e_off),
      static_cast<const int64_t*>(band_off), static_cast<const float*>(params),
      static_cast<const float*>(model), static_cast<const int32_t*>(order),
      static_cast<uint8_t*>(traces), static_cast<int32_t*>(bll_e),
      static_cast<uint8_t*>(trace1), static_cast<float*>(best),
      static_cast<int32_t*>(best_ev));
  return static_cast<int>(cudaGetLastError());
}

// The inputs of gb_abea_fill, its `order`, and its traces, bll_e, best and
// best_ev; traces and bll_e 16-byte aligned.  `out` (i32) holds a header of
// 4 per read, (pair count, sum of the emission terms as float bits, longest
// event gap, best as float bits), then (sum of the bands) x 2 pairs: read
// b's pairs in forward order end at band_off[b+1]; the slots before them
// are left as they were.  `tiles` (i32, B), where given, gets the trace
// tiles each walk stepped into.  Launches on `stream`, does not
// synchronise, and returns the CUDA error of the launch.
extern "C" int gb_abea_backtrack(const void* ranks, const void* events, const void* k_off,
                                 const void* e_off, const void* band_off, const void* params,
                                 const void* model, const void* order, const void* traces,
                                 const void* bll_e, const void* best, const void* best_ev,
                                 int64_t n_reads, void* out, void* tiles, void* stream) {
  if (n_reads <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(abea_backtrack_kernel,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n_reads + kBtReads - 1) / kBtReads;
  abea_backtrack_kernel<<<static_cast<unsigned>(blocks), 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranks), static_cast<const float*>(events),
      static_cast<const int64_t*>(k_off), static_cast<const int64_t*>(e_off),
      static_cast<const int64_t*>(band_off), static_cast<const float*>(params),
      static_cast<const float*>(model), static_cast<const int32_t*>(order),
      static_cast<const uint8_t*>(traces), static_cast<const int32_t*>(bll_e),
      static_cast<const float*>(best), static_cast<const int32_t*>(best_ev), n_reads,
      static_cast<int32_t*>(out), static_cast<int32_t*>(tiles));
  return static_cast<int>(cudaGetLastError());
}
