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
// Backtrack.  One thread per read: the walk is a pointer chase, one
// dependent load of the band's corner and one of its trace byte per step,
// over the read's own traces.  The emission terms sum with float32 Kahan
// compensation; after the walk the Kahan update runs kTailSteps more times
// with a zero term, as the JAX scan's padded steps do, which folds the
// compensation into the sum (it settles within two).  Pairs are written
// back to front into the read's slot of n_events + n_kmers pairs, so they
// end in forward order at the slot's end; a header per read holds the
// pair count, the sum, the longest event gap and the best score.  Its
// bound is the longest read's chain of dependent steps, not its operations.

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
constexpr int kBacktrackThreads = 32;
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

__global__ void __launch_bounds__(kBacktrackThreads) abea_backtrack_kernel(
    const int32_t* __restrict__ ranks, const float* __restrict__ events,
    const int64_t* __restrict__ k_off, const int64_t* __restrict__ e_off,
    const int64_t* __restrict__ band_off, const float* __restrict__ params,
    const float* __restrict__ model, const uint8_t* __restrict__ traces,
    const int32_t* __restrict__ bll_e, const float* __restrict__ best,
    const int32_t* __restrict__ best_ev, int64_t n_reads, int32_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n_reads) return;
  const int32_t* rk = ranks + k_off[b];
  const float* ev = events + e_off[b];
  const int nk = static_cast<int>(k_off[b + 1] - k_off[b]);
  const int64_t b0 = band_off[b];
  const float* p = params + b * kParams;
  const float scale = p[0], shift = p[1];
  const float bst = best[b];
  int32_t* pairs = out + 4 * n_reads;     // (k-mer, event) int32 pairs
  int n = 0, gap = 0, max_gap = 0;
  float sum = 0.0f, comp = 0.0f;
  if (isfinite(bst)) {
    int k = nk - 1, e = best_ev[b];
    int64_t pos = band_off[b + 1];        // back to front: forward order at the slot's end
    while (k >= 0 && e >= 0) {
      --pos;
      pairs[2 * pos] = k;
      pairs[2 * pos + 1] = e;
      ++n;
      const Kmer t_k = kmer_terms(model, __ldg(rk + k), scale, shift);
      const float term = emission(__ldg(ev + e), t_k.m, t_k.sd, t_k.c);
      const float y = __fsub_rn(term, comp);
      const float t = __fadd_rn(sum, y);
      comp = __fsub_rn(__fsub_rn(t, sum), y);
      sum = t;
      const int64_t band = b0 + (e + k);  // band index (e + 1) + (k + 1), less the 2 initial
      const int off = min(max(__ldg(bll_e + band) - e, 0), kW - 1);
      const unsigned frm = (__ldg(traces + band * kLiveLanes + (off >> 2)) >> (2 * (off & 3))) & 3u;
      if (frm != kFromU) --k;
      if (frm != kFromL) --e;
      gap = frm == kFromL ? gap + 1 : 0;
      max_gap = max(max_gap, gap);
    }
    for (int i = 0; i < kTailSteps; ++i) {  // the scan's steps past the walk: a zero term
      const float y = __fsub_rn(0.0f, comp);
      const float t = __fadd_rn(sum, y);
      comp = __fsub_rn(__fsub_rn(t, sum), y);
      sum = t;
    }
  }
  int32_t* hdr = out + 4 * b;
  hdr[0] = n;
  hdr[1] = __float_as_int(sum);
  hdr[2] = max_gap;
  hdr[3] = __float_as_int(bst);
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

// The inputs of gb_abea_fill and its traces, bll_e, best and best_ev.
// `out` (i32) holds a header of 4 per read, (pair count, sum of the
// emission terms as float bits, longest event gap, best as float bits),
// then (sum of the bands) x 2 pairs: read b's pairs in forward order end at
// band_off[b+1]; the slots before them are left as they were.  Launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch.
extern "C" int gb_abea_backtrack(const void* ranks, const void* events, const void* k_off,
                                 const void* e_off, const void* band_off, const void* params,
                                 const void* model, const void* traces, const void* bll_e,
                                 const void* best, const void* best_ev, int64_t n_reads,
                                 void* out, void* stream) {
  if (n_reads <= 0) return 0;
  const int64_t blocks = (n_reads + kBacktrackThreads - 1) / kBacktrackThreads;
  abea_backtrack_kernel<<<static_cast<unsigned>(blocks), kBacktrackThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ranks), static_cast<const float*>(events),
      static_cast<const int64_t*>(k_off), static_cast<const int64_t*>(e_off),
      static_cast<const int64_t*>(band_off), static_cast<const float*>(params),
      static_cast<const float*>(model), static_cast<const uint8_t*>(traces),
      static_cast<const int32_t*>(bll_e), static_cast<const float*>(best),
      static_cast<const int32_t*>(best_ev), n_reads, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
