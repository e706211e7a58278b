// GATK/GKL pair-HMM forward pass (phmm) for Hopper, in float and in double.
//
// Replaces the device loop of the JAX package's phmm path,
// genomicsbench_tpu/ops/pairhmm.py `_phmm_core` (:45-139), reached through
// `_phmm_scan` (:142) and `_phmm_scan_gather` (:146-163); the double
// instance replaces the host-side float64 fallback that the JAX package
// runs in C++ (genomicsbench_tpu/native/gbingest.cpp:1408-1458, on the host
// only because the TPU has no f64).  It computes what that C++ loop and the
// port's plain version `pairhmm_forward_reference` (ops/pairhmm.py)
// compute, bit for bit: every multiply and add is __fmul_rn / __fadd_rn
// (__dmul_rn / __dadd_rn), so nvcc forms no FMA, the divisions qp / 3 and
// 2^E / H are IEEE divisions, the deletion row Y runs along the haplotype
// in order, and the result is summed over the last row in column order.
// The ph2pr table comes from the host (C pow's in double), never from the
// card's pow or exp10.
//
// Bound.  Floating-point work per cell, one instruction per multiply or
// add (no FMA, which would change the rounding):
//   M = prior * (mm * M[i-1][j-1] + gapm * (X[i-1][j-1] + Y[i-1][j-1]))
//                                                       5 (2 add, 3 mul)
//   X = mx * M[i-1][j] + xx * X[i-1][j]                 3 (1 add, 2 mul)
//   Y = my * M[i][j-1] + yy * Y[i][j-1]                 3 (1 add, 2 mul)
//   -------------------------------------------------------------------
//   per cell                                           11 (PHMM_OPS_PER_CELL)
//   per cell of the last row, fin += M + X              2 more
// The prior's select, the base compare, the per-row coefficients and the
// data movement are left out, so the bound is a floor.  The rate is the
// card's FP32 rate outside the tensor cores, 128 lanes per SM x 132 SMs x
// the SM clock, and for double its FP64 rate, 64 lanes per SM.  The bytes
// are a few microseconds at the memory rate, so the kernel is bound by
// operations; what it can lose is issue slots around those operations.
//
// Design.  A pair runs on a group of g lanes (g = 4, 8, 16 or 32), each lane
// holding RR consecutive read rows (RR = 1 .. kMaxRows<T>, a template
// argument): their coefficients, and their previous column's M, X and Y, in
// registers (eleven a row; at RR = 8 in float and 4 in double ptxas spilled
// under the 128 registers that two blocks of 256 threads an SM allow, so
// the most is 7 and 3).  A warp runs 32 / g pairs of one (g, RR) class side by side,
// with width-g shuffles.  The group sweeps the haplotype as a wavefront: at
// step t, lane l of the group is at column t - l and computes its RR cells
// of that column top to bottom.  A lane's top row takes (i-1, j) from lane
// l-1's bottom row by shuffle and (i-1, j-1) from what it received a step
// earlier; each lower row takes both from the row just above it (its new
// and its previous values).  So three shuffles, one haplotype base and the
// loop's own work serve RR cells, where a warp per pair with one row a
// lane spent them on one cell.
//
// The rows are placed bottom-aligned: the pair's R rows end at the last
// lane's last register, and the g * RR * S - R rows above row 1 (S strips
// of g * RR rows) are dead rows that repeat row 0, the boundary M = X = 0,
// Y = 2^E / H: their coefficients are mm = gapm = mx = my = 0, xx = yy = 1
// and both priors 0, so each cell gives exactly M = 0, X = the X above (0),
// Y = its own previous Y (2^E / H).  Row 1 then sees row 0 without a test,
// and the result row R is the last lane's last register, whose M + X the
// lane adds in column order.  The group's first lane takes the boundary
// (strip 0) or the strip's top row (later strips) where its shuffle would
// cross into another pair.
//
// The host picks (g, RR) per pair from R (ops/pairhmm.py `phmm_classes`,
// weighing each step's and each strip's own cost, not only the cells) and
// orders the pairs by class, strips and haplotype length, longest first
// (`phmm_order`), so that a warp's pairs run about as long as each other.
// A class of g < 32 lanes holds pairs of R <= g * RR only (one strip); a
// pair longer than 32 * kMaxRows<T> rows runs on a whole warp in strips,
// whose last lane writes its bottom row (M, X, Y of columns 1..H) for the
// next strip's first lane, in shared memory or, past a block's shared
// memory, in device scratch, one slice per warp.  A row whose base is N
// takes p_match for both priors, so the match test is one compare of the
// two bases, or'ed with the step's "haplotype base is N".  Every branch
// that holds a shuffle is uniform across the warp: a warp loops to its
// longest pair's strips and columns, with the lanes outside their own
// pair's matrix idle.
//
// Left for later: strips below 32 lanes (a top row per group would need
// shared memory for 2-8 groups a warp), which the picker could then weigh
// against one strip; RR = 8 at 8 warps an SM; and the wrapper's order of a
// listed subset on the host where a caller holds its host copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kAmbig = 4;
constexpr int kQualMax = 127;
constexpr int kClassCols = 4;   // a class row: first warp, first slot, pairs, (g << 8) | RR

template <typename T> struct Rn;
template <> struct Rn<float> {
  static constexpr int kMaxRows = 7;
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};
template <> struct Rn<double> {
  static constexpr int kMaxRows = 3;
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

struct Args {
  const uint8_t* bases;
  const uint8_t* qq;
  const uint8_t* qi;
  const uint8_t* qd;
  const uint8_t* qc;
  const int64_t* r_off;
  const uint8_t* haps;
  const int64_t* h_off;
  const int32_t* pair_r;
  const int32_t* pair_h;
  const int64_t* idx;
  const int64_t* order;
  const int64_t* classes;
  int64_t n;
  int n_classes;
  int64_t n_vwarps;
  int init_exp;
  int64_t h_max;
  unsigned char* scratch;
  int warp_bytes;
};

// One warp's 32 / g pairs of class (g, RR), from slot `slot0` of the order.
template <typename T, int RR>
__device__ __forceinline__ void phmm_warp(const Args& a, const T* __restrict__ tab, int g,
                                          int64_t slot0, int64_t pos0, int64_t count,
                                          T* top_m, T* top_x, T* top_y, T* __restrict__ out) {
  using A = Rn<T>;
  const T zero = static_cast<T>(0), one = static_cast<T>(1), three = static_cast<T>(3);
  const T scale = static_cast<T>(ldexp(1.0, a.init_exp));   // 2^E, exact
  const int lane = threadIdx.x & 31;
  const int lg = lane & (g - 1);                  // lane in the group
  const int64_t slot = slot0 + lane / g;
  const bool has_pair = slot < count;
  int64_t k = 0, rb0 = 0, hb0 = 0;
  int R = 0, H = 0;
  if (has_pair) {
    k = a.order[pos0 + slot];
    const int64_t p = a.idx != nullptr ? a.idx[k] : k;
    const int64_t r = a.pair_r[p], h = a.pair_h[p];
    rb0 = a.r_off[r];
    hb0 = a.h_off[h];
    R = static_cast<int>(a.r_off[r + 1] - rb0);
    H = static_cast<int>(a.h_off[h + 1] - hb0);
    if ((R == 0 || H == 0) && lg == 0) out[k] = zero;   // nothing to sum
  }
  const int rows = g * RR;                        // rows of a strip
  const int S = (has_pair && R > 0 && H > 0) ? (R + rows - 1) / rows : 0;
  const int S_w = __reduce_max_sync(kFull, S);
  const int H_w = __reduce_max_sync(kFull, S > 0 ? H : 0);
  if (S_w == 0) return;
  const int dead = S * rows - R;                  // dead rows above row 1
  const T init_y = S > 0 ? A::div(scale, static_cast<T>(H)) : zero;
  const bool result_lane = lg == g - 1;
  T fin = zero;

  for (int s = 0; s < S_w; ++s) {
    // this lane's rows: padded row s * rows + lg * RR + kk, real row i from 1
    T t_mm[RR], t_gapm[RR], t_pi[RR], t_pd[RR], t_pc[RR], p_match[RR], p_mis[RR];
    T pM[RR], pX[RR], pY[RR];
    int rbase[RR];
#pragma unroll
    for (int kk = 0; kk < RR; ++kk) {
      const int i = s * rows + lg * RR + kk - dead + 1;
      pM[kk] = zero;
      pX[kk] = zero;
      if (s < S && i >= 1) {
        const int64_t o = rb0 + i - 1;
        const T pi = tab[min(static_cast<int>(a.qi[o]), kQualMax)];
        const T pd = tab[min(static_cast<int>(a.qd[o]), kQualMax)];
        const T pc = tab[min(static_cast<int>(a.qc[o]), kQualMax)];
        const T pq = tab[min(static_cast<int>(a.qq[o]), kQualMax)];
        const T gap_open = A::add(pi, pd);
        t_mm[kk] = A::sub(one, gap_open < one ? gap_open : one);
        t_gapm[kk] = A::sub(one, pc);
        t_pi[kk] = pi;
        t_pd[kk] = pd;
        t_pc[kk] = pc;
        p_match[kk] = A::sub(one, pq);
        rbase[kk] = a.bases[o];
        p_mis[kk] = rbase[kk] == kAmbig ? p_match[kk] : A::div(pq, three);
        pY[kk] = zero;                            // column 0 of a row >= 1
      } else {                                    // a dead row: row 0 again
        t_mm[kk] = t_gapm[kk] = t_pi[kk] = t_pd[kk] = zero;
        t_pc[kk] = one;
        p_match[kk] = p_mis[kk] = zero;
        rbase[kk] = -1;
        pY[kk] = init_y;
      }
    }
    // (i-1, j-1) of the top row at column 1: the row above's column 0 (row
    // 0's for the first lane of strip 0; the lanes above take it from the
    // shuffle of the step before their first)
    T qM = zero, qX = zero, qY = (s == 0 && lg == 0) ? init_y : zero;
    const bool writes_top = result_lane && s + 1 < S;
    // the haplotype base of the next column, loaded a step ahead
    int hb_next = (s < S) ? a.haps[hb0] : 0;
    const int steps = H_w + g - 1;
    for (int t = 1; t <= steps; ++t) {
      T rM = __shfl_up_sync(kFull, pM[RR - 1], 1, g);
      T rX = __shfl_up_sync(kFull, pX[RR - 1], 1, g);
      T rY = __shfl_up_sync(kFull, pY[RR - 1], 1, g);
      const int j = t - lg;
      const bool in_row = s < S && j >= 1 && j <= H;
      if (lg == 0) {
        if (s == 0) {
          rM = zero;
          rX = zero;
          rY = init_y;
        } else if (in_row) {
          rM = top_m[j];
          rX = top_x[j];
          rY = top_y[j];
        }
      }
      if (in_row) {
        const int hb = hb_next;
        hb_next = a.haps[hb0 + min(j, H - 1)];
        const bool hamb = hb == kAmbig;
        T uM = rM, uX = rX;
        T dM = qM, dX = qX, dY = qY;
#pragma unroll
        for (int kk = 0; kk < RR; ++kk) {
          const bool match = hamb || hb == rbase[kk];
          const T prior = match ? p_match[kk] : p_mis[kk];
          const T M = A::mul(prior, A::add(A::mul(t_mm[kk], dM),
                                           A::mul(t_gapm[kk], A::add(dX, dY))));
          const T X = A::add(A::mul(t_pi[kk], uM), A::mul(t_pc[kk], uX));
          const T Y = A::add(A::mul(t_pd[kk], pM[kk]), A::mul(t_pc[kk], pY[kk]));
          dM = pM[kk];
          dX = pX[kk];
          dY = pY[kk];
          uM = M;
          uX = X;
          pM[kk] = M;
          pX[kk] = X;
          pY[kk] = Y;
        }
        if (result_lane && s == S - 1) fin = A::add(fin, A::add(pM[RR - 1], pX[RR - 1]));
        if (writes_top) {
          top_m[j] = pM[RR - 1];
          top_x[j] = pX[RR - 1];
          top_y[j] = pY[RR - 1];
        }
      }
      qM = rM;
      qX = rX;
      qY = rY;
    }
    __syncwarp();                       // the top row, before the next strip
  }
  if (result_lane && S > 0) out[k] = fin;
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock, 2) phmm_kernel(Args a,
                                                                       const T* __restrict__ ph2pr,
                                                                       T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T tab[kQualMax + 1];
  for (int q = threadIdx.x; q <= kQualMax; q += blockDim.x) tab[q] = ph2pr[q];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * warps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  unsigned char* slice = a.scratch != nullptr ? a.scratch + gw * a.warp_bytes
                                              : smem + static_cast<int64_t>(warp) * a.warp_bytes;
  T* top_m = reinterpret_cast<T*>(slice);
  T* top_x = top_m + (a.h_max + 1);
  T* top_y = top_x + (a.h_max + 1);

  for (int64_t vw = gw; vw < a.n_vwarps; vw += stride) {
    // this virtual warp's class: the last whose first warp is at or before it
    int c = 0;
    while (c + 1 < a.n_classes && a.classes[(c + 1) * kClassCols] <= vw) ++c;
    const int64_t* row = a.classes + c * kClassCols;
    const int g = static_cast<int>(row[3] >> 8), rr = static_cast<int>(row[3] & 0xFF);
    const int64_t slot0 = (vw - row[0]) * (32 / g);
    if (slot0 >= row[2]) continue;      // past the class's pairs (a bound on the grid)
    switch (rr) {
#define GB_PHMM_CASE(R_)                                                                    \
  case R_:                                                                                  \
    if constexpr (R_ <= Rn<T>::kMaxRows)                                                    \
      phmm_warp<T, R_>(a, tab, g, slot0, row[1], row[2], top_m, top_x, top_y, out);         \
    break;
      GB_PHMM_CASE(1)
      GB_PHMM_CASE(2)
      GB_PHMM_CASE(3)
      GB_PHMM_CASE(4)
      GB_PHMM_CASE(5)
      GB_PHMM_CASE(6)
      GB_PHMM_CASE(7)
#undef GB_PHMM_CASE
      default:
        break;
    }
  }
}

template <typename T>
int launch(Args a, const void* ph2pr, int blocks, int warps_per_block, void* out, void* stream) {
  if (a.n <= 0) return 0;
  const int64_t rows_bytes = ((3 * (a.h_max + 1) * static_cast<int64_t>(sizeof(T)) + 15) / 16) * 16;
  if (a.h_max < 0 || blocks < 1 || warps_per_block < 1 ||
      warps_per_block > kMaxWarpsPerBlock || a.warp_bytes < rows_bytes || a.n_classes < 1 ||
      a.n_vwarps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = phmm_kernel<T>;
  const size_t shared =
      a.scratch != nullptr ? 0 : static_cast<size_t>(warps_per_block) * a.warp_bytes;
  // past 48 KB with the static table, the block opts in to more
  if (shared + (kQualMax + 1) * sizeof(T) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), 32 * warps_per_block, shared,
           static_cast<cudaStream_t>(stream)>>>(a, static_cast<const T*>(ph2pr),
                                                 static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* bases, const void* q, const void* i, const void* d, const void* c,
               const void* r_off, const void* haps, const void* h_off, const void* pair_r,
               const void* pair_h, const void* idx, const void* order, const void* classes,
               int64_t n, int n_classes, int64_t n_vwarps, int init_exp, int64_t h_max,
               void* scratch, int warp_bytes) {
  return Args{static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(q),
              static_cast<const uint8_t*>(i), static_cast<const uint8_t*>(d),
              static_cast<const uint8_t*>(c), static_cast<const int64_t*>(r_off),
              static_cast<const uint8_t*>(haps), static_cast<const int64_t*>(h_off),
              static_cast<const int32_t*>(pair_r), static_cast<const int32_t*>(pair_h),
              static_cast<const int64_t*>(idx), static_cast<const int64_t*>(order),
              static_cast<const int64_t*>(classes), n, n_classes, n_vwarps, init_exp, h_max,
              static_cast<unsigned char*>(scratch), warp_bytes};
}

}  // namespace

// Unique reads: bases and the q/i/d/c quality planes (u8, clamped to
// [0, 127] by the host; the kernel clamps again), read r at [r_off[r],
// r_off[r+1]) (i64); haplotypes (u8), h at [h_off[h], h_off[h+1]); pair p =
// (pair_r[p], pair_h[p]) (i32).  idx (n,) i64 lists the pairs to compute
// (null: pairs 0..n-1); out[k] is the scaled forward probability of pair
// idx[k].  order (n,) i64 is a permutation of 0..n-1, the list positions in
// the order the warps take them, grouped by class; classes (n_classes, 4)
// i64 holds per class its first virtual warp, its first slot in `order`,
// its pair count and (g << 8) | RR, classes in order of first warp, every
// class of g < 32 lanes holding pairs of at most g * RR rows, and RR at
// most 7 (float) or 3 (double).  n_vwarps virtual warps (at least the sum
// of the classes' warps; those past a class's pairs do nothing) stride
// over a grid of `blocks` blocks of warps_per_block warps.  ph2pr is the
// 128-entry table in the instance's type.  A warp whose pairs run in
// strips holds a top row of warp_bytes >= 3 (h_max + 1) sizeof(T), rounded
// up to 16: in shared memory (warps_per_block of them per block), or, when
// scratch is not null, in device scratch of blocks x warps_per_block
// slices.  Launches on `stream`, does not synchronise, and returns the
// CUDA error of the launch (0 on success).
extern "C" int gb_pairhmm_f32(
    const void* bases, const void* q, const void* i, const void* d, const void* c,
    const void* r_off, const void* haps, const void* h_off, const void* pair_r,
    const void* pair_h, const void* idx, const void* order, const void* classes, int64_t n,
    int n_classes, int64_t n_vwarps, const void* ph2pr, int64_t h_max, void* scratch,
    int blocks, int warps_per_block, int warp_bytes, void* out, void* stream) {
  return launch<float>(make_args(bases, q, i, d, c, r_off, haps, h_off, pair_r, pair_h, idx,
                                 order, classes, n, n_classes, n_vwarps, 120, h_max, scratch,
                                 warp_bytes),
                       ph2pr, blocks, warps_per_block, out, stream);
}

extern "C" int gb_pairhmm_f64(
    const void* bases, const void* q, const void* i, const void* d, const void* c,
    const void* r_off, const void* haps, const void* h_off, const void* pair_r,
    const void* pair_h, const void* idx, const void* order, const void* classes, int64_t n,
    int n_classes, int64_t n_vwarps, const void* ph2pr, int64_t h_max, void* scratch,
    int blocks, int warps_per_block, int warp_bytes, void* out, void* stream) {
  return launch<double>(make_args(bases, q, i, d, c, r_off, haps, h_off, pair_r, pair_h, idx,
                                  order, classes, n, n_classes, n_vwarps, 1020, h_max, scratch,
                                  warp_bytes),
                        ph2pr, blocks, warps_per_block, out, stream);
}
