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
// The prior's select, the base compare, the per-row coefficients (a few
// operations per row) and the data movement (shuffles, the strip's top row,
// loop control) are left out, so the bound is a floor.  The rate is the
// card's FP32 rate outside the tensor cores, 128 lanes per SM x 132 SMs x
// the SM clock, and for double its FP64 rate, 64 lanes per SM.  The bytes
// (the unique reads' 5 planes, the haplotypes, offsets, pair indices, one
// result per pair) are a few microseconds at the memory rate, so the
// kernel is bound by operations.
//
// Design.  One warp per pair.  The read is cut into strips of 32 rows; lane
// l owns row 32 s + l + 1 of strip s, with that row's coefficients in
// registers.  The warp sweeps the haplotype as a wavefront: at step t lane l
// is at column t - l, so a strip takes H + 31 steps.  A cell needs
//   (i-1, j)   lane l-1's values of the previous step, by __shfl_up_sync;
//   (i-1, j-1) the values the lane received one step earlier (a register);
//   (i, j-1)   the lane's own previous values (registers).
// Lane 0 takes row i-1 from the strip's top row: M, X, Y of columns 1..H,
// which lane 31 of the previous strip writes as it goes (row 0, the
// boundary M = X = 0 and Y = 2^E / H, for the first strip).  The top row and
// the haplotype live in shared memory, one slice per warp; past a block's
// shared memory (haplotypes of thousands of bases) the same slices live in
// device scratch, one per warp of a capped grid that strides over the pairs.
// The lane of row R adds M + X of each of its columns to the result in
// column order.  Every branch that holds a collective is uniform across the
// warp.
//
// Left for later: the wavefront wastes 31 of every H + 31 steps per strip
// and the lanes past R in a pair's last strip; packing two pairs into one
// warp, or pairs of similar length into one block, would fill them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kAmbig = 4;
constexpr int kQualMax = 127;

template <typename T> struct Rn;
template <> struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};
template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock) phmm_warp_kernel(
    const uint8_t* __restrict__ bases, const uint8_t* __restrict__ qq,
    const uint8_t* __restrict__ qi, const uint8_t* __restrict__ qd,
    const uint8_t* __restrict__ qc, const int64_t* __restrict__ r_off,
    const uint8_t* __restrict__ haps, const int64_t* __restrict__ h_off,
    const int32_t* __restrict__ pair_r, const int32_t* __restrict__ pair_h,
    const int64_t* __restrict__ idx, int64_t n, const T* __restrict__ ph2pr,
    int init_exp, int64_t h_max, unsigned char* scratch, int warp_bytes,
    T* __restrict__ out) {
  using A = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T tab[kQualMax + 1];
  for (int k = threadIdx.x; k <= kQualMax; k += blockDim.x) tab[k] = ph2pr[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * warps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  unsigned char* slice = scratch != nullptr ? scratch + gw * warp_bytes
                                            : smem + static_cast<int64_t>(warp) * warp_bytes;
  T* top_m = reinterpret_cast<T*>(slice);
  T* top_x = top_m + (h_max + 1);
  T* top_y = top_x + (h_max + 1);
  // the haplotype after the three rows, 16-byte aligned as the host sizes it
  const int64_t rows_bytes = ((3 * (h_max + 1) * static_cast<int64_t>(sizeof(T)) + 15) / 16) * 16;
  uint8_t* hap = slice + rows_bytes;
  const T scale = static_cast<T>(ldexp(1.0, init_exp));   // 2^E, exact
  const T one = static_cast<T>(1), zero = static_cast<T>(0), three = static_cast<T>(3);

  for (int64_t k = gw; k < n; k += stride) {
    const int64_t p = idx != nullptr ? idx[k] : k;
    const int64_t r = pair_r[p], h = pair_h[p];
    const int64_t rb0 = r_off[r], hb0 = h_off[h];
    const int R = static_cast<int>(r_off[r + 1] - rb0);
    const int H = static_cast<int>(h_off[h + 1] - hb0);
    if (R == 0 || H == 0) {             // nothing to sum: the result is 0
      if (lane == 0) out[k] = zero;
      continue;
    }
    const T init_y = A::div(scale, static_cast<T>(H));
    for (int j = lane; j < H; j += 32) hap[j] = haps[hb0 + j];
    for (int j = lane; j <= H; j += 32) {
      top_m[j] = zero;
      top_x[j] = zero;
      top_y[j] = init_y;
    }
    __syncwarp();

    T fin = zero;
    const int strips = (R + 31) / 32;
    for (int s = 0; s < strips; ++s) {
      const int i = 32 * s + lane + 1;  // this lane's row, from 1
      const bool row_ok = i <= R;
      T t_mm = zero, t_gapm = zero, t_mx = zero, t_xx = zero, t_my = zero, t_yy = zero;
      T p_match = zero, p_mis = zero;
      int rb = 0;
      if (row_ok) {
        const int64_t o = rb0 + i - 1;
        const T pi = tab[min(static_cast<int>(qi[o]), kQualMax)];
        const T pd = tab[min(static_cast<int>(qd[o]), kQualMax)];
        const T pc = tab[min(static_cast<int>(qc[o]), kQualMax)];
        const T pq = tab[min(static_cast<int>(qq[o]), kQualMax)];
        const T gap_open = A::add(pi, pd);
        t_mm = A::sub(one, gap_open < one ? gap_open : one);
        t_gapm = A::sub(one, pc);
        t_mx = pi;
        t_xx = pc;
        t_my = pd;
        t_yy = pc;
        p_match = A::sub(one, pq);
        p_mis = A::div(pq, three);
        rb = bases[o];
      }
      // (i-1, j-1) at column 1: the column-0 boundary, Y = 2^E / H in row 0
      T dM = zero, dX = zero, dY = (s == 0 && lane == 0) ? init_y : zero;
      T lM = zero, lY = zero;           // (i, j-1): column 0 of a row >= 1
      T cM = zero, cX = zero, cY = zero;  // this lane's last cell, for lane l+1
      const bool result_row = i == R;
      const bool writes_top = lane == 31 && s + 1 < strips;
      for (int t = 1; t <= H + 31; ++t) {
        T uM = __shfl_up_sync(kFull, cM, 1);
        T uX = __shfl_up_sync(kFull, cX, 1);
        T uY = __shfl_up_sync(kFull, cY, 1);
        const int j = t - lane;
        if (lane == 0 && j <= H) {
          uM = top_m[j];
          uX = top_x[j];
          uY = top_y[j];
        }
        if (row_ok && j >= 1 && j <= H) {
          const int hb = hap[j - 1];
          const bool match = hb == rb || rb == kAmbig || hb == kAmbig;
          const T prior = match ? p_match : p_mis;
          const T M = A::mul(prior, A::add(A::mul(t_mm, dM),
                                           A::mul(t_gapm, A::add(dX, dY))));
          const T X = A::add(A::mul(t_mx, uM), A::mul(t_xx, uX));
          const T Y = A::add(A::mul(t_my, lM), A::mul(t_yy, lY));
          if (result_row) fin = A::add(fin, A::add(M, X));
          if (writes_top) {
            top_m[j] = M;
            top_x[j] = X;
            top_y[j] = Y;
          }
          dM = uM;
          dX = uX;
          dY = uY;
          lM = M;
          lY = Y;
          cM = M;
          cX = X;
          cY = Y;
        }
      }
      __syncwarp();                     // the top row, before the next strip
    }
    if (lane == (R - 1) % 32) out[k] = fin;
    __syncwarp();                       // the slice, before the next pair
  }
}

template <typename T>
int launch(const void* bases, const void* q, const void* i, const void* d,
           const void* c, const void* r_off, const void* haps, const void* h_off,
           const void* pair_r, const void* pair_h, const void* idx, int64_t n,
           const void* ph2pr, int init_exp, int64_t h_max, void* scratch,
           int blocks, int warps_per_block, int warp_bytes, void* out,
           void* stream) {
  if (n <= 0) return 0;
  const int64_t rows_bytes = ((3 * (h_max + 1) * static_cast<int64_t>(sizeof(T)) + 15) / 16) * 16;
  if (h_max < 0 || blocks < 1 || warps_per_block < 1 ||
      warps_per_block > kMaxWarpsPerBlock || warp_bytes < rows_bytes + h_max)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = phmm_warp_kernel<T>;
  const size_t shared =
      scratch != nullptr ? 0 : static_cast<size_t>(warps_per_block) * warp_bytes;
  // past 48 KB with the static table, the block opts in to more
  if (shared + (kQualMax + 1) * sizeof(T) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), 32 * warps_per_block, shared,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(q),
      static_cast<const uint8_t*>(i), static_cast<const uint8_t*>(d),
      static_cast<const uint8_t*>(c), static_cast<const int64_t*>(r_off),
      static_cast<const uint8_t*>(haps), static_cast<const int64_t*>(h_off),
      static_cast<const int32_t*>(pair_r), static_cast<const int32_t*>(pair_h),
      static_cast<const int64_t*>(idx), n, static_cast<const T*>(ph2pr), init_exp,
      h_max, static_cast<unsigned char*>(scratch), warp_bytes, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Unique reads: bases and the q/i/d/c quality planes (u8, clamped to
// [0, 127] by the host; the kernel clamps again), read r at [r_off[r],
// r_off[r+1]) (i64); haplotypes (u8), h at [h_off[h], h_off[h+1]); pair p =
// (pair_r[p], pair_h[p]) (i32).  idx (n,) i64 lists the pairs to compute
// (null: pairs 0..n-1); out[k] is the scaled forward probability of pair
// idx[k].  ph2pr is the 128-entry table in the instance's type.  Each warp
// holds a slice of warp_bytes >= 3 (h_max + 1) sizeof(T), rounded up to 16,
// plus h_max: in shared memory (warps_per_block of them per block), or,
// when scratch is not null, in device scratch of blocks x warps_per_block
// slices.  A grid of `blocks` blocks strides over the n pairs.  Launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch
// (0 on success).
extern "C" int gb_pairhmm_f32(
    const void* bases, const void* q, const void* i, const void* d, const void* c,
    const void* r_off, const void* haps, const void* h_off, const void* pair_r,
    const void* pair_h, const void* idx, int64_t n, const void* ph2pr, int64_t h_max,
    void* scratch, int blocks, int warps_per_block, int warp_bytes, void* out,
    void* stream) {
  return launch<float>(bases, q, i, d, c, r_off, haps, h_off, pair_r, pair_h, idx, n,
                       ph2pr, 120, h_max, scratch, blocks, warps_per_block, warp_bytes,
                       out, stream);
}

extern "C" int gb_pairhmm_f64(
    const void* bases, const void* q, const void* i, const void* d, const void* c,
    const void* r_off, const void* haps, const void* h_off, const void* pair_r,
    const void* pair_h, const void* idx, int64_t n, const void* ph2pr, int64_t h_max,
    void* scratch, int blocks, int warps_per_block, int warp_bytes, void* out,
    void* stream) {
  return launch<double>(bases, q, i, d, c, r_off, haps, h_off, pair_r, pair_h, idx, n,
                        ph2pr, 1020, h_max, scratch, blocks, warps_per_block, warp_bytes,
                        out, stream);
}
