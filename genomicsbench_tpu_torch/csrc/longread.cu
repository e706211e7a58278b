// Long-read banded global alignment for Hopper: one read's banded
// Needleman-Wunsch score with linear gaps, the whole band in one thread
// block.  One kernel:
//
//   gb_longread_nw  replaces the JAX package's `sharded_banded_nw` `step`
//                   and its `lax.scan` over target rows
//                   (genomicsbench_tpu/ops/longread.py:113-144) on one
//                   device: D = 1, no halo, the cummax over the whole band.
//
// Band coordinates as in the JAX package: lane k of target row i holds
// query position j = i + k - W / 2, so a row of the band is an
// anti-diagonal strip of the (target x query) matrix.  Per row, for each
// lane: diag = H[i-1][k] + s(q[j-1], t[i-1]) where j >= 1 and H[i-1][k] >
// NEG / 2; up = H[i-1][k+1] - gap where that is > NEG / 2; B = max(diag,
// up); the left chain H[i][k-1] - gap in its closed form, pref = the
// inclusive max over k' <= k of key = B + k' gap (NEG where B <= NEG / 2)
// and left = pref - k gap; H[i][k] = max(B, left), NEG outside 0 <= j <= m.
// The score is H[n][kend], kend = m - n + W / 2, which the host checks lies
// in the band.  All int32, NEG = -(1 << 30), exactly the JAX package's
// arithmetic, so the score equals its and the oracle's.
//
// Design.  A block of T threads (a multiple of 32, at most 1,024) holds the
// band; thread t owns the L = ceil(W / 1024) consecutive lanes t L .. t L +
// L - 1 in registers while a row is computed.  The two H rows live in shared
// memory, double-buffered (2 W ints: 16 KB at W = 2,048; above 48 KB, past W
// 6,144, the block opts in).  The left chain is one block-wide inclusive
// max-scan per row: each thread's running max over its lanes, a warp scan of
// the thread totals by shuffles, the warp totals through shared memory and
// an all-reduce by shuffles over the earlier warps' totals in every warp.
// Two barriers a row: after the warp totals are written, and after the new
// row is.  The target base is read once a row (one broadcast load), the
// query through the row's sliding window j - 1 = i + k - W / 2 - 1 (global
// loads that hit L1: the window moves one base a row).
//
// Bound.  The rows are a chain: row i needs all of row i - 1, so one block
// on one SM computes them, and the card's other 131 SMs idle.  Over the
// whole card the bound is the int32 operations at 132 SMs x 64 lanes; over
// the one SM this design uses, 64 lanes; in practice the two barriers and
// the scan's shuffle latency each row set the time, not the arithmetic.
// Bytes are negligible: the query and the target, read once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLanes = 8;           // lanes per thread: a band of up to 8,192
constexpr int kNeg = -(1 << 30);
constexpr int kHalf = kNeg / 2;        // NEG // 2 in the JAX package: NEG is even
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kMaxThreads)
nw_kernel(const int* __restrict__ q, const int* __restrict__ t, int m, int n, int W, int L,
          int match, int mismatch, int gap, int* __restrict__ out) {
  extern __shared__ int rows[];        // [2][W]
  __shared__ int wtot[32];
  int* hp = rows;
  int* hn = rows + W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W2 = W / 2;
  const int k0 = threadIdx.x * L;
  for (int l = 0; l < L; ++l) {
    const int k = k0 + l;
    if (k < W) {
      const int j = k - W2;
      hp[k] = (j >= 0 && j <= m) ? -gap * j : kNeg;
    }
  }
  __syncthreads();
  for (int i = 1; i <= n; ++i) {
    const int ti = __ldg(t + i - 1);
    int B[kMaxLanes], pref[kMaxLanes];
    int run = kNeg;
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) {
      B[l] = kNeg;
      const int k = k0 + l;
      if (l < L && k < W) {
        const int j = i + k - W2;
        const int h = hp[k];
        int diag = kNeg;
        if (j >= 1 && h > kHalf) {
          const int qj = j - 1 < m ? __ldg(q + j - 1) : -1;    // the JAX pad is -1
          diag = h + (qj == ti ? match : mismatch);
        }
        const int us = k + 1 < W ? hp[k + 1] : kNeg;
        const int up = us > kHalf ? us - gap : kNeg;
        B[l] = max(diag, up);
        run = max(run, B[l] > kHalf ? B[l] + k * gap : kNeg);
      }
      pref[l] = run;
    }
    // inclusive max-scan of the thread totals across the block
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = max(incl, o);
    }
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kNeg;
    int before = lane < warp ? wtot[lane] : kNeg;    // the earlier warps' totals
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) before = max(before, __shfl_xor_sync(kFull, before, d));
    excl = max(excl, before);
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) {
      const int k = k0 + l;
      if (l < L && k < W) {
        const int j = i + k - W2;
        const int pr = max(pref[l], excl);
        const int left = pr > kHalf ? pr - k * gap : kNeg;
        hn[k] = (j >= 0 && j <= m) ? max(B[l], left) : kNeg;
      }
    }
    __syncthreads();
    int* tmp = hp;
    hp = hn;
    hn = tmp;
  }
  if (threadIdx.x == 0) *out = hp[m - n + W2];
}

}  // namespace

// q (m,) and t (n,) int32 codes; 1 <= W <= 8,192 with 0 <= m - n + W / 2 < W
// (the host checks both); out one int32, the score.
extern "C" int gb_longread_nw(const void* q, const void* t, int m, int n, int W, int match,
                              int mismatch, int gap, void* out, void* stream) {
  if (W < 1 || W > kMaxThreads * kMaxLanes || m < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kend = m - n + W / 2;
  if (kend < 0 || kend >= W) return static_cast<int>(cudaErrorInvalidValue);
  const int L = (W + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((W + L - 1) / L + 31) / 32 * 32;
  const size_t shared = static_cast<size_t>(2) * W * sizeof(int);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nw_kernel<<<1, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q), static_cast<const int*>(t), m, n, W, L, match, mismatch, gap,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
