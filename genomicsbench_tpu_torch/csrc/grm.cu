// plink2 --make-grm-bin (the grm workload) for Hopper: the two passes of the
// GCTA relationship matrix that are not matrix products.  Two kernels:
//
//   gb_grm_standardize  one block of variants: the 2-bit unpack, each
//                       variant's observed count and allele frequency, and
//                       the standardised dosages x and observed mask w,
//                       replacing the elementwise part of the JAX package's
//                       `_grm_block_body` (genomicsbench_tpu/ops/grm.py:29-48,
//                       w at :56);
//   gb_grm_finish       num / max(den, 1) and the row-major lower-triangle
//                       gather of both planes, replacing `_grm_tril` (:89):
//                       exactly the layout of plink's .grm.bin and
//                       .grm.N.bin.
//
// Between them the products num += x^T x and den += w^T w stay cuBLAS f32
// GEMMs with TF32 off, as the JAX package leaves them to XLA at
// Precision.HIGHEST.  The MAF filter is the host's float64 test, as in the
// JAX package (grm.py:103-108): the kernel takes its verdict per variant.
//
// Rounding.  Every f32 operation is an __f*_rn intrinsic in the JAX
// package's order, so nvcc contracts nothing into an FMA and x and w equal
// the plain version's in ops/grm.py bit for bit: p = sum / max(2 n_obs, 1);
// denom = sqrt(max((2 p) (1 - p), 1e-30)); x = ((g - 2 p) / denom) * use *
// obs; w = obs * use.  n_obs and the dosage sum are integer counts, exact
// in any order, and below 2^24, so their float conversions are exact too.
//
// Layout.  packed is (Mb, Nb / 4) uint8, four 2-bit codes a byte, LSB
// first: lane l of byte b is sample 4b + l (0/1/2 dosage, 3 missing; the
// pad samples are 3, so their x and w are 0).  x and w are (Mb, Nb) f32
// row-major.  gb_grm_standardize runs one block of 256 threads per variant:
// a first pass over the row's bytes counts, a block reduction (warp
// shuffles, then the eight warp totals from shared memory in every thread)
// gives n_obs and the sum, a second pass writes each byte's four samples
// as one float4 of x and one of w.  Bound: bytes, Nb / 4 + 1 in and 8 Nb
// out per variant; the writes are 32 times the reads.
//
// gb_grm_finish runs one block per row i < N, threads over the columns
// j <= i, and writes out[0][i (i + 1) / 2 + j] = num[i][j] / max(den[i][j],
// 1) and out[1][...] = den[i][j]: both vectors in one (2, N (N + 1) / 2)
// buffer, fetched by one copy.  Bound: bytes, the two lower triangles read
// and written once, 16 bytes per entry.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
standardize_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ maf_ok,
                   int bytes, float* __restrict__ x, float* __restrict__ w) {
  __shared__ int red[2][kWarps];
  const int64_t v = blockIdx.x;
  const uint8_t* row = packed + v * bytes;
  int nobs = 0, sum = 0;
  for (int b = threadIdx.x; b < bytes; b += kThreads) {
    const unsigned byte = row[b];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int code = (byte >> (2 * l)) & 3;
      nobs += code != 3;
      sum += code != 3 ? code : 0;
    }
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    nobs += __shfl_xor_sync(kFull, nobs, d);
    sum += __shfl_xor_sync(kFull, sum, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = nobs;
    red[1][warp] = sum;
  }
  __syncthreads();
  nobs = 0;
  sum = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    nobs += red[0][k];
    sum += red[1][k];
  }
  const float fn = static_cast<float>(nobs);
  const float p = __fdiv_rn(static_cast<float>(sum), fmaxf(__fmul_rn(2.0f, fn), 1.0f));
  const float two_p = __fmul_rn(2.0f, p);
  const float denom = __fsqrt_rn(fmaxf(__fmul_rn(two_p, __fsub_rn(1.0f, p)), 1e-30f));
  const float use = (maf_ok[v] != 0 && nobs > 0) ? 1.0f : 0.0f;
  float4* xr = reinterpret_cast<float4*>(x + v * 4 * bytes);
  float4* wr = reinterpret_cast<float4*>(w + v * 4 * bytes);
  for (int b = threadIdx.x; b < bytes; b += kThreads) {
    const unsigned byte = row[b];
    float xs[4], ws[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int code = (byte >> (2 * l)) & 3;
      const float obs = code != 3 ? 1.0f : 0.0f;
      const float g = code != 3 ? static_cast<float>(code) : 0.0f;
      const float z = __fdiv_rn(__fsub_rn(g, two_p), denom);
      xs[l] = __fmul_rn(__fmul_rn(z, use), obs);
      ws[l] = __fmul_rn(obs, use);
    }
    xr[b] = make_float4(xs[0], xs[1], xs[2], xs[3]);
    wr[b] = make_float4(ws[0], ws[1], ws[2], ws[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ num, const float* __restrict__ den, int ld,
              int64_t tri, float* __restrict__ out) {
  const int64_t i = blockIdx.x;
  const int64_t base = i * (i + 1) / 2;
  const float* nr = num + i * ld;
  const float* dr = den + i * ld;
  for (int64_t j = threadIdx.x; j <= i; j += kThreads) {
    const float d = dr[j];
    out[base + j] = __fdiv_rn(nr[j], fmaxf(d, 1.0f));
    out[tri + base + j] = d;
  }
}

}  // namespace

// packed (Mb, bytes) uint8, maf_ok (Mb,) uint8 (nonzero: the variant passes
// the host's MAF filter); x and w (Mb, 4 * bytes) f32.
extern "C" int gb_grm_standardize(const void* packed, const void* maf_ok, int64_t Mb, int bytes,
                                  void* x, void* w, void* stream) {
  if (Mb <= 0 || bytes <= 0) return 0;
  if (Mb > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  standardize_kernel<<<static_cast<unsigned>(Mb), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(maf_ok), bytes,
      static_cast<float*>(x), static_cast<float*>(w));
  return static_cast<int>(cudaGetLastError());
}

// num and den (>= N, ld) f32 row-major; out (2, N (N + 1) / 2) f32.
extern "C" int gb_grm_finish(const void* num, const void* den, int ld, int N, void* out,
                             void* stream) {
  if (N <= 0) return 0;
  const int64_t tri = static_cast<int64_t>(N) * (N + 1) / 2;
  finish_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(num), static_cast<const float*>(den), ld, tri,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
