// f5c call-methylation for Hopper: the forward pass of the R9 CpG profile
// HMM (f5c hmm.c:305-527 profile_hmm_fill_generic_r9), one kernel.
//
// gb_meth_forward replaces the JAX package's `_phmm_meth_scan`
// (genomicsbench_tpu/ops/methylation.py:241-307).  It computes what the
// port's plain version `meth_forward_reference` (ops/methylation.py)
// computes, in float32 with the -1e30 sentinel, within the JAX package's
// own bound (rel 2e-4, abs 2e-3): the two differ only in the last bits of
// expf/log1pf and in the order the K state's along-blocks chain is summed.
// Each product and sum of the emission and of the k-mer level planes
// (scale * mean + shift, stdv * var, log stdv + log var) is an
// __fmul_rn / __fadd_rn / __fsub_rn intrinsic, so nvcc forms no FMA and the
// planes equal the ones the JAX package builds in numpy, bit for bit.  No
// --use_fast_math: __expf is looser than expf, and the error would grow
// over thousands of rows.
//
// Layout.  One warp per instance (a CpG group's reference or methylated
// variant against its event rows), one warp per block, one launch for the
// batch.  A lane holds about 150 registers, so an SM holds 12 to 14
// warps; with several warps to a block, a block would hold its SM's
// registers until its longest instance ended (rows run from 12 to a few
// hundred), so each warp is its own block and leaves as soon as its
// instance is done.  The launch bound asks for 12 such blocks per SM (at
// most 170 registers): at 14 ptxas spills.  Lane l owns
// the contiguous blocks [l*C, l*C + C) of the instance's K k-mer blocks,
// C = ceil(K / 32) <= 8, in registers: the three states M, B, K and the
// block's scaled level (mean, stdv, log stdv).  The rows go in sequence.
// Per row:
//   * M and B of block b read block b and b-1 of the previous row: b-1 is
//     the same lane's register, or for a lane's first block the previous
//     lane's last one, by __shfl_up_sync;
//   * K(b) = logaddexp(u(b), lp_kk + K(b-1)) is a first-order recurrence
//     along the blocks: each lane folds its own blocks from -1e30, the
//     lanes' maps x -> logaddexp(U, S + x) combine in a warp scan (JAX's
//     `combine`, :256-260), and each lane then runs its blocks again from
//     the K of the block before its first;
//   * the lane holding block K-1 adds the end state with the post flank.
// The event of the next row is loaded while the current row runs; all
// lanes read the same address (one broadcast).
//
// Bound.  The forward pass needs, per (row, block) cell, seven logaddexp
// (four for M, one for B, one for u, one for K), eleven adds and the
// emission (sub, div, two mul, two sub); per row, with both clip flags, the
// pre flank's logaddexp at block 0 and the end state's three and one add;
// per block, once, the level planes' two mul and two add.  A logaddexp is
// max, sub, add, expf and log1pf; the FP32 and MUFU instructions these
// compile to are METH_FP32_PER_LA and METH_MUFU_PER_LA of
// ops/methylation.py, which holds the counts (METH_FP32_OPS_PER_CELL FP32
// instructions at 128 lanes per SM, METH_MUFU_OPS_PER_CELL special-function
// ones at 16 per SM, and the per-row and per-block terms): the FP32 pipe
// sets the bound.  This design's own extra work is left out: the K fold
// and its rerun (two logaddexp per cell where the recurrence needs one),
// the warp scan (five logaddexp per lane and row), the shuffles and the
// idle lanes of an instance with K < 32 blocks.  Bytes: each instance's
// ranks once, its events once, its 32 bytes of offsets, one float out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kModel = 15625;             // 5^6 ACGMT k-mers
constexpr int kParams = 16;               // scale shift var log_var, 10 transitions, 2 pad
constexpr int kMaxChunk = 8;              // blocks per lane: K <= 256
constexpr float kNeg = -1e30f;
constexpr float kLogInvSqrt2Pi = -0x1.d67f0ap-1f;   // float32(-0.918938)
constexpr int kPreClip = 1, kPostClip = 2;          // HAF_ALLOW_PRE_CLIP, _POST_CLIP

// logaddexp as XLA computes it: max + log1p(exp(-|a - b|))
__device__ __forceinline__ float la(float a, float b) {
  const float m = fmaxf(a, b);
  return __fadd_rn(m, log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

__global__ void __launch_bounds__(32, 12)
meth_forward_kernel(const int16_t* __restrict__ ranks, const int64_t* __restrict__ rank_off,
                    const int64_t* __restrict__ ev_first, const int64_t* __restrict__ ev_last,
                    const int32_t* __restrict__ read, const float* __restrict__ events,
                    const float* __restrict__ params, const float* __restrict__ model,
                    const float* __restrict__ flank, int64_t n_inst, int flags,
                    float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int64_t g = blockIdx.x;           // one warp per block, one block per instance

  const int64_t r0 = rank_off[g];
  const int K = static_cast<int>(rank_off[g + 1] - r0);
  const int64_t e0 = ev_first[g], e1 = ev_last[g];
  const int64_t step = e1 >= e0 ? 1 : -1;
  const int E = static_cast<int>(e1 >= e0 ? e1 - e0 : e0 - e1) + 1;
  const float* p = params + static_cast<int64_t>(read[g]) * kParams;
  const float scale = p[0], shift = p[1], var = p[2], log_var = p[3];
  const float lp_mk = p[4], lp_mb = p[5], lp_mm_self = p[6], lp_mm_next = p[7];
  const float lp_bb = p[8], lp_bk = p[9], lp_bm_next = p[10], lp_bm_self = p[11];
  const float lp_kk = p[12], lp_km = p[13];

  const int C = (K + 31) >> 5;            // blocks per lane
  const int b0 = lane * C;                // this lane's first block
  const int last_lane = (K - 1) / C;      // the lane and slot of block K-1
  const int last_j = (K - 1) - last_lane * C;
  const float lane_s = __fmul_rn(static_cast<float>(C), lp_kk);   // its chunk's K step

  float gm[kMaxChunk], gs[kMaxChunk], gl[kMaxChunk];
  float M[kMaxChunk], B[kMaxChunk], Ks[kMaxChunk], u[kMaxChunk];
#pragma unroll
  for (int j = 0; j < kMaxChunk; ++j) {
    const int b = b0 + j;
    gm[j] = 0.f;
    gs[j] = 1.f;
    gl[j] = 0.f;
    if (j < C && b < K) {
      const int r = ranks[r0 + b];
      gm[j] = __fadd_rn(__fmul_rn(scale, model[r]), shift);
      gs[j] = __fmul_rn(model[kModel + r], var);
      gl[j] = __fadd_rn(model[2 * kModel + r], log_var);
    }
    M[j] = B[j] = Ks[j] = u[j] = kNeg;
  }

  float lp_end = kNeg;
  float ev = events[e0];
  for (int row = 1; row <= E; ++row) {
    const float ev_next = row < E ? events[e0 + row * step] : 0.f;
    const float pre = flank[row - 1];
    const float post = flank[E - row];

    // the previous row's states of the block before this lane's first
    float lm = kNeg, lb = kNeg, lk = kNeg;
#pragma unroll
    for (int j = 0; j < kMaxChunk; ++j)
      if (j == C - 1) { lm = M[j]; lb = B[j]; lk = Ks[j]; }
    float pm = __shfl_up_sync(kFull, lm, 1);
    float pb = __shfl_up_sync(kFull, lb, 1);
    float pk = __shfl_up_sync(kFull, lk, 1);
    if (lane == 0) pm = pb = pk = kNeg;

    // M and B (JAX :265-278)
#pragma unroll
    for (int j = 0; j < kMaxChunk; ++j) {
      if (j < C) {
        const int b = b0 + j;
        const float mo = M[j], bo = B[j], ko = Ks[j];
        float s = la(__fadd_rn(lp_mm_self, mo), __fadd_rn(lp_mm_next, pm));
        s = la(s, __fadd_rn(lp_bm_self, bo));
        s = la(s, __fadd_rn(lp_bm_next, pb));
        s = la(s, __fadd_rn(lp_km, pk));
        if (b == 0 && ((flags & kPreClip) || row == 1)) s = la(s, pre);
        const float a = __fdiv_rn(__fsub_rn(ev, gm[j]), gs[j]);
        const float em = __fsub_rn(__fsub_rn(kLogInvSqrt2Pi, gl[j]),
                                   __fmul_rn(__fmul_rn(0.5f, a), a));
        const bool live = b < K;
        M[j] = live ? __fadd_rn(s, em) : kNeg;
        B[j] = live ? la(__fadd_rn(lp_mb, mo), __fadd_rn(lp_bb, bo)) : kNeg;
        pm = mo;
        pb = bo;
        pk = ko;
      }
    }

    // u(b) from this row's M and B of block b-1, and the lane's K fold
#pragma unroll
    for (int j = 0; j < kMaxChunk; ++j)
      if (j == C - 1) { lm = M[j]; lb = B[j]; }
    pm = __shfl_up_sync(kFull, lm, 1);
    pb = __shfl_up_sync(kFull, lb, 1);
    if (lane == 0) pm = pb = kNeg;
    float fold = kNeg;
#pragma unroll
    for (int j = 0; j < kMaxChunk; ++j) {
      if (j < C) {
        u[j] = b0 + j < K ? la(__fadd_rn(lp_mk, pm), __fadd_rn(lp_bk, pb)) : kNeg;
        pm = M[j];
        pb = B[j];
        fold = la(u[j], __fadd_rn(lp_kk, fold));
      }
    }
    // the lanes' maps x -> logaddexp(U, S + x), combined in a warp scan
    float U = fold, S = lane_s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float Uo = __shfl_up_sync(kFull, U, d);
      const float So = __shfl_up_sync(kFull, S, d);
      if (lane >= d) {
        U = la(U, __fadd_rn(S, Uo));
        S = __fadd_rn(So, S);
      }
    }
    float x = __shfl_up_sync(kFull, U, 1);     // K of the block before this lane's first
    if (lane == 0) x = kNeg;
    float em = kNeg, eb = kNeg, ek = kNeg;
#pragma unroll
    for (int j = 0; j < kMaxChunk; ++j) {
      if (j < C) {
        x = la(u[j], __fadd_rn(lp_kk, x));
        Ks[j] = b0 + j < K ? x : kNeg;
        if (j == last_j) { em = M[j]; eb = B[j]; ek = Ks[j]; }
      }
    }
    // the end state (JAX :287-291), on the lane of block K-1
    if ((flags & kPostClip) || row == E)
      lp_end = la(lp_end, __fadd_rn(la(la(em, eb), ek), post));
    ev = ev_next;
  }
  if (lane == last_lane) out[g] = lp_end;
}

}  // namespace

// ranks (int16, 0..15624), rank_off (int64, n_inst + 1), ev_first and
// ev_last (int64, n_inst: an instance's rows are events ev_first,
// ev_first +- 1, ..., ev_last), read (int32, n_inst: its row of params),
// events (f32), params (f32, rows of 16: scale, shift, var, log var, the
// ten transitions), model (f32, 3 x 15625: level mean, stdv, log stdv),
// flank (f32, at least the longest instance's rows), flags
// (HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP bits); out (f32, n_inst) the
// forward scores.  Every instance has 1 to 256 k-mers.  Launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch.
extern "C" int gb_meth_forward(const void* ranks, const void* rank_off, const void* ev_first,
                               const void* ev_last, const void* read, const void* events,
                               const void* params, const void* model, const void* flank,
                               int64_t n_inst, int flags, void* out, void* stream) {
  if (n_inst <= 0) return 0;
  meth_forward_kernel<<<static_cast<unsigned>(n_inst), 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(ranks), static_cast<const int64_t*>(rank_off),
      static_cast<const int64_t*>(ev_first), static_cast<const int64_t*>(ev_last),
      static_cast<const int32_t*>(read), static_cast<const float*>(events),
      static_cast<const float*>(params), static_cast<const float*>(model),
      static_cast<const float*>(flank), n_inst, flags, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
