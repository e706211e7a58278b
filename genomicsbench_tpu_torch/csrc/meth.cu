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
// Layout.  An instance (a CpG group's reference or methylated variant
// against its event rows) of K k-mer blocks takes a group of g lanes, g the
// smallest power of two from 1 to 32 with C = ceil(K / g) <= 8: lane i of
// the group owns the contiguous blocks [i*C, i*C + C), their three states
// M, B and K in registers, and in shared memory (a column a lane, so no
// barrier and no bank conflict) the block's scaled level (mean, stdv and
// log(1/sqrt(2 pi)) - log stdv) and the skip chain's u of the current row,
// which leaves a lane's registers to its states and the row's chains.  A
// warp runs 32 / g instances of one g at once, each warp its own block, one
// launch for the batch.  The host sorts
// the instances by g, and within g by rows x C, longest first
// (`lane_group_order` in ops/methylation.py), so the instances sharing a
// warp run about as long as each other; `order` maps each slot to its
// instance and the score is written at the instance's own index.  The
// rows go in sequence.  Per row:
//   * M and B of block b read block b and b-1 of the previous row: b-1 is
//     the same lane's register, or for a lane's first block the previous
//     lane's last one, by __shfl_up_sync within the group (width g); a
//     group's first lane takes -1e30;
//   * K(b) = logaddexp(u(b), lp_kk + K(b-1)) is a first-order recurrence
//     along the blocks.  With g = 1 it runs in sequence along the lane's
//     blocks, as f5c runs it.  With g > 1 each lane folds its own blocks
//     from -1e30, the lanes' maps x -> logaddexp(U, S + x) combine in a
//     scan of log2(g) steps within the group (JAX's `combine`, :256-260),
//     and each lane then runs its blocks again from the K of the block
//     before its first;
//   * the lane holding block K-1 adds the end state with the post flank.
// The event of the next row is loaded while the current row runs.  A warp
// runs to its longest instance's rows; a lane whose instance has ended
// keeps joining the shuffles and no longer touches its score.
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
// sets the bound.  This design's own extra work is left out: with g > 1
// the K fold and its rerun (two logaddexp per cell where the recurrence
// needs one) and the group scan (log2(g) logaddexp per lane and row), the
// end state on every lane, the shuffles and the blocks of a lane's last
// chunk past K.  Bytes: each instance's ranks once, its events once, its
// 40 bytes of offsets, read and slot, one float out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kModel = 15625;             // 5^6 ACGMT k-mers
constexpr int kParams = 16;               // scale shift var log_var, 10 transitions, 2 pad
constexpr int kMaxChunk = 8;              // blocks per lane: K <= 8 g
constexpr int kClasses = 6;               // lane groups of 1, 2, 4, 8, 16 and 32
constexpr int kBlocksPerSm = 16;          // one warp each: at most 128 registers a thread
constexpr float kNeg = -1e30f;
constexpr float kLogInvSqrt2Pi = -0x1.d67f0ap-1f;   // float32(-0.918938)
constexpr int kPreClip = 1, kPostClip = 2;          // HAF_ALLOW_PRE_CLIP, _POST_CLIP

// The instances of each lane-group size 2^c, in `order`: slots
// [first[c], first[c] + count[c]), on the warps from warp0[c]
struct Classes {
  int64_t first[kClasses];
  int64_t count[kClasses];
  int64_t warp0[kClasses + 1];
};

// logaddexp as XLA computes it: max + log1p(exp(-|a - b|))
__device__ __forceinline__ float la(float a, float b) {
  const float m = fmaxf(a, b);
  return __fadd_rn(m, log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

__global__ void __launch_bounds__(32, kBlocksPerSm)
meth_forward_kernel(const int16_t* __restrict__ ranks, const int64_t* __restrict__ rank_off,
                    const int64_t* __restrict__ ev_first, const int64_t* __restrict__ ev_last,
                    const int32_t* __restrict__ read, const float* __restrict__ events,
                    const float* __restrict__ params, const float* __restrict__ model,
                    const float* __restrict__ flank, const int32_t* __restrict__ order,
                    const Classes cls, int flags, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int64_t w = blockIdx.x;           // one warp per block
  int lg = 0;                             // this warp's class: groups of g = 2^lg lanes
  while (lg < kClasses - 1 && w >= cls.warp0[lg + 1]) ++lg;
  const int g = 1 << lg;
  const int li = lane & (g - 1);          // the lane's place in its group
  const int64_t slot = cls.first[lg] + (w - cls.warp0[lg]) * (32 >> lg) + (lane >> lg);
  // a group past the class's last instance takes a 1-block instance of no
  // rows: it joins the shuffles and writes nothing
  const bool has = slot < cls.first[lg] + cls.count[lg];
  const int64_t gi = order[has ? slot : cls.first[lg]];

  const int64_t r0 = rank_off[gi];
  const int K = has ? static_cast<int>(rank_off[gi + 1] - r0) : 1;
  const int64_t e0 = ev_first[gi], e1 = ev_last[gi];
  const int64_t step = e1 >= e0 ? 1 : -1;
  const int E = has ? static_cast<int>(e1 >= e0 ? e1 - e0 : e0 - e1) + 1 : 0;
  const float* p = params + static_cast<int64_t>(read[gi]) * kParams;
  const float scale = p[0], shift = p[1], var = p[2], log_var = p[3];
  const float lp_mk = p[4], lp_mb = p[5], lp_mm_self = p[6], lp_mm_next = p[7];
  const float lp_bb = p[8], lp_bk = p[9], lp_bm_next = p[10], lp_bm_self = p[11];
  const float lp_kk = p[12], lp_km = p[13];

  const int C = (K + g - 1) >> lg;        // blocks per lane, <= kMaxChunk (checked by the host)
  const int b0 = li * C;                  // this lane's first block
  const int last_lane = (K - 1) / C;      // the group lane of block K-1
  const float lane_s = __fmul_rn(static_cast<float>(C), lp_kk);   // its chunk's K step

  // the blocks' levels and the row's u, a column a lane
  __shared__ float gm[kMaxChunk][32], gs[kMaxChunk][32], gc[kMaxChunk][32], u[kMaxChunk][32];
  float M[kMaxChunk], B[kMaxChunk], Ks[kMaxChunk];
#pragma unroll
  for (int j = 0; j < kMaxChunk; ++j) {
    const int b = b0 + j;
    float m = 0.f, sd = 1.f, c = kLogInvSqrt2Pi;
    if (j < C && b < K) {
      const int r = ranks[r0 + b];
      m = __fadd_rn(__fmul_rn(scale, model[r]), shift);
      sd = __fmul_rn(model[kModel + r], var);
      c = __fsub_rn(kLogInvSqrt2Pi, __fadd_rn(model[2 * kModel + r], log_var));
    }
    gm[j][lane] = m;
    gs[j][lane] = sd;
    gc[j][lane] = c;
    M[j] = B[j] = Ks[j] = kNeg;
  }

  const int rows = __reduce_max_sync(kFull, E);
  // the states of the lane's last block (C - 1) after the previous row, and
  // of its last block below K after this row; kept as they are written, so
  // no block is picked by a runtime index (which would put the states in
  // local memory)
  float lastM = kNeg, lastB = kNeg, lastK = kNeg;
  float endM = kNeg, endB = kNeg, endK = kNeg;
  float lp_end = kNeg;
  float ev = E > 0 ? events[e0] : 0.f;
  for (int row = 1; row <= rows; ++row) {
    const float ev_next = row < E ? events[e0 + row * step] : 0.f;
    const float pre = flank[row - 1];
    const float post = flank[E > row ? E - row : 0];

    // the previous row's states of the block before this lane's first
    float pm = __shfl_up_sync(kFull, lastM, 1, g);
    float pb = __shfl_up_sync(kFull, lastB, 1, g);
    float pk = __shfl_up_sync(kFull, lastK, 1, g);
    if (li == 0) pm = pb = pk = kNeg;

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
        const float a = __fdiv_rn(__fsub_rn(ev, gm[j][lane]), gs[j][lane]);
        const float em = __fsub_rn(gc[j][lane], __fmul_rn(__fmul_rn(0.5f, a), a));
        const bool in = b < K;
        M[j] = in ? __fadd_rn(s, em) : kNeg;
        B[j] = in ? la(__fadd_rn(lp_mb, mo), __fadd_rn(lp_bb, bo)) : kNeg;
        pm = mo;
        pb = bo;
        pk = ko;
        lastM = M[j];
        lastB = B[j];
        if (in) {
          endM = M[j];
          endB = B[j];
        }
      }
    }

    // u(b) from this row's M and B of block b-1, then K along the blocks
    pm = __shfl_up_sync(kFull, lastM, 1, g);
    pb = __shfl_up_sync(kFull, lastB, 1, g);
    if (li == 0) pm = pb = kNeg;
    float x = kNeg;                       // K of the block before the next one
    if (g == 1) {                         // warp-uniform: K in sequence, as f5c
#pragma unroll
      for (int j = 0; j < kMaxChunk; ++j) {
        if (j < C) {
          const float uj = la(__fadd_rn(lp_mk, pm), __fadd_rn(lp_bk, pb));
          pm = M[j];
          pb = B[j];
          x = la(uj, __fadd_rn(lp_kk, x));
          Ks[j] = b0 + j < K ? x : kNeg;
          lastK = Ks[j];
          if (b0 + j < K) endK = x;
        }
      }
    } else {
      float fold = kNeg;
#pragma unroll
      for (int j = 0; j < kMaxChunk; ++j) {
        if (j < C) {
          const float uj = b0 + j < K ? la(__fadd_rn(lp_mk, pm), __fadd_rn(lp_bk, pb)) : kNeg;
          u[j][lane] = uj;
          pm = M[j];
          pb = B[j];
          fold = la(uj, __fadd_rn(lp_kk, fold));
        }
      }
      // the group's maps x -> logaddexp(U, S + x), combined in a scan
      float U = fold, S = lane_s;
      for (int d = 1; d < g; d <<= 1) {
        const float Uo = __shfl_up_sync(kFull, U, d, g);
        const float So = __shfl_up_sync(kFull, S, d, g);
        if (li >= d) {
          U = la(U, __fadd_rn(S, Uo));
          S = __fadd_rn(So, S);
        }
      }
      x = __shfl_up_sync(kFull, U, 1, g);   // K of the block before this lane's first
      if (li == 0) x = kNeg;
#pragma unroll
      for (int j = 0; j < kMaxChunk; ++j) {
        if (j < C) {
          x = la(u[j][lane], __fadd_rn(lp_kk, x));
          Ks[j] = b0 + j < K ? x : kNeg;
          lastK = Ks[j];
          if (b0 + j < K) endK = x;
        }
      }
    }
    // the end state (JAX :287-291); the lane of block K-1 writes it
    if (row <= E && ((flags & kPostClip) || row == E))
      lp_end = la(lp_end, __fadd_rn(la(la(endM, endB), endK), post));
    ev = ev_next;
  }
  if (has && li == last_lane) out[gi] = lp_end;
}

}  // namespace

// ranks (int16, 0..15624), rank_off (int64, n_inst + 1), ev_first and
// ev_last (int64, n_inst: an instance's rows are events ev_first,
// ev_first +- 1, ..., ev_last), read (int32, n_inst: its row of params),
// events (f32), params (f32, rows of 16: scale, shift, var, log var, the
// ten transitions), model (f32, 3 x 15625: level mean, stdv, log stdv),
// flank (f32, at least the longest instance's rows), order (int32, n_inst:
// the instances by lane-group size, 1, 2, 4, ..., 32 lanes), class_n (host
// memory, int64 x 6: how many of `order`'s instances take each size, in
// that order; an instance of K blocks takes the smallest size g with
// K <= 8 g), flags (HAF_ALLOW_PRE_CLIP | HAF_ALLOW_POST_CLIP bits); out
// (f32, n_inst) the forward scores, by instance.  Every instance has 1 to
// 256 k-mers.  Launches on `stream`, does not synchronise, and returns the
// CUDA error of the launch.
extern "C" int gb_meth_forward(const void* ranks, const void* rank_off, const void* ev_first,
                               const void* ev_last, const void* read, const void* events,
                               const void* params, const void* model, const void* flank,
                               const void* order, const int64_t* class_n, int64_t n_inst,
                               int flags, void* out, void* stream) {
  if (n_inst <= 0) return 0;
  Classes cls;
  int64_t first = 0;
  cls.warp0[0] = 0;
  for (int c = 0; c < kClasses; ++c) {
    const int per_warp = 32 >> c;
    cls.first[c] = first;
    cls.count[c] = class_n[c];
    first += class_n[c];
    cls.warp0[c + 1] = cls.warp0[c] + (class_n[c] + per_warp - 1) / per_warp;
  }
  if (first != n_inst) return static_cast<int>(cudaErrorInvalidValue);
  meth_forward_kernel<<<static_cast<unsigned>(cls.warp0[kClasses]), 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(ranks), static_cast<const int64_t*>(rank_off),
      static_cast<const int64_t*>(ev_first), static_cast<const int64_t*>(ev_last),
      static_cast<const int32_t*>(read), static_cast<const float*>(events),
      static_cast<const float*>(params), static_cast<const float*>(model),
      static_cast<const float*>(flank), static_cast<const int32_t*>(order), cls, flags,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
