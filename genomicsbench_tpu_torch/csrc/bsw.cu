// Banded Smith-Waterman seed extension (bwa-mem ksw_extend2) for Hopper.
//
// Replaces the TPU kernels genomicsbench_tpu/ops/bsw.py `_make_bsw_pallas`
// (body, :525-678) / `_bsw_pallas` (the pl.pallas_call launcher, :686-715)
// and the lax.scan form of the same recurrence, `_bsw_core` (:113-285).
// It transcribes the port's plain version, `bsw_extend_reference`
// (ops/bsw.py), step for step, and is bit-exact with it and with both TPU
// kernels: the first-row decay, the M == 0 gate, F in closed form, the
// latest-column argmax on ties, the max_ie / gscore update, the zero-row
// and z-drop exits, the band shrink.
//
// Bound.  The floor is integer-ALU work: the operations ksw_extend2 needs
// per band cell, counted at the card's best int32 form, 10 in all
// (BSW_OPS_PER_CELL in ops/bsw.py):
//   substitution score   1  one load of a query profile, qp[t_i][j]
//   M gate               2  M != 0 test, predicated add of the score
//   H = max(M, E, F)     1  __vimax3_s32
//   row max, argmax      2  __vibmax_s32 (max and h >= row_max), select j
//   E(i+1, j)            2  E - e_del, __viaddmax_s32_relu(M, -oe_del, .)
//   F(i, j+1)            2  F - e_ins, __viaddmax_s32_relu(M, -oe_ins, .)
// Loop control, the eh row's loads and stores and the per-row work (band
// limits, exits, the shrink) are left out, so the bound is a floor.  The
// rate is the card's int32 rate without tensor cores: 64 int32 lanes per SM
// x 132 SMs x the SM clock (16.7 Tops/s at 1980 MHz; chip_smoke.py reads
// the clock from nvidia-smi).  Input and output bytes (one query row and
// one target row per pair) are negligible beside it.
//
// Design.  One warp per pair; warp w of the grid takes pair idx[w].  Lane l
// owns the columns c = 32k + l of the pair's eh row (H(i-1, c-1) and
// E(i, c), int32), and a target row visits only the 32-column chunks k that
// the band [beg, end) touches, so the work follows the band, not qlen.  The
// row lives in shared memory beside the pair's query bases (9 bytes per
// column, `warp_bytes` per warp), so the DP loop makes no device-memory
// access at all; a lane reads and writes only its own columns, so the loop
// needs no __syncwarp and has no bank conflicts.  What crosses lanes goes
// through shuffles, per chunk:
//   F    the column recurrence of F in closed form (as the plain version):
//        F(c) = max_{beg<=k<c} (A(k) + k*e_ins) - (c-1)*e_ins,
//        A(k) = max(M(k) - oe_ins, 0), by a 5-step __shfl_up_sync max-scan
//        with the running max of earlier chunks as its carry; F(beg) = 0;
//   H    the write-back shift eh[c].h = H(i, c-1), __shfl_up_sync by one,
//        with lane 0 taking the previous chunk's lane 31, or h1_init at beg;
//   band __ballot_sync of the columns whose new (H, E) is nonzero, whose
//        first and last set bits (__ffs, __clz) give the shrunk band.
// Per row: the target base (32 rows loaded at a time, broadcast by
// __shfl_sync), and two __reduce_max_sync for the row max and its latest
// column.  Everything the row loop branches on is warp-uniform.  The serial
// chain of a pair is one row (its chunks' scans), not one cell.
//
// Queries whose row does not fit a block's 227 KB of shared memory (above
// about 25,800 bases) take the same body with kScratch: the eh row in a
// device scratch, [pair][H or E][column], and the query read in place.  The
// wrapper picks the instance, the warps per block and the shared bytes from
// the padded query width alone (ops/bsw.py `bsw_launch`).
//
// Left for later: int16x2 state with the __vi*_s16x2 DPX forms (two cells
// per lane-instruction); a persistent grid that takes the heaviest pairs
// first; TMA only for staging the query and target, if ever (this DP has no
// matrix product for wgmma).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 30);
constexpr int kBig = 1 << 30;
constexpr int kMaxWarpsPerBlock = 8;

template <bool kScratch>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock) bsw_warp_kernel(
    const uint8_t* __restrict__ query, const uint8_t* __restrict__ target,
    const int32_t* __restrict__ qlen_all, const int32_t* __restrict__ tlen_all,
    const int32_t* __restrict__ h0_all, const int32_t* __restrict__ w_all,
    const int64_t* __restrict__ idx, int64_t m, int64_t q_stride,
    int64_t t_stride, int32_t* __restrict__ scratch, int warps_per_block,
    int warp_bytes, int32_t* __restrict__ out, int match, int mis, int ambig,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * warps_per_block + warp;
  if (k >= m) return;
  const int64_t p = idx[k];
  const uint8_t* qg = query + p * q_stride;
  const uint8_t* t = target + p * t_stride;
  const int qlen = qlen_all[p];
  const int tlen = tlen_all[p];
  const int h0 = h0_all[p];
  const int w = w_all[p];
  const int oe_del = o_del + e_del;
  const int oe_ins = o_ins + e_ins;

  // the pair's eh row, columns 0..q_stride, and its query bases
  const int64_t cols = q_stride + 1;
  // Each lane writes only its own columns, the only ones it reads later.
  int32_t* H;
  const uint8_t* q;
  if constexpr (kScratch) {
    H = scratch + k * 2 * cols;
    q = qg;
  } else {
    H = reinterpret_cast<int32_t*>(smem + warp * warp_bytes);
    uint8_t* qs = reinterpret_cast<uint8_t*>(H + 2 * cols);
    for (int c = lane; c < qlen; c += 32) qs[c] = qg[c];
    q = qs;
  }
  int32_t* E = H + cols;

  // First row seeded from h0, decaying by the insert-extend cost
  // (bandedSWA.cpp:154-157).
  for (int c = lane; c <= qlen; c += 32) {
    H[c] = c == 0 ? h0
                  : (h0 > oe_ins ? max(h0 - oe_ins - (c - 1) * e_ins, 0) : 0);
    E[c] = 0;
  }

  int best = h0, best_i = -1, best_j = -1, max_ie = -1, gscore = -1;
  int max_off = 0, cells = 0;
  int beg = 0, end = qlen;
  int t32 = 0;  // target bases i & ~31 .. (i & ~31) + 31, one per lane
  for (int i = 0; i < tlen; ++i) {
    if ((i & 31) == 0) t32 = i + lane < tlen ? t[i + lane] : 0;
    const int tb = __shfl_sync(kFull, t32, i & 31);
    beg = max(beg, i - w);
    end = min(min(end, i + w + 1), qlen);
    const int h1_init =
        beg == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
    int h1 = h1_init;             // H(i, end-1); h1_init for an empty band
    int lane_max = 0, lane_arg = -1;
    int first_nz = kBig, last_nz = -1;
    if (beg < end) {
      int h = 0, h_carry = 0, f_carry = kNeg;
      for (int c0 = beg & ~31; c0 < end; c0 += 32) {
        const int c = c0 + lane;
        const bool in_band = c >= beg && c < end;
        int hs = 0, e = 0, qb = 0;
        if (in_band) {
          hs = H[c];                // H(i-1, c-1)
          e = E[c];                 // E(i, c)
          qb = q[c];
        }
        const int s = (qb == 4 || tb == 4) ? ambig : (qb == tb ? match : mis);
        const int M = hs ? hs + s : 0;
        // inclusive max-scan of A(c) + c*e_ins over the chunk
        int x = in_band ? max(M - oe_ins, 0) + c * e_ins : kNeg;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x = max(x, y);
        }
        const int x_left = __shfl_up_sync(kFull, x, 1);
        const int f_pre = max(f_carry, lane == 0 ? kNeg : x_left);
        f_carry = max(f_carry, __shfl_sync(kFull, x, 31));
        const int f = c == beg ? 0 : f_pre - (c - 1) * e_ins;
        h = __vimax3_s32(M, e, f);
        const int e_next = __viaddmax_s32_relu(M, -oe_del, e - e_del);
        // write-back shift: eh[c].h = H(i, c-1)
        const int h_up = __shfl_up_sync(kFull, h, 1);
        const int h_left = c == beg ? h1_init : (lane == 0 ? h_carry : h_up);
        h_carry = __shfl_sync(kFull, h, 31);
        if (in_band) {
          H[c] = h_left;
          E[c] = e_next;
          if (h >= lane_max) {      // ties (also at 0) take the latest column
            lane_max = h;
            lane_arg = c;
          }
        }
        const unsigned nz =
            __ballot_sync(kFull, in_band && (h_left | e_next) != 0);
        if (nz) {
          if (first_nz == kBig) first_nz = c0 + __ffs(nz) - 1;
          last_nz = c0 + 31 - __clz(nz);
        }
      }
      h1 = __shfl_sync(kFull, h, (end - 1) & 31);
    }
    if (lane == (end & 31)) {       // eh[end] = (h1, 0), by its own lane
      H[end] = h1;
      E[end] = 0;
    }
    cells += max(end - beg, 0);

    // the column loop exits at j == max(beg, end); the row reached the
    // query end when that is qlen
    if (max(beg, end) == qlen) {
      if (h1 >= gscore) max_ie = i;  // ties move max_ie forward
      gscore = max(gscore, h1);
    }

    const int row_max = __reduce_max_sync(kFull, lane_max);
    const int row_arg =
        __reduce_max_sync(kFull, lane_max == row_max ? lane_arg : -1);
    if (row_max == 0) break;
    if (row_max > best) {
      best = row_max;
      best_i = i;
      best_j = row_arg;
      max_off = max(max_off, abs(row_arg - i));
    } else if (zdrop > 0) {
      const int di = i - best_i;
      const int dj = row_arg - best_j;
      const int z = di > dj ? best - row_max - (di - dj) * e_del
                            : best - row_max - (dj - di) * e_ins;
      if (z > zdrop) break;
    }

    // Adaptive band shrink around the nonzero region of the new row
    // (bandedSWA.cpp:229-233): the first nonzero column of [beg, end), the
    // last of [beg_new, end]; column end holds (h1, 0).  A row that got
    // here has some H(i, c) > 0, c in [beg, end), so column c + 1 <= end
    // is nonzero and last_nz is set when h1 == 0.
    beg = min(first_nz, end);
    end = min((h1 != 0 ? end : last_nz) + 2, qlen);
  }

  if (lane == 0) {
    out[0 * m + k] = best;
    out[1 * m + k] = best_j + 1;
    out[2 * m + k] = best_i + 1;
    out[3 * m + k] = max_ie + 1;
    out[4 * m + k] = gscore;
    out[5 * m + k] = max_off;
    out[6 * m + k] = cells;
  }
}

}  // namespace

// query (n, q_stride) u8, target (n, t_stride) u8, qlen/tlen/h0/w_eff (n,)
// i32, idx (m,) i64 into the n pairs; out (7, m) i32.  match / mis / ambig
// are the substitution scores of a same base, a different base and base 4
// (mis is negative).  warps_per_block warps per block, each holding its eh
// row and query in warp_bytes >= 9 * (q_stride + 1) of shared memory; or,
// when scratch is not null, an (m, 2, q_stride + 1) i32 device scratch in
// place of shared memory.  Launches on `stream`, does not synchronise, and
// returns the CUDA error of the launch (0 on success).
extern "C" int gb_bsw_extend(
    const void* query, const void* target, const void* qlen, const void* tlen,
    const void* h0, const void* w_eff, const void* idx, int64_t m,
    int64_t q_stride, int64_t t_stride, void* scratch, void* out,
    int warps_per_block, int warp_bytes, int match, int mis, int ambig,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop, void* stream) {
  if (m <= 0) return 0;
  const bool in_scratch = scratch != nullptr;
  if (warps_per_block < 1 || warps_per_block > kMaxWarpsPerBlock ||
      (!in_scratch && warp_bytes < 9 * (q_stride + 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = in_scratch ? bsw_warp_kernel<true> : bsw_warp_kernel<false>;
  const size_t shared =
      in_scratch ? 0 : static_cast<size_t>(warps_per_block) * warp_bytes;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (m + warps_per_block - 1) / warps_per_block;
  kernel<<<static_cast<unsigned>(blocks), 32 * warps_per_block, shared,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlen), static_cast<const int32_t*>(tlen),
      static_cast<const int32_t*>(h0), static_cast<const int32_t*>(w_eff),
      static_cast<const int64_t*>(idx), m, q_stride, t_stride,
      static_cast<int32_t*>(scratch), warps_per_block, warp_bytes,
      static_cast<int32_t*>(out), match, mis, ambig, o_del, e_del, o_ins,
      e_ins, zdrop);
  return static_cast<int>(cudaGetLastError());
}
