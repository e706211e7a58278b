// FM-index SMEM seeding (bwa-mem2 fmi) for Hopper: three kernels over the
// FMD index's packed line table.
//
// Replaces the device loops of the JAX package's fmi path,
// genomicsbench_tpu/ops/fmi.py:
//   gb_fmi_smem1  <- `_pass1_smem1_reg` (:1805), the bwt_smem1 walk of
//                    passes 1 and 2 (and its TPU twins `_pass1_smem1`,
//                    `_pass1_jump`, `_pass1_jump_queued`);
//   gb_fmi_seed3  <- `_pass3_jump_reg` (:2335), the pass-3 seed-strategy
//                    walk (twin `_pass3_jump`);
//   gb_fmi_extend <- `_extend_lanes_init` / `_extend_lanes_run` (:349-410),
//                    forward extension lanes, the e-table fallback.
// Each computes what its JAX loop and the port's plain version
// (ops/fmi.py `fmi_smem1_reference`, `fmi_seed3_reference`,
// `fmi_extend_reference`) compute, value for value: the emits in each work
// item's walk order, the caps and overflow flag of the smem1 walk (at most
// CP intervals in a list, ME emits per item), and per work item the rank
// lines and extension steps of its walk.  The JAX walks are lockstep state
// machines with round caps because XLA needs one while_loop over all lanes;
// here one thread runs one work item's scalar loop to its end (the recipe of
// tools/ref_drivers/fmi_gold.cpp:106-159 and :246-290), and it always ends.
//
// The table: one 32-byte line per 64 BWT rows, int32 [occ0..occ3 | plane0
// lo, hi | plane1 lo, hi], read as two int4 through the read-only path.  A
// rank is the line's count plus the popcount of the masked plane bits of
// the symbol; the sentinel row, which the planes hold as symbol 0, is taken
// out of base 0 arithmetically (`_rank4`, :279-295).  An extension needs
// the ranks at rows a and a + s: two lines, or one when both rows share a
// block, and the two loads are issued together.
//
// Bound.  At the workload's scale the table is about 100 MB, twice the
// card's L2, and every extension step's rows depend on the step before, so
// a walk is a chain of dependent random loads into device memory.  The
// bytes bound counts 32 B per line loaded (the per-item `loads` counters
// every kernel writes); the operations bound counts FMI_INT32_OPS_PER_STEP
// (ops/fmi.py) int32 operations per extension step (the `steps` counters)
// at the card's best
// form, one op per instruction, three-input logic (LOP3) and adds (IADD3)
// one op each:
//   per row (two rows):  block, offset, the two 32-bit masks        4
//                        four symbols' masked plane words, 2 halves  8 LOP3
//                        their popcounts                             8 POPC
//                        count + popcount lo + popcount hi           4 IADD3
//                        the sentinel correction                     3
//                        the line address                            2   -> 29 x 2
//   interval size of each symbol (hi - lo)                           4
//   sentinel inside [a, a + s)                                       3
//   suffix sums above c, and the picks of C[c], lo[c], s4[c], suf[c] 2 + 12
//   new a, new other                                                 2
//   the next base (address, load, test) and the loop's bookkeeping   6   -> 91
// The bytes bound is the larger at these shapes (about 1.9 lines, 61 B, per
// step against 91 ops).  The design keeps loads in flight: one thread per
// work item with its lists in local memory (the registers stay few), 128
// threads per block, and both lines of a step requested before either is
// used.  The reads (uint8 codes) are read byte by byte through L1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCpMax = 24;     // interval-list slots (JAX's CP cap)
constexpr int kThreads = 128;

struct Fmd {
    const int4* __restrict__ table;   // 2 int4 per line: counts, planes
    int C[5];
    int sent;
};

__device__ __forceinline__ int sel4(int v0, int v1, int v2, int v3, int c) {
    const int lo = (c & 1) ? v1 : v0;
    const int hi = (c & 1) ? v3 : v2;
    return c < 2 ? lo : hi;
}

// counts of each base in BWT[0:row] from the row's line
__device__ __forceinline__ void rank4(const int4 cnt, const int4 pl, int row, int sent,
                                      int r[4]) {
    const int off = row & 63;
    const uint32_t m_lo = off >= 32 ? 0xFFFFFFFFu : ((1u << off) - 1u);
    const uint32_t m_hi = off > 32 ? ((1u << (off - 32)) - 1u) : 0u;
    const uint32_t a0 = (uint32_t)pl.x, a1 = (uint32_t)pl.y;   // plane0 (bit 0)
    const uint32_t b0 = (uint32_t)pl.z, b1 = (uint32_t)pl.w;   // plane1 (bit 1)
    r[0] = cnt.x + __popc(~a0 & ~b0 & m_lo) + __popc(~a1 & ~b1 & m_hi);
    r[1] = cnt.y + __popc(a0 & ~b0 & m_lo) + __popc(a1 & ~b1 & m_hi);
    r[2] = cnt.z + __popc(~a0 & b0 & m_lo) + __popc(~a1 & b1 & m_hi);
    r[3] = cnt.w + __popc(a0 & b0 & m_lo) + __popc(a1 & b1 & m_hi);
    r[0] -= ((sent >> 6) == (row >> 6)) & (sent < row);
}

// The symmetric FMD extension core (`_ext_pick_sym`, ops/fmi.py:309-328):
// the rank pair at rows a and a + s, picking symbol c.  Backward extension
// is (a, other) = (k, l) with c = base, forward (a, other) = (l, k) with
// c = 3 - base.  Returns the rank lines loaded.
__device__ __forceinline__ int ext(const Fmd& f, int a, int other, int s, int c,
                                   int& a_n, int& other_n, int& s_n) {
    const int b = a + s;
    const int blk_a = a >> 6, blk_b = b >> 6;
    const int4 ca = __ldg(f.table + 2 * (int64_t)blk_a);
    const int4 pa = __ldg(f.table + 2 * (int64_t)blk_a + 1);
    int4 cb = ca, pb = pa;
    if (blk_b != blk_a) {
        cb = __ldg(f.table + 2 * (int64_t)blk_b);
        pb = __ldg(f.table + 2 * (int64_t)blk_b + 1);
    }
    int lo[4], hi[4];
    rank4(ca, pa, a, f.sent, lo);
    rank4(cb, pb, b, f.sent, hi);
    const int s0 = hi[0] - lo[0], s1 = hi[1] - lo[1];
    const int s2 = hi[2] - lo[2], s3 = hi[3] - lo[3];
    const int sent_cnt = (f.sent >= a) & (f.sent < b);
    other_n = other + sent_cnt + sel4(s1 + s2 + s3, s2 + s3, s3, 0, c);
    a_n = sel4(f.C[0], f.C[1], f.C[2], f.C[3], c) + sel4(lo[0], lo[1], lo[2], lo[3], c);
    s_n = sel4(s0, s1, s2, s3, c);
    return blk_a == blk_b ? 1 : 2;
}

__device__ __forceinline__ int base_at(const uint8_t* __restrict__ q, int pos, int L) {
    return __ldg(q + (pos < L ? pos : L - 1));
}

// bwt_smem1, one work item per thread.  Pass 1 (has_pivot 0): from x = 0,
// pivot after pivot to the read's end.  Pass 2: the first position at or
// after pivot[w] that seeds, one walk.  out: count[n], ovf[n], loads[n],
// steps[n], then n x ME slots of (m, e, k, s).
__global__ void __launch_bounds__(kThreads)
fmi_smem1_kernel(Fmd f, const uint8_t* __restrict__ query, int L,
                 const int* __restrict__ qlen, const int* __restrict__ qrow,
                 const int* __restrict__ pivot, const int* __restrict__ min_intv, int64_t n,
                 int has_pivot, int min_seed_len, int CP, int ME, int* __restrict__ out) {
    const int64_t w = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (w >= n) return;
    const int row = qrow ? qrow[w] : (int)w;
    const uint8_t* q = query + (int64_t)row * L;
    const int ql = qlen[row];
    const int mi = min_intv ? min_intv[w] : 1;
    int* slots = out + 4 * n + w * (int64_t)ME * 4;
    int count = 0, ovf = 0, loads = 0, steps = 0;
    // interval lists (k, s, end): the FWD collection, then each backward
    // column's survivors, ping-ponged between the two halves
    int lk[2][kCpMax], ls[2][kCpMax], le[2][kCpMax];
    int x = has_pivot ? pivot[w] : 0;
    if (ql < 1) x = ql;
    while (x < ql) {
        const int nb = x >= 0 ? base_at(q, x, L) : 4;
        if (nb >= 4 || f.C[nb + 1] - f.C[nb] < mi) {   // the seed is dead
            ++x;
            continue;
        }
        // forward collect: the longest end per distinct interval size
        int wk = f.C[nb], wl = f.C[3 - nb], ws = f.C[nb + 1] - f.C[nb];
        int cnt = 0, i = x + 1;
        for (;;) {
            const int c = i < ql ? base_at(q, i, L) : 4;
            int kf = 0, lf = 0, sf = 0;
            if (c < 4) {
                loads += ext(f, wl, wk, ws > 1 ? ws : 1, 3 - c, lf, kf, sf);
                ++steps;
            }
            const bool stop = c >= 4 || sf < mi;
            if (stop || sf != ws) {
                if (cnt >= CP) { ovf = 1; goto done; }
                lk[0][cnt] = wk; ls[0][cnt] = ws; le[0][cnt] = i;
                ++cnt;
            }
            if (stop) break;
            wk = kf; wl = lf; ws = sf;
            ++i;
        }
        {
            // backward: the first column reads the collection longest first
            const int ex = i;
            int par = 0, prev_n = cnt, j = x - 1;
            bool first = true;
            for (;;) {
                const int c = (j >= 0 && j < ql) ? base_at(q, j, L) : 4;
                int curr_n = 0, last_s = 0;
                bool emitted = false;
                for (int p = 0; p < prev_n; ++p) {
                    const int idx = first ? prev_n - 1 - p : p;
                    const int pk = lk[par][idx], ps = ls[par][idx], pe = le[par][idx];
                    int kb = 0, ob = 0, sb = 0;
                    if (c < 4) {
                        loads += ext(f, pk, 0, ps > 1 ? ps : 1, c, kb, ob, sb);
                        ++steps;
                    }
                    if (c >= 4 || sb < mi) {
                        // only the first (longest) interval dying here is an SMEM
                        if (curr_n == 0 && !emitted) {
                            if (pe - (j + 1) >= min_seed_len) {
                                if (count >= ME) { ovf = 1; goto done; }
                                int* sl = slots + count * 4;
                                sl[0] = j + 1; sl[1] = pe; sl[2] = pk; sl[3] = ps;
                                ++count;
                            }
                            emitted = true;
                        }
                    } else if (curr_n == 0 || sb != last_s) {
                        lk[par ^ 1][curr_n] = kb; ls[par ^ 1][curr_n] = sb;
                        le[par ^ 1][curr_n] = pe;
                        ++curr_n;
                        last_s = sb;
                    }
                }
                if (curr_n == 0) break;
                par ^= 1;
                prev_n = curr_n;
                first = false;
                --j;
            }
            if (has_pivot) break;
            x = ex > x + 1 ? ex : x + 1;
        }
    }
done:
    out[w] = count;
    out[n + w] = ovf;
    out[2 * n + w] = loads;
    out[3 * n + w] = steps;
}

// bwt_seed_strategy1, one read per thread.  out: count[n], loads[n],
// steps[n], then n x EM3 slots of (m, n, k, s), n inclusive.
__global__ void __launch_bounds__(kThreads)
fmi_seed3_kernel(Fmd f, const uint8_t* __restrict__ query, int L,
                 const int* __restrict__ qlen, int64_t n, int mi, int min_len, int EM3,
                 int* __restrict__ out) {
    const int64_t w = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (w >= n) return;
    const uint8_t* q = query + w * L;
    const int ql = qlen[w];
    int* slots = out + 3 * n + w * (int64_t)EM3 * 4;
    int count = 0, loads = 0, steps = 0;
    int x = 0;
    while (x < ql) {
        const int nb = base_at(q, x, L);
        if (nb >= 4) {
            ++x;
            continue;
        }
        int k = f.C[nb], l = f.C[3 - nb], s = f.C[nb + 1] - f.C[nb];
        bool tail = s < mi;             // a seed under the floor: e(x) = x
        int exr = tail ? x : x + 1;     // the floored end e(x) once known
        int ee = x + 1;
        for (;;) {
            const int pos = ee;
            const int c = pos < ql ? base_at(q, pos, L) : 4;
            if (c >= 4) {               // ambiguous base or read end: no emit
                x = pos >= ql ? ql : pos + 1;
                break;
            }
            int l_n, k_n, s_n;
            loads += ext(f, l, k, s, 3 - c, l_n, k_n, s_n);
            ++steps;
            if (!tail && s_n < mi) {
                exr = ee;
                tail = true;
            }
            const int istar = exr > x + min_len ? exr : x + min_len;
            k = k_n; l = l_n; s = s_n;
            ee = pos + 1;
            if (tail && pos >= istar) {  // [x, istar] covered: emit, hop
                int* sl = slots + (count < EM3 ? count : EM3 - 1) * 4;
                sl[0] = x; sl[1] = istar; sl[2] = k_n; sl[3] = s_n;
                ++count;
                x = istar + 1;
                break;
            }
        }
    }
    out[w] = count;
    out[n + w] = loads;
    out[2 * n + w] = steps;
}

// Forward extension, one lane per thread, with floor min_intv[w], to
// max_e[w] or death.  out: e[n], k[n], s[n], loads[n], steps[n].
__global__ void __launch_bounds__(kThreads)
fmi_extend_kernel(Fmd f, const uint8_t* __restrict__ query, int L,
                  const int* __restrict__ qlen, const int* __restrict__ qrow,
                  const int* __restrict__ start, const int* __restrict__ min_intv,
                  const int* __restrict__ max_e, int64_t n, int* __restrict__ out) {
    const int64_t w = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (w >= n) return;
    const int row = qrow[w];
    const uint8_t* q = query + (int64_t)row * L;
    const int ql = qlen[row], st = start[w], mi = min_intv[w], me = max_e[w];
    const int base0 = __ldg(q + (st < 0 ? 0 : (st < L ? st : L - 1)));
    const int b0 = base0 < 3 ? base0 : 3;
    int k = f.C[b0], l = f.C[3 - b0];
    const int s0 = f.C[b0 + 1] - f.C[b0];
    bool alive = base0 < 4 && st < ql && st >= 0 && s0 >= mi;
    int s = alive ? s0 : 0, e = alive ? st + 1 : st, loads = 0, steps = 0;
    while (alive) {
        const int pos = e;
        if (pos >= ql || pos >= me) break;
        const int c = base_at(q, pos, L);
        if (c >= 4) break;
        int l_n, k_n, s_n;
        loads += ext(f, l, k, s, 3 - c, l_n, k_n, s_n);
        ++steps;
        if (s_n < mi) break;
        k = k_n; l = l_n; s = s_n;
        e = pos + 1;
    }
    out[w] = e;
    out[n + w] = k;
    out[2 * n + w] = s;
    out[3 * n + w] = loads;
    out[4 * n + w] = steps;
}

Fmd make_fmd(const void* table, int c0, int c1, int c2, int c3, int c4, int sent) {
    Fmd f;
    f.table = static_cast<const int4*>(table);
    f.C[0] = c0; f.C[1] = c1; f.C[2] = c2; f.C[3] = c3; f.C[4] = c4;
    f.sent = sent;
    return f;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int gb_fmi_smem1(const void* table, const uint8_t* query, int L, const int* qlen,
                 const int* qrow, const int* pivot, const int* min_intv, int64_t n,
                 int has_pivot, int min_seed_len, int CP, int ME, int c0, int c1, int c2,
                 int c3, int c4, int sent, int* out, void* stream) {
    if (CP < 1 || CP > kCpMax || ME < 1 || L < 1 || (has_pivot && !pivot))
        return (int)cudaErrorInvalidValue;
    fmi_smem1_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        make_fmd(table, c0, c1, c2, c3, c4, sent), query, L, qlen, qrow, pivot, min_intv, n,
        has_pivot, min_seed_len, CP, ME, out);
    return (int)cudaGetLastError();
}

int gb_fmi_seed3(const void* table, const uint8_t* query, int L, const int* qlen, int64_t n,
                 int min_intv, int min_len, int EM3, int c0, int c1, int c2, int c3, int c4,
                 int sent, int* out, void* stream) {
    if (EM3 < 1 || L < 1 || min_len < 1) return (int)cudaErrorInvalidValue;
    fmi_seed3_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        make_fmd(table, c0, c1, c2, c3, c4, sent), query, L, qlen, n, min_intv, min_len, EM3,
        out);
    return (int)cudaGetLastError();
}

int gb_fmi_extend(const void* table, const uint8_t* query, int L, const int* qlen,
                  const int* qrow, const int* start, const int* min_intv, const int* max_e,
                  int64_t n, int c0, int c1, int c2, int c3, int c4, int sent, int* out,
                  void* stream) {
    if (L < 1) return (int)cudaErrorInvalidValue;
    fmi_extend_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        make_fmd(table, c0, c1, c2, c3, c4, sent), query, L, qlen, qrow, start, min_intv,
        max_e, n, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
