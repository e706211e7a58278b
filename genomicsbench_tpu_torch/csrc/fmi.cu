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
// lines and extension steps of its walk.
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
// step against 91 ops).
//
// smem1's design: a work item on a lane group of kGroup lanes, 32 / kGroup
// items a warp, the walk run as the plain version's round machine (scan /
// forward / backward) in rounds that every lane of the warp runs together.
// A thread per item, as this walk was first written, ran its lanes' walks
// in different phases one after another (a warp waited for the sum of its
// lanes' paths), extended a backward column's intervals one after another
// (a load latency each), and kept its lists in local memory.  Here, in a
// round every group makes at most one extension a lane, all of them
// issued before any is used, then updates its state by selects:
//   - scan: where a pivot ended (or the item began), the next position
//     that seeds, over the staged bases, no load; the forward step follows
//     in the same round;
//   - forward: one step, made alike by every lane of the group (the same
//     lines, one request), so the group's state needs no shuffle;
//   - backward: kGroup intervals of the column a round, one a lane, the
//     first column longest first; the survivors compacted in list order by
//     __ballot_sync and __popc, the size test against the previous
//     survivor read by a shuffle (or the chunk before's last), the column's
//     one emit (its first interval dying) from the same ballots.
// The counters and caps are the sequential walk's: an ME overflow at a
// column's first interval stops the item there and counts that interval's
// extension only, though the group's other lanes extended theirs; a CP
// overflow in the forward collection stops it the same way.  One list of
// CP (k, s, e) slots a group in shared memory, no local memory: the forward
// collection fills it from the top down, every column reads it upwards
// from `base`, and survivors are compacted in place from 0 (a round reads
// before it writes, and no survivor lands above the slot it came from).
// The read's bases are staged once an item into the group's shared slice
// by 16-byte loads (reads wider than kStageMax stay in global memory and
// are read through the same pointer).  A group that ends its item takes
// the next from a per-launch counter, so warps stay resident across items
// and none waits for its slowest item.  tests/torch_fmi_cases.py
// `lane_group_smem1` models this schedule and the CPU tests hold it bit
// for bit against the plain version.
//
// seed3's design (bwt_seed_strategy1, tools/ref_drivers/fmi_gold.cpp:106-159):
// a read on a group of kSeedGroup lanes, 32 / kSeedGroup reads a warp,
// every read one chain of dependent extension steps (143 on the bench
// batch's reads of 151).  A thread a read, as this walk was first written,
// read each step's base from global memory and tested it before it issued
// the step's line loads, so a step carried two dependent trips, and its
// warp ran the nested loops of seeds of different lengths, each lane
// waiting at every seed's end for the slowest.  Here:
//   - the read is staged once into the group's slice of shared memory by
//     16-byte loads (reads wider than kSeedStageMax stay in global memory
//     and are read through the same pointer);
//   - the walk is one flat loop of rounds, one extension step a live group
//     a round: a seed's end, an emit, an ambiguous base or the read's end
//     reseeds in the same round (the scan past ambiguous bases reads only
//     the staged bases), so a warp waits only for its longest chain;
//   - a step's rows l and l + s do not depend on its base, so its lines are
//     loaded at the top of the round, before the base and the end tests; a
//     round that finds an ambiguous base or the read's end discards them
//     (the counters count the sequential walk's loads and steps only);
//   - lane j of a group loads row j's line (row l's, or row l + s's, the
//     same as l's where both lie in one block), adds its share of the four
//     interval sizes and of the rank at l, and the group sums the shares
//     by shuffles: both lanes run one path, where lanes split by the
//     line's counts and planes ran both one after the other (that form
//     took 0.2692 ms against 0.2311, tools/sites_seed3_ab.py --variants,
//     NVIDIA H100 80GB HBM3, 700 W);
//   - a group that ends its read takes the next from a per-launch counter,
//     one atomic a warp for the groups that need one.
// tests/torch_fmi_cases.py `staged_seed3` models this schedule (rounds,
// parts, discarded loads) and the CPU tests hold it bit for bit against
// the plain version; the card tests hold the kernel's rounds to it.
//
// extend keeps a thread a lane.  The e-table's lanes of a read are
// adjacent starts, so a warp's lanes walk one read in lockstep and share
// the lines of a repeat (1.30 lines a step on the SSR batch against 1.57
// for seed3's reads), and all of the SSR batch's 252,472 chains are in
// flight at once; seed3's design, which holds a third of them in flight
// and lets a warp's lanes drift apart, took 0.44 ms there against this
// layout's 0.18 (tools/sites_seed3_ab.py, NVIDIA H100 80GB HBM3, 700 W).
// A step's lines are loaded before its end and base tests, which they do
// not depend on (about 1% faster); a step that ends there discards them.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kCpMax = 24;     // interval-list slots (JAX's CP cap)
constexpr int kThreads = 128;  // extend: a thread per work item
// seed3: lanes a read (2 beside 1 and 4 in tools/sites_seed3_ab.py
// --variants: 37% and 26% faster), warps a block, and the most bytes a
// read's slice of shared memory takes (wider reads are read from global
// memory; unstaged, seed3 took 8-13% longer)
constexpr int kSeedGroup = 2;
constexpr int kSeedWarps = 4;
constexpr int kSeedStageMax = 384;
// smem1: lanes a work item (4 beside 2 and 8 in tools/fmi_head_ab.py
// --variants: pass 1 3% and 29% faster, pass 2 11% and 34%), items a warp,
// warps a block, and the most bytes of a read a group stages (wider reads
// are read from global memory)
constexpr int kGroup = 4;
constexpr int kGroups = 32 / kGroup;
constexpr int kWarps = 4;
constexpr int kStageMax = 1024;
// blocks an SM the compiler keeps room for: 64 registers a thread, 32 warps
// an SM without a spill (tools/fmi_head_ab.py --variants: 3.5% faster than
// the 68 it takes unbounded; 10 and 12 spill and run 28% and 70% slower)
constexpr int kMinBlocks = 8;
constexpr unsigned kFull = 0xffffffffu;
static_assert(32 % kGroup == 0 && kGroup < 32, "a lane group divides a warp");
static_assert(kSeedGroup == 1 || kSeedGroup == 2 || kSeedGroup == 4, "a line is 4 parts");
constexpr int kSeedParts = 4 / kSeedGroup;     // 16-byte parts of a step's lines a lane

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

// The lines an extension at rows a and a + s reads: counts and planes of
// row a's line and of row a + s's
struct Lines {
    int4 ca, pa, cb, pb;
};

// The lines of an extension at rows a and a + s: one load pair, or two
// when the rows lie in different blocks, issued together
__device__ __forceinline__ Lines ext_lines(const Fmd& f, int a, int s) {
    const int blk_a = a >> 6, blk_b = (a + s) >> 6;
    Lines t;
    t.ca = __ldg(f.table + 2 * (int64_t)blk_a);
    t.pa = __ldg(f.table + 2 * (int64_t)blk_a + 1);
    t.cb = t.ca, t.pb = t.pa;
    if (blk_b != blk_a) {
        t.cb = __ldg(f.table + 2 * (int64_t)blk_b);
        t.pb = __ldg(f.table + 2 * (int64_t)blk_b + 1);
    }
    return t;
}

// The symmetric FMD extension core (`_ext_pick_sym`, ops/fmi.py:309-328)
// on its loaded lines: the rank pair at rows a and a + s, picking symbol c.
// Backward extension is (a, other) = (k, l) with c = base, forward (a,
// other) = (l, k) with c = 3 - base.  Returns the rank lines loaded.
__device__ __forceinline__ int ext_on(const Fmd& f, const Lines& t, int a, int other, int s,
                                      int c, int& a_n, int& other_n, int& s_n) {
    const int b = a + s;
    const int blk_a = a >> 6, blk_b = b >> 6;
    const int4 ca = t.ca, pa = t.pa, cb = t.cb, pb = t.pb;
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

// `ext_on`, its lines loaded first
__device__ __forceinline__ int ext(const Fmd& f, int a, int other, int s, int c,
                                   int& a_n, int& other_n, int& s_n) {
    return ext_on(f, ext_lines(f, a, s), a, other, s, c, a_n, other_n, s_n);
}

// C[b] and the single-base interval's size C[b + 1] - C[b], by selects
__device__ __forceinline__ int c_at(const Fmd& f, int b) {
    return sel4(f.C[0], f.C[1], f.C[2], f.C[3], b);
}
__device__ __forceinline__ int c_size(const Fmd& f, int b) {
    return sel4(f.C[1] - f.C[0], f.C[2] - f.C[1], f.C[3] - f.C[2], f.C[4] - f.C[3], b);
}

// A group's shared slice: its list of kCpMax (k, s, e) int4 slots and, for
// reads up to kStageMax bytes, the read staged at its 16-byte phase
__host__ __device__ __forceinline__ int slice_bytes(int L) {
    const int stage = (L + 30) / 16 * 16;
    return kCpMax * 16 + (stage <= kStageMax ? stage : 0);
}

// A seed3 group's slice: the read staged at its 16-byte phase, or nothing
// for reads wider than kSeedStageMax
__host__ __device__ __forceinline__ int seed_slice_bytes(int L) {
    const int stage = (L + 30) / 16 * 16;
    return stage <= kSeedStageMax ? stage : 0;
}

// seed3 groups that need a read take the next ones from `work`,
// one atomic a warp.  Returns the group's item, or -1 where it asked for
// none or the counter has passed n (`over` is then set).  Every lane of
// the warp calls it.
__device__ __forceinline__ int take_item(bool need, bool& over, int lane, unsigned* work,
                                         int n) {
    const int g0 = lane - lane % kSeedGroup;
    const bool ask = need && !over;
    const unsigned wants = __ballot_sync(kFull, ask && lane == g0);
    unsigned first = 0;
    if (lane == 0 && wants) first = atomicAdd(work, (unsigned)__popc(wants));
    first = __shfl_sync(kFull, first, 0);
    if (!ask) return -1;
    const unsigned got = first + __popc(wants & ((1u << g0) - 1u));
    if (got >= (unsigned)n) {
        over = true;
        return -1;
    }
    return (int)got;
}

// The first nst bases of a read into the group's slice at the read's
// 16-byte phase, 16 bytes a lane; returns where the staged bases start
__device__ __forceinline__ const uint8_t* stage_read(const uint8_t* src, int nst,
                                                     uint8_t* stage, int gl) {
    const int ph = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    const int4* line = reinterpret_cast<const int4*>(src - ph);
    for (int c = gl; c * 16 < ph + nst; c += kSeedGroup)
        reinterpret_cast<int4*>(stage)[c] = __ldg(line + c);
    return stage + ph;
}

// A seed3 step's lines on a group of kSeedGroup lanes, loaded before its
// base is known: of the 16-byte parts [counts, planes of row a's line,
// counts, planes of row b's line], lane gl takes kSeedParts from part
// kSeedParts gl on (with 2 lanes, lane j row j's line whole, so both lanes
// take one path through each part; a lone lane reuses row a's parts where
// both rows share a block)
__device__ __forceinline__ void load_step(const Fmd& f, int a, int b, int gl, bool on,
                                          int4 (&part)[kSeedParts]) {
    const int ba = a >> 6, bb = b >> 6;
    if (!on) return;
#pragma unroll
    for (int i = 0; i < kSeedParts; ++i) {
        const int p = kSeedParts * gl + i;
        if (kSeedGroup == 1 && p >= 2 && bb == ba)
            part[i] = part[i & 1];
        else
            part[i] = __ldg(f.table + 2 * (int64_t)(p < 2 ? ba : bb) + (p & 1));
    }
}

// `ext` from a group's loaded parts: each lane adds its share of the four
// interval sizes (rank at b less rank at a) and of the rank at a of symbol
// c, the group sums the shares by shuffles; c < 0 for a group that makes
// no step this round.  Every lane of the warp calls it.  Returns the rank
// lines the step loads.
__device__ __forceinline__ int group_ext(const Fmd& f, const int4 (&part)[kSeedParts], int a,
                                         int other, int s, int c, int gl, int& a_n, int& other_n,
                                         int& s_n) {
    const int b = a + s;
    int P[4] = {0, 0, 0, 0}, Q = 0;
    if (c >= 0) {
#pragma unroll
        for (int i = 0; i < kSeedParts; ++i) {
            const int p = kSeedParts * gl + i;
            int r[4];
            if (p & 1) {
                rank4(make_int4(0, 0, 0, 0), part[i], p < 2 ? a : b, f.sent, r);
            } else {
                r[0] = part[i].x, r[1] = part[i].y, r[2] = part[i].z, r[3] = part[i].w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) P[j] += p < 2 ? -r[j] : r[j];
            if (p < 2) Q += sel4(r[0], r[1], r[2], r[3], c);
        }
    }
#pragma unroll
    for (int off = kSeedGroup / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) P[j] += __shfl_xor_sync(kFull, P[j], off);
        Q += __shfl_xor_sync(kFull, Q, off);
    }
    const int sent_cnt = (f.sent >= a) & (f.sent < b);
    other_n = other + sent_cnt + sel4(P[1] + P[2] + P[3], P[2] + P[3], P[3], 0, c);
    a_n = c_at(f, c) + Q;
    s_n = sel4(P[0], P[1], P[2], P[3], c);
    return (a >> 6) == (b >> 6) ? 1 : 2;
}

enum Phase { kIdle, kScan, kFwd, kBwd };

// bwt_smem1, a work item a lane group, in rounds (the design above).  Pass
// 1 (has_pivot 0): from x = 0, pivot after pivot to the read's end.  Pass
// 2: the first position at or after pivot[w] that seeds, one walk.  out
// (zeroed by the caller): count[n], ovf[n], loads[n], steps[n], then n x ME
// slots of (m, e, k, s); `work` the item counter, 0 at launch; `rounds`,
// where not null, the rounds each item took.
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
fmi_smem1_kernel(Fmd f, const uint8_t* __restrict__ query, int L,
                 const int* __restrict__ qlen, const int* __restrict__ qrow,
                 const int* __restrict__ pivot, const int* __restrict__ min_intv, int n,
                 int has_pivot, int min_seed_len, int CP, int ME, int* __restrict__ out,
                 int* __restrict__ rounds, unsigned* __restrict__ work) {
    extern __shared__ int4 sh[];
    const int lane = threadIdx.x & 31, gl = lane % kGroup, g0 = lane - gl;
    const unsigned below = (1u << lane) - 1u;
    const unsigned gmask = ((1u << kGroup) - 1u) << g0;
    const int slice = slice_bytes(L);
    char* mine = reinterpret_cast<char*>(sh) + (threadIdx.x / kGroup) * slice;
    int4* lst = reinterpret_cast<int4*>(mine);
    uint8_t* stage = reinterpret_cast<uint8_t*>(mine + kCpMax * 16);
    const bool staged = slice > kCpMax * 16;
    int4* slots = reinterpret_cast<int4*>(out + 4 * (int64_t)n);
    // the group's state, the same in each of its lanes
    int phase = kIdle, w = 0, ql = 0, mi = 1, x = 0, i = 0, j = 0, cnt = 0, ex = 0;
    int base = 0, prev_n = 0, curr_n = 0, ptr = 0, last_s = 0, wk = 0, wl = 0, ws = 0;
    int count = 0, loads = 0, steps = 0, nround = 0, ovf = 0;
    bool need = true;
    const uint8_t* rd = stage;      // the item's bases, staged or in global memory
    for (;;) {
        // groups without an item take the next one and stage its read
        if (__any_sync(kFull, need)) {
            unsigned got = 0;
            if (need && gl == 0) got = atomicAdd(work, 1u);
            got = __shfl_sync(kFull, got, g0);
            if (need && got < (unsigned)n) {
                w = (int)got;
                const int row = qrow ? qrow[w] : w;
                ql = qlen[row];
                mi = min_intv ? min_intv[w] : 1;
                x = ql < 1 ? ql : (has_pivot ? pivot[w] : 0);
                count = loads = steps = nround = ovf = 0;
                phase = kScan;
                const uint8_t* src = query + (int64_t)row * L;
                rd = src;
                if (staged && ql > 0) {
                    const int ph = (int)(reinterpret_cast<uintptr_t>(src) & 15);
                    const int4* line = reinterpret_cast<const int4*>(src - ph);
                    for (int c = gl; c * 16 < ph + ql; c += kGroup) {
                        const int lo = c * 16 - ph;     // the chunk's first byte in the read
                        if (lo >= 0 && lo + 16 <= ql) {
                            reinterpret_cast<int4*>(stage)[c] = __ldg(line + c);
                        } else {
                            for (int b = 0; b < 16; ++b)
                                if (lo + b >= 0 && lo + b < ql)
                                    stage[c * 16 + b] = __ldg(src + lo + b);
                        }
                    }
                    rd = stage + ph;
                }
            }
            need = false;           // a group that found no item stays idle
            __syncwarp();
        }
        if (!__any_sync(kFull, phase != kIdle)) break;
        bool fin = false;
        if (phase != kIdle) ++nround;
        if (phase == kScan) {       // the next position that seeds, no load
            int b = 4;
            while (x < ql) {
                b = x >= 0 ? rd[x] : 4;
                if (b < 4 && c_size(f, b) >= mi) break;
                ++x;
            }
            if (x < ql) {
                wk = c_at(f, b);
                wl = c_at(f, 3 - b);
                ws = c_size(f, b);
                cnt = 0;
                i = x + 1;
                phase = kFwd;
            } else {
                fin = true;
            }
        }
        // the round's extension: the forward step on every lane alike, or
        // interval ptr + gl of the column
        int cf = 4, cb = 4, ea = 0, es = 1, ec = 0;
        int4 ent = make_int4(0, 0, 0, 0);
        bool on = false;
        if (phase == kFwd) {
            cf = i < ql ? rd[i] : 4;
            on = cf < 4;
            ea = wl;
            es = ws > 1 ? ws : 1;
            ec = 3 - cf;
        } else if (phase == kBwd) {
            cb = (j >= 0 && j < ql) ? rd[j] : 4;
            const int p = ptr + gl;
            if (p < prev_n) ent = lst[base + p];
            on = p < prev_n && cb < 4;
            ea = ent.x;
            es = ent.y > 1 ? ent.y : 1;
            ec = cb;
        }
        int an = 0, on_ = 0, sn = 0, nl = 0;
        if (on) nl = ext(f, ea, phase == kFwd ? wk : 0, es, ec, an, on_, sn);
        // the column's survivors, compacted in list order, and its emit
        unsigned g_ext = 0, g_two = 0, g_surv = 0, g_app = 0;
        bool emit = false;
        int s_end = 0;
        if (__any_sync(kFull, phase == kBwd)) {
            const bool surv = phase == kBwd && on && sn >= mi;
            const unsigned m_surv = __ballot_sync(kFull, surv);
            const unsigned prev = m_surv & gmask & below;
            g_surv = m_surv & gmask;
            const int s_prev = __shfl_sync(kFull, sn, prev ? 31 - __clz(prev) : lane);
            s_end = __shfl_sync(kFull, sn, g_surv ? 31 - __clz(g_surv) : lane);
            const bool app = surv && (prev ? sn != s_prev : (curr_n == 0 || sn != last_s));
            g_app = __ballot_sync(kFull, app) & gmask;
            g_ext = __ballot_sync(kFull, on) & gmask;
            g_two = __ballot_sync(kFull, on && nl == 2) & gmask;
            const bool em = phase == kBwd && gl == 0 && ptr == 0 && !surv &&
                            ent.z - (j + 1) >= min_seed_len;
            emit = (__ballot_sync(kFull, em) >> g0) & 1u;
            // every lane of the chunk read its slot before the ballots
            if (app) lst[curr_n + __popc(g_app & below)] = make_int4(an, sn, ent.z, 0);
        }
        if (phase == kFwd) {
            if (on) {
                loads += nl;
                ++steps;
            }
            const bool stop = cf >= 4 || sn < mi;
            if (stop || sn != ws) {
                if (cnt >= CP) {
                    ovf = 1;
                    fin = true;
                } else {
                    if (gl == 0) lst[CP - 1 - cnt] = make_int4(wk, ws, i, 0);
                    ++cnt;
                }
            }
            if (!fin) {
                if (stop) {
                    phase = kBwd;
                    ex = i;
                    base = CP - cnt;
                    prev_n = cnt;
                    j = x - 1;
                    ptr = curr_n = last_s = 0;
                } else {
                    wk = on_;
                    wl = an;
                    ws = sn;
                    ++i;
                }
            }
        } else if (phase == kBwd) {
            unsigned counted = g_ext;
            if (emit) {
                if (count >= ME) {      // the sequential walk stops at interval 0
                    ovf = 1;
                    counted &= 1u << g0;
                    fin = true;
                } else {
                    if (gl == 0)
                        slots[(int64_t)w * ME + count] = make_int4(j + 1, ent.z, ent.x, ent.y);
                    ++count;
                }
            }
            steps += __popc(counted);
            loads += __popc(counted) + __popc(g_two & counted);
            if (!fin) {
                curr_n += __popc(g_app);
                if (g_surv) last_s = s_end;
                ptr += kGroup;
                if (cb >= 4 || ptr >= prev_n) {     // the column's end
                    if (curr_n == 0) {
                        if (has_pivot) {
                            fin = true;
                        } else {
                            x = ex > x + 1 ? ex : x + 1;
                            phase = kScan;
                        }
                    } else {
                        base = 0;
                        prev_n = curr_n;
                        curr_n = ptr = 0;
                        --j;
                    }
                }
            }
        }
        if (fin) {
            if (gl == 0) {
                out[w] = count;
                out[n + w] = ovf;
                out[2 * (int64_t)n + w] = loads;
                out[3 * (int64_t)n + w] = steps;
                if (rounds) rounds[w] = nround;
            }
            phase = kIdle;
            need = true;
        }
        __syncwarp();
    }
}

// bwt_seed_strategy1, a read on a group of kSeedGroup lanes (the design in the
// file's head).  out (zeroed by the caller): count[n], loads[n], steps[n],
// then n x EM3 slots of (m, n, k, s), n inclusive; `work` the item
// counter, 0 at launch; `rounds`, where not null, the rounds each read
// took.
__global__ void __launch_bounds__(kSeedWarps * 32)
fmi_seed3_kernel(Fmd f, const uint8_t* __restrict__ query, int L, const int* __restrict__ qlen,
                 int n, int mi, int min_len, int EM3, int* __restrict__ out,
                 int* __restrict__ rounds, unsigned* __restrict__ work) {
    extern __shared__ int4 sh[];
    const int lane = threadIdx.x & 31, gl = lane % kSeedGroup;
    const int slice = seed_slice_bytes(L);
    uint8_t* stage = reinterpret_cast<uint8_t*>(sh) + (threadIdx.x / kSeedGroup) * slice;
    const int last = L - 1;
    // the group's state, the same in each of its lanes
    int w = 0, ql = 0, x = 0, k = 0, l = 0, s = 0, exr = 0, ee = 0;
    int count = 0, loads = 0, steps = 0, nround = 0;
    bool alive = false, tail = false, need = true, over = false;
    const uint8_t* rd = stage;              // the read's bases, staged or in global memory
    // the next position at or after x that seeds, and its bi-interval
    auto seed = [&]() {
        while (x < ql && rd[x < last ? x : last] >= 4) ++x;
        alive = x < ql;
        if (alive) {
            const int nb = rd[x < last ? x : last];
            k = c_at(f, nb);
            l = c_at(f, 3 - nb);
            s = c_size(f, nb);
            tail = s < mi;                  // a seed under the floor: e(x) = x
            exr = tail ? x : x + 1;         // the floored end e(x) once known
            ee = x + 1;
        }
    };
    auto finish = [&]() {
        if (gl == 0) {
            out[w] = count;
            out[n + w] = loads;
            out[2 * (int64_t)n + w] = steps;
            if (rounds) rounds[w] = nround;
        }
        need = true;
    };
    for (;;) {
        while (__any_sync(kFull, need && !over)) {
            const int got = take_item(need, over, lane, work, n);
            if (got >= 0) {
                w = got;
                ql = qlen[w];
                count = loads = steps = nround = 0;
                x = 0;
                rd = query + (int64_t)w * L;
                if (slice > 0 && ql > 0) rd = stage_read(rd, ql < L ? ql : L, stage, gl);
                need = false;
            }
            __syncwarp();                   // the staged bases, for the group's lanes
            if (got >= 0) {
                seed();
                if (!alive) finish();
            }
        }
        if (!__any_sync(kFull, alive)) break;
        // one extension step a live group: the step's lines first, then
        // its base, which they do not depend on
        int4 part[kSeedParts];
        load_step(f, l, l + s, gl, alive, part);
        const int pos = ee;
        const int c = alive && pos < ql ? rd[pos < last ? pos : last] : 4;
        int l_n, k_n, s_n;
        const int nl = group_ext(f, part, l, k, s, c < 4 ? 3 - c : -1, gl, l_n, k_n, s_n);
        if (alive) {
            ++nround;
            if (c < 4) {
                loads += nl;
                ++steps;
                if (!tail && s_n < mi) {
                    exr = ee;
                    tail = true;
                }
                const int istar = exr > x + min_len ? exr : x + min_len;
                k = k_n;
                l = l_n;
                s = s_n;
                ee = pos + 1;
                if (tail && pos >= istar) {     // [x, istar] covered: emit, hop
                    if (gl == 0) {
                        int* sl = out + 3 * (int64_t)n +
                                  ((int64_t)w * EM3 + (count < EM3 ? count : EM3 - 1)) * 4;
                        sl[0] = x;
                        sl[1] = istar;
                        sl[2] = k_n;
                        sl[3] = s_n;
                    }
                    ++count;
                    x = istar + 1;
                    seed();
                }
            } else {                            // ambiguous base or read end: no emit
                x = pos >= ql ? ql : pos + 1;
                seed();
            }
            if (!alive) finish();
        }
        __syncwarp();
    }
}

// Forward extension, one lane per thread, with floor min_intv[w], to
// max_e[w] or death (the design in the file's head).  out: e[n], k[n],
// s[n], loads[n], steps[n].
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
    int k = c_at(f, b0), l = c_at(f, 3 - b0);
    const int s0 = c_size(f, b0);
    bool alive = base0 < 4 && st < ql && st >= 0 && s0 >= mi;
    int s = alive ? s0 : 0, e = alive ? st + 1 : st, loads = 0, steps = 0;
    while (alive) {
        const int pos = e;
        const Lines t = ext_lines(f, l, s);     // before the tests: they need no base
        if (pos >= ql || pos >= me) break;
        const int c = __ldg(q + (pos < L ? pos : L - 1));
        if (c >= 4) break;
        int l_n, k_n, s_n;
        loads += ext_on(f, t, l, k, s, 3 - c, l_n, k_n, s_n);
        ++steps;
        if (s_n < mi) break;
        k = k_n;
        l = l_n;
        s = s_n;
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

// The SM count and a kernel's resident blocks an SM at `threads` and
// `shared` bytes on the current device, asked once per (device, kernel,
// shared) and kept.
cudaError_t resident(const void* kernel, int threads, size_t shared, int* sms, int* per_sm) {
    struct Seen {
        int dev;
        const void* kernel;
        size_t shared;
        int sms, per_sm;
    };
    static std::mutex mu;
    static std::vector<Seen> seen;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const std::lock_guard<std::mutex> lock(mu);
    for (const Seen& o : seen)
        if (o.dev == dev && o.kernel == kernel && o.shared == shared) {
            *sms = o.sms, *per_sm = o.per_sm;
            return cudaSuccess;
        }
    Seen o{dev, kernel, shared, 0, 0};
    err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, kernel, threads, shared);
    if (err != cudaSuccess) return err;
    seen.push_back(o);
    *sms = o.sms, *per_sm = o.per_sm;
    return cudaSuccess;
}

}  // namespace

extern "C" {

// out: (4 + 4 ME) n int32 zeroed by the caller, 16-byte aligned, and one
// more for the work counter; rounds: n int32 or null.
int gb_fmi_smem1(const void* table, const uint8_t* query, int L, const int* qlen,
                 const int* qrow, const int* pivot, const int* min_intv, int64_t n,
                 int has_pivot, int min_seed_len, int CP, int ME, int c0, int c1, int c2,
                 int c3, int c4, int sent, int* out, int* rounds, void* stream) {
    if (CP < 1 || CP > kCpMax || ME < 1 || L < 1 || n < 0 || n > (1 << 30) ||
        (has_pivot && !pivot) || reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const auto s = (cudaStream_t)stream;
    auto* work = reinterpret_cast<unsigned*>(out + (4 + 4 * (int64_t)ME) * n);
    const size_t shared = (size_t)kWarps * kGroups * slice_bytes(L);
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaMemsetAsync(work, 0, sizeof(unsigned), s);
    if (err == cudaSuccess)
        err = resident(reinterpret_cast<const void*>(fmi_smem1_kernel), kWarps * 32, shared, &sms,
                       &per_sm);
    if (err != cudaSuccess) return (int)err;
    const int64_t wanted = (n + kWarps * kGroups - 1) / (kWarps * kGroups);
    const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    fmi_smem1_kernel<<<(unsigned)(wanted < fit ? wanted : fit), kWarps * 32, shared, s>>>(
        make_fmd(table, c0, c1, c2, c3, c4, sent), query, L, qlen, qrow, pivot, min_intv,
        (int)n, has_pivot, min_seed_len, CP, ME, out, rounds, work);
    return (int)cudaGetLastError();
}

// out: (3 + 4 EM3) n int32 zeroed by the caller, and one more for the work
// counter; rounds: n int32 or null.
int gb_fmi_seed3(const void* table, const uint8_t* query, int L, const int* qlen, int64_t n,
                 int min_intv, int min_len, int EM3, int c0, int c1, int c2, int c3, int c4,
                 int sent, int* out, int* rounds, void* stream) {
    if (EM3 < 1 || L < 1 || min_len < 1 || n < 0 || n > (1 << 30))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const auto st = (cudaStream_t)stream;
    auto* work = reinterpret_cast<unsigned*>(out + (3 + 4 * (int64_t)EM3) * n);
    const int threads = kSeedWarps * 32;
    const size_t shared = (size_t)(threads / kSeedGroup) * seed_slice_bytes(L);
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaMemsetAsync(work, 0, sizeof(unsigned), st);
    if (err == cudaSuccess)
        err = resident(reinterpret_cast<const void*>(fmi_seed3_kernel), threads, shared, &sms,
                       &per_sm);
    if (err != cudaSuccess) return (int)err;
    const int64_t wanted = (n * kSeedGroup + threads - 1) / threads;
    const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    fmi_seed3_kernel<<<(unsigned)(wanted < fit ? wanted : fit), threads, shared, st>>>(
        make_fmd(table, c0, c1, c2, c3, c4, sent), query, L, qlen, (int)n, min_intv, min_len,
        EM3, out, rounds, work);
    return (int)cudaGetLastError();
}

int gb_fmi_extend(const void* table, const uint8_t* query, int L, const int* qlen,
                  const int* qrow, const int* start, const int* min_intv, const int* max_e,
                  int64_t n, int c0, int c1, int c2, int c3, int c4, int sent, int* out,
                  void* stream) {
    if (L < 1) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    fmi_extend_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(make_fmd(table, c0, c1, c2, c3, c4, sent), query,
                                                L, qlen, qrow, start, min_intv, max_e, n, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
