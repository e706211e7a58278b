// Flye kmer-cnt for Hopper: canonical k-mers, their run counts and
// per-position frequencies, the window-minimizer walk and the minimizer
// sites.  Five kernels: the canonical pass one thread per unit of 16
// positions, the run count a streaming read of 16-byte vectors, the
// frequency scatter one block per tile of 2,048 sorted slots, the site
// build one thread per position, the walk one block per read.
//
// The JAX package computes these in genomicsbench_tpu/ops/kmer.py:
//   gb_kmer_canonical  replaces `_canonical_kmers` (:165) and, on the
//                      count path, `_unpack_codes_2bit` (:688);
//   gb_kmer_runs       replaces `_count_stats_device`'s tail (:704-709);
//   gb_kmer_freqs      replaces `_per_position_freqs`' run bounds and
//                      inverse-permutation gather (:199-217);
//   gb_kmer_minimizers replaces `minimizer_mask`'s lax.scan (:293-388);
//   gb_kmer_sites      replaces `_minimizer_sites` (:422) and the key build
//                      of `_minimizer_sites_sorted` (:438-454).
// The sorts between them stay torch.sort (XLA sort primitives in JAX).
// Each kernel computes what the port's plain version beside its wrapper in
// ops/kmer.py computes, bit for bit.
//
// Keys.  A canonical k-mer (k <= 16) is a uint32; the count and frequency
// keys are int32 holding `canon ^ 0x80000000`, so the signed order of the
// keys is the unsigned order of the k-mers and the SENTINEL 0xFFFFFFFF of
// positions the reference never iterates (at and beyond length - k,
// IterKmers' end being exclusive, kmer.h:193-198) becomes INT32_MAX and
// sorts last.  int32 keys halve the sort's key bytes and radix passes
// against int64 keys.  No canonical k-mer equals 0xFFFFFFFF: for k = 16
// that would need x = 0xFFFFFFFF, whose reverse complement is 0.
//
// Codes.  A k-mer is the sum of code << 2(k-1-j) modulo 2^32, as the JAX
// package's `extract_kmers` adds them: an ambiguous code 4 carries into the
// next 2-bit group.  count_kmers_stats packs codes four to a byte in numpy
// (`pack_codes_2bit`, :675-685), where a 4 sets the next slot's low bit and
// is lost in a byte's last slot; mode 1 of gb_kmer_canonical forms each
// byte from the unpacked codes exactly so, without the host pass.  Mode 0
// reads the codes as given (count_kmers, the frequency plane).
//
// The minimizer walk.  The JAX package's scan carries the deque's front,
// and the front is path dependent: on a homopolymer a walk from position 0
// and one started fresh a few positions later keep fronts of different
// phase for ever, so the read cannot be split by warming each piece up.
// It is a chain instead.  The front after a live step p is always a
// position of the minimum hash of the window max(0, p - w + 1) .. p (by
// induction over the plain version's new = evict ? latest_tied :
// max(front, earliest), and min(new, earliest) for p < w): so it stays
// where it is until a strictly smaller hash enters the window, and moves
// there, or until step front + w evicts it, and moves to the last minimum
// of the window front + 1 .. front + w.  Which comes first, and where to,
// depends on the front's position s alone: next(s) is the first q in s + 1
// .. s + w with h[q] < h[s], else the last minimum of s + 1 .. s + w, and
// none where that step is not live (q >= length - k).  The fronts are the
// chain of next from position 0, and the mask is the set of them (the
// plain version's emission only skips a front already emitted).  So the
// walk is a scan over segments: each thread owns kMinSeg consecutive
// positions of a tile, computes next for each (the hashes ahead are in
// shared memory; a random read finds a smaller hash within a few), then in
// one backward sweep each position's exit, the first front at or past the
// segment's end that the chain reaches from it.  That sweep is the
// segment's map from its entry (the first front at or past its start, one
// of w positions or none) to its exit.  Warp 0 composes the maps from the
// tile's carried entry, 32 segments a round: a segment whose w entries all
// exit to one front (most, on random sequence) gives the next its entry
// outright, and a run of the others is walked a shuffle a segment (a
// homopolymer's maps are permutations: the run is the whole tile).  Each
// thread then walks its segment from its entry and marks the fronts in a
// shared byte per position, and the block stores the tile's mask bytes
// and raw k-mers coalesced, each position once.  Positions past a row's
// last full k-mer read columns modulo L, as jnp.roll does, so the raw
// plane there holds the wrapped values.  A window above kMinSharedWindow
// keeps the read's hashes in a device scratch, written by a first pass
// over the read, since its look-ahead passes a tile.  The look-ahead costs
// at most w hash compares a position (about ln w on random sequence, w on
// a homopolymer).  tests/torch_kmer_cases.py `segment_scan_walk` is a
// numpy model of the scan, held against the plain version and the JAX
// package at segments of 1, w - 1, w, w + 1 and 37 positions.
//
// Bounds (chip_smoke.py `[kmer kernel]` counts them from each run's inputs):
// the canonical pass, the run count and the frequency scatter are bytes
// bound (one code byte in and one 4-byte key out per position, the
// canonical pass's few tens of integer instructions a position, a roll, the
// butterfly and in mode 1 the packed byte's carry, near that line; 4 bytes of
// key; 4 + 8 bytes of key and permutation in and 2 bytes out, though each
// of the scatter's 2-byte stores to a random position moves a 32-byte
// sector, a floor of 32 bytes a key beside the bound); the
// minimizer walk moves one code byte in and 8 + 1 bytes of raw k-mer and
// mask out per position and does a few tens of integer instructions per
// position (the hash is two 64-bit products, the look-ahead a few 64-bit
// compares), so it is bytes bound; the site build reads 9 bytes per
// position and writes 16 per site.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinelKey = 0x7FFFFFFF;   // SENTINEL 0xFFFFFFFF ^ 0x80000000
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kUnit = 16;                      // positions of a canonical-pass thread's unit
constexpr int kMinThreads = 128;               // threads of a minimizer block
constexpr int kMinSegBits = 4;
constexpr int kMinSeg = 1 << kMinSegBits;      // consecutive positions a thread walks
constexpr int kMinTile = kMinThreads * kMinSeg;
constexpr int kMinSharedWindow = 1024;         // windows up to this read ahead in shared memory
constexpr int kMinMaxLen = 1 << 30;            // positions are int32, with room for a window
constexpr int32_t kEnd = INT32_MAX;            // no next front

__device__ __forceinline__ uint32_t kmer_mask(int k) {
  return k == 16 ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
}

// Kmer::reverseComplement on 2-bit groups (the JAX package's butterfly,
// ops/kmer.py:127-135)
__device__ __forceinline__ uint32_t revcomp(uint32_t x, int k) {
  x = ~x & kmer_mask(k);
  x = ((x & 0x33333333u) << 2) | ((x & 0xCCCCCCCCu) >> 2);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x & 0xF0F0F0F0u) >> 4);
  x = ((x & 0x00FF00FFu) << 8) | ((x & 0xFF00FF00u) >> 8);
  x = (x << 16) | (x >> 16);
  return x >> (32 - 2 * k);
}

__device__ __forceinline__ uint32_t canonical(uint32_t x, int k) {
  const uint32_t rc = revcomp(x, k);
  return rc < x ? rc : x;
}

// Kmer::hash (kmer.h:91-98), splitmix64 in native uint64
__device__ __forceinline__ uint64_t splitmix(uint32_t v) {
  uint64_t z = static_cast<uint64_t>(v) + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// The canonical pass: one unit of kUnit consecutive positions of the flat
// (B * L) plane a thread, a grid-stride loop over the units.  The units
// follow the codes' 16-byte alignment (the first starts sh = codes % 16
// bytes before the plane), so a unit's codes are one aligned 16-byte load,
// the k - 1 after it the next unit's (an L1 hit), and in mode 1 the 4 bytes
// before it; its keys are four 16-byte stores where sh % 4 == 0 and the
// unit lies in the plane, else one store a position.  One division a unit
// finds its first row and column; the rows its window of kUnit + K - 1
// positions touches are walked a segment at a time, giving a bit mask of
// its valid positions (col < length - K) and, in mode 1, of the window's
// positions whose column is a multiple of 4.  Mode 1 derives each code as
// `pack_codes_2bit` and `_unpack_codes_2bit` read it: the code at slot s of
// a packed byte is ((OR over t <= s of code_t << 2t) >> 2s) & 3, so
// d = (c | carry) & 3 with the carry the bits above the slot of the codes
// before it in its byte, cleared at a byte's first slot (the byte's `&
// 0xFF` and its later slots never reach it).  The k-mer is seeded from the
// first K codes and rolled, x' = (x - d_q 4^(K-1)) 4 + d_(q+K) mod 2^32,
// exact for any uint8 code: the flat window sum, which at a valid position
// is that position's k-mer, since its K codes lie in its row, so the roll
// needs no restart at a row boundary, and it is left unmasked as
// `extract_kmers` leaves it.  The reverse complement is the butterfly on
// ~x & mask at every position (a rolled one would be wrong once a code
// carries).  K and the mode are template arguments, so the window's
// registers are indexed at compile time.  tests/torch_kmer_cases.py
// `unit_sweep_keys` is a model of the sweep in Python integers, held
// against the plain version at every byte offset of the codes.
template <int K>
__device__ __forceinline__ uint32_t revcomp_k(uint32_t x) {
  constexpr uint32_t mask = K == 16 ? 0xFFFFFFFFu : ((1u << (2 * K)) - 1u);
  x = ~x & mask;
  x = ((x & 0x33333333u) << 2) | ((x & 0xCCCCCCCCu) >> 2);
  x = ((x & 0x0F0F0F0Fu) << 4) | ((x & 0xF0F0F0F0u) >> 4);
  x = __byte_perm(x, 0, 0x0123);
  return x >> (32 - 2 * K);
}

template <int K, int MODE>
__global__ void __launch_bounds__(kThreads)
canonical_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                 int64_t B, int64_t L, int32_t* __restrict__ keys) {
  constexpr int W = kUnit + K - 1;                 // the window's positions
  constexpr uint32_t kTop = 1u << (2 * (K - 1));   // 4^(K-1)
  const int64_t N = B * L;
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  const uint8_t* base = codes - sh;                // 16-byte aligned
  const int64_t units = (N + sh + 15) / 16;
  for (int64_t c = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; c < units;
       c += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p0 = 16 * c - sh;                // the unit's first position
    const uint4 v0 = *reinterpret_cast<const uint4*>(base + 16 * c);
    uint4 v1 = make_uint4(0, 0, 0, 0);
    if (p0 + 16 < N) v1 = *reinterpret_cast<const uint4*>(base + 16 * c + 16);
    const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    uint32_t prev = 0;                             // the 4 codes before the unit
    if (MODE == 1 && c > 0) prev = *reinterpret_cast<const uint32_t*>(base + 16 * c - 4);

    // the rows: the first position's row and column, then a segment a row
    int q = p0 < 0 ? static_cast<int>(-p0) : 0;
    const int64_t first = p0 + q;
    int64_t b;
    if (N <= 0xFFFFFFFFll) {
      b = static_cast<uint32_t>(first) / static_cast<uint32_t>(L);
    } else {
      b = first / L;
    }
    int64_t col = first - b * L;
    const int col0 = static_cast<int>(col & 3);
    uint32_t valid = 0;
    uint64_t slot0 = 0;
    while (q < W && p0 + q < N) {
      const int64_t left = L - col;               // the row's positions from here
      const int seg = left < W - q ? static_cast<int>(left) : W - q;
      slot0 |= (0x1111111111111111ull << (q + (static_cast<int>(-col) & 3))) &
               (((1ull << seg) - 1) << q);
      if (q < kUnit) {
        const int64_t room = static_cast<int64_t>(lengths[b]) - K - col;
        const int most = seg < kUnit - q ? seg : kUnit - q;
        const int nv = room <= 0 ? 0 : (room < most ? static_cast<int>(room) : most);
        valid |= ((1u << nv) - 1u) << q;
      }
      q += seg;
      col = 0;
      ++b;
    }

    // the window's codes, as the mode reads them
    uint32_t d[W];
    if constexpr (MODE == 0) {
#pragma unroll
      for (int i = 0; i < W; ++i) d[i] = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
    } else {
      const int a = p0 >= 0 ? col0 : 0;            // the unit's slot in its byte
      uint32_t carry = 0;
      if (a >= 1) carry |= (prev >> 24) >> 2;
      if (a >= 2) carry |= ((prev >> 16) & 0xFFu) >> 4;
      if (a >= 3) carry |= ((prev >> 8) & 0xFFu) >> 6;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (i > 0 && ((slot0 >> i) & 1)) carry = 0;
        const uint32_t u = ((w[i >> 2] >> (8 * (i & 3))) & 0xFFu) | carry;
        d[i] = u & 3u;
        carry = u >> 2;
      }
    }

    // the roll
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) x = x * 4u + d[j];
    int32_t out[kUnit];
#pragma unroll
    for (int i = 0; i < kUnit; ++i) {
      const uint32_t rc = revcomp_k<K>(x);
      const uint32_t canon = rc < x ? rc : x;
      out[i] = ((valid >> i) & 1u) ? static_cast<int32_t>(canon ^ 0x80000000u) : kSentinelKey;
      if (i + 1 < kUnit) x = (x - d[i] * kTop) * 4u + d[i + K];
    }
    if (p0 >= 0 && p0 + kUnit <= N && (sh & 3) == 0) {
      int4* dst = reinterpret_cast<int4*>(keys + p0);
#pragma unroll
      for (int v = 0; v < kUnit / 4; ++v)
        dst[v] = make_int4(out[4 * v], out[4 * v + 1], out[4 * v + 2], out[4 * v + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kUnit; ++i)
        if (p0 + i >= 0 && p0 + i < N) keys[p0 + i] = out[i];
    }
  }
}

// The run count: run starts among the valid sorted keys, and the valid
// keys.  A streaming read at 16 bytes a lane: the keys from the first
// 16-byte boundary of `s` on are int4 vectors (any 4-byte offset of `s`:
// the `head` keys before the boundary and the 0-3 after the last whole
// vector are counted one at a time by thread 0).  A warp takes chunks of
// kRunsUnroll x 32 consecutive vectors, a grid-stride loop over them, all
// kRunsUnroll loads of a lane issued before any is used; a vector's left
// neighbour is the previous lane's last key (__shfl_up_sync), lane 0's the
// previous step's lane 31's, and at a chunk's start the one key before it,
// which lane 0 loads beside the vectors.  Vectors past the end load as
// sentinels, which count nothing.  Counts stay 32-bit in registers, go
// through __reduce_add_sync, and each block makes one 64-bit atomic per
// total into `out`, which the caller zeroes.  The grid is kRunsWaves waves
// of kRunsBlocksPerSm blocks an SM, each warp striding over the chunks.
constexpr int kRunsUnroll = 4;
constexpr int kRunsChunk = 32 * kRunsUnroll;        // vectors a warp takes at a time
constexpr int kRunsBlocksPerSm = 8;
constexpr int kRunsWaves = 4;

__device__ __forceinline__ void count_key(int32_t v, int32_t prev, unsigned& starts,
                                          unsigned& valid) {
  const bool ok = v != kSentinelKey;
  valid += ok;
  starts += ok && v != prev;
}

__global__ void __launch_bounds__(kThreads, kRunsBlocksPerSm)
runs_kernel(const int32_t* __restrict__ s, int64_t n, int head, int64_t nv,
            unsigned long long* __restrict__ out) {
  __shared__ unsigned warp_sum[2][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int4* body = reinterpret_cast<const int4*>(s + head);
  const int64_t chunks = (nv + kRunsChunk - 1) / kRunsChunk;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  unsigned starts = 0, valid = 0;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + warp; c < chunks;
       c += warps) {
    const int64_t v0 = c * kRunsChunk;
    int4 x[kRunsUnroll];
#pragma unroll
    for (int u = 0; u < kRunsUnroll; ++u) {
      const int64_t idx = v0 + u * 32 + lane;
      x[u] = idx < nv ? __ldg(body + idx)
                      : make_int4(kSentinelKey, kSentinelKey, kSentinelKey, kSentinelKey);
    }
    const int64_t p = head + 4 * v0 - 1;            // the key before the chunk
    int32_t before = 0;
    if (lane == 0) before = p >= 0 ? __ldg(s + p) : ~x[0].x;
#pragma unroll
    for (int u = 0; u < kRunsUnroll; ++u) {
      int32_t prev = __shfl_up_sync(kFull, x[u].w, 1);
      const int32_t last = __shfl_sync(kFull, x[u].w, 31);
      if (lane == 0) prev = before;
      before = last;
      count_key(x[u].x, prev, starts, valid);
      count_key(x[u].y, x[u].x, starts, valid);
      count_key(x[u].z, x[u].y, starts, valid);
      count_key(x[u].w, x[u].z, starts, valid);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {      // the keys outside the vectors
    for (int64_t i = 0; i < n; ++i) {
      if (i == head) i = head + 4 * nv;           // past the vectors
      if (i >= n) break;
      const int32_t v = s[i];
      count_key(v, i > 0 ? s[i - 1] : ~v, starts, valid);
    }
  }
  starts = __reduce_add_sync(kFull, starts);
  valid = __reduce_add_sync(kFull, valid);
  if (lane == 0) {
    warp_sum[0][warp] = starts;
    warp_sum[1][warp] = valid;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[threadIdx.x][w];
    if (total) atomicAdd(&out[threadIdx.x], total);
  }
}

// The ends of the run of equal keys through s[i] == v: an exponential
// search outward from i, then a binary search inside the last step, so a
// run of r keys costs O(log r) dependent loads.
__device__ int64_t run_first(const int32_t* __restrict__ s, int64_t i, int32_t v) {
  int64_t good = i, bad = -1, step = 1;     // s[good] == v; s[bad] != v or bad == -1
  while (i - step >= 0) {
    const int64_t j = i - step;
    if (s[j] != v) {
      bad = j;
      break;
    }
    good = j;
    step <<= 1;
  }
  while (good - bad > 1) {
    const int64_t mid = bad + (good - bad) / 2;
    if (s[mid] == v) good = mid; else bad = mid;
  }
  return good;
}

__device__ int64_t run_last(const int32_t* __restrict__ s, int64_t n, int64_t i, int32_t v) {
  int64_t good = i, bad = n, step = 1;      // s[good] == v; s[bad] != v or bad == n
  while (i + step < n) {
    const int64_t j = i + step;
    if (s[j] != v) {
      bad = j;
      break;
    }
    good = j;
    step <<= 1;
  }
  while (bad - good > 1) {
    const int64_t mid = good + (bad - good) / 2;
    if (s[mid] == v) good = mid; else bad = mid;
  }
  return good;
}

// The frequency scatter: the length of the run of equal keys through each
// sorted slot i, clipped to 0xFFFF (0 for SENTINEL_KEY), written to the
// slot's position order[i].  A block takes a tile of kFreqTile consecutive
// slots, kFreqSlots a thread: its keys by 16-byte loads and its order
// entries by 16-byte pairs (where `s` and `order` are 16-byte aligned and
// the thread's slots lie in the array, else one at a time).  The keys
// beside a thread's come from the lanes beside it by shuffles; lane 0 and
// lane 31 load the one key before and after their warp's (the tile's halo
// among them).  Each thread marks its slots' heads (a key unlike the one
// before) and tails (unlike the one after, or the last slot) in two masks
// of kFreqSlots bits.  A slot's run starts at the last head at or before it: in the
// thread's own mask, else an exclusive max-scan of the threads' last heads
// (warp shuffles, then the warps' totals through shared memory); it ends
// at the first tail at or after it, by the mirror min-scan.  Only the
// tile's first and last runs can cross its edges, and only they find no
// head or no tail in the tile: thread 0 finds the first run's start and
// the last thread the last run's end by run_first / run_last, the rest of
// the block scanning meanwhile, so a run of r keys costs each tile it
// crosses two O(log r) searches.  Saturation is OR-reduced in the block
// and written once a block.  The stores freq[order[i]] are the function:
// each thread issues its kFreqSlots stores unrolled.  A 2-byte store to a
// random position writes part of a 32-byte sector, and a plane larger
// than the L2 cache evicts most sectors part written, each written back
// on its own.  So the grid makes one pass over the tiles for each window
// of kFreqWindow positions of the plane, in order (blockIdx.x = window x
// tiles + tile), and a pass stores only the counts whose position lies in
// its window: the window's sectors fill in L2 before they are written
// back, for one more read of the keys and permutation a window.  The keys
// and permutation are read as streaming (evict-first) loads and the counts
// stored under an L2 evict-last policy, so that the window's lines stay in
// L2 while the reads stream past.  A window is kFreqWindow positions (32 MB
// of the plane), or more where the plane needs more than kFreqMaxPasses of
// them: each pass reads all 12 bytes a key again.
constexpr int kFreqSlots = 8;
constexpr int kFreqTile = kThreads * kFreqSlots;      // slots a block
constexpr int64_t kFreqWindow = int64_t{1} << 24;     // positions a pass stores, at least
constexpr int64_t kFreqMaxPasses = 4;

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void store_evict_last(uint16_t* p, uint16_t v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.b16 [%0], %1, %2;" :: "l"(p), "h"(v), "l"(policy)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
freqs_kernel(const int32_t* __restrict__ s, const int64_t* __restrict__ order, int64_t n,
             int vec, unsigned tiles, int64_t window, uint16_t* __restrict__ freq,
             int32_t* __restrict__ sat) {
  __shared__ int32_t warp_head[kThreads / 32], warp_tail[kThreads / 32];
  __shared__ int64_t edge[2];                      // the first run's start, the last run's end
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x % tiles) * kFreqTile;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x / tiles) * window;
  const int lo = tid * kFreqSlots;                 // the thread's first slot in the tile
  const int64_t b0 = t0 + lo;
  int32_t v[kFreqSlots];
  int64_t dst[kFreqSlots];
  if (vec && b0 + kFreqSlots <= n) {
    const int4* sv = reinterpret_cast<const int4*>(s + b0);
    const longlong2* ov = reinterpret_cast<const longlong2*>(order + b0);
#pragma unroll
    for (int q = 0; q < kFreqSlots / 4; ++q) {
      const int4 x = __ldcs(sv + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int q = 0; q < kFreqSlots / 2; ++q) {
      const longlong2 y = __ldcs(ov + q);
      dst[2 * q] = y.x;
      dst[2 * q + 1] = y.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kFreqSlots; ++j) {
      const bool in = b0 + j < n;
      v[j] = in ? s[b0 + j] : kSentinelKey;
      dst[j] = in ? order[b0 + j] : 0;
    }
  }
  int32_t prev = __shfl_up_sync(kFull, v[kFreqSlots - 1], 1);
  int32_t next = __shfl_down_sync(kFull, v[0], 1);
  if (lane == 0) prev = b0 > 0 && b0 <= n ? s[b0 - 1] : ~v[0];
  if (lane == 31) next = b0 + kFreqSlots < n ? s[b0 + kFreqSlots] : ~v[kFreqSlots - 1];
  unsigned head = 0, tail = 0;
#pragma unroll
  for (int j = 0; j < kFreqSlots; ++j) {
    const int32_t pj = j == 0 ? prev : v[j - 1];
    const int32_t nj = j == kFreqSlots - 1 ? next : v[j + 1];
    head |= static_cast<unsigned>(pj != v[j]) << j;
    tail |= static_cast<unsigned>(nj != v[j] || b0 + j >= n - 1) << j;
  }
  // the scans: each thread's last head (-1: none) and first tail
  // (kFreqTile: none), as tile indices
  int hs = head ? lo + 31 - __clz(head) : -1;
  int ts = tail ? lo + __ffs(tail) - 1 : kFreqTile;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int h = __shfl_up_sync(kFull, hs, d);
    const int t = __shfl_down_sync(kFull, ts, d);
    if (lane >= d) hs = max(hs, h);
    if (lane + d < 32) ts = min(ts, t);
  }
  if (lane == 31) warp_head[warp] = hs;
  if (lane == 0) warp_tail[warp] = ts;
  int carry_h = __shfl_up_sync(kFull, hs, 1);
  int carry_t = __shfl_down_sync(kFull, ts, 1);
  if (lane == 0) carry_h = -1;
  if (lane == 31) carry_t = kFreqTile;
  // the runs across the tile's edges
  if (tid == 0) edge[0] = (head & 1u) ? t0 : run_first(s, t0 - 1, v[0]);
  if (tid == kThreads - 1)
    edge[1] = (tail >> (kFreqSlots - 1)) ? b0 + kFreqSlots - 1
                                         : run_last(s, n, b0 + kFreqSlots, v[kFreqSlots - 1]);
  __syncthreads();
  for (int w = 0; w < warp; ++w) carry_h = max(carry_h, warp_head[w]);
  for (int w = warp + 1; w < kThreads / 32; ++w) carry_t = min(carry_t, warp_tail[w]);
  const int64_t first0 = edge[0], last0 = edge[1];
  const uint64_t policy = evict_last_policy();
  bool saturated = false;
#pragma unroll
  for (int j = 0; j < kFreqSlots; ++j) {
    const unsigned hb = head & ((2u << j) - 1u);   // heads at or before slot j
    const unsigned tb = tail & (~0u << j);         // tails at or after it
    const int sl = hb ? lo + 31 - __clz(hb) : carry_h;
    const int el = tb ? lo + __ffs(tb) - 1 : carry_t;
    const int64_t cnt = (el < kFreqTile ? t0 + el : last0) - (sl >= 0 ? t0 + sl : first0) + 1;
    uint16_t f = static_cast<uint16_t>(cnt);
    if (v[j] == kSentinelKey) {
      f = 0;
    } else if (cnt >= 0xFFFF) {
      f = 0xFFFF;
      saturated = true;
    }
    if (b0 + j < n && static_cast<uint64_t>(dst[j] - w0) < static_cast<uint64_t>(window))
      store_evict_last(freq + dst[j], f, policy);
  }
  if (__syncthreads_or(saturated) && tid == 0) *sat = 1;
}

// Shared-memory index of tile slot i: one pad word after every segment's
// kMinSeg slots, so that the threads, each at the same step of its own
// segment, hit distinct banks; the code bytes pad four bytes a segment.
__device__ __forceinline__ int slot(int i) { return i + (i >> kMinSegBits); }
__device__ __forceinline__ int code_slot(int i) { return i + 4 * (i >> kMinSegBits); }
__host__ __device__ constexpr int slots(int n) { return n + (n >> kMinSegBits) + 1; }

__device__ __forceinline__ uint32_t kmer_from(const uint8_t* cbuf, int i, int k) {
  uint32_t x = 0;
  for (int j = 0; j < k; ++j)
    x += static_cast<uint32_t>(cbuf[code_slot(i + j)]) << (2 * (k - 1 - j));
  return x;
}

// The dynamic shared memory of a minimizer block: the hashes of the tile
// and of the `ahead` positions past it (uint64), then in their place each
// position's exit (int32) and mask byte; the raw k-mers, then in their
// place the next fronts (int32); the segments' entries and the carry,
// their constant exits; and the codes.
size_t minimizer_shared_bytes(int ahead, int k) {
  const int n_codes = kMinTile + ahead + k;
  return static_cast<size_t>(slots(kMinTile + ahead)) * 8 + slots(kMinTile) * 4
         + (2 * kMinThreads + 1) * 4 + n_codes + 4 * (n_codes >> kMinSegBits) + 20;
}

template <bool kScratch>
__global__ void __launch_bounds__(kMinThreads)
minimizer_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                 int64_t L, int k, int w, int64_t* __restrict__ raw,
                 uint8_t* __restrict__ mask, uint64_t* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ahead = kScratch ? 0 : w;
  uint64_t* hs = reinterpret_cast<uint64_t*>(smem);
  int32_t* ext = reinterpret_cast<int32_t*>(smem);                      // over hs
  uint8_t* mbuf = reinterpret_cast<uint8_t*>(ext + slots(kMinTile));   // over hs
  uint32_t* rawbuf = reinterpret_cast<uint32_t*>(hs + slots(kMinTile + ahead));
  int32_t* nxt = reinterpret_cast<int32_t*>(rawbuf);                    // over rawbuf
  int32_t* entry = nxt + slots(kMinTile);            // kMinThreads, then the carry
  int32_t* segc = entry + kMinThreads + 1;           // kMinThreads
  uint8_t* cbuf = reinterpret_cast<uint8_t*>(segc + kMinThreads);
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = static_cast<int>(L);
  const uint8_t* row = codes + b * L;
  int64_t* raw_row = raw + b * L;
  uint8_t* mask_row = mask + b * L;
  uint64_t* hash_row = kScratch ? scratch + b * L : nullptr;
  const int live = lengths[b] - k;      // steps 0 .. live - 1 move the front
  const int top = 2 * (k - 1);
  const int a = tid * kMinSeg;          // the thread's segment, from the tile's start
  const int n_codes = kMinTile + ahead + k;
  // 16-byte code loads and 4-byte mask stores where the row allows them
  const bool row16 = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const bool mask4 = (reinterpret_cast<uintptr_t>(mask_row) & 3) == 0;

  // The tile's codes (columns modulo L, as jnp.roll reads them), raw
  // k-mers and hashes; with the hashes in the scratch, the raw plane
  // stored, coalesced (else `fronts` stores it).
  auto raw_and_hashes = [&](int t0) {
    for (int i0 = tid * 16; i0 < n_codes; i0 += kMinThreads * 16) {
      if (row16 && t0 + i0 + 16 <= n) {      // one segment's 16 codes, padded past
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + t0 + i0));
        uint32_t* dst = reinterpret_cast<uint32_t*>(cbuf + code_slot(i0));
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      } else {
        for (int i = i0; i < i0 + 16 && i < n_codes; ++i) {
          int c = t0 + i;
          if (c >= n) c %= n;
          cbuf[code_slot(i)] = row[c];
        }
      }
    }
    __syncthreads();
    if (t0 + a < n) {
      uint32_t x = kmer_from(cbuf, a, k);
#pragma unroll 4
      for (int s = 0; s < kMinSeg; ++s) {
        const int p = t0 + a + s;
        rawbuf[slot(a + s)] = x;
        if (p < live) {
          const uint64_t h = splitmix(canonical(x, k));
          if constexpr (kScratch) hash_row[p] = h; else hs[slot(a + s)] = h;
        }
        x = ((x - (static_cast<uint32_t>(cbuf[code_slot(a + s)]) << top)) << 2)
            + static_cast<uint32_t>(cbuf[code_slot(a + s + k)]);
      }
    }
    if constexpr (!kScratch) {
      for (int i = kMinTile + tid; i < kMinTile + w && t0 + i < live; i += kMinThreads)
        hs[slot(i)] = splitmix(canonical(kmer_from(cbuf, i, k), k));
    }
    __syncthreads();
    if constexpr (kScratch) {
      const int here = min(kMinTile, n - t0);
      for (int i = tid; i < here; i += kMinThreads) raw_row[t0 + i] = rawbuf[slot(i)];
    }
  };

  // The tile's fronts from the carried entry (the first front at or past
  // t0), and its mask bytes stored, coalesced; the carry becomes the next
  // tile's entry.
  auto fronts = [&](int t0) {
    // each position's next front: the first later position of a strictly
    // smaller hash within w - 1, else the last minimum of the window whose
    // step evicts it; kEnd where that step is not live.  Consecutive lanes
    // take consecutive positions, so their look-ahead reads hit distinct
    // banks; each position's raw k-mer is stored (coalesced) before its
    // next front takes its slot.
    for (int i = tid; i < kMinTile; i += kMinThreads) {
      const int p = t0 + i;
      if constexpr (!kScratch) {
        if (p < n) raw_row[p] = rawbuf[slot(i)];
      }
      int nx = kEnd;
      if (p < live) {
        const uint64_t hp = kScratch ? hash_row[p] : hs[slot(i)];
        const int steps = min(w, live - 1 - p);      // look-ahead steps still live
        uint64_t m = ~0ull;
        int d = 1;
        for (; d <= steps; ++d) {
          const uint64_t hq = kScratch ? hash_row[p + d] : hs[slot(i + d)];
          if (hq < hp) {
            nx = p + d;
            break;
          }
          if (hq <= m) {
            m = hq;
            nx = p + d;
          }
        }
        if (d > steps && steps < w) nx = kEnd;     // the walk ends before the eviction
      }
      nxt[slot(i)] = nx;
    }
    __syncthreads();                   // the hashes are read no more
    // each position's exit: the first front at or past the segment's end
    // that the fronts reach from it
    const int end = t0 + a + kMinSeg;
    for (int s = a + kMinSeg - 1; s >= a; --s) {
      const int y = nxt[slot(s)];
      ext[slot(s)] = y >= end ? y : ext[slot(y - t0)];
    }
    // the segment's map is constant where its w entries share one exit.
    // Past the walk's last front s (its next step not live) every segment's
    // entries exit to none too: their fronts stay below s + w, short of
    // the segment's end, since w <= kMinSeg; so a constant exit is never a
    // front after the walk has ended.
    {
      const int c = ext[slot(a)];
      bool same = w <= kMinSeg;
      for (int o = 1; o < w && same; ++o) same = ext[slot(a + o)] == c;
      segc[tid] = same ? c : -1;
    }
    for (int i = tid; i < kMinTile; i += kMinThreads) mbuf[i] = 0;
    __syncthreads();
    // the segments' entries: warp 0 takes 32 segments a round, each lane's
    // entry the constant exit of the segment before it where it has one,
    // else that segment's map applied to the entry before, as it becomes
    // known (a shuffle a step)
    if (tid < 32) {
      auto apply = [&](int i, int e) {     // segment i's map (e at or past its start)
        return e < t0 + (i + 1) * kMinSeg ? ext[slot(e - t0)] : e;
      };
      int first = entry[kMinThreads];
      for (int g = 0; g < kMinThreads; g += 32) {
        const int i = g + tid;
        int v = first;
        bool known = tid == 0;
        if (!known) {
          v = segc[i - 1];
          known = v >= 0;
        }
        while (__ballot_sync(kFull, !known)) {
          const int pv = __shfl_up_sync(kFull, v, 1);
          const bool pk = __shfl_up_sync(kFull, known, 1);
          if (!known && pk) {
            v = apply(i - 1, pv);
            known = true;
          }
        }
        entry[i] = v;
        first = apply(g + 31, __shfl_sync(kFull, v, 31));
      }
      if (tid == 0) entry[kMinThreads] = first;
    }
    __syncthreads();
    for (int e = entry[tid]; e < end; e = nxt[slot(e - t0)]) mbuf[e - t0] = 1;
    __syncthreads();
    const int here = min(kMinTile, n - t0);
    if (mask4) {
      for (int i = 4 * tid; i < here; i += 4 * kMinThreads) {
        if (i + 4 <= here)
          *reinterpret_cast<uint32_t*>(mask_row + t0 + i) = *reinterpret_cast<uint32_t*>(mbuf + i);
        else
          for (int j = i; j < here; ++j) mask_row[t0 + j] = mbuf[j];
      }
    } else {
      for (int i = tid; i < here; i += kMinThreads) mask_row[t0 + i] = mbuf[i];
    }
  };

  if (tid == 0) entry[kMinThreads] = live > 0 ? 0 : kEnd;    // the first front is position 0
  if constexpr (kScratch) {
    for (int t0 = 0; t0 < n; t0 += kMinTile) {
      raw_and_hashes(t0);
      __syncthreads();                 // the codes and raw k-mers are refilled next
    }
    for (int t0 = 0; t0 < n; t0 += kMinTile) {
      fronts(t0);
      __syncthreads();
    }
  } else {
    for (int t0 = 0; t0 < n; t0 += kMinTile) {
      raw_and_hashes(t0);
      fronts(t0);
      __syncthreads();
    }
  }
}

// The minimizer sites in canonical form with strand-adjusted global
// positions (vertex_index.cpp:441-446: a flipped site's position becomes
// len - pos - k), compacted: each site takes a slot of its block by a
// shared-memory atomic, one thread takes the block's range of the output
// by one global atomic.  The slots' order does not matter: the keys are
// sorted next.  The k-mer and the global position go to two int64 arrays,
// so any total of bases fits.
__global__ void __launch_bounds__(kThreads)
sites_kernel(const int64_t* __restrict__ raw, const uint8_t* __restrict__ mask,
             const int32_t* __restrict__ lengths, const int64_t* __restrict__ offsets, int64_t B,
             int64_t L, int k, int64_t* __restrict__ reps, int64_t* __restrict__ gpos,
             unsigned long long* __restrict__ count) {
  __shared__ unsigned int block_n;
  __shared__ unsigned long long block_base;
  const int64_t n = B * L;
  for (int64_t base = blockIdx.x * static_cast<int64_t>(blockDim.x); base < n;
       base += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (threadIdx.x == 0) block_n = 0;
    __syncthreads();
    const int64_t idx = base + threadIdx.x;
    const bool site = idx < n && mask[idx] != 0;
    unsigned int slot = 0;
    if (site) slot = atomicAdd(&block_n, 1u);
    __syncthreads();
    if (threadIdx.x == 0)
      block_base = block_n ? atomicAdd(count, static_cast<unsigned long long>(block_n)) : 0;
    __syncthreads();
    if (site) {
      const int64_t b = idx / L;
      const int64_t col = idx - b * L;
      const uint32_t x = static_cast<uint32_t>(raw[idx]);
      const uint32_t rc = revcomp(x, k);
      const bool flip = rc < x;
      const uint32_t canon = flip ? rc : x;
      const int64_t g = offsets[b] + (flip ? lengths[b] - col - k : col);
      const int64_t at = static_cast<int64_t>(block_base) + slot;
      reps[at] = canon;
      gpos[at] = g;
    }
    __syncthreads();      // block_n and block_base are reused by the next tile
  }
}

unsigned grid_for(int64_t n, int64_t threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return static_cast<unsigned>(blocks < 8192 ? blocks : 8192);
}

template <int MODE>
int launch_canonical(const void* codes, const void* lengths, int64_t B, int64_t L, int k,
                     void* keys, cudaStream_t stream) {
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  const unsigned grid = grid_for((B * L + sh + 15) / 16, kThreads);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* out = static_cast<int32_t*>(keys);
  switch (k) {
#define GB_CANON_CASE(K_)                                                       \
  case K_:                                                                      \
    canonical_kernel<K_, MODE><<<grid, kThreads, 0, stream>>>(c, len, B, L, out); \
    break;
    GB_CANON_CASE(1) GB_CANON_CASE(2) GB_CANON_CASE(3) GB_CANON_CASE(4)
    GB_CANON_CASE(5) GB_CANON_CASE(6) GB_CANON_CASE(7) GB_CANON_CASE(8)
    GB_CANON_CASE(9) GB_CANON_CASE(10) GB_CANON_CASE(11) GB_CANON_CASE(12)
    GB_CANON_CASE(13) GB_CANON_CASE(14) GB_CANON_CASE(15) GB_CANON_CASE(16)
#undef GB_CANON_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The canonical key of every position of the (B, L) codes, at any byte
// offset, into keys (B * L,) int32, which must be 16-byte aligned; mode 0
// reads the codes as given, mode 1 through their packed bytes.
extern "C" int gb_kmer_canonical(const void* codes, const void* lengths, int64_t B, int64_t L,
                                 int k, int mode, void* keys, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (L > INT_MAX || (mode != 0 && mode != 1) ||
      (reinterpret_cast<uintptr_t>(keys) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return mode == 0 ? launch_canonical<0>(codes, lengths, B, L, k, keys, st)
                   : launch_canonical<1>(codes, lengths, B, L, k, keys, st);
}

// The run starts and the valid keys of the sorted keys at `sorted_keys`
// (any 4-byte offset), added to out[0] and out[1] (uint64), which the
// caller zeroes.
extern "C" int gb_kmer_runs(const void* sorted_keys, int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  const auto* s = static_cast<const int32_t*>(sorted_keys);
  const int64_t head = ((16 - (reinterpret_cast<uintptr_t>(s) & 15)) & 15) / 4;
  const int h = static_cast<int>(head < n ? head : n);
  const int64_t nv = (n - h) / 4;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = ((nv + kRunsChunk - 1) / kRunsChunk + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t wave = static_cast<int64_t>(sms) * kRunsBlocksPerSm * kRunsWaves;
  const unsigned grid = static_cast<unsigned>(need < 1 ? 1 : (need < wave ? need : wave));
  runs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, n, h, nv, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// freq[order[i]] = the length of the run through sorted slot i (see
// freqs_kernel); sat, which the caller zeroes, set to 1 where one reached
// 0xFFFF.
extern "C" int gb_kmer_freqs(const void* sorted_keys, const void* order, int64_t n, void* freq,
                             void* sat, void* stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kFreqTile - 1) / kFreqTile;
  const int64_t most = (n + kFreqMaxPasses - 1) / kFreqMaxPasses;
  const int64_t window = most > kFreqWindow ? most : kFreqWindow;
  const int64_t blocks = tiles * ((n + window - 1) / window);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = ((reinterpret_cast<uintptr_t>(sorted_keys) | reinterpret_cast<uintptr_t>(order))
                   & 15) == 0;
  freqs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sorted_keys), static_cast<const int64_t*>(order), n, vec,
      static_cast<unsigned>(tiles), window, static_cast<uint16_t*>(freq),
      static_cast<int32_t*>(sat));
  return static_cast<int>(cudaGetLastError());
}

// The raw k-mer plane (B, L) int64 and the mask (B, L) uint8 of every
// read; `scratch`, (B, L) uint64, holds the hashes where window >
// kMinSharedWindow and may be null otherwise.
extern "C" int gb_kmer_minimizers(const void* codes, const void* lengths, int64_t B, int64_t L,
                                  int k, int window, void* raw, void* mask, void* scratch,
                                  void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const bool scr = window > kMinSharedWindow;
  if (B > INT_MAX || L > kMinMaxLen || window < 1 || window > kMinMaxLen || k < 1 || k > 16 ||
      (scr && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int shared = static_cast<int>(minimizer_shared_bytes(scr ? 0 : window, k));
  const auto kernel = scr ? minimizer_kernel<true> : minimizer_kernel<false>;
  kernel<<<static_cast<unsigned>(B), kMinThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths), L, k, window,
      static_cast<int64_t*>(raw), static_cast<uint8_t*>(mask), static_cast<uint64_t*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gb_kmer_sites(const void* raw, const void* mask, const void* lengths,
                             const void* offsets, int64_t B, int64_t L, int k, void* reps,
                             void* gpos, void* count, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  sites_kernel<<<grid_for(B * L, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(raw), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(lengths), static_cast<const int64_t*>(offsets), B, L, k,
      static_cast<int64_t*>(reps), static_cast<int64_t*>(gpos),
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
