// Flye kmer-cnt for Hopper: canonical k-mers, their run counts and
// per-position frequencies, the window-minimizer deque and the minimizer
// sites.  Five kernels, each one thread per work item, no warp collective.
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
// Bounds (chip_smoke.py `[kmer kernel]` counts them from each run's inputs):
// the canonical pass, the run count and the frequency scatter are bytes
// bound (one code byte in and one 4-byte key out per position; 4 bytes of
// key; 4 + 8 bytes of key and permutation in and 2 bytes out); the
// minimizer walk moves one code byte in and 8 + 1 bytes of raw k-mer and
// mask out per position and does a few tens of integer instructions per
// position (the hash is two 64-bit products), one thread per read, so a
// 25,000-read batch fills about 6 warps of each SM and the walk is bound by
// the latency of its dependent chain; the site build reads 9 bytes per
// position and writes 16 per site.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinelKey = 0x7FFFFFFF;   // SENTINEL 0xFFFFFFFF ^ 0x80000000
constexpr int kRingCap = 64;                   // ring entries held per thread; more in scratch
constexpr int kThreads = 256;

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

// The code at column c of a row, as each input mode holds it: 0 the codes
// themselves; 1 the codes, each read through its byte as pack_codes_2bit
// forms it (columns at and beyond L are 0 there).
__device__ __forceinline__ uint32_t code_at(const uint8_t* __restrict__ row, int64_t c,
                                            int64_t L, int mode) {
  if (mode == 0) return row[c];
  const int shift = 2 * static_cast<int>(c & 3);
  const int64_t g = c & ~static_cast<int64_t>(3);
  uint32_t byte = 0;
  for (int s = 0; s < 4; ++s)
    if (g + s < L) byte |= static_cast<uint32_t>(row[g + s]) << (2 * s);
  return ((byte & 0xFFu) >> shift) & 3u;
}

__global__ void __launch_bounds__(kThreads)
canonical_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                 int64_t B, int64_t L, int k, int mode, int32_t* __restrict__ keys) {
  const int64_t n = B * L;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < n;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = idx / L;
    const int64_t i = idx - b * L;
    int32_t key = kSentinelKey;
    if (i < static_cast<int64_t>(lengths[b]) - k) {
      const uint8_t* row = codes + b * L;
      uint32_t x = 0;
      for (int j = 0; j < k; ++j) x += code_at(row, i + j, L, mode) << (2 * (k - 1 - j));
      key = static_cast<int32_t>(canonical(x, k) ^ 0x80000000u);
    }
    keys[idx] = key;
  }
}

// Run starts among the valid sorted keys, and the valid keys: each thread
// counts its keys, the block sums into shared memory, one thread adds the
// block's sums to the two totals.
__global__ void __launch_bounds__(kThreads)
runs_kernel(const int32_t* __restrict__ s, int64_t n, unsigned long long* __restrict__ out) {
  __shared__ unsigned long long block_sum[2];
  if (threadIdx.x == 0) block_sum[0] = block_sum[1] = 0;
  __syncthreads();
  unsigned long long starts = 0, valid = 0;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int32_t v = s[i];
    if (v != kSentinelKey) {
      ++valid;
      if (i == 0 || s[i - 1] != v) ++starts;
    }
  }
  if (starts) atomicAdd(&block_sum[0], starts);
  if (valid) atomicAdd(&block_sum[1], valid);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_sum[0]) atomicAdd(&out[0], block_sum[0]);
    if (block_sum[1]) atomicAdd(&out[1], block_sum[1]);
  }
}

// The length of the run of equal keys through each sorted slot, written to
// the slot's original position order[i]: an exponential search outward from
// i for each end of the run, then a binary search inside the last step, so a
// run of r equal keys costs each of its slots O(log r) loads (a poly-A read
// gives a run of tens of thousands).
__global__ void __launch_bounds__(kThreads)
freqs_kernel(const int32_t* __restrict__ s, const int64_t* __restrict__ order, int64_t n,
             uint16_t* __restrict__ freq, int32_t* __restrict__ sat) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int32_t v = s[i];
    const int64_t dst = order[i];
    if (v == kSentinelKey) {
      freq[dst] = 0;
      continue;
    }
    // first slot of the run: s[good] == v, and s[bad] != v or bad == -1
    int64_t good = i, bad = -1, step = 1;
    while (true) {
      const int64_t j = i - step;
      if (j < 0) break;
      if (s[j] != v) { bad = j; break; }
      good = j;
      step <<= 1;
    }
    while (good - bad > 1) {
      const int64_t mid = bad + (good - bad) / 2;
      if (s[mid] == v) good = mid; else bad = mid;
    }
    const int64_t first = good;
    // last slot: s[good] == v, and s[bad] != v or bad == n
    good = i;
    bad = n;
    step = 1;
    while (true) {
      const int64_t j = i + step;
      if (j >= n) break;
      if (s[j] != v) { bad = j; break; }
      good = j;
      step <<= 1;
    }
    while (bad - good > 1) {
      const int64_t mid = good + (bad - good) / 2;
      if (s[mid] == v) good = mid; else bad = mid;
    }
    const int64_t count = good - first + 1;
    if (count >= 0xFFFF) {
      freq[dst] = 0xFFFF;
      *sat = 1;
    } else {
      freq[dst] = static_cast<uint16_t>(count);
    }
  }
}

// yieldMinimizers' monotone deque (kmer.h:206-262) for one read per thread,
// as a ring of window + 1 (position, hash) entries: in the thread's local
// array up to kRingCap entries, else in the device scratch, slot s of read b
// at s * B + b.  The raw k-mer rolls along the row modulo 2^32 (subtract the
// leaving code's term, shift, add the entering code), reading columns
// modulo L as the JAX package's jnp.roll does, so positions past the row's
// last full k-mer hold its wrapped values too.
template <bool kScratch>
struct Ring {
  uint64_t h_local[kScratch ? 1 : kRingCap];
  int32_t p_local[kScratch ? 1 : kRingCap];
  uint64_t* h_glob;
  int32_t* p_glob;
  int64_t stride;

  __device__ __forceinline__ uint64_t& h(int s) {
    if constexpr (kScratch) return h_glob[s * stride]; else return h_local[s];
  }
  __device__ __forceinline__ int32_t& p(int s) {
    if constexpr (kScratch) return p_glob[s * stride]; else return p_local[s];
  }
};

template <bool kScratch>
__global__ void __launch_bounds__(64)
minimizer_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
                 int64_t B, int64_t L, int k, int window, int64_t* __restrict__ raw,
                 uint8_t* __restrict__ mask, uint64_t* scratch_h, int32_t* scratch_p) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B || L == 0) return;
  const uint8_t* row = codes + b * L;
  int64_t* raw_row = raw + b * L;
  uint8_t* mask_row = mask + b * L;
  const int64_t live = static_cast<int64_t>(lengths[b]) - k;
  const int cap = window + 1;

  Ring<kScratch> q;
  if constexpr (kScratch) {
    q.h_glob = scratch_h + b;
    q.p_glob = scratch_p + b;
    q.stride = B;
  }
  int head = 0, size = 0;           // the front is slot head; the back head + size - 1
  int64_t last_emit = -1;

  uint32_t x = 0;
  for (int j = 0; j < k; ++j) x += static_cast<uint32_t>(row[j % L]) << (2 * (k - 1 - j));
  const int top = 2 * (k - 1);
  for (int64_t p = 0; p < L; ++p) {
    raw_row[p] = x;
    mask_row[p] = 0;
    if (p < live) {
      const uint64_t h = splitmix(canonical(x, k));
      while (size > 0) {
        int back = head + size - 1;
        if (back >= cap) back -= cap;
        if (q.h(back) <= h) break;
        --size;
      }
      int tail = head + size;
      if (tail >= cap) tail -= cap;
      q.h(tail) = h;
      q.p(tail) = static_cast<int32_t>(p);
      ++size;
      if (q.p(head) <= p - window) {
        while (q.p(head) <= p - window) {
          if (++head == cap) head = 0;
          --size;
        }
        while (size >= 2) {
          int second = head + 1;
          if (second == cap) second = 0;
          if (q.h(head) != q.h(second)) break;
          head = second;
          --size;
        }
      }
      const int64_t front = q.p(head);
      if (front != last_emit) {
        mask_row[front] = 1;
        last_emit = front;
      }
    }
    x = ((x - (static_cast<uint32_t>(row[p]) << top)) << 2)
        + static_cast<uint32_t>(row[(p + k) % L]);
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

}  // namespace

extern "C" int gb_kmer_canonical(const void* codes, const void* lengths, int64_t B, int64_t L,
                                 int k, int mode, void* keys, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  canonical_kernel<<<grid_for(B * L, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths), B, L, k, mode,
      static_cast<int32_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gb_kmer_runs(const void* sorted_keys, int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  runs_kernel<<<grid_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sorted_keys), n, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gb_kmer_freqs(const void* sorted_keys, const void* order, int64_t n, void* freq,
                             void* sat, void* stream) {
  if (n <= 0) return 0;
  freqs_kernel<<<grid_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sorted_keys), static_cast<const int64_t*>(order), n,
      static_cast<uint16_t*>(freq), static_cast<int32_t*>(sat));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gb_kmer_minimizers(const void* codes, const void* lengths, int64_t B, int64_t L,
                                  int k, int window, void* raw, void* mask, void* scratch_h,
                                  void* scratch_p, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + 63) / 64);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (window + 1 <= kRingCap) {
    minimizer_kernel<false><<<blocks, 64, 0, st>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths), B, L, k, window,
        static_cast<int64_t*>(raw), static_cast<uint8_t*>(mask), nullptr, nullptr);
  } else {
    minimizer_kernel<true><<<blocks, 64, 0, st>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lengths), B, L, k, window,
        static_cast<int64_t*>(raw), static_cast<uint8_t*>(mask),
        static_cast<uint64_t*>(scratch_h), static_cast<int32_t*>(scratch_p));
  }
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
