"""Flye k-mer counting and minimizers (kmer-cnt) in PyTorch.

The port of genomicsbench_tpu/ops/kmer.py.  Semantics: benchmarks/kmer-cnt
-- 2-bit k-mer representation (kmer.h:16-109), standardForm canonicalization
(min of k-mer and reverse complement, kmer.h:53-63), the splitmix64 hash
(kmer.h:91-98), monotone-deque window minimizers (kmer.h:206-262),
KmerCounter::count's final totals (vertex_index.cpp:513-612) and the two
index builders (vertex_index.cpp:25-125, 316-358, 389-497), as the JAX
package computes them, for k from 1 to 16.

Device part: five functions, each with its hand-written kernel in
`csrc/kmer.cu` (CUDA tensors) and its plain PyTorch version (CPU tensors):

* `canonical_keys`: the canonical k-mer of every position as an int32 key
  `canon ^ 0x80000000` (signed order = unsigned order), SENTINEL_KEY where
  the reference iterates no k-mer (`_canonical_kmers`, :165);
* `kmer_runs`: (run starts, valid keys) of a sorted key array
  (`_count_stats_device`'s tail, :704-709);
* `kmer_freqs`: each position's run length through the sort's permutation,
  clipped to 0xFFFF, and a saturation flag (`_per_position_freqs`, :199-217);
* `minimizer_walk`: the raw k-mer plane and the emission mask
  (`minimizer_mask`, :293-388);
* `minimizer_sites`: the compacted (canonical k-mer, global position)
  pairs of the minimizer sites (`_minimizer_sites`, :422, and the key build
  of `_minimizer_sites_sorted`, :438-454).

Between them the sorts are `torch.sort`, as the JAX package's are XLA sort
primitives.  The host parts of the two index builders are the JAX package's
numpy, copied, with the per-k-mer loop of `build_index_uneven_coverage`
vectorised (the same arrays).

torch has no unsigned 32- or 64-bit arithmetic, so the plain versions hold
uint32 values in int64, mask after shifts, wrap sums at 2^32, multiply in
16-bit limbs and compare 64-bit hashes as `(hi - 2^31) * 2^32 + lo`, whose
signed order is the unsigned order of the hash.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.oracle.kmer import revcomp_np as _revcomp_np
from genomicsbench_tpu_torch.utils import offsets_from_lengths

SENTINEL = 0xFFFFFFFF                  # no k-mer at this position (uint32)
KEY_BIAS = 1 << 31                     # key = canon ^ 0x80000000 = canon - 2^31
SENTINEL_KEY = SENTINEL - KEY_BIAS     # INT32_MAX: sorts after every k-mer
MODE_CODES, MODE_PACK_CODES = 0, 1     # gb_kmer_canonical's inputs
MIN_SHARED_WINDOW = 1024   # gb_kmer_minimizers reads hashes ahead in shared memory up to it
_M32 = 0xFFFFFFFF
_I64_MAX = (1 << 63) - 1
# The 32-bit integer instructions each function needs, for the kernels'
# bounds (chip_smoke.py `[kmer kernel]`), one per Hopper instruction: a
# LOP3 takes any and/or/xor/not of three operands, IMNMX a min, LEA a
# shift and add, SHF a funnel shift, PRMT a byte permute, IMAD.WIDE a
# 32x32->64 product; a 64-bit add or compare is two.  Per counted k-mer:
# its roll along the read (the leaving code's term off by an IMAD, the
# entering code on by a LEA: 2), the code read through its packed byte (the
# previous slot's spill shifted in and masked: 2), the reverse complement
# (the complement under the mask: 1; the 2- and 4-bit butterfly stages, two
# shifts and one LOP3 each: 6; the byte reverse, which is the 8-bit stage
# and the half swap, one PRMT; the final shift: 9 in all), the min (1) and
# the key's xor (1): 15.  Per run-count key: the sentinel test, the
# neighbour test and two sums.  Per frequency key: the neighbour tests of
# its run's two ends, the length and its clip.  Per minimizer step: the
# roll (2), the canonical form (10), the hash (a 64-bit add: 2; three
# 64-bit xor-shifts of two SHF and two LOP3: 12; two products' low 64 bits
# by one IMAD.WIDE and two IMAD: 6; 20 in all), the deque's amortised push
# and pop (a 64-bit compare each and four index updates: 8) and the
# eviction and emission tests (4): 44.  Per site: the reverse complement,
# its compare and the select (11), the strand-adjusted position (its
# difference, the select and the 64-bit offset add: 4) and the output slot
# (a 64-bit add: 2): 17.  Per position, every function but the run count:
# its bound test and store select (2).
KMER_CANON_OPS = 15
KMER_RUNS_OPS = 4
KMER_FREQS_OPS = 6
KMER_MIN_OPS = 44
KMER_SITE_OPS = 17
KMER_POS_OPS = 2

_U8, _I32, _I64 = torch.uint8, torch.int32, torch.int64


def _check_k(k: int) -> None:
    if not isinstance(k, (int, np.integer)) or not 1 <= k <= 16:
        raise ValueError(f"k must be an integer from 1 to 16 (a k-mer is 2k bits of a uint32), "
                         f"got {k!r}")


def _check_window(window: int) -> None:
    if not isinstance(window, (int, np.integer)) or window < 1:
        raise ValueError(f"window must be an integer >= 1, got {window!r}")


def _check_lengths(lengths: torch.Tensor, B: int, L: int, device: torch.device) -> None:
    """(B,) int32 lengths, contiguous on `device`, each in 0..L."""
    if lengths.dtype != _I32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if lengths.shape != (B,) or lengths.device != device or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous ({B},) tensor on {device}, got "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if L >= 1 << 31:
        raise ValueError(f"rows of {L} bases: at most 2^31 - 1")
    if B and (int(lengths.min()) < 0 or int(lengths.max()) > L):
        raise ValueError(f"lengths must lie in 0..{L} (the batch's width)")


def _check_codes(codes: torch.Tensor, lengths: torch.Tensor) -> None:
    """A contiguous (B, L) uint8 code batch and its lengths."""
    if codes.dtype != _U8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    if codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous (B, L) tensor, got {tuple(codes.shape)}")
    _check_lengths(lengths, *codes.shape, codes.device)


def _launch(dev: torch.device):
    from genomicsbench_tpu_torch import _kernels

    return _kernels.load(), torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError {rc}")


# ---------------------------------------------------------------- primitives
def _mul32(a: torch.Tensor, b: int):
    """Full product of uint32 values (in int64) and a uint32 constant, as
    (hi, lo) uint32 halves, through 16-bit limbs (no int64 overflow)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = (hh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & _M32
    return hi, lo


def _mul64(hi, lo, k: int):
    """(hi, lo) * a 64-bit constant, the low 64 bits."""
    k_hi, k_lo = k >> 32, k & _M32
    p_hi, p_lo = _mul32(lo, k_lo)
    p_hi = (p_hi + _mul32(lo, k_hi)[1] + _mul32(hi, k_lo)[1]) & _M32
    return p_hi, p_lo


def _xorshr(hi, lo, n: int):
    """(hi, lo) ^ ((hi, lo) >> n) for 0 < n < 32."""
    return hi ^ (hi >> n), lo ^ (((lo >> n) | (hi << (32 - n))) & _M32)


def _as_long(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_I64)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def splitmix_hash(repr_lo, device="cuda"):
    """Kmer::hash (kmer.h:91-98) of representations < 2^32, as (hi, lo)
    int64 tensors holding the uint32 halves (the JAX package's
    `splitmix_hash`, ops/kmer.py:83-95)."""
    x = _as_long(repr_lo, resolve_device(device))
    lo = x + 0x7F4A7C15
    hi = torch.full_like(x, 0x9E3779B9) + (lo >> 32)
    lo, hi = lo & _M32, hi & _M32
    hi, lo = _mul64(*_xorshr(hi, lo, 30), 0xBF58476D1CE4E5B9)
    hi, lo = _mul64(*_xorshr(hi, lo, 27), 0x94D049BB133111EB)
    return _xorshr(hi, lo, 31)


def extract_kmers(seq, k: int, device="cuda") -> torch.Tensor:
    """(B, L) codes -> (B, L) int64 k-mer representations (uint32 values):
    position i holds sum_j code[i + j] << 2(k-1-j) modulo 2^32, columns
    read modulo L (jnp.roll), so positions past a row's last full k-mer
    hold wrapped junk; mask with `kmer_valid`."""
    _check_k(k)
    s = _as_long(seq, resolve_device(device))
    out = torch.zeros_like(s)
    for j in range(k):
        out = (out + (torch.roll(s, -j, dims=1) << (2 * (k - 1 - j)))) & _M32
    return out


def kmer_valid(lengths, L: int, k: int, device="cuda") -> torch.Tensor:
    """(B, L) bool: the positions the reference iterates, col < length - k
    (IterKmers::end() is exclusive, kmer.h:193-198)."""
    lens = _as_long(lengths, resolve_device(device))
    cols = torch.arange(L, device=lens.device)
    return cols[None, :] < (lens[:, None] - k)


def revcomp(repr32, k: int, device="cuda") -> torch.Tensor:
    """Reverse complement of 2-bit packed k-mers (exact Kmer semantics; the
    bit butterfly of ops/kmer.py:127-135)."""
    _check_k(k)
    x = (~_as_long(repr32, resolve_device(device))) & ((1 << (2 * k)) - 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x << 16) & _M32) | (x >> 16)
    return x >> (32 - 2 * k)


def canonical(repr32, k: int, device="cuda") -> torch.Tensor:
    x = _as_long(repr32, resolve_device(device))
    return torch.minimum(x, revcomp(x, k, device=x.device))


def pack_codes_2bit(seq_codes: np.ndarray) -> np.ndarray:
    """Host-side 4-codes-per-byte packing (ops/kmer.py:675-685): a code
    above 3 spills into the next slot of its byte, and out of the byte's
    last slot."""
    B, L = seq_codes.shape
    L4 = -(-L // 4) * 4
    q = np.zeros((B, L4), np.uint8)
    q[:, :L] = seq_codes
    q = q.reshape(B, L4 // 4, 4)
    return (q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4)
            | (q[..., 3] << 6)).astype(np.uint8)


def _unpack_codes_2bit(packed, L: int, device="cuda") -> torch.Tensor:
    """(B, ceil(L/4)) packed bytes -> (B, L) uint8 codes 0..3."""
    p = _as_long(packed, resolve_device(device))
    cols = torch.arange(L, device=p.device)
    byte = p[:, cols >> 2]
    return ((byte >> (2 * (cols & 3))) & 3).to(_U8)


def _pack_codes_torch(codes: torch.Tensor) -> torch.Tensor:
    """`pack_codes_2bit` on a tensor: the same bytes."""
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    q = torch.zeros((B, L4), dtype=_I64, device=codes.device)
    q[:, :L] = codes
    q = q.view(B, L4 // 4, 4)
    return ((q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)) & 0xFF).to(_U8)


def keys_to_u32(keys) -> np.ndarray:
    """int32 keys (canon ^ 0x80000000) -> the uint32 k-mers, SENTINEL
    0xFFFFFFFF where there is none."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    return np.asarray(keys, np.int32).view(np.uint32) ^ np.uint32(KEY_BIAS)


# ------------------------------------------------------ canonical k-mer keys
def canonical_keys_reference(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                             mode: int = MODE_CODES) -> torch.Tensor:
    """Plain version of `canonical_keys`: shifted adds over the codes (for
    MODE_PACK_CODES the codes through `pack_codes_2bit` and back), the
    canonical form, SENTINEL_KEY where col >= length - k; flat (B * L,)
    int32."""
    L = codes.shape[1]
    if mode == MODE_PACK_CODES:
        codes = _unpack_codes_2bit(_pack_codes_torch(codes), L, device=codes.device)
    km = canonical(extract_kmers(codes, k, device=codes.device), k, device=codes.device)
    ok = kmer_valid(lengths, L, k, device=codes.device)
    return torch.where(ok, km - KEY_BIAS, SENTINEL_KEY).to(_I32).reshape(-1)


def canonical_keys(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                   mode: int = MODE_CODES) -> torch.Tensor:
    """The canonical k-mer key of every position of a (B, L) uint8 batch,
    flat (B * L,) int32: `canon ^ 0x80000000` where col < length - k, else
    SENTINEL_KEY.

    mode MODE_CODES: the codes as given (code 4 carries, as in
    `extract_kmers`; count_kmers and the frequency plane); MODE_PACK_CODES:
    each code read as `pack_codes_2bit` packs it (what count_kmers_stats
    counts).  The codes may lie at any byte offset (a view into a larger
    buffer).  CPU tensors take the plain version; CUDA tensors launch
    gb_kmer_canonical once on the current stream (16 positions a thread,
    the k-mer rolled along them; see csrc/kmer.cu)."""
    _check_k(k)
    if mode not in (MODE_CODES, MODE_PACK_CODES):
        raise ValueError(f"unknown mode {mode}")
    _check_codes(codes, lengths)
    if codes.device.type == "cpu":
        return canonical_keys_reference(codes, lengths, k, mode)
    B, L = codes.shape
    keys = torch.empty(B * L, dtype=_I32, device=codes.device)
    if keys.numel() == 0:
        return keys
    lib, stream = _launch(codes.device)
    rc = lib.gb_kmer_canonical(codes.data_ptr(), lengths.data_ptr(), B, L, k, mode,
                               keys.data_ptr(), stream)
    _raise_on(rc, "kmer canonical")
    canonical_keys.launches += 1
    return keys


canonical_keys.launches = 0     # kernel launches, counted where they happen


def _check_sorted_keys(s: torch.Tensor) -> None:
    if s.dtype != _I32 or s.dim() != 1 or not s.is_contiguous():
        raise TypeError(f"sorted keys must be a contiguous 1-D int32 tensor, got {s.dtype} "
                        f"{tuple(s.shape)}")


# ------------------------------------------------------------------ runs
def kmer_runs_reference(s: torch.Tensor) -> torch.Tensor:
    """Plain version of `kmer_runs`: torch.unique_consecutive over the
    valid keys; (2,) int64 [runs, valid keys]."""
    valid = s[s != SENTINEL_KEY]
    runs = torch.unique_consecutive(valid).numel()
    return torch.tensor([runs, valid.numel()], dtype=_I64, device=s.device)


def kmer_runs(s: torch.Tensor) -> torch.Tensor:
    """(2,) int64 [distinct valid keys, valid keys] of a sorted int32 key
    array: `count_kmers_stats`' (unique, total).  CPU tensors take the plain
    version; CUDA tensors launch gb_kmer_runs once."""
    _check_sorted_keys(s)
    if s.device.type == "cpu":
        return kmer_runs_reference(s)
    out = torch.zeros(2, dtype=_I64, device=s.device)
    if s.numel() == 0:
        return out
    lib, stream = _launch(s.device)
    _raise_on(lib.gb_kmer_runs(s.data_ptr(), s.numel(), out.data_ptr(), stream), "kmer runs")
    kmer_runs.launches += 1
    return out


kmer_runs.launches = 0


# ----------------------------------------------------------------- freqs
def kmer_freqs_reference(s: torch.Tensor, order: torch.Tensor):
    """Plain version of `kmer_freqs` (JAX's run bounds by cummax/cummin and
    the inverse permutation, ops/kmer.py:204-217)."""
    n = s.numel()
    idx = torch.arange(n, device=s.device)
    starts = torch.ones(n, dtype=torch.bool, device=s.device)
    starts[1:] = s[1:] != s[:-1]
    run_start = torch.cummax(torch.where(starts, idx, -1), 0).values
    nxt = torch.ones(n, dtype=torch.bool, device=s.device)
    nxt[:-1] = starts[1:]
    run_end = torch.cummin(torch.where(nxt, idx, n).flip(0), 0).values.flip(0)
    cnt = torch.where(s == SENTINEL_KEY, 0, run_end - run_start + 1)
    freq = torch.empty(n, dtype=_I64, device=s.device)
    freq[order] = cnt
    sat = torch.any(freq >= 0xFFFF).reshape(1).to(_I32)
    return freq.clamp(0, 0xFFFF).to(torch.uint16), sat


def kmer_freqs(s: torch.Tensor, order: torch.Tensor):
    """Each position's global frequency from the sorted keys `s` and the
    sort's permutation `order` (s[i] = keys[order[i]]): freq[order[i]] = the
    length of s[i]'s run, clipped to 0xFFFF, 0 at SENTINEL_KEY; (n,) uint16
    and a (1,) int32 flag, 1 when a count reached 0xFFFF.  CPU tensors take
    the plain version; CUDA tensors launch gb_kmer_freqs once."""
    _check_sorted_keys(s)
    if order.dtype != _I64 or order.shape != s.shape or not order.is_contiguous() \
            or order.device != s.device:
        raise TypeError("order must be a contiguous int64 tensor of the keys' shape and device")
    if s.device.type == "cpu":
        return kmer_freqs_reference(s, order)
    n = s.numel()
    freq = torch.empty(n, dtype=torch.uint16, device=s.device)
    sat = torch.zeros(1, dtype=_I32, device=s.device)
    if n == 0:
        return freq, sat
    lib, stream = _launch(s.device)
    _raise_on(lib.gb_kmer_freqs(s.data_ptr(), order.data_ptr(), n, freq.data_ptr(),
                                sat.data_ptr(), stream), "kmer freqs")
    kmer_freqs.launches += 1
    return freq, sat


kmer_freqs.launches = 0


# ------------------------------------------------------------- minimizers
def _hash_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 halves -> int64 whose signed order is the unsigned
    order of the 64-bit hash."""
    return (hi - KEY_BIAS) * (1 << 32) + lo


def minimizer_walk_reference(codes: torch.Tensor, lengths: torch.Tensor, k: int, window: int):
    """Plain version of `minimizer_walk`: the JAX package's collapsed scan
    (ops/kmer.py:304-388) as a Python loop over the columns.  The deque's
    state at step p is its front: q is a member iff h[q] <= min(h[q+1..p])
    within the window; the eviction-time tie-advance (kmer.h:244-247) makes
    the front path-dependent, so the loop carries it."""
    dev = codes.device
    B, L = codes.shape
    w = window
    raw = extract_kmers(codes, k, device=dev)
    ok = kmer_valid(lengths, L, k, device=dev)
    h = torch.where(ok, _hash_keys(*splitmix_hash(canonical(raw, k, device=dev), device=dev)),
                    _I64_MAX)
    hp = torch.cat([torch.full((B, w - 1), _I64_MAX, dtype=_I64, device=dev), h], 1)
    d_ids = torch.arange(w, device=dev)
    top = torch.full((B, 1), _I64_MAX, dtype=_I64, device=dev)
    live_to = lengths.to(_I64) - k
    front = torch.zeros(B, dtype=_I64, device=dev)
    last_emit = torch.full((B,), -1, dtype=_I64, device=dev)
    emits = torch.full((B, L), -1, dtype=_I64, device=dev)
    for p in range(L):
        hw = hp[:, p:p + w]                          # columns p-w+1 .. p
        q_pos = (p - w + 1) + d_ids
        # suffix minima over the later columns of the window
        suf = torch.cat([torch.cummin(hw.flip(1), 1).values.flip(1)[:, 1:], top], 1)
        member = (hw <= suf) & (q_pos >= 0)
        first_d = torch.where(member, d_ids, w).min(1).values
        min_h = hw.gather(1, first_d[:, None])
        tied = member & (hw == min_h)
        last_tied_d = torch.where(tied, d_ids, -1).max(1).values
        earliest = (p - w + 1) + first_d
        latest_tied = (p - w + 1) + last_tied_d
        evict = front <= p - w
        prev_alive = front >= earliest
        new = torch.where(evict, latest_tied, torch.where(prev_alive, front, earliest))
        if p < w:
            new = torch.minimum(new, earliest)
        live = p < live_to
        new = torch.where(live, new, front)
        emit = live & (new != last_emit)
        last_emit = torch.where(emit, new, last_emit)
        emits[:, p] = torch.where(emit, new, -1)
        front = new
    # position q is emitted iff a step p in q .. q+w-1 emitted it
    cols = torch.arange(L, device=dev)
    emitted = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for d in range(w):
        chooser = torch.roll(emits, -d, dims=1)
        emitted |= ((cols + d) < L) & (chooser == cols)
    return raw, emitted & ok


def minimizer_walk(codes: torch.Tensor, lengths: torch.Tensor, k: int, window: int):
    """yieldMinimizers over every read of a (B, L) uint8 batch: the raw
    k-mer plane (B, L) int64 (uint32 values, `extract_kmers`) and the
    emission mask (B, L) bool.  CPU tensors take the plain version; CUDA
    tensors launch gb_kmer_minimizers once (one block per read, the front's
    chain as a scan over segments of each tile; windows above
    MIN_SHARED_WINDOW keep the read's hashes in a device scratch)."""
    _check_k(k)
    _check_window(window)
    _check_codes(codes, lengths)
    if codes.device.type == "cpu":
        return minimizer_walk_reference(codes, lengths, k, window)
    B, L = codes.shape
    raw = torch.empty((B, L), dtype=_I64, device=codes.device)
    mask = torch.empty((B, L), dtype=torch.bool, device=codes.device)
    if raw.numel() == 0:
        return raw, mask
    scratch = None
    if window > MIN_SHARED_WINDOW:
        scratch = torch.empty((B, L), dtype=_I64, device=codes.device)
    lib, stream = _launch(codes.device)
    rc = lib.gb_kmer_minimizers(codes.data_ptr(), lengths.data_ptr(), B, L, k, window,
                                raw.data_ptr(), mask.data_ptr(),
                                None if scratch is None else scratch.data_ptr(), stream)
    _raise_on(rc, "kmer minimizers")
    minimizer_walk.launches += 1
    return raw, mask


minimizer_walk.launches = 0


# ------------------------------------------------------------------ sites
def _site_planes(raw: torch.Tensor, lengths: torch.Tensor, k: int):
    """(canonical rep, strand-adjusted in-read position) of every position
    (vertex_index.cpp:441-446: a flipped site's position is len - pos - k)."""
    rc = revcomp(raw, k, device=raw.device)
    flip = rc < raw
    cols = torch.arange(raw.shape[1], device=raw.device)
    pos = torch.where(flip, lengths.to(_I64)[:, None] - cols - k, cols)
    return torch.where(flip, rc, raw), pos


def minimizer_sites_reference(raw, mask, lengths, offsets, k: int):
    """Plain version of `minimizer_sites`, in row-major order."""
    canon, pos = _site_planes(raw, lengths, k)
    return canon[mask], (offsets[:, None] + pos)[mask]


def minimizer_sites(raw: torch.Tensor, mask: torch.Tensor, lengths: torch.Tensor,
                    offsets: torch.Tensor, k: int):
    """The minimizer sites of `minimizer_walk`'s (raw, mask), compacted:
    (canonical k-mers, global positions), two (n,) int64 tensors, gpos =
    offsets[read] + the strand-adjusted position.  CPU tensors take the
    plain version (row-major order); CUDA tensors launch gb_kmer_sites once,
    in no particular order (the caller sorts)."""
    _check_k(k)
    if raw.dtype != _I64 or mask.dtype != torch.bool or raw.shape != mask.shape \
            or raw.dim() != 2 or offsets.dtype != _I64 or offsets.shape != lengths.shape:
        raise TypeError("raw must be (B, L) int64, mask (B, L) bool and offsets (B,) int64")
    if not (raw.is_contiguous() and mask.is_contiguous() and offsets.is_contiguous()) \
            or len({raw.device, mask.device, offsets.device}) != 1:
        raise ValueError("raw, mask and offsets must be contiguous and on one device")
    _check_lengths(lengths, *raw.shape, raw.device)
    if raw.device.type == "cpu":
        return minimizer_sites_reference(raw, mask, lengths, offsets, k)
    B, L = raw.shape
    reps = torch.empty(B * L, dtype=_I64, device=raw.device)
    gpos = torch.empty(B * L, dtype=_I64, device=raw.device)
    count = torch.zeros(1, dtype=_I64, device=raw.device)
    if raw.numel() == 0:
        return reps, gpos
    lib, stream = _launch(raw.device)
    rc = lib.gb_kmer_sites(raw.data_ptr(), mask.data_ptr(), lengths.data_ptr(),
                           offsets.data_ptr(), B, L, k, reps.data_ptr(), gpos.data_ptr(),
                           count.data_ptr(), stream)
    _raise_on(rc, "kmer sites")
    minimizer_sites.launches += 1
    n = int(count)
    return reps[:n], gpos[:n]


minimizer_sites.launches = 0


# ------------------------------------------------------------- public API
def _upload(seq_codes, lengths, dev: torch.device):
    codes = torch.as_tensor(np.ascontiguousarray(seq_codes, np.uint8)).to(dev)
    lens = torch.as_tensor(np.ascontiguousarray(lengths, np.int32)).to(dev)
    return codes, lens


def _canonical_kmers(seq, lengths, *, k: int, device="cuda"):
    """(B, L) int32 keys of `canonical_keys` (MODE_CODES) and the (B, L)
    valid mask; `keys_to_u32` gives the JAX package's uint32 plane."""
    dev = resolve_device(device)
    codes, lens = _upload(seq, lengths, dev)
    keys = canonical_keys(codes, lens, k).view(codes.shape)
    return keys, keys != SENTINEL_KEY


def rle_counts(sorted_arr: np.ndarray):
    """Host run-length encode of a sorted uint32 array (SENTINEL =
    padding): (unique uint32, counts int64)."""
    n_valid = int(np.searchsorted(sorted_arr, np.uint32(SENTINEL)))
    s = sorted_arr[:n_valid]
    if len(s) == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.nonzero(s[1:] != s[:-1])[0] + 1])
    counts = np.diff(np.concatenate([starts, [len(s)]]))
    return s[starts], counts


def count_kmers(seq_codes: np.ndarray, lengths: np.ndarray, k: int, device="cuda"):
    """Count canonical k-mers over a batch of reads (forward strands only,
    KmerCounter::count semantics): the keys and their sort on the device,
    the run-length encode on the host as the JAX package does.  Returns
    (unique uint32, counts int64)."""
    dev = resolve_device(device)
    codes, lens = _upload(seq_codes, lengths, dev)
    s = torch.sort(canonical_keys(codes, lens, k)).values
    return rle_counts(keys_to_u32(s))


def count_kmers_stats(seq_codes: np.ndarray, lengths: np.ndarray, k: int, device="cuda",
                      stats=None):
    """(unique, total) canonical k-mer counts with two scalars leaving the
    device (kmer_cnt.cpp:243-248 prints exactly this).  The JAX package
    packs the codes on the host and unpacks them on the device; here the
    raw codes go up and gb_kmer_canonical reads each as its packed byte
    holds it (MODE_PACK_CODES), the same counts without the host pass.

    `stats`, if a dict, gets the seconds of each part ("upload",
    "canonical", "sort", "runs", "fetch"; each waits for the device)."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" and stats is not None \
        else (lambda: None)
    t0 = time.perf_counter()
    codes, lens = _upload(seq_codes, lengths, dev)
    sync()
    t1 = time.perf_counter()
    keys = canonical_keys(codes, lens, k, MODE_PACK_CODES)
    sync()
    t2 = time.perf_counter()
    s = torch.sort(keys).values
    del keys
    sync()
    t3 = time.perf_counter()
    out = kmer_runs(s)
    sync()
    t4 = time.perf_counter()
    u, t = out.tolist()
    if stats is not None:
        stats.update(upload=t1 - t0, canonical=t2 - t1, sort=t3 - t2, runs=t4 - t3,
                     fetch=time.perf_counter() - t4)
    return int(u), int(t)


def _per_position_freqs(seq, lengths, *, k: int, device="cuda"):
    """(B, L) uint16 plane: the global canonical-k-mer frequency of the
    k-mer at every iterated position (0 elsewhere), and whether any count
    reached 0xFFFF (the caller then counts by table).  One sort of the
    keys, then gb_kmer_freqs through the sort's permutation."""
    dev = resolve_device(device)
    codes, lens = _upload(seq, lengths, dev)
    s, order = torch.sort(canonical_keys(codes, lens, k))
    freq, sat = kmer_freqs(s, order)
    return freq.view(codes.shape), bool(sat.item())


def minimizer_mask(seq, lengths, *, k: int, window: int, device="cuda"):
    """Window minimizers of every read (yieldMinimizers, kmer.h:206-262):
    (raw k-mers (B, L) int64 holding uint32, emission mask (B, L) bool), on
    the device."""
    dev = resolve_device(device)
    codes, lens = _upload(seq, lengths, dev)
    return minimizer_walk(codes, lens, k, window)


@dataclasses.dataclass
class MinimizerIndex:
    """Per-kmer sorted global-position lists.

    kmers (U,) uint32 canonical reps, ascending; offsets (U+1,) int64 into
    positions; positions (P,) int64 sorted within each k-mer (the per-kmer
    sort at vertex_index.cpp:476-482); repetitive (R,) uint32 reps dropped
    by the frequency filter; mean_frequency as the reference logs it."""

    kmers: np.ndarray
    offsets: np.ndarray
    positions: np.ndarray
    repetitive: np.ndarray
    mean_frequency: float

    def lookup(self, rep: int) -> np.ndarray:
        i = np.searchsorted(self.kmers, np.uint32(rep))
        if i == len(self.kmers) or self.kmers[i] != np.uint32(rep):
            return np.zeros(0, np.int64)
        return self.positions[self.offsets[i]: self.offsets[i + 1]]


def _minimizer_sites_sorted(seq, lengths, *, k: int, window: int, device="cuda", stats=None):
    """The minimizer sites in (canonical rep, global position) order:
    (reps (n,) int64, gpos (n,) int64, n), the first n entries of the JAX
    package's padded arrays.  gpos = read offset (exclusive sum of the
    lengths) + the strand-adjusted position.  Two stable torch.sorts, by
    gpos and then by rep, are the lexsort.  `stats`, if a dict, gets the
    seconds of "upload", "walk", "sites", "sort" (each waits for the
    device) and "sites_n"."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" and stats is not None \
        else (lambda: None)
    t0 = time.perf_counter()
    lengths = np.asarray(lengths, np.int32)
    codes, lens = _upload(seq, lengths, dev)
    offs = torch.as_tensor(offsets_from_lengths(lengths)).to(dev)
    sync()
    t1 = time.perf_counter()
    raw, mask = minimizer_walk(codes, lens, k, window)
    sync()
    t2 = time.perf_counter()
    reps, gpos = minimizer_sites(raw, mask, lens, offs, k)
    del raw, mask
    sync()
    t3 = time.perf_counter()
    gpos, by_pos = torch.sort(gpos, stable=True)
    reps, by_rep = torch.sort(reps[by_pos], stable=True)
    gpos = gpos[by_rep]
    sync()
    if stats is not None:
        stats.update(upload=t1 - t0, walk=t2 - t1, sites=t3 - t2,
                     sort=time.perf_counter() - t3, sites_n=reps.numel())
    return reps, gpos, reps.numel()


def build_index_minimizers(seq_codes, lengths, *, k: int, window: int,
                           repeat_kmer_rate: float = 1.0, min_coverage: int = 1,
                           device="cuda", stats=None) -> MinimizerIndex:
    """Flye minimizer index (VertexIndex::buildIndexMinimizers,
    vertex_index.cpp:389-497, and filterFrequentKmers :173-212).

    One device walk extracting (canonical minimizer, strand-adjusted
    position) sites, one global sort -- which yields the per-kmer position
    lists already sorted -- and the JAX package's numpy frequency filter.
    Global positions are read_offset + in-read standard-strand position,
    read offsets = cumsum of read lengths.  `stats` as in
    `_minimizer_sites_sorted`, plus "fetch" and "host"."""
    seq_codes = np.asarray(seq_codes)
    lengths = np.asarray(lengths, np.int32)
    reps_t, gpos_t, n = _minimizer_sites_sorted(seq_codes, lengths, k=k, window=window,
                                                device=device, stats=stats)
    t0 = time.perf_counter()
    reps = reps_t.cpu().numpy().astype(np.uint32)
    gpos = gpos_t.cpu().numpy()
    t1 = time.perf_counter()
    # sorted-stream RLE (the stream is already in (kmer, gpos) order)
    if len(reps):
        starts = np.flatnonzero(np.concatenate([[True], reps[1:] != reps[:-1]]))
        uniq = reps[starts]
        counts = np.diff(starts, append=len(reps))
    else:
        uniq = np.zeros(0, reps.dtype)
        counts = np.zeros(0, np.int64)

    # filterFrequentKmers (vertex_index.cpp:173-212): mean over kmers with
    # capacity >= minCoverage, denominator +1; drop capacity > rate*mean.
    covered = counts >= min_coverage
    mean_freq = counts[covered].sum() / (covered.sum() + 1)
    threshold = repeat_kmer_rate * mean_freq
    repetitive = uniq[counts > threshold]
    keep = counts <= threshold
    # the kept groups' position runs, contiguous in the sorted stream: one
    # mask over the stream (the JAX package gathers them by offsets)
    positions = gpos[np.repeat(keep, counts)]
    offsets = offsets_from_lengths(counts[keep], with_total=True)
    if stats is not None:
        stats.update(fetch=t1 - t0, host=time.perf_counter() - t1)
    return MinimizerIndex(kmers=uniq[keep], offsets=offsets, positions=positions,
                          repetitive=repetitive, mean_frequency=float(mean_freq))


def yield_frequent_kmers(codes, length, k, global_freq_lookup, select_rate: float,
                         tandem_freq: int, freqs=None):
    """Per-read top-kmer selection (vertex_index.cpp:316-358), the JAX
    package's numpy (ops/kmer.py:548-592).

    Selection is the set {k-mers with global freq >= minFreq} where minFreq
    is the (maxKmers+1)-th largest per-occurrence freq, minus k-mers
    occurring more than tandem_freq times within the read.  Returns
    (positions, forward reps, canonical reps, freqs) in position order."""
    codes = np.asarray(codes[:length])
    n_km = length - k + 1
    if n_km <= 1:  # <=1: the final k-mer is excluded below anyway
        return (np.zeros(0, np.int64), np.zeros(0, np.uint32),
                np.zeros(0, np.uint32), np.zeros(0, np.int64))
    # Horner roll; the per-step mask replicates the reference's packing,
    # including how an ambiguous code (4) bleeds into the neighbouring group
    mask = np.uint32((1 << (2 * k)) - 1)
    acc = np.zeros(n_km, np.uint32)
    for j in range(k):
        acc = ((acc << np.uint32(2)) | codes[j:j + n_km].astype(np.uint32)) & mask
    # IterKmers excludes the read's final k-mer (kmer.h:193-198)
    fwd = acc[:-1]
    rc = _revcomp_np(fwd, k)
    canon = np.minimum(fwd, rc)
    if freqs is None:
        freqs = global_freq_lookup(canon)
    else:
        freqs = np.asarray(freqs[: len(fwd)], np.int64)
    order_desc = np.sort(freqs)[::-1]
    max_kmers = int(select_rate * len(freqs))
    min_freq = order_desc[min(max_kmers, len(freqs) - 1)]
    keep = freqs >= min_freq
    if tandem_freq > 0:
        uniq, counts = np.unique(canon, return_counts=True)
        local = counts[np.searchsorted(uniq, canon)]
        keep &= local <= tandem_freq
    pos = np.nonzero(keep)[0].astype(np.int64)
    return pos, fwd[keep], canon[keep], freqs[keep]


def build_index_uneven_coverage(seq_codes, lengths, *, k: int, global_min_freq: int = 2,
                                select_rate: float = 0.01, tandem_freq: int = 10,
                                repeat_kmer_rate: float = 1.0, device="cuda",
                                stats=None) -> MinimizerIndex:
    """Flye metagenome-mode index (vertex_index.cpp:25-125): per-read
    frequent-kmer selection against the global counter, capacity count,
    frequency filter (minCoverage = global_min_freq), position fill for
    k-mers with global_min_freq <= global freq <= repetitive threshold,
    per-kmer position sort.

    The per-position global frequencies come from one device sort and
    gb_kmer_freqs when every code is 0..3 and no count saturates; else, as
    in the JAX package, from `count_kmers` on the device and a per-read
    table lookup.  `stats`, if a dict, gets the seconds of "freqs" and
    "host" and which "route" ("plane" or "table") was taken."""
    dev = resolve_device(device)
    seq_codes = np.asarray(seq_codes)
    lengths = np.asarray(lengths, np.int64)
    t0 = time.perf_counter()
    freq_plane = None
    if seq_codes.size and seq_codes.max() <= 3:
        plane, sat = _per_position_freqs(seq_codes, lengths, k=k, device=dev)
        if not sat:
            freq_plane = plane.cpu().numpy()
    lookup = None
    if freq_plane is None:
        uniq_all, counts_all = count_kmers(seq_codes, lengths.astype(np.int32), k, device=dev)

        def lookup(reps):
            idx = np.searchsorted(uniq_all, reps)
            idx = np.clip(idx, 0, len(uniq_all) - 1)
            hit = uniq_all[idx] == reps
            return np.where(hit, counts_all[idx], 0).astype(np.int64)
    t1 = time.perf_counter()

    offs = offsets_from_lengths(lengths, with_total=True)
    reps_sel, gpos_sel, freq_sel = [], [], []
    for b in range(len(lengths)):
        pos, fwd, canon, freqs = yield_frequent_kmers(
            seq_codes[b], int(lengths[b]), k, lookup, select_rate, tandem_freq,
            freqs=None if freq_plane is None else freq_plane[b])
        ok = freqs >= global_min_freq
        pos, fwd, canon, freqs = pos[ok], fwd[ok], canon[ok], freqs[ok]
        flip = canon != fwd
        pos_std = np.where(flip, lengths[b] - pos - k, pos)
        reps_sel.append(canon)
        gpos_sel.append(offs[b] + pos_std)
        freq_sel.append(freqs)
    reps = np.concatenate(reps_sel) if reps_sel else np.zeros(0, np.uint32)
    gpos = np.concatenate(gpos_sel) if gpos_sel else np.zeros(0, np.int64)
    gfreq = np.concatenate(freq_sel) if freq_sel else np.zeros(0, np.int64)

    order = np.lexsort((gpos, reps))
    reps, gpos, gfreq = reps[order], gpos[order], gfreq[order]
    uniq, starts, caps = np.unique(reps, return_index=True, return_counts=True)

    covered = caps >= global_min_freq
    mean_freq = caps[covered].sum() / (covered.sum() + 1)
    threshold = repeat_kmer_rate * mean_freq
    repetitive = uniq[caps > threshold]
    # position fill also requires the GLOBAL freq <= threshold
    # (vertex_index.cpp:73-74) and index membership; the JAX package's
    # per-k-mer loop (ops/kmer.py:659-666) as one mask over the sorted stream
    keep = (caps <= threshold) & (gfreq[starts] <= threshold)
    positions = gpos[np.repeat(keep, caps)].astype(np.int64)
    offsets = offsets_from_lengths(caps[keep], with_total=True)
    if stats is not None:
        stats.update(freqs=t1 - t0, host=time.perf_counter() - t1,
                     route="plane" if freq_plane is not None else "table")
    return MinimizerIndex(kmers=uniq[keep].astype(np.uint32), offsets=offsets,
                          positions=positions, repetitive=repetitive,
                          mean_frequency=float(mean_freq))
