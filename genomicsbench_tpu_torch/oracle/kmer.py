"""NumPy oracles of Flye's k-mer counting and minimizers (kmer-cnt).

`yield_minimizers_oracle` is the port's copy of the JAX package's
transliteration of yieldMinimizers (genomicsbench_tpu/ops/kmer.py:235-289,
kmer.h:206-262).  `count_kmers_oracle` counts canonical k-mers by a Horner
roll and `np.unique`, with tests/test_kmer.py:15-33's semantics: the read's
final k-mer is not counted (IterKmers' end is exclusive, kmer.h:193-198).
Both roll a code into the k-mer with `(rep << 2 | c) & mask`, as the
reference does; on codes 0..3 that equals the JAX package's shifted adds.
"""

from __future__ import annotations

import collections

import numpy as np

_U64 = 0xFFFFFFFFFFFFFFFF
_ROWS_PER_CHUNK = 1024     # reads per Horner pass: about 40 MB of uint32 at 10 kb


def splitmix64(v: int) -> int:
    """Kmer::hash (kmer.h:91-98) of one representation, in Python ints."""
    z = (v + 0x9E3779B97F4A7C15) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def revcomp_np(repr32, k: int):
    """Reverse complement of 2-bit packed k-mers held in uint32 (the bit
    butterfly of the JAX package's `_revcomp_np`, ops/kmer.py:138-149)."""
    x = (~np.asarray(repr32, np.uint32)) & np.uint32((1 << (2 * k)) - 1)
    x = ((x & np.uint32(0x33333333)) << np.uint32(2)) \
        | ((x & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    x = ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4)) \
        | ((x & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    x = ((x & np.uint32(0x00FF00FF)) << np.uint32(8)) \
        | ((x & np.uint32(0xFF00FF00)) >> np.uint32(8))
    x = (x << np.uint32(16)) | (x >> np.uint32(16))
    return x >> np.uint32(32 - 2 * k)


def yield_minimizers_oracle(codes: np.ndarray, k: int, window: int):
    """Exact transliteration of yieldMinimizers (kmer.h:206-262): monotone
    deque over (kmer, hash), pop-front alignment and tie advancing, dedup by
    emitted position.  Returns list of (position, canonical_repr)."""
    n = len(codes)
    if n < k:
        return []
    mask = (1 << (2 * k)) - 1
    rep = 0
    for i in range(k):
        rep = ((rep << 2) | int(codes[i])) & mask
    reps = [rep]
    for i in range(k, n):
        rep = ((rep << 2) | int(codes[i])) & mask
        reps.append(rep)
    # IterKmers::end() is `length - k` exclusive (kmer.h:193-198): the
    # reference never yields the final k-mer of a read
    reps = reps[:-1]
    if not reps:
        return []

    def rc(v):
        out = 0
        for _ in range(k):
            out = (out << 2) | ((~v) & 3)
            v >>= 2
        return out

    out = []
    if window == 1:
        return [(p, r) for p, r in enumerate(reps)]
    q = collections.deque()
    for pos, r in enumerate(reps):
        hh = splitmix64(min(r, rc(r)))
        while q and q[-1][2] > hh:
            q.pop()
        q.append((pos, r, hh))
        if q[0][0] <= pos - window:
            while q[0][0] <= pos - window:
                q.popleft()
            while len(q) >= 2 and q[0][2] == q[1][2]:
                q.popleft()
        if not out or out[-1][0] != q[0][0]:
            out.append((q[0][0], q[0][1]))
    return out


def canonical_kmers_oracle(codes: np.ndarray, lengths, k: int):
    """Every counted canonical k-mer of a (B, L) code batch, read by read in
    position order, as one uint32 array: a Horner roll of the codes, the
    final k-mer of each read left out."""
    codes = np.asarray(codes)
    lengths = np.asarray(lengths, np.int64)
    B, L = codes.shape
    n_pos = L - k + 1
    n_valid = np.clip(lengths - k, 0, None)
    out = np.empty(int(n_valid.sum()), np.uint32)
    if n_pos <= 0 or len(out) == 0:
        return out
    mask = np.uint32((1 << (2 * k)) - 1)
    at = 0
    for r0 in range(0, B, _ROWS_PER_CHUNK):
        c = codes[r0:r0 + _ROWS_PER_CHUNK].astype(np.uint32)
        acc = np.zeros((len(c), n_pos), np.uint32)
        for j in range(k):
            acc = ((acc << np.uint32(2)) | c[:, j:j + n_pos]) & mask
        acc = np.minimum(acc, revcomp_np(acc, k))
        keep = np.arange(n_pos)[None, :] < n_valid[r0:r0 + _ROWS_PER_CHUNK, None]
        sel = acc[keep]
        out[at:at + len(sel)] = sel
        at += len(sel)
    return out


def count_kmers_oracle(codes: np.ndarray, lengths, k: int):
    """(unique canonical k-mers ascending as uint32, their counts as int64)
    over a (B, L) code batch: KmerCounter::count's final totals."""
    uniq, counts = np.unique(canonical_kmers_oracle(codes, lengths, k), return_counts=True)
    return uniq.astype(np.uint32), counts.astype(np.int64)
