"""Distributed canonical k-mer counting: a key-range exchange by
all_to_all (the port of genomicsbench_tpu/parallel/sharded_count.py).

Each rank of the mesh's axis:
  1. computes the canonical keys of its block of reads with the
     `canonical_keys` kernel (its plain version on a cpu mesh),
  2. gives each key the destination rank `key >> shift` (the keys' top
     bits) and sorts the destinations stably with torch.sort,
  3. packs one bucket of `cap` keys per destination, SENTINEL-padded,
     after checking every rank's fullest bucket against `cap`,
  4. exchanges the buckets with one all_to_all_single,
  5. sorts what it received and run-length-encodes it on the host.
The ranks' key ranges are disjoint and ordered, so their (unique, counts)
concatenated in rank order are the global result: a last gather hands it
to every rank.  Deterministic, and equal to ops.kmer.count_kmers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from genomicsbench_tpu_torch.ops.kmer import (KEY_BIAS, SENTINEL_KEY, _upload, canonical_keys,
                                              keys_to_u32, rle_counts)
from genomicsbench_tpu_torch.parallel.mesh import Mesh, gather_rows, row_bounds


def sharded_count_kmers(mesh: Mesh, seq_codes: np.ndarray, lengths: np.ndarray, k: int,
                        axis: str = "data", capacity_factor: float = 2.0,
                        replicate_out: bool = False):
    """Count canonical k-mers with the reads sharded over `axis`: (unique
    uint32, counts int64) of the whole batch, on every rank.

    A multi-process mesh has no single controller to hand back a sharded
    result to, so every rank returns the full result whatever
    `replicate_out` says (JAX keeps the sharded output where it is False;
    the argument stays for the same call).  The batch is padded to a
    multiple of the axis with reads of length 0, which give no k-mer (JAX
    asserts that B divides).  Each rank sends at most cap =
    ceil(capacity_factor * rows * L / axis / 128) * 128 keys to each
    destination; a fuller bucket on any rank raises ValueError on every
    rank, before the exchange (JAX asserts after it).  Keys whose top bits
    pass the last rank (an axis size that is no power of two) go to the
    last rank, where JAX's buckets would drop them."""
    n_dev, group = mesh.size(axis), mesh.group(axis)
    seq = np.asarray(seq_codes, np.uint8)
    lens = np.asarray(lengths, np.int32)
    B, L = seq.shape
    pad = (-B) % n_dev
    if pad:
        seq = np.concatenate([seq, np.zeros((pad, L), np.uint8)])
        lens = np.concatenate([lens, np.zeros(pad, np.int32)])
    n_local = (len(seq) // n_dev) * L
    cap = int(capacity_factor * n_local / n_dev)
    cap = -(-cap // 128) * 128
    shift = 2 * k - max(1, (n_dev - 1).bit_length()) if n_dev > 1 else 2 * k
    lo, hi = row_bounds(mesh, len(seq), axis)
    codes, ln = _upload(seq[lo:hi], lens[lo:hi], mesh.device)
    keys = canonical_keys(codes, ln, k)                      # int32, canon - 2^31
    valid = keys != SENTINEL_KEY
    dest = torch.where(valid, ((keys.long() + KEY_BIAS) >> shift).clamp(max=n_dev - 1), n_dev)
    dest, order = torch.sort(dest, stable=True)
    fill = torch.bincount(dest, minlength=n_dev + 1)[:n_dev]
    worst = fill.max().reshape(1)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
    if int(worst) > cap:
        raise ValueError(f"k-mer bucket overflow: {int(worst)} keys for one rank > capacity "
                         f"{cap}; raise capacity_factor (now {capacity_factor})")
    starts = torch.cumsum(fill, 0) - fill
    sent = dest < n_dev
    d = dest[sent]
    slot = torch.arange(len(d), device=d.device) - starts[d]
    send = torch.full((n_dev, cap), SENTINEL_KEY, dtype=torch.int32, device=mesh.device)
    send[d, slot] = keys[order[sent]]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    local = torch.sort(recv.reshape(-1)).values
    u, c = rle_counts(keys_to_u32(local.cpu().numpy()))
    table = torch.from_numpy(np.stack([u.astype(np.int64), c], 1))
    got = gather_rows(mesh, table, axis).cpu().numpy()
    return got[:, 0].astype(np.uint32), got[:, 1].astype(np.int64)
