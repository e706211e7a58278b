"""Batch data parallelism over the mesh's "data" axis for the kernels (the
port of genomicsbench_tpu/parallel/data_parallel.py).

Each wrapper pads the batch to a multiple of the axis by JAX's rule for it,
each rank runs the port's one-card entry point on its contiguous block of
rows (on the mesh's device: the hand-written kernels on a cuda mesh, their
plain versions on a cpu one), and one gather per output merges the blocks
in rank order (`mesh.gather_rows`).  Every rank returns the full result,
equal to the one-card entry point's on the whole batch: the kernels are
per row, so no collective runs inside them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from genomicsbench_tpu_torch.parallel.mesh import Mesh, gather_rows, row_bounds


def _pad_rows(n_dev: int, *arrays):
    """Pad the leading dim of every array to a multiple of n_dev by
    repeating row 0 (the padding rows are dropped by the caller)."""
    b = len(arrays[0])
    bp = -(-b // n_dev) * n_dev
    if bp == b:
        return b, arrays
    return b, tuple(np.concatenate([a, np.repeat(a[:1], bp - b, axis=0)]) for a in arrays)


def banded_sw_sharded(mesh: Mesh, query, target, qlen, tlen, h0, params=None):
    """Banded SW (csrc/bsw.cu on a cuda mesh) over the "data" axis; the
    results of ops.bsw.banded_sw_batch."""
    from genomicsbench_tpu_torch.config import BswParams
    from genomicsbench_tpu_torch.ops.bsw import BswBatchResult, banded_sw_batch

    params = params or BswParams()
    b, (query, target, qlen, tlen, h0) = _pad_rows(
        mesh.data, np.asarray(query), np.asarray(target), np.asarray(qlen, np.int32),
        np.asarray(tlen, np.int32), np.asarray(h0, np.int32))
    lo, hi = row_bounds(mesh, len(qlen))
    part = banded_sw_batch(query[lo:hi], target[lo:hi], qlen[lo:hi], tlen[lo:hi],
                           h0[lo:hi], params, device=mesh.device)
    rows = np.stack([part.score, part.qle, part.tle, part.gtle, part.gscore, part.max_off], 1)
    got = gather_rows(mesh, torch.from_numpy(np.ascontiguousarray(rows, np.int32)))
    return BswBatchResult(*got.cpu().numpy()[:b].T.copy())


def pairhmm_sharded(mesh: Mesh, reads, haps, pairs=None):
    """The pair-HMM over (read, hap) pairs sharded over "data"; the results
    of ops.pairhmm.pairhmm_batch, its float64 pass over the pairs whose
    float32 result underflows included (on the card on a cuda mesh)."""
    from genomicsbench_tpu_torch.ops.pairhmm import pairhmm_batch

    if pairs is None:
        pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    if len(pairs) == 0:
        return np.zeros(0, np.float64)
    b, (padded,) = _pad_rows(mesh.data, np.asarray(pairs, np.int64).reshape(-1, 2))
    lo, hi = row_bounds(mesh, len(padded))
    part = pairhmm_batch(reads, haps, [tuple(p) for p in padded[lo:hi].tolist()],
                         device=mesh.device)
    return gather_rows(mesh, torch.from_numpy(part)).cpu().numpy()[:b]


def chain_sharded(mesh: Mesh, calls, **kwargs):
    """Chaining over independent reads, one read's anchors a row sharded
    over "data" (the last call repeated to pad, as JAX pads); the results
    of ops.chain.chain_batch."""
    from genomicsbench_tpu_torch.ops import chain as ch

    n = len(calls)
    full = list(calls) + [calls[-1]] * ((-n) % mesh.data) if n else []
    out = ch.chain_batch(full, mesh=mesh, **kwargs)
    return ch.ChainBatchResult(scores=out.scores[:n], parents=out.parents[:n],
                               peak_scores=out.peak_scores[:n], n=out.n[:n])


def abea_sharded(mesh: Mesh, sequences, event_means, model_mean, model_stdv, scalings):
    """ABEA with the reads sharded over "data" and the pore model on every
    rank (the last read repeated to pad, as JAX pads); the results of
    ops.abea.align_batch."""
    from genomicsbench_tpu_torch.ops import abea as ab

    B = len(sequences)
    scalings = np.asarray(scalings, np.float32).reshape(B, 2)
    pad = (-B) % mesh.data
    if pad:
        sequences = list(sequences) + [sequences[-1]] * pad
        event_means = list(event_means) + [event_means[-1]] * pad
        scalings = np.concatenate([scalings, np.repeat(scalings[-1:], pad, 0)])
    res = ab.align_batch(sequences, event_means, model_mean, model_stdv, scalings, mesh=mesh)
    return ab.AbeaResult(pairs=res.pairs[:B], failed=res.failed[:B])


def pileup_hist_sharded(mesh: Mesh, keys, size: int):
    """The pileup feature histogram with its flat keys (column * plane +
    feature) sharded over "data": each rank scatter-adds its keys into a
    (size + 1,) int32 plane and one all_reduce sums the planes, exact since
    integer adds commute.  The padding keys go to the drop bin `size`, as
    JAX pads.  Keys outside [0, size) raise ValueError (JAX's scatter drops
    them).  Returns (size,) int32 counts."""
    keys = np.asarray(keys, np.int64).reshape(-1)
    if len(keys) and (int(keys.min()) < 0 or int(keys.max()) >= size):
        raise ValueError(f"pileup keys must lie in [0, {size}), got "
                         f"[{int(keys.min())}, {int(keys.max())}]")
    buf = np.concatenate([keys, np.full((-len(keys)) % mesh.data, size, np.int64)])
    lo, hi = row_bounds(mesh, len(buf))
    k = torch.from_numpy(buf[lo:hi]).to(mesh.device)
    hist = torch.zeros(size + 1, dtype=torch.int32, device=mesh.device)
    hist.index_add_(0, k, torch.ones(len(k), dtype=torch.int32, device=mesh.device))
    dist.all_reduce(hist, group=mesh.data_group)
    return hist[:size].cpu().numpy()


def fmi_sharded(mesh: Mesh, index, query, qlen, **pipe_kwargs):
    """SMEM seeding with the read batch sharded over "data" and the FMD
    index on every rank (zero-length queries pad the batch, as JAX pads);
    the SMEMs of a one-card FmiPipeline.run, in its order."""
    from genomicsbench_tpu_torch.ops.fmi import FmiPipeline, _mk_smem

    query = np.asarray(query)
    qlen = np.asarray(qlen, np.int32)
    B = len(query)
    pad = (-B) % mesh.data
    if pad:
        query = np.concatenate([query, np.zeros((pad, query.shape[1]), query.dtype)])
        qlen = np.concatenate([qlen, np.zeros(pad, qlen.dtype)])
    p1, p2, p3, _ = FmiPipeline(index, mesh=mesh, **pipe_kwargs).run(query, qlen)

    def trim(r):
        keep = r.rid < B
        return _mk_smem(r.rid[keep], r.m[keep], r.n[keep], r.k[keep], r.s[keep])

    p1, p2, p3 = trim(p1), trim(p2), trim(p3)
    return p1, p2, p3, p1.count + p2.count + p3.count
