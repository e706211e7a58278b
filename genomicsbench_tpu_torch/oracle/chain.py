"""Scalar oracle for minimap2 anchor chaining DP (the port's own copy of
genomicsbench_tpu/oracle/chain.py).

Semantics follow the reference kernel (benchmarks/chain/src/host_kernel.cpp:
30-94, chain_dp): for each anchor i, scan predecessors j downward from a
sliding window start (bounded by max_dist_x and max_iter=5000), score
candidate chains with the concave gap cost 0.01*avg_qspan*dd + ilog2(dd)/2,
and apply the max_skip=25 early-break heuristic driven by the `targets`
array.  Outputs per anchor: best chain score, parent index, peak score.

Anchor encoding is minimap2's: x = (rid<<32 | ref_pos); y carries query pos
(low 32 bits), span (bits 32..39) and segment id (bits 48..55).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

MM_SEED_SEG_SHIFT = 48
MM_SEED_SEG_MASK = 0xFF << MM_SEED_SEG_SHIFT


def ilog2_32(v: int) -> int:
    """floor(log2(v)) for v >= 1; -1 for v == 0 (LogTable256 semantics)."""
    if v == 0:
        return -1
    return int(v).bit_length() - 1


@dataclasses.dataclass
class ChainResult:
    scores: np.ndarray
    parents: np.ndarray
    targets: np.ndarray
    peak_scores: np.ndarray


def chain_dp_oracle(
    x: np.ndarray,
    y: np.ndarray,
    *,
    avg_qspan: float,
    max_dist_x: int,
    max_dist_y: int,
    bw: int,
    n_segs: int = 1,
    max_iter: int = 5000,
    max_skip: int = 25,
    gap_scale: float = 1.0,
    is_cdna: bool = False,
) -> ChainResult:
    n = len(x)
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)
    scores = np.zeros(n, dtype=np.int32)
    parents = np.full(n, -1, dtype=np.int64)
    targets = np.zeros(n, dtype=np.int32)
    peak = np.zeros(n, dtype=np.int32)

    qpos = y.astype(np.int64) & 0xFFFFFFFF
    qpos = qpos.astype(np.int32)                      # int32 truncation of y
    span = ((y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    sid = ((y & np.uint64(MM_SEED_SEG_MASK)) >> np.uint64(MM_SEED_SEG_SHIFT)).astype(
        np.int32
    )
    xs = x.astype(np.int64)  # ref positions fit comfortably in int64

    st = 0
    for i in range(n):
        ri = xs[i]
        qi = int(qpos[i])
        q_span = int(span[i])
        sidi = int(sid[i])
        max_f = q_span
        max_j = -1
        n_skip = 0

        while st < i and ri > xs[st] + max_dist_x:
            st += 1
        if i - st > max_iter:
            st = i - max_iter

        for j in range(i - 1, st - 1, -1):
            dr = int(ri - xs[j])
            dq = qi - int(qpos[j])
            sidj = int(sid[j])
            if (sidi == sidj and dr == 0) or dq <= 0:
                continue
            if (sidi == sidj and dq > max_dist_y) or dq > max_dist_x:
                continue
            dd = dr - dq if dr > dq else dq - dr
            if sidi == sidj and dd > bw:
                continue
            if n_segs > 1 and not is_cdna and sidi == sidj and dr > max_dist_y:
                continue
            min_d = dq if dq < dr else dr
            sc = q_span if min_d > q_span else min_d
            log_dd = ilog2_32(dd) if dd else 0
            if is_cdna or sidi != sidj:
                c_lin = int(dd * 0.01 * avg_qspan)
                c_log = log_dd
                if sidi != sidj and dr == 0:
                    sc += 1
                    gap_cost = 0
                elif dr > dq or sidi != sidj:
                    gap_cost = min(c_lin, c_log)
                else:
                    gap_cost = c_lin + (c_log >> 1)
            else:
                gap_cost = int(dd * 0.01 * avg_qspan) + (log_dd >> 1)
            sc -= int(gap_cost * gap_scale + 0.499)
            sc += int(scores[j])
            if sc > max_f:
                max_f = sc
                max_j = j
                if n_skip > 0:
                    n_skip -= 1
            elif targets[j] == i:
                n_skip += 1
                if n_skip > max_skip:
                    break
            if parents[j] >= 0:
                targets[parents[j]] = i

        scores[i] = max_f
        parents[i] = max_j
        peak[i] = (
            peak[max_j] if (max_j >= 0 and peak[max_j] > max_f) else max_f
        )

    return ChainResult(scores=scores, parents=parents, targets=targets, peak_scores=peak)


def make_anchors(
    ref_pos: Sequence[int],
    query_pos: Sequence[int],
    span: Sequence[int] | int,
    seg_id: Sequence[int] | int = 0,
    rid: int = 0,
):
    """Pack (ref_pos, query_pos, span, seg) into minimap2 x/y uint64 words."""
    n = len(ref_pos)
    span = np.broadcast_to(np.asarray(span, dtype=np.uint64), (n,))
    seg_id = np.broadcast_to(np.asarray(seg_id, dtype=np.uint64), (n,))
    x = (np.uint64(rid) << np.uint64(32)) | np.asarray(ref_pos, dtype=np.uint64)
    y = (
        (seg_id << np.uint64(MM_SEED_SEG_SHIFT))
        | (span << np.uint64(32))
        | np.asarray(query_pos, dtype=np.uint64)
    )
    return x, y
