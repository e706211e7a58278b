"""Ultra-long-read banded global alignment on one card, in PyTorch.

The port of genomicsbench_tpu/ops/longread.py on one device.  The JAX
package's `sharded_banded_nw` (:83-154) keeps one read's banded DP on a
whole mesh, the band split across devices with a one-lane `ppermute` halo
and a cross-device prefix max each row.  `banded_nw` is that function at
D = 1: no halo, the left chain a cummax over the whole band.  On the card
the kernel recomputes the same recurrence in (target, query) coordinates,
as a pipeline of warps over stripes of query columns (csrc/longread.cu),
for any band width.  The multi-card form, with the halo exchange on
torch.distributed, waits for ROADMAP.md §1 item 5.

Semantics (the JAX package's): global Needleman-Wunsch with linear gaps,
int32; lane k of target row i holds query position j = i + k - W // 2; per
row the diagonal and up moves, then the left chain in closed form, max over
k' <= k of (B(k') + k' gap), minus k gap; NEG = -(1 << 30) marks cells
outside the band or the matrix, tested as `> NEG // 2`.

Device part: `longread_nw`, the hand-written kernel `gb_longread_nw` of
`csrc/longread.cu` on CUDA tensors and its plain PyTorch version,
`longread_nw_reference` (the JAX package's `step` with D = 1, one torch op
per array op, a Python loop over the rows), on CPU tensors.  Both give the
oracle's score exactly.

The inputs are int arrays and three ints, so nothing converts between the
packages.  Where the end cell lies outside the band the JAX package fails
an `assert` (:94); the port raises ValueError naming the band.  The kernel
also needs every in-band score above NEG / 2, where the JAX thresholds
hold, and int32 coordinates: it refuses reads and scores past those bounds
(`check_kernel_range`).
"""

from __future__ import annotations

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch._kernels import check_device as _check_device
from genomicsbench_tpu_torch._kernels import check_tensor as _check
from genomicsbench_tpu_torch._kernels import launch as _launch

NEG = -(1 << 30)
COORD_LIMIT = 1 << 30       # m + n + W: the kernel's int32 row and column arithmetic
# int32 operations per band cell of the recurrence at its best form, for the
# kernel's bound: the substitution (compare, select), the up move's
# subtraction, two add-and-max (DPX), the band test (subtract, compare) and
# its select
LONGREAD_OPS_PER_CELL = 8
_I32 = torch.int32


def _check_band(m: int, n: int, band: int) -> None:
    if not isinstance(band, (int, np.integer)) or band < 1:
        raise ValueError(f"band must be an integer of at least 1, got {band!r}")
    kend = m - n + band // 2
    if not 0 <= kend < band:
        raise ValueError(f"end cell outside the band: a query of {m} and a target of {n} "
                         f"end at lane {kend} of a band of W = {band} lanes")


def _check_inputs(query, target, band):
    for name, x in (("query", query), ("target", target)):
        _check(name, x, _I32, 1)
        if x.shape[0] >= 1 << 31:
            raise ValueError(f"{name} holds {x.shape[0]} bases: at most 2^31 - 1")
    _check_device(query.device, target)
    _check_band(query.shape[0], target.shape[0], band)


def check_kernel_range(m: int, n: int, band: int, match: int, mismatch: int, gap: int) -> None:
    """Refuse what gb_longread_nw cannot hold exactly: m + n + W at or past
    2^30 (its int32 coordinates), or scores that could bring an in-band cell
    to NEG / 2, where the JAX thresholds would drop a real cell (every
    in-band score is at least -(n + m) max(|s|, gap))."""
    if m + n + band >= COORD_LIMIT:
        raise ValueError(f"a query of {m}, a target of {n} and a band of {band} pass the "
                         f"kernel's int32 coordinates (m + n + W < 2^30)")
    worst = (m + n + band + 1) * max(abs(match), abs(mismatch), abs(gap))
    if worst >= -NEG // 2:
        raise ValueError(f"scores ({match}, {mismatch}, {gap}) over {m + n} bases could reach "
                         "NEG / 2, where the JAX thresholds drop real cells")


def longread_nw_reference(query: torch.Tensor, target: torch.Tensor, band: int, match: int = 1,
                          mismatch: int = -1, gap: int = 2) -> torch.Tensor:
    """The plain version of gb_longread_nw: the JAX package's `step` at
    D = 1, row by row.  Returns the score as a (1,) int32 tensor."""
    dev = query.device
    m, n, W = query.shape[0], target.shape[0], band
    W2 = W // 2
    k = torch.arange(W, dtype=_I32, device=dev)
    kgap = k * gap
    jk = k - W2
    neg = torch.tensor(NEG, dtype=_I32, device=dev)
    s_match = torch.tensor(match, dtype=_I32, device=dev)
    s_mismatch = torch.tensor(mismatch, dtype=_I32, device=dev)
    # the query padded so every row's window stays in range
    pad = W + n + 2
    qpad = torch.full((m + 2 * pad,), -1, dtype=_I32, device=dev)
    qpad[pad:pad + m] = query
    H = torch.where((jk >= 0) & (jk <= m), -gap * jk, neg)
    for i in range(1, n + 1):
        j = jk + i
        qrow = qpad[i - W2 - 1 + pad:i - W2 - 1 + pad + W]
        s = torch.where(qrow == target[i - 1], s_match, s_mismatch)
        diag = torch.where((j >= 1) & (H > NEG // 2), H + s, neg)
        up_src = torch.cat([H[1:], neg[None]])
        up = torch.where(up_src > NEG // 2, up_src - gap, neg)
        B = torch.maximum(diag, up)
        key = torch.where(B > NEG // 2, B + kgap, neg)
        pref = torch.cummax(key, 0).values
        left = torch.where(pref > NEG // 2, pref - kgap, neg)
        H = torch.where((j >= 0) & (j <= m), torch.maximum(B, left), neg)
    kend = m - n + W2
    return H[kend:kend + 1].clone()


def longread_nw(query: torch.Tensor, target: torch.Tensor, band: int, match: int = 1,
                mismatch: int = -1, gap: int = 2) -> torch.Tensor:
    """The banded NW score of query (m,) against target (n,), int32 codes,
    in a band of `band` lanes, as a (1,) int32 tensor on their device.
    Checks its inputs on the host before any build or launch (an end cell
    outside the band is a ValueError); CPU tensors take the plain version,
    CUDA tensors one launch on the current stream, without synchronising
    (after `check_kernel_range`)."""
    _check_inputs(query, target, band)
    if query.device.type == "cpu":
        return longread_nw_reference(query, target, band, match, mismatch, gap)
    m, n = query.shape[0], target.shape[0]
    check_kernel_range(m, n, band, match, mismatch, gap)
    out = torch.empty(1, dtype=_I32, device=query.device)
    # the stripe counter, then one (value, tag) hand-off word per target row
    scratch = torch.zeros(n + 2, dtype=torch.int64, device=query.device)
    _launch(query.device, "gb_longread_nw", query.data_ptr(), target.data_ptr(), m, n, band,
            match, mismatch, gap, scratch.data_ptr(), out.data_ptr())
    longread_nw.launches += 1
    return out


longread_nw.launches = 0        # kernel launches, counted where they happen


def banded_nw(query, target, band: int, match: int = 1, mismatch: int = -1, gap: int = 2,
              device="cuda") -> int:
    """The banded global NW score of one read: the one-card form of the JAX
    package's `sharded_banded_nw` (genomicsbench_tpu/ops/longread.py:83),
    whose multi-card halo exchange waits for ROADMAP.md §1 item 5.  query
    and target are integer code arrays; on `cuda` (the default) one kernel
    launch, on `cpu` the plain version.  Raises ValueError where the end
    cell lies outside the band."""
    dev = resolve_device(device)
    qt, tt = (torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
              for a in (query, target))
    return int(longread_nw(qt, tt, band, match, mismatch, gap).item())
