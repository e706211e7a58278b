"""chain anchor-call text format (the port's own copy of
genomicsbench_tpu/io/anchors.py).

Reference format (benchmarks/chain/src/host_data_io.cpp:13-50): whitespace-
separated records
    n avg_qspan max_dist_x max_dist_y bw n_segs
    x y            (n times, uint64 each)
    EOR
Output format (print_return, :53-60): "n", then "score\tparent" per anchor,
then "EOR".
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AnchorCall:
    x: np.ndarray        # (n,) uint64
    y: np.ndarray        # (n,) uint64
    avg_qspan: float
    max_dist_x: int
    max_dist_y: int
    bw: int
    n_segs: int

    @property
    def n(self) -> int:
        return len(self.x)


def anchor_calls_from_dicts(dicts) -> list[AnchorCall]:
    """The port's AnchorCalls from `dataclasses.asdict` of the JAX package's
    (same field names; x and y as uint64 arrays; an unknown field raises
    TypeError)."""
    out = []
    for d in dicts:
        d = dict(d)
        d["x"] = np.asarray(d["x"], dtype=np.uint64).copy()
        d["y"] = np.asarray(d["y"], dtype=np.uint64).copy()
        out.append(AnchorCall(**d))
    return out


def load_anchor_calls(path: str) -> list[AnchorCall]:
    calls = []
    with open(path) as f:
        toks = f.read().split()
    pos = 0
    while pos + 6 <= len(toks):
        n = int(toks[pos])
        avg_qspan = float(toks[pos + 1])
        mdx, mdy, bw, n_segs = (int(t) for t in toks[pos + 2 : pos + 6])
        pos += 6
        xy = np.array(toks[pos : pos + 2 * n], dtype=np.uint64).reshape(n, 2)
        pos += 2 * n
        if pos < len(toks) and toks[pos] == "EOR":
            pos += 1
        calls.append(
            AnchorCall(
                x=xy[:, 0].copy(),
                y=xy[:, 1].copy(),
                avg_qspan=avg_qspan,
                max_dist_x=mdx,
                max_dist_y=mdy,
                bw=bw,
                n_segs=n_segs,
            )
        )
    return calls


def write_anchor_calls(path: str, calls: list[AnchorCall]) -> None:
    with open(path, "w") as f:
        for c in calls:
            f.write(f"{c.n} {c.avg_qspan} {c.max_dist_x} {c.max_dist_y} {c.bw} {c.n_segs}\n")
            for x, y in zip(c.x, c.y):
                f.write(f"{int(x)} {int(y)}\n")
            f.write("EOR\n")


def write_returns(path: str, results) -> None:
    """Write scores/parents in the reference output format (print_return)."""
    with open(path, "w") as f:
        for r in results:
            f.write(f"{len(r.scores)}\n")
            for s, p in zip(r.scores, r.parents):
                f.write(f"{int(s)}\t{int(p)}\n")
            f.write("EOR\n")
