"""phmm testfile format (a copy of genomicsbench_tpu/io/phmm_text.py).

Reference format (benchmarks/phmm/PairHMMUnitTest.cpp:95-140, read_batch):
whitespace-separated batches of
    num_reads num_haps
    per read: bases q i d c      (five strings; quals are Phred+33 chars)
    per hap:  bases
Quality strings are normalized by subtracting 33, with a floor of 6 applied
to the base-quality string q only (normalize(q, 6), :110).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from genomicsbench_tpu_torch.oracle.pairhmm import encode_bases


@dataclasses.dataclass
class PhmmRead:
    bases: np.ndarray  # uint8 codes 0..4
    q: np.ndarray      # int32 quals
    i: np.ndarray
    d: np.ndarray
    c: np.ndarray


@dataclasses.dataclass
class PhmmBatch:
    reads: list
    haps: list  # list of uint8 code arrays

    @property
    def num_testcases(self) -> int:
        return len(self.reads) * len(self.haps)

    def testcases(self):
        """Yield (read, hap) pairs in the reference's read-major order
        (PairHMMUnitTest.cpp:232-244)."""
        for r in self.reads:
            for h in self.haps:
                yield r, h


def phmm_batches_from_dicts(dicts) -> list[PhmmBatch]:
    """The port's PhmmBatches from `dataclasses.asdict` of the JAX package's
    (reads as dicts of bases/q/i/d/c, haps as arrays; an unknown field
    raises TypeError)."""
    out = []
    for d in dicts:
        d = dict(d)
        d["reads"] = [PhmmRead(**{k: np.asarray(v).copy() for k, v in r.items()})
                      for r in d["reads"]]
        d["haps"] = [np.asarray(h, np.uint8).copy() for h in d["haps"]]
        out.append(PhmmBatch(**d))
    return out


def _norm_qual(s: str, min_value: int = 0) -> np.ndarray:
    q = np.frombuffer(s.encode(), dtype=np.uint8).astype(np.int32) - 33
    return np.maximum(q, min_value)


def load_phmm_testfile(path: str) -> list[PhmmBatch]:
    with open(path) as f:
        toks = f.read().split()
    batches = []
    pos = 0
    while pos + 2 <= len(toks):
        nr, nh = int(toks[pos]), int(toks[pos + 1])
        pos += 2
        reads = []
        for _ in range(nr):
            bases, q, i, d, c = toks[pos : pos + 5]
            pos += 5
            reads.append(
                PhmmRead(
                    bases=encode_bases(bases),
                    q=_norm_qual(q, 6),
                    i=_norm_qual(i),
                    d=_norm_qual(d),
                    c=_norm_qual(c),
                )
            )
        haps = [encode_bases(toks[pos + k]) for k in range(nh)]
        pos += nh
        batches.append(PhmmBatch(reads=reads, haps=haps))
    return batches


_CODE_TO_BASE = "ACTGN"


def write_phmm_testfile(path: str, batches: list[PhmmBatch]) -> None:
    def qstr(q):
        return "".join(chr(int(v) + 33) for v in q)

    with open(path, "w") as f:
        for b in batches:
            f.write(f"{len(b.reads)} {len(b.haps)}\n")
            for r in b.reads:
                bases = "".join(_CODE_TO_BASE[v] for v in r.bases)
                f.write(f"{bases} {qstr(r.q)} {qstr(r.i)} {qstr(r.d)} {qstr(r.c)}\n")
            for h in b.haps:
                f.write("".join(_CODE_TO_BASE[v] for v in h) + "\n")
