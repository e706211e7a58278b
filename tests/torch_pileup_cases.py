"""Inputs of the pileup tests and of chip_smoke.py's pileup phases, made
with the port's BAM writer; this file imports neither JAX nor the JAX
package.

* `edge_sets()`: tests/test_pileup.py's record sets (hand-built CIGARs:
  matches on both strands, insertions, a deletion, an insertion after a
  deletion, a mapq-0 read and a gap, an ambiguous base, quality strata)
  with their regions;
* `random_records(seed)`: random CIGARs with S, H, M, I, D, N, =, X and P,
  reverse strands, ambiguity codes, mapq 0 and the five filtered flags;
* `weibull_records(seed)`: reads with medaka's WL/WK float tags (some
  missing or short);
* `bench_pileup_records(region)`: tools/scale_bench.py bench_pileup's
  workload (:561-590, seed 8): 150-base reads at 30x, every 7th read
  60M 2I 40M 3D 48M, odd reads reversed, mapq 50, quality 30;
* `mixed_records(region, coverage, seed)`: reads sliced from a random
  reference with substitutions, indels and random qualities (the CLI's
  inputs, which dbg reads too);
* `write_indexed(path, records, ref_len)`: a sorted BAM and its .bai.
"""

from __future__ import annotations

import numpy as np

from genomicsbench_tpu_torch.io import bam as B


def mk_rec(name, pos, cigar, seq, flag=0, mapq=60, qual=None):
    seq = np.array(seq, np.uint8)
    return B.BamRecord(name=name, flag=flag, ref_id=0, pos=pos, mapq=mapq, cigar=cigar, seq=seq,
                       qual=np.full(len(seq), 30, np.uint8) if qual is None
                       else np.asarray(qual, np.uint8))


def mk_bam(records, ref_len=1000):
    return B.BamFile(header_text="@HD\tVN:1.6\n", ref_names=["chr1"], ref_lens=[ref_len],
                     records=sorted(records, key=lambda r: r.pos))


def edge_sets():
    """{name: (records, region, num_homop)}: tests/test_pileup.py's cases."""
    return {
        "simple_matches": ([mk_rec("f", 100, [("M", 4)], [0, 1, 2, 3]),
                            mk_rec("r", 102, [("M", 4)], [0, 1, 2, 3], flag=16)],
                           "chr1:101-110", 1),
        "insertion_minor_columns": ([mk_rec("i", 10, [("M", 2), ("I", 2), ("M", 1)],
                                            [0, 0, 1, 2, 3])], "chr1:11-13", 1),
        "deletion_and_strand": ([mk_rec("d", 20, [("M", 1), ("D", 2), ("M", 1)], [0, 1],
                                        flag=16)], "chr1:21-24", 1),
        "insertion_after_deletion": ([mk_rec("x", 5, [("M", 1), ("D", 1), ("I", 2), ("M", 1)],
                                             [0, 1, 2, 3])], "chr1:6-8", 1),
        "mapq_filter_and_gaps": ([mk_rec("low", 10, [("M", 5)], [0] * 5, mapq=0),
                                  mk_rec("ok", 40, [("M", 3)], [1] * 3)], "chr1:1-100", 1),
        "ambiguous_base": ([mk_rec("n", 10, [("M", 3)], [0, 4, 1])], "chr1:11-13", 1),
        "qstrat_planes": ([mk_rec("q", 10, [("M", 2)], [0, 0], qual=[1, 50])],
                          "chr1:11-12", 3),
        "empty_region": ([mk_rec("a", 10, [("M", 5)], [0] * 5)], "chr1:500-600", 1),
    }


_FLAGS = (0, 16, 0, 16, 0, 16, 4, 256, 512, 1024, 2048, 16 | 1024)


def random_records(seed, n_rec=60, ref_len=600, big=False):
    """Random reads over [0, ref_len): tests/test_pileup.py's adversarial
    CIGARs (consecutive I, I after D/N/S, leading and trailing clips) with
    H, =, X and P added, codes 0..4, qualities 0..59, mapq 0..60, and every
    sixth read carrying a filtered flag.  With big=True the reads are
    longer (enough records for several BGZF blocks)."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_rec):
        cig, qlen = [], 0
        if rng.random() < 0.15:
            cig.append(("H", int(rng.integers(1, 9))))
        if rng.random() < 0.3:
            s = int(rng.integers(1, 5))
            cig.append(("S", s))
            qlen += s
        prev = None
        for _ in range(int(rng.integers(1, 8 if big else 6))):
            op = str(rng.choice(["M", "I", "D", "N", "M", "M", "=", "X", "P"]))
            ln = int(rng.integers(1, 40 if big else 12))
            if op in "MI=X":
                qlen += ln
            cig.append((op, ln))
            prev = op
        if prev not in ("M", "=", "X"):
            cig.append(("M", 5))
            qlen += 5
        if rng.random() < 0.2:
            cig.append(("S", 2))
            qlen += 2
        if rng.random() < 0.1:
            cig.append(("H", 3))
        flag = int(_FLAGS[int(rng.integers(0, len(_FLAGS)))]) if i % 6 == 5 \
            else (16 if rng.random() < 0.5 else 0)
        recs.append(mk_rec(f"r{i}", int(rng.integers(0, ref_len - 100)), cig,
                           rng.integers(0, 5, qlen), flag=flag,
                           mapq=0 if i % 11 == 7 else int(rng.integers(1, 61)),
                           qual=rng.integers(0, 60, qlen)))
    recs.sort(key=lambda r: r.pos)
    return recs


def weibull_records(seed, n_rec=40, ref_len=400):
    """Reads with WL/WK float tags (medaka's Weibull scale and shape per
    base), every fifth without tags and every seventh with tags shorter
    than its read; a few insertions and deletions."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_rec):
        a, b = int(rng.integers(5, 30)), int(rng.integers(5, 30))
        cig = [("M", a), ("I", 2), ("M", b)] if i % 3 == 0 else \
            [("M", a), ("D", 2), ("M", b)] if i % 3 == 1 else [("M", a + b)]
        qlen = a + b + (2 if i % 3 == 0 else 0)
        rec = mk_rec(f"w{i}", int(rng.integers(0, ref_len - 80)), cig, rng.integers(0, 5, qlen),
                     flag=16 if i % 2 else 0, qual=rng.integers(1, 40, qlen))
        if i % 5:
            n_tag = qlen - 3 if i % 7 == 0 else qlen
            rec.tags = (B.encode_array_tag("WL", "f", rng.uniform(0.5, 4.0, n_tag))
                        + B.encode_array_tag("WK", "f", rng.uniform(0.5, 3.0, n_tag)))
        recs.append(rec)
    recs.sort(key=lambda r: r.pos)
    return recs


def bench_pileup_records(region=10_000_000, coverage=30, read_len=150, seed=8):
    """tools/scale_bench.py bench_pileup's reads (:561-590), drawn in its
    order: positions sorted, every 7th read 60M 2I 40M 3D 48M, odd reads
    reversed, mapq 50, quality 30."""
    n_reads = region * coverage // read_len
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, region - read_len - 10, n_reads))
    qual = np.full(read_len, 30, np.uint8)
    indel = [("M", 60), ("I", 2), ("M", 40), ("D", 3), ("M", 48)]
    plain = [("M", read_len)]
    return [B.BamRecord(name=f"r{i}", flag=16 if i % 2 else 0, ref_id=0, pos=int(pos[i]),
                        mapq=50, cigar=indel if i % 7 == 3 else plain,
                        seq=rng.integers(0, 4, read_len).astype(np.uint8), qual=qual)
            for i in range(n_reads)]


def mixed_records(region, coverage=15, read_len=150, seed=41):
    """(reference codes, reads) over `region` bases: reads sliced from a
    random reference with 1% substitutions, every 9th with a 2-base
    insertion and every 13th with a 3-base deletion, qualities 10..44,
    odd reads reversed, every 23rd at mapq 5 and every 31st QC-failed."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, region).astype(np.uint8)
    n_reads = region * coverage // read_len
    pos = np.sort(rng.integers(0, region - read_len - 10, n_reads))
    recs = []
    for i in range(n_reads):
        p = int(pos[i])
        if i % 9 == 4:
            seq = np.concatenate([ref[p:p + 70], rng.integers(0, 4, 2), ref[p + 70:p + 148]])
            cig = [("M", 70), ("I", 2), ("M", 78)]
        elif i % 13 == 6:
            seq = np.concatenate([ref[p:p + 80], ref[p + 83:p + 153]])
            cig = [("M", 80), ("D", 3), ("M", 70)]
        else:
            seq = ref[p:p + read_len].copy()
            cig = [("M", read_len)]
        seq = seq.astype(np.uint8)
        mut = rng.random(len(seq)) < 0.01
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        flag = (16 if i % 2 else 0) | (512 if i % 31 == 30 else 0)
        recs.append(B.BamRecord(name=f"m{i}", flag=flag, ref_id=0, pos=p,
                                mapq=5 if i % 23 == 22 else 50, cigar=cig, seq=seq,
                                qual=rng.integers(10, 45, len(seq)).astype(np.uint8)))
    return ref, recs


def write_indexed(path, records, ref_len, with_bai=True):
    """`records` (sorted by position) as a BAM at `path`, and its .bai."""
    B.write_bam(path, mk_bam(records, ref_len))
    if with_bai:
        B.write_bai(path)
    return path


def write_fasta(path, name, codes):
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    seq = acgt[np.minimum(codes, 4)].tobytes().decode()
    with open(path, "w") as f:
        f.write(f">{name}\n" + "\n".join(seq[i:i + 80] for i in range(0, len(seq), 80)) + "\n")
    return path
