"""Inputs of the methylation slice, for tests/test_torch_meth*.py,
tests/test_torch_ref_align.py and chip_smoke.py.  Plain numpy and the
port's own modules only: the machine with the card has no JAX.

* `instance`, `edge_instances` -- profile-HMM instances as dicts (the
  keys of either package's `profile_hmm_score_batch`): k-mer ranks of real
  ACGT sequences and their CG -> MG variants (rank 3, M), event means
  drawn around the CpG model's levels; the edges of the kernel's shapes.
* `reversed_read` -- one read whose alignment runs its events backwards, so
  that a CpG group's event range ends at event 0.
* `ref_mode_case`, `write_ref_mode_files` -- reads sliced from a random
  genome (half of them from the reverse strand), their raw signals, and
  their BAM records (cigar all M), for eventalign and call-methylation in
  reference mode (-b/-g).
* `lane_k_batch`, `strong_skip` -- one batch of every lane-group size, and
  params under which the skip chain carries weight in the score.
* `lane_group_forward` -- a numpy model of `gb_meth_forward`'s layout: the
  instances on warps of lane groups, g lanes x C blocks, the segmented
  scan of the skip chain, the group edges.
"""

from __future__ import annotations

import os

import numpy as np

from torch_abea_cases import _model, _ranks

KMER = 6
_COMP = np.array([3, 2, 1, 0], np.uint8)      # A C G T -> T G C A


def _meth_ranks(codes: np.ndarray, methylated: bool) -> np.ndarray:
    """ACGMT ranks (A0 C1 G2 M3 T4) of the k-mers of an ACGT-coded
    sequence, its CpG Cs as M when `methylated`."""
    c = np.array([0, 1, 2, 4], np.int64)[codes]
    if methylated:
        c[:-1][(codes[:-1] == 1) & (codes[1:] == 2)] = 3
    n = len(c) - KMER + 1
    r = np.zeros(n, np.int64)
    for j in range(KMER):
        r = r * 5 + c[j:j + n]
    return r.astype(np.int32)


def instance(rng, cpg_mean, n_kmers, n_events, methylated=False, epb=1.6):
    """One instance of `n_kmers` k-mers (a random sequence with CpGs) and
    `n_events` events around the model's levels of its k-mers."""
    codes = rng.integers(0, 4, n_kmers + KMER - 1).astype(np.uint8)
    codes[2:-2:9] = 1          # a CpG every nine bases
    codes[3:-1:9] = 2
    ranks = _meth_ranks(codes, methylated)
    k_of_event = np.minimum((np.arange(n_events) * n_kmers) // max(n_events, 1), n_kmers - 1)
    ev = cpg_mean[ranks[k_of_event]] + rng.normal(0, 1.5, n_events)
    return dict(kmer_ranks=ranks, event_means=ev.astype(np.float32),
                scale=float(np.float32(rng.uniform(0.9, 1.1))),
                shift=float(np.float32(rng.uniform(-2, 2))),
                var=float(np.float32(rng.uniform(0.9, 1.4))), events_per_base=epb)


def edge_instances(cpg_mean, seed=3, longest=4001):
    """{name: list of instances}: K from 7 to 216 (and 1, and 256, the
    kernel's most), across the 32-block lane edges; E from 1 to `longest`;
    one instance alone; a ragged batch of both variants."""
    rng = np.random.default_rng(seed)
    cases = {
        "k_range": [instance(rng, cpg_mean, k, 40, k % 2 == 1)
                    for k in (7, 8, 31, 32, 33, 63, 64, 65, 96, 97, 128, 200, 216)],
        "k_edges": [instance(rng, cpg_mean, 1, 12), instance(rng, cpg_mean, 256, 300, True),
                    instance(rng, cpg_mean, 2, 1), instance(rng, cpg_mean, 3, 2, epb=1.01)],
        "long_rows": [instance(rng, cpg_mean, 216, longest, True),
                      instance(rng, cpg_mean, 20, 12), instance(rng, cpg_mean, 90, 1500),
                      instance(rng, cpg_mean, 7, 140, epb=4.9)],
        "single": [instance(rng, cpg_mean, 23, 45, True)],
    }
    cases["ragged"] = [instance(rng, cpg_mean, int(k), int(e), bool(m), float(epb))
                       for k, e, m, epb in zip(rng.integers(7, 217, 48), rng.integers(12, 400, 48),
                                               rng.integers(0, 2, 48), rng.uniform(1.05, 4, 48))]
    return cases


def reversed_read(cpg_mean, seed=5, tail=14):
    """A call_methylation_batch read (dict) on the reverse strand whose
    alignment maps reference position k to event n - 1 - k and whose one
    CpG (at 25) lies `tail` + 2 bases from the end: with tail 14 its
    group's event range runs from 20 down to 0.  The event of position k
    holds the level of k-mer k of the methylated sequence as the HMM reads
    it on the reverse strand, plus noise."""
    from genomicsbench_tpu_torch.ops import methylation as meth

    rng = np.random.default_rng(seed)
    left = "".join(rng.choice(list("ACT"), 25))
    right = "".join(rng.choice(list("ACT"), tail))
    ref = left + "CG" + right
    m = meth.methylate(ref)
    ranks = meth.meth_kmer_ranks(m, meth.reverse_complement_meth(m), True)
    n = len(ranks)
    ev = (cpg_mean[ranks] + rng.normal(0, 0.4, n)).astype(np.float32)[::-1].copy()
    return dict(ref_seq=ref, ref_start_pos=0, aln_ref_pos=np.arange(n),
                aln_event_idx=(n - 1) - np.arange(n), event_means=ev,
                scalings3=(1.0, 0.0, 1.0), events_per_base=1.1, rc=True)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes)[::-1]]


def ref_mode_case(n_reads, seed, genome_len=5_000_000, lo=800, hi=1200, samples_per_kmer=8,
                  noise=0.3):
    """Reads sliced from a uniform random genome of `genome_len` bases
    (contig "chr1"): read i of lo..hi-1 bases at a random position, from
    the reverse strand when i is odd; its raw signal holds each k-mer level
    of the read's own sequence for `samples_per_kmer` samples with normal
    noise (tests/torch_abea_cases.py `synthetic_read`).  Returns dict:
    genome (uint8 codes), names, seqs (the reads' 0..3 codes as
    sequenced), signals, and records: (name, flag, pos, length) sorted by
    position, as a BAM holds them."""
    mean, _ = _model()
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    names, seqs, signals, records = [], [], [], []
    for i in range(n_reads):
        L = int(rng.integers(lo, hi))
        pos = int(rng.integers(0, genome_len - L))
        rev = i % 2 == 1
        stored = genome[pos:pos + L]
        seq = revcomp(stored) if rev else stored.copy()
        levels = mean[_ranks(seq)]
        sig = np.repeat(levels, samples_per_kmer) + rng.normal(
            0, noise, len(levels) * samples_per_kmer)
        names.append(f"read_{i}")
        seqs.append(seq)
        signals.append(sig.astype(np.float32))
        records.append((f"read_{i}", 16 if rev else 0, pos, L))
    records.sort(key=lambda r: (r[2], r[0]))
    return dict(genome=genome, names=names, seqs=seqs, signals=signals, records=records)


def write_ref_mode_files(directory, case, bam):
    """genome.fa, reads.fa, signals.npz and reads.bam of a `ref_mode_case`
    in `directory`, the BAM written with `bam` (an io.bam module of either
    package).  Returns their paths by name."""
    os.makedirs(directory, exist_ok=True)
    paths = {k: os.path.join(directory, f) for k, f in (
        ("genome", "genome.fa"), ("reads", "reads.fa"), ("signals", "signals.npz"),
        ("bam", "reads.bam"))}
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[case["genome"]].tobytes().decode()
    with open(paths["genome"], "w") as f:
        f.write(">chr1\n")
        f.write("\n".join(genome[i:i + 80] for i in range(0, len(genome), 80)) + "\n")
    with open(paths["reads"], "w") as f:
        for name, seq in zip(case["names"], case["seqs"]):
            f.write(f">{name}\n{acgt[seq].tobytes().decode()}\n")
    np.savez(paths["signals"], **dict(zip(case["names"], case["signals"])))
    recs = [bam.BamRecord(name=name, flag=flag, ref_id=0, pos=pos, mapq=60,
                          cigar=[("M", L)], seq=case["genome"][pos:pos + L].copy(),
                          qual=np.full(L, 30, np.uint8))
            for name, flag, pos, L in case["records"]]
    bam.write_bam(paths["bam"], bam.BamFile(header_text="@HD\tVN:1.6\tSO:coordinate\n",
                                            ref_names=["chr1"],
                                            ref_lens=[len(case["genome"])], records=recs))
    return paths


def parse_meth_rows(text):
    """The rows of a call-methylation TSV (after its header) as tuples of
    (chromosome, start, end, read, ll_ratio, ll_meth, ll_unmeth, n_cpg,
    sequence), the scores as floats."""
    lines = text.splitlines()
    assert lines[0].startswith("chromosome\tstart\tend\tread_name")
    out = []
    for ln in lines[1:]:
        t = ln.split("\t")
        out.append((t[0], int(t[1]), int(t[2]), t[3], float(t[4]), float(t[5]),
                    float(t[6]), int(t[7]), t[8]))
    return out


def same_meth_rows(a, b, rel=2e-4, abs_=2e-3):
    """Whether two call-methylation outputs agree: every integer and string
    column exactly, each log likelihood within rel/abs of the other's plus
    0.01 for their two-decimal printing, the ratio within the sum of its two
    likelihoods' bounds.  Returns (ok, largest likelihood difference)."""
    ra, rb = parse_meth_rows(a), parse_meth_rows(b)
    if len(ra) != len(rb):
        return False, float("inf")
    worst = 0.0
    for x, y in zip(ra, rb):
        if x[:4] != y[:4] or x[7:] != y[7:]:
            return False, float("inf")
        tol = [abs_ + rel * abs(x[c]) + 0.01 for c in (5, 6)]
        d = [abs(x[c] - y[c]) for c in (5, 6)]
        worst = max(worst, *d)
        if d[0] > tol[0] or d[1] > tol[1] or abs(x[4] - y[4]) > tol[0] + tol[1]:
            return False, worst
    return True, worst


# K at every lane-group edge: 8 g and 8 g + 1 blocks, and the 256 cap
LANE_KS = (1, 2, 7, 8, 9, 16, 17, 32, 33, 64, 65, 255, 256)


def lane_k_batch(cpg_mean, seed=11, rows=(1, 60)):
    """Instances of K = LANE_KS in one batch (both variants, rows drawn
    from `rows`), then 20 of random K from 1 to 256."""
    rng = np.random.default_rng(seed)
    out = [instance(rng, cpg_mean, k, int(rng.integers(*rows)), k % 2 == 1) for k in LANE_KS]
    out += [instance(rng, cpg_mean, int(k), int(rng.integers(*rows)), bool(k % 2))
            for k in rng.integers(1, 257, 20)]
    return out


def strong_skip(params):
    """The (R, 16) params with a skip chain that carries weight: lp_kk
    -0.05, lp_mk -0.3 and lp_km -0.5 (the model's own are log 0.3 and
    below), so that an error in the K state's scan moves the score beyond
    the bound."""
    p = np.array(params, np.float32, copy=True)
    p[:, 12], p[:, 4], p[:, 13] = -0.05, -0.3, -0.5
    return p


def _la(a, b):
    """logaddexp as the kernel computes it, in float32."""
    m = np.maximum(a, b)
    return (m + np.log1p(np.exp(-np.abs(a - b)))).astype(np.float32)


def lane_group_forward(tab, flags=3):
    """A numpy float32 model of `gb_meth_forward` (csrc/meth.cu) on a batch's
    host tables (a dict of numpy arrays: ranks, rank_off, ev_first, ev_last,
    read, events, params, model, flank, order, class_n): each class c of
    `class_n` puts its instances, in `order`, on warps of 32 / g groups of
    g = 2^c lanes; lane i of a group holds blocks [i C, i C + C), C =
    ceil(K / g); per row M and B take the block before a lane's first from
    the previous lane (__shfl_up_sync within the group, -1e30 at a group's
    first lane), the skip chain runs along the blocks (g = 1) or as a fold,
    a Hillis-Steele scan of the lanes' maps within the group and a rerun,
    and the lane of block K - 1 adds the end state.  A warp runs to its
    longest instance's rows.  Returns (G,) float32 scores in instance
    order."""
    f32, neg = np.float32, np.float32(-1e30)
    off = np.asarray(tab["rank_off"], np.int64)
    order, class_n = np.asarray(tab["order"]), np.asarray(tab["class_n"], np.int64)
    first, last = np.asarray(tab["ev_first"], np.int64), np.asarray(tab["ev_last"], np.int64)
    model = np.asarray(tab["model"], np.float32)
    params = np.asarray(tab["params"], np.float32)
    events, flank = np.asarray(tab["events"], np.float32), np.asarray(tab["flank"], np.float32)
    ranks, read = np.asarray(tab["ranks"]).astype(np.int64), np.asarray(tab["read"])
    G = len(off) - 1
    out = np.full(G, np.nan, np.float32)
    lanes = np.arange(32)
    start = 0
    for c, n in enumerate(class_n.tolist()):
        g = 1 << c
        li = lanes % g
        for w in range(-(-n // (32 // g))):
            slot = start + w * (32 // g) + lanes // g
            has = slot < start + n
            gi = order[np.where(has, slot, start)].astype(np.int64)
            K = np.where(has, off[gi + 1] - off[gi], 1)
            E = np.where(has, np.abs(last[gi] - first[gi]) + 1, 0)
            step = np.where(last[gi] >= first[gi], 1, -1)
            C = -(-K // g)
            if (C > 8).any():
                raise AssertionError(f"class {c}: an instance of {int(K.max())} blocks")
            b0 = li * C
            last_lane = (K - 1) // C
            last_j = (K - 1) - last_lane * C
            p = params[read[gi]]
            (scale, shift, var, log_var, lp_mk, lp_mb, lp_mm_self, lp_mm_next, lp_bb, lp_bk,
             lp_bm_next, lp_bm_self, lp_kk, lp_km) = (p[:, i] for i in range(14))
            blk = b0[:, None] + np.arange(8)[None, :]
            live = (np.arange(8)[None, :] < C[:, None]) & (blk < K[:, None])
            r = ranks[np.where(live, off[gi][:, None] + blk, 0)]
            gm = np.where(live, scale[:, None] * model[0][r] + shift[:, None], f32(0))
            gs = np.where(live, model[1][r] * var[:, None], f32(1))
            gc = np.where(live, f32(-0.918938) - (model[2][r] + log_var[:, None]),
                          f32(-0.918938)).astype(f32)
            M = np.full((32, 8), neg, f32)
            B, Ks, u = M.copy(), M.copy(), M.copy()
            lane_s = C.astype(f32) * lp_kk
            lp_end = np.full(32, neg, f32)

            def up(v, d):           # __shfl_up_sync(v, d, g)
                return v[np.where(li >= d, lanes - d, lanes)]

            def at(X, j):           # X[lane, j[lane]]
                return X[lanes, j]

            with np.errstate(over="ignore"):
                for row in range(1, int(E.max()) + 1):
                    ev = events[np.where(row <= E, first[gi] + (row - 1) * step, 0)]
                    pre, post = flank[row - 1], flank[np.maximum(E - row, 0)]
                    pm, pb, pk = (np.where(li == 0, neg, up(at(X, C - 1), 1)) for X in (M, B, Ks))
                    for j in range(8):
                        act = j < C
                        b = b0 + j
                        mo, bo, ko = M[:, j].copy(), B[:, j].copy(), Ks[:, j].copy()
                        s = _la(lp_mm_self + mo, lp_mm_next + pm)
                        s = _la(s, lp_bm_self + bo)
                        s = _la(s, lp_bm_next + pb)
                        s = _la(s, lp_km + pk)
                        s = np.where((b == 0) & bool((flags & 1) or row == 1), _la(s, pre), s)
                        a = (ev - gm[:, j]) / gs[:, j]
                        em = gc[:, j] - (f32(0.5) * a) * a
                        inn = b < K
                        M[:, j] = np.where(act, np.where(inn, s + em, neg), mo)
                        B[:, j] = np.where(act, np.where(inn, _la(lp_mb + mo, lp_bb + bo), neg),
                                           bo)
                        pm, pb, pk = (np.where(act, v, q) for v, q in ((mo, pm), (bo, pb),
                                                                      (ko, pk)))
                    pm, pb = (np.where(li == 0, neg, up(at(X, C - 1), 1)) for X in (M, B))
                    x = np.full(32, neg, f32)
                    if g == 1:
                        for j in range(8):
                            act = j < C
                            uj = _la(lp_mk + pm, lp_bk + pb)
                            pm, pb = np.where(act, M[:, j], pm), np.where(act, B[:, j], pb)
                            x = np.where(act, _la(uj, lp_kk + x), x)
                            Ks[:, j] = np.where(act, np.where(b0 + j < K, x, neg), Ks[:, j])
                    else:
                        fold = np.full(32, neg, f32)
                        for j in range(8):
                            act = j < C
                            uj = np.where(b0 + j < K, _la(lp_mk + pm, lp_bk + pb), neg)
                            u[:, j] = np.where(act, uj, u[:, j])
                            pm, pb = np.where(act, M[:, j], pm), np.where(act, B[:, j], pb)
                            fold = np.where(act, _la(u[:, j], lp_kk + fold), fold)
                        U, S = fold, lane_s
                        d = 1
                        while d < g:
                            Uo, So = up(U, d), up(S, d)
                            U, S = (np.where(li >= d, _la(U, S + Uo), U),
                                    np.where(li >= d, So + S, S))
                            d *= 2
                        x = np.where(li == 0, neg, up(U, 1))
                        for j in range(8):
                            act = j < C
                            x = np.where(act, _la(u[:, j], lp_kk + x), x)
                            Ks[:, j] = np.where(act, np.where(b0 + j < K, x, neg), Ks[:, j])
                    mine = li == last_lane
                    em, eb, ek = (np.where(mine, at(X, last_j), neg) for X in (M, B, Ks))
                    end = (row <= E) & (bool(flags & 2) | (row == E))
                    lp_end = np.where(end, _la(lp_end, _la(_la(em, eb), ek) + post), lp_end)
            keep = has & (li == last_lane)
            out[gi[keep]] = lp_end[keep]
        start += n
    return out


def host_tables(t):
    """`lane_group_forward`'s dict from MethTables on the CPU."""
    tab = {name: getattr(t, name).numpy() for name in (
        "ranks", "rank_off", "ev_first", "ev_last", "read", "events", "params", "model",
        "flank", "order")}
    tab["class_n"] = t.host["class_n"]
    return tab
