"""The PyTorch port's reference mode of eventalign and call-methylation
(-b/-g: BAM input, the PSR9 realignment onto the genome, --sam) against the
JAX package, on the CPU.

The JAX package's realignment calls `genomicsbench_tpu.native.psr9_viterbi`
from its native library, which its build compiles with -march=native (FMA
contraction, and a build that may time out on a loaded host).  Here that
function is replaced by `gb_psr9_viterbi` cut from the JAX package's native
source and compiled with -ffp-contract=off, the loop as written, so no test
needs the JAX native library to load.  The port's copy (native/psr9.cpp)
must equal that cut output for output.

Tolerances: none for the Viterbi outputs, the realigned rows, the TSV
bytes, the --sam records and the BAM records; call-methylation's rows as in
tests/test_torch_meth.py (integer and string columns exactly, scores within
rel 2e-4 and abs 2e-3 plus 0.01 for the two-decimal printing).
"""

import contextlib
import ctypes
import io
import re
import subprocess

import numpy as np
import pytest
import torch

import genomicsbench_tpu.native as jax_native
from genomicsbench_tpu.cli import _iter_ref_alignments as jax_iter_ref_alignments
from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.io import bam as jax_bam
from genomicsbench_tpu.ops import methylation as jax_meth
from genomicsbench_tpu.ops import ref_align as jax_ref
from genomicsbench_tpu.ops.eventalign import eventalign_reads as jax_eventalign_reads

from genomicsbench_tpu_torch import native
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.io import bam
from genomicsbench_tpu_torch.ops import ref_align
from genomicsbench_tpu_torch.ops.methylation import synthetic_cpg_model

from torch_abea_cases import _model
from torch_meth_cases import parse_meth_rows, ref_mode_case, same_meth_rows, write_ref_mode_files

torch.set_num_threads(1)

MODEL = _model()


@pytest.fixture(scope="module")
def psr9_cut(tmp_path_factory):
    """gb_psr9_viterbi cut from the JAX package's native source and compiled
    with -ffp-contract=off, wrapped with the signature of
    genomicsbench_tpu.native.psr9_viterbi."""
    src = open(jax_native._SRC).read()
    body = re.search(r"int64_t gb_psr9_viterbi\(.*?\n    return n_out;\n\}\n", src, re.S)
    assert body, "gb_psr9_viterbi not found in the native source"
    d = tmp_path_factory.mktemp("psr9_cut")
    (d / "psr9.cpp").write_text("#include <cmath>\n#include <cstdint>\n#include <vector>\n"
                                "extern \"C\" {\n" + body.group(0) + "}\n")
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(d / "psr9.so"), str(d / "psr9.cpp")], check=True, timeout=120)
    fn = ctypes.CDLL(str(d / "psr9.so")).gb_psr9_viterbi
    fn.restype = ctypes.c_int64
    P, I64, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, I64, P, I64, F, F, F, P, P,
                   ctypes.c_double] + [I64] * 5 + [P, P, P, I64]

    def psr9_viterbi(fwd_seq, rc_seq, ev_mean, scale, shift, var, model_mean, model_stdv,
                     events_per_base, e_start, e_end, event_stride, rc, k=6):
        ev = np.ascontiguousarray(ev_mean, np.float32)
        mm = np.ascontiguousarray(model_mean, np.float32)
        ms = np.ascontiguousarray(model_stdv, np.float32)
        cap = (abs(int(e_end) - int(e_start)) + 1 + max(len(fwd_seq) - k + 1, 0)) * 2 + 16
        out = [np.empty(cap, np.int32), np.empty(cap, np.int32), np.empty(cap, np.uint8)]
        n = fn(fwd_seq, rc_seq, len(fwd_seq), ev.ctypes.data, len(ev), scale, shift, var,
               mm.ctypes.data, ms.ctypes.data, events_per_base, e_start, e_end,
               event_stride, int(bool(rc)), k, *(a.ctypes.data for a in out), cap)
        assert n >= 0
        return tuple(a[:n].copy() for a in out)
    return psr9_viterbi


@pytest.fixture
def jax_psr9(psr9_cut, monkeypatch):
    """The JAX package's realignment on the compiled cut."""
    monkeypatch.setattr(jax_native, "psr9_viterbi", psr9_cut)
    return psr9_cut


def test_psr9_matches_the_cut(psr9_cut):
    """The port's host-library Viterbi equals the cut on segments of both
    strands and strides, at the windows' sizes and at the edges (fewer than
    two events, one k-mer)."""
    rng = np.random.default_rng(0)
    mean, stdv = MODEL
    for trial in range(60):
        n = int(rng.integers(6, 130))
        seq = "".join(rng.choice(list("ACGT"), n))
        rc_seq = ref_align.reverse_complement(seq)
        ev = (rng.uniform(60, 140, 400)).astype(np.float32)
        e0 = int(rng.integers(0, 400))
        e1 = int(rng.integers(0, 400)) if trial % 10 else e0
        args = (seq.encode(), rc_seq.encode(), ev, 1.02, 0.5, 1.1, mean, stdv,
                float(rng.uniform(1.1, 3)), e0, e1, 1 if e1 >= e0 else -1, trial % 2 == 1)
        got, want = native.psr9_viterbi(*args), psr9_cut(*args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), trial


def test_cigar_walk_and_helpers_match_jax():
    ops = [4, 0, 1, 0, 2, 0, 3, 0, 5, 7, 8]
    lens = [2, 3, 1, 2, 2, 2, 1, 2, 1, 4, 3]
    for got, want in zip(ref_align.aligned_pairs_from_cigar(ops, lens, 100),
                         jax_ref.aligned_pairs_from_cigar(ops, lens, 100)):
        assert np.array_equal(got, want)
    b2e = np.full((3000, 2), -1, np.int32)
    rng = np.random.default_rng(1)
    filled = rng.choice(3000, 200, replace=False)
    b2e[filled, 0] = rng.integers(0, 5000, 200)
    for k in list(rng.integers(0, 3000, 100)) + [0, 2999]:
        assert ref_align._get_closest_event_to(int(k), b2e) == jax_ref._get_closest_event_to(
            int(k), b2e)
    pairs = np.stack([np.sort(rng.integers(0, 500, 300)), np.arange(300)], 1)
    for lim, start in ((100, 0), (250, 10), (1000, 0), (-1, 0)):
        assert ref_align._get_end_pair(pairs, lim, start) == jax_ref._get_end_pair(
            pairs, lim, start)
    s = "acgtNRYKMSWBDHV"
    assert ref_align.disambiguate(s) == jax_ref.disambiguate(s)
    assert ref_align.reverse_complement("AACGTX") == jax_ref.reverse_complement("AACGTX")


def _mk_case(rng, is_rev, L=300, pos=50, G=600):
    """tests/test_ref_align.py's case: a genome, a read mapped with an
    M-only cigar, one event per k-mer at its model level plus noise."""
    from torch_abea_cases import _ranks

    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, G))
    stored = genome[pos:pos + L]
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    fastq = "".join(comp[c] for c in reversed(stored)) if is_rev else stored
    ranks = _ranks(np.array(["ACGT".index(c) for c in fastq], np.uint8))
    nk = L - 5
    b2e = np.stack([np.arange(nk), np.arange(nk)], 1).astype(np.int32)
    ev = (MODEL[0][ranks] + rng.normal(0, 0.3, nk)).astype(np.float32)
    return genome, pos, L, b2e, ev


@pytest.mark.parametrize("is_rev", [False, True])
def test_align_read_to_ref_and_its_outputs_match_jax(jax_psr9, is_rev):
    """align_read_to_ref's rows, their TSV (both scale_events modes, with
    B rows) and their --sam record equal JAX's."""
    rng = np.random.default_rng(3 + is_rev)
    genome, pos, L, b2e, ev = _mk_case(rng, is_rev)
    args = (genome[pos:pos + L], pos, [0], [L], pos, is_rev, L, b2e, ev, (1.01, 0.3, 1.2),
            *MODEL, 1.0)
    got, want = ref_align.align_read_to_ref(*args), jax_ref.align_read_to_ref(*args)
    assert len(got) > 100
    assert [vars(r) for r in got] == [vars(r) for r in want]
    got[3].hmm_state = want[3].hmm_state = "B"
    got[3].model_kmer = want[3].model_kmer = "NNNNNN"
    stdv = rng.uniform(0.5, 2, len(ev)).astype(np.float32)
    length = rng.integers(2, 40, len(ev)).astype(np.float32)
    for scale_events in (True, False):
        outs = []
        for mod, rows in ((ref_align, got), (jax_ref, want)):
            buf = io.StringIO()
            mod.emit_ref_alignment_tsv(buf, rows, ev, stdv, length, (1.01, 0.3, 1.2), *MODEL,
                                       read_index=7, ref_name="chr9",
                                       scale_events=scale_events)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and outs[0].count("\n") == len(got)
    a = ref_align.ref_rows_to_sam_record(got, "r", 0, 42)
    b = jax_ref.ref_rows_to_sam_record(want, "r", 0, 42)
    assert (a.name, a.flag, a.pos, a.mapq, a.cigar, a.tags) == (
        b.name, b.flag, b.pos, b.mapq, b.cigar, b.tags)
    assert ref_align.ref_rows_to_sam_record([], "r", 0, 1) is None


def _records(recs):
    return [(r.name, r.flag, r.ref_id, r.pos, r.mapq, list(r.cigar), r.seq.tobytes(),
             r.qual.tobytes(), r.tags) for r in recs]


def test_bam_round_trips_both_ways(tmp_path):
    """write_bam writes the JAX package's bytes; each package reads the
    other's file to the same records (odd and even lengths, base N, tags,
    an unmapped record); BGZF and the array tags both ways."""
    rng = np.random.default_rng(5)
    tags = bam.encode_array_tag("WL", "f", [0.5, 1.5]) + b"NMi" + np.int32(3).tobytes()
    assert tags[:-7] == jax_bam.encode_array_tag("WL", "f", [0.5, 1.5])

    def make(mod):
        recs = []
        for i, L in enumerate((0, 1, 7, 300)):
            seq = rng.integers(0, 5, L).astype(np.uint8)
            recs.append(mod.BamRecord(name=f"q{i}", flag=(16, 0, 4, 2048)[i], ref_id=i % 2,
                                      pos=100 * i, mapq=i, cigar=[("S", 1), ("M", L), ("D", 2)],
                                      seq=seq, qual=rng.integers(0, 60, L).astype(np.uint8),
                                      tags=tags))
        return mod.BamFile(header_text="@HD\tVN:1.6\n", ref_names=["a", "b"],
                           ref_lens=[1000, 2000], records=recs)
    state = rng.bit_generator.state
    bam.write_bam(str(tmp_path / "p.bam"), make(bam))
    rng.bit_generator.state = state
    jax_bam.write_bam(str(tmp_path / "j.bam"), make(jax_bam))
    assert (tmp_path / "p.bam").read_bytes() == (tmp_path / "j.bam").read_bytes()
    p_reads_j = bam.read_bam(str(tmp_path / "j.bam"))
    j_reads_p = jax_bam.read_bam(str(tmp_path / "p.bam"))
    assert _records(p_reads_j.records) == _records(j_reads_p.records)
    assert (p_reads_j.header_text, p_reads_j.ref_names, p_reads_j.ref_lens) == (
        j_reads_p.header_text, j_reads_p.ref_names, j_reads_p.ref_lens)
    rec = p_reads_j.records[3]
    assert np.array_equal(rec.get_array_tag("WL"), np.array([0.5, 1.5], np.float32))
    assert rec.get_array_tag("NM").tolist() == [3] and rec.end_pos() == 300 + 300 + 2
    assert [r.name for r in p_reads_j.fetch("b", 0, 1000)] == ["q1", "q3"]
    raw = rng.integers(0, 256, 150_000).astype(np.uint8).tobytes()
    assert bam.bgzf_compress(raw) == jax_bam.bgzf_compress(raw)
    assert bam.bgzf_decompress(jax_bam.bgzf_compress(raw)) == raw
    assert jax_bam.bgzf_decompress(bam.bgzf_compress(raw)) == raw


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    """Eight reads of 300-499 bases from a 30 kb genome, half from the
    reverse strand, written as genome.fa, reads.fa, signals.npz and a BAM."""
    case = ref_mode_case(8, seed=3, genome_len=30_000, lo=300, hi=500)
    return case, write_ref_mode_files(str(tmp_path_factory.mktemp("ref_mode")), case, bam)


def _argv(paths, *extra):
    return ["--signals", paths["signals"], "-r", paths["reads"], "-b", paths["bam"],
            "-g", paths["genome"], *extra]


def test_eventalign_ref_mode_and_sam_match_jax_cli(jax_psr9, ref_files, tmp_path):
    """`eventalign -b/-g` writes the JAX CLI's TSV byte for byte; with
    --sam the JAX CLI's BAM byte for byte; a .bai beside the input BAM
    changes none of the port's rows."""
    _, paths = ref_files
    got, err = _run(torch_cli_main, ["eventalign", *_argv(paths, "--device", "cpu")])
    want, jerr = _run(jax_cli_main, ["eventalign", *_argv(paths)])
    assert got == want and got.count("\n") > 2000
    assert {ln.split("\t")[3] for ln in got.splitlines()[1:]} == {str(i) for i in range(8)}
    assert err.splitlines()[0] == jerr.splitlines()[0]
    _run(torch_cli_main, ["eventalign", *_argv(paths, "--device", "cpu", "--sam",
                                               str(tmp_path / "p.bam"))])
    _run(jax_cli_main, ["eventalign", *_argv(paths, "--sam", str(tmp_path / "j.bam"))])
    assert (tmp_path / "p.bam").read_bytes() == (tmp_path / "j.bam").read_bytes()
    recs = bam.read_bam(str(tmp_path / "p.bam")).records
    assert len(recs) == 8 and all(r.name.endswith(".template") and r.tags[:3] == b"ESi"
                                  for r in recs)
    assert {r.flag for r in recs} == {0, 16}
    jax_bam.write_bai(paths["bam"])
    try:
        again, _ = _run(torch_cli_main, ["eventalign", *_argv(paths, "--device", "cpu")])
    finally:
        import os
        os.remove(paths["bam"] + ".bai")
    assert again == got


def test_call_methylation_ref_mode_matches_jax(jax_psr9, ref_files):
    """`call-methylation -b/-g` against JAX's flow read by read.  The JAX
    CLI raises IndexError on these reads (a reverse-strand group whose
    event range ends at event 0, ROADMAP §3); so each reverse read's events
    are handed to JAX call_methylation_for_read mirrored (event e as n - 1 -
    e), which gives its groups the same rows in the same order with stride
    +1.  Forward reads go to JAX as they are."""
    _, paths = ref_files
    cpg = synthetic_cpg_model()
    with pytest.raises(IndexError):
        _run(jax_cli_main, ["call-methylation", *_argv(paths)])
    got, err = _run(torch_cli_main, ["call-methylation", *_argv(paths, "--device", "cpu")])
    names, seqs, raws = [], [], []
    from genomicsbench_tpu.io.msa_fasta import encode_seq
    from genomicsbench_tpu.io.seqio import read_fastx
    sig = dict(np.load(paths["signals"]))
    for name, seq in read_fastx(paths["reads"]):
        names.append(name)
        seqs.append(encode_seq(seq.decode()))
        raws.append(sig[name])
    results = jax_eventalign_reads(raws, seqs, *MODEL, keep_aux=True)
    lines = [got.splitlines()[0]]
    strands = set()
    for _, rec, contig, ref_slice, rows, r in jax_iter_ref_alignments(
            paths["bam"], paths["genome"], names, seqs, results, *MODEL):
        rp = np.array([row.ref_position for row in rows], np.int64)
        ev_idx = np.array([row.event_idx for row in rows], np.int64)
        means = r.events[0]
        if rec.is_reverse:
            ev_idx, means = len(means) - 1 - ev_idx, means[::-1].copy()
        strands.add(rec.is_reverse)
        sites = jax_meth.call_methylation_for_read(ref_slice, rec.pos, rp, ev_idx, means,
                                                   r.scalings, *cpg, r.events_per_base,
                                                   rc=rec.is_reverse)
        for _, ss in sorted(sites.items()):
            lines.append(f"{contig}\t{ss.start_position}\t{ss.end_position}\t{rec.name}\t"
                         f"{ss.ll_ratio:.2f}\t{ss.ll_methylated:.2f}\t"
                         f"{ss.ll_unmethylated:.2f}\t{ss.n_cpg}\t{ss.sequence}")
    want = "\n".join(lines) + "\n"
    assert strands == {False, True}
    ok, worst = same_meth_rows(got, want)
    assert ok, worst
    rows = parse_meth_rows(got)
    assert len(rows) > 20 and {r[0] for r in rows} == {"chr1"}
    genome = "".join(open(paths["genome"]).read().split("\n")[1:])
    assert all(genome[r[1]:r[1] + 2] == "CG" for r in rows)
    assert err.startswith(f"[call-methylation] {len(rows)} site groups from ")
