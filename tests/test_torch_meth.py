"""The PyTorch port's call-methylation (genomicsbench_tpu_torch) against the
JAX package, on the CPU.

On the CPU `meth_forward` takes its plain PyTorch version.  The same numpy
inputs (tests/torch_meth_cases.py, tests/torch_abea_cases.py) go through
both packages; tolerances:

* the host functions exactly: ranks, rewriting, transitions and flanks bit
  for bit;
* the forward scores within the JAX package's own bound, rel 2e-4 and abs
  2e-3 (tests/test_methylation.py:52), of JAX `_phmm_meth_scan` and of the
  float32 oracle; the float32 oracle within rel 1e-3, abs 5e-2 of the
  float64 one (:53).  The scores come from float32 logaddexp chains over
  hundreds of cells summed in another order (Hillis-Steele against XLA's
  associative scan), so they differ in the last bits;
* every site key, start, end, n_cpg and sequence exactly; the CLIs' integer
  and string columns exactly, their scores within the bound plus 0.01 for
  the two-decimal printing; meth-freq, freq-merge and index byte for byte.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.ops import methylation as jax_meth

from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.ops import methylation as meth
from genomicsbench_tpu_torch.ops.abea import detect_events
from genomicsbench_tpu_torch.ops.eventalign import eventalign_reads

from torch_abea_cases import _model, eventalign_reads_case
from torch_meth_cases import edge_instances, instance, reversed_read, same_meth_rows

torch.set_num_threads(1)

REL, ABS = 2e-4, 2e-3           # tests/test_methylation.py:52
CPG = meth.synthetic_cpg_model()


def _close(got, want, rel=REL, abs_=ABS):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool((np.abs(got - want) <= abs_ + rel * np.abs(want)).all())


def test_synthetic_cpg_model_is_jax_model():
    for a, b in zip(meth.synthetic_cpg_model(), jax_meth.synthetic_cpg_model()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_sequence_rewriting_and_ranks_match_jax():
    """disambiguate, methylate, reverse_complement_meth and the k-mer ranks
    of both strands, on random sequences dense in CpGs (so MG sites meet
    both strands' reversal)."""
    rng = np.random.default_rng(0)
    for n in list(range(6, 40)) + [221] * 20:
        s = "".join(rng.choice(list("ACGTCGCGNacgt"), n))
        d = meth.disambiguate(s)
        assert d == jax_meth.disambiguate(s)
        assert meth.disambiguate_bytes(s) == d.encode()
        assert meth.methylate(d) == jax_meth.methylate(d)
        for v in (d, meth.methylate(d)):
            rc = meth.reverse_complement_meth(v)
            assert rc == jax_meth.reverse_complement_meth(v)
            for strand in (False, True):
                got = meth.meth_kmer_ranks(v, rc, strand)
                want = jax_meth.meth_kmer_ranks(v, rc, strand)
                assert got.dtype == want.dtype and np.array_equal(got, want), (v, strand)
            assert meth.meth_kmer_rank(v, 0) == jax_meth.meth_kmer_rank(v, 0)
    assert meth.meth_kmer_rank("AAAAAM", 0) == 3 and meth.meth_kmer_rank("CAAAAA", 0) == 5**5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_transitions_and_flanks_bit_for_bit(dtype):
    """The copied _block_transitions and _flanks equal JAX's bit for bit;
    the vectorised per-read params and the one flank table equal JAX's
    float32 values for every events_per_base and row count."""
    rng = np.random.default_rng(1)
    epbs = np.concatenate([rng.uniform(1.001, 5.0, 400), [1.5, 2.0, 1.0 + 1e-7, 4.999]])
    for e in epbs[:50]:
        got, want = meth._block_transitions(float(e), dtype), jax_meth._block_transitions(
            float(e), dtype)
        assert got.keys() == want.keys()
        assert all(np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes() for k in got)
    for n in (1, 2, 3, 17, 400):
        for a, b in zip(meth._flanks(n, dtype), jax_meth._flanks(n, dtype)):
            assert a.tobytes() == b.tobytes()
    if dtype is np.float64:
        return
    sc = rng.uniform(0.5, 2.0, (len(epbs), 3)).astype(np.float32)
    params = meth.read_params(sc, epbs)
    for i, e in enumerate(epbs):
        bt = jax_meth._block_transitions(float(e), np.float32)
        want = np.array([bt[k] for k in meth.TRANSITIONS], np.float32)
        assert params[i, 4:14].tobytes() == want.tobytes(), e
        assert params[i, 3] == np.float32(np.log(np.float32(sc[i, 2])))
        assert params[i, :3].tobytes() == sc[i].tobytes()
    table = meth.flank_table(2001)
    for n in (1, 2, 3, 10, 377, 2001):
        pre, post = jax_meth._flanks(n, np.float32)
        assert pre[:n].tobytes() == table[:n].tobytes()
        assert post.tobytes() == table[:n][::-1].tobytes()


def _batch():
    cases = edge_instances(CPG[0], longest=400)
    return cases["k_range"] + cases["k_edges"] + cases["ragged"][:24] + cases["long_rows"]


@pytest.mark.parametrize("flags", [0, 1, 2, 3])
def test_plain_forward_matches_jax_scan(flags):
    """meth_forward_reference against JAX `_phmm_meth_scan` (through its
    profile_hmm_score_batch, one shape) under each clip flag, on K from 1
    to 256 across the 32-block lane edges, E from 1 to 400, both
    variants."""
    insts = _batch()
    want = jax_meth.profile_hmm_score_batch(insts, *CPG, flags=flags)
    got = meth.profile_hmm_score_batch(insts, *CPG, flags=flags, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    assert _close(got, want), np.abs(got - want).max()


def test_plain_forward_matches_oracles():
    """The plain version within the bound of the float32 oracle; the port's
    oracles equal JAX's; float32 within rel 1e-3, abs 5e-2 of float64."""
    insts = _batch()[::3]
    got = meth.profile_hmm_score_batch(insts, *CPG, device="cpu")
    for g, inst in zip(got, insts):
        args = (inst["kmer_ranks"], inst["event_means"], inst["scale"], inst["shift"],
                inst["var"], *CPG, inst["events_per_base"])
        w32 = meth.profile_hmm_score_oracle(*args, dtype=np.float32)
        w64 = meth.profile_hmm_score_oracle(*args, dtype=np.float64)
        assert w32 == jax_meth.profile_hmm_score_oracle(*args, dtype=np.float32)
        assert w64 == jax_meth.profile_hmm_score_oracle(*args, dtype=np.float64)
        assert g == pytest.approx(w32, rel=REL, abs=ABS)
        assert w32 == pytest.approx(w64, rel=1e-3, abs=5e-2)


@pytest.fixture(scope="module")
def aligned_reads():
    """Eight synthetic reads of 300-499 bases through the port's
    eventalign_reads(keep_aux=True) on the CPU, and their raw signals."""
    raws, seqs = eventalign_reads_case(8, seed=5, lo=300, hi=500)
    res = eventalign_reads(raws, seqs, *_model(), keep_aux=True, device="cpu")
    return raws, seqs, res


def test_keep_aux_events_are_detect_events(aligned_reads):
    """Event-space call-methylation takes the events that eventalign kept;
    detect_events is deterministic, so they equal a second detection (the
    JAX CLI's `_detect_means`)."""
    raws, seqs, res = aligned_reads
    assert any(r.flag == 0 for r in res)
    for raw, seq, r in zip(raws, seqs, res):
        if r.flag == 0:
            ev = detect_events(raw)
            assert np.array_equal(r.events[0], ev[2]) and np.array_equal(r.events[1], ev[3])
            assert np.array_equal(r.events[2], ev[1])
            assert r.b2e.shape == (len(seq) - 5, 2)
        else:
            assert r.b2e is None and r.events is None


def _same_sites(got, want, what):
    assert list(got) == list(want), what
    for k in want:
        a, b = want[k], got[k]
        assert (b.start_position, b.end_position, b.n_cpg, b.sequence) == (
            a.start_position, a.end_position, a.n_cpg, a.sequence), (what, k)
        assert _close([b.ll_methylated, b.ll_unmethylated],
                      [a.ll_methylated, a.ll_unmethylated]), (what, k)


@pytest.mark.parametrize("rc", [False, True])
def test_call_methylation_batch_matches_jax_per_read(aligned_reads, rc):
    """call_methylation_batch(device="cpu") over every read at once against
    JAX call_methylation_for_read read by read, on each strand's ranks; a
    reference offset moves every start.  One batch equals read-by-read
    calls."""
    _, seqs, res = aligned_reads
    _, reads = meth.event_space_reads(res, seqs)
    offset = 1000 if rc else 0
    for rd in reads:
        rd.update(rc=rc, ref_start_pos=offset,
                  aln_ref_pos=np.asarray(rd["aln_ref_pos"]) + offset)
    stats = {}
    got = meth.call_methylation_batch(reads, *CPG, device="cpu", stats=stats)
    assert stats["groups"] == sum(len(g) for g in got) > 0
    assert stats["instances_n"] == 2 * stats["groups"] and stats["cells"] > 0
    for i, rd in enumerate(reads):
        want = jax_meth.call_methylation_for_read(
            rd["ref_seq"], rd["ref_start_pos"], rd["aln_ref_pos"], rd["aln_event_idx"],
            rd["event_means"], rd["scalings3"], *CPG, rd["events_per_base"], rc=rc)
        _same_sites(got[i], want, i)
    one = meth.call_methylation_for_read(
        *(reads[0][k] for k in ("ref_seq", "ref_start_pos", "aln_ref_pos", "aln_event_idx",
                                "event_means", "scalings3")), *CPG,
        reads[0]["events_per_base"], rc=rc, device="cpu")
    assert list(one) == list(got[0])
    assert all(one[k].ll_methylated == got[0][k].ll_methylated for k in one)


def test_unsorted_alignment_takes_find_event_bounds(aligned_reads):
    """A read whose alignment is not in ascending reference order gets its
    event bounds from find_event_bounds group by group, as JAX does."""
    _, seqs, res = aligned_reads
    _, reads = meth.event_space_reads(res, seqs)
    rd = dict(reads[0])
    perm = np.random.default_rng(2).permutation(len(rd["aln_ref_pos"]))
    rd["aln_ref_pos"] = np.asarray(rd["aln_ref_pos"])[perm]
    rd["aln_event_idx"] = np.asarray(rd["aln_event_idx"])[perm]
    got = meth.call_methylation_batch([rd, reads[1]], *CPG, device="cpu")
    want = jax_meth.call_methylation_for_read(
        rd["ref_seq"], 0, rd["aln_ref_pos"], rd["aln_event_idx"], rd["event_means"],
        rd["scalings3"], *CPG, rd["events_per_base"])
    _same_sites(got[0], want, "permuted")


@pytest.mark.parametrize("tail", [14, 30])
def test_reversed_range_ending_at_event_0(tail):
    """A reverse-strand group whose event range runs down to event 0 (tail
    14): JAX slices event_means[e1 : -1 : -1], which is empty, and raises
    IndexError; the port scores the |e2 - e1| + 1 = e1 + 1 events from e1
    down to 0, as meth.c does, equal to the oracle on those rows.  With a
    longer tail the range ends above 0 and both packages agree."""
    rd = reversed_read(CPG[0], tail=tail)
    args = [rd[k] for k in ("ref_seq", "ref_start_pos", "aln_ref_pos", "aln_event_idx",
                            "event_means", "scalings3")] + [*CPG, rd["events_per_base"]]
    got = meth.call_methylation_for_read(*args, rc=True, device="cpu")
    assert len(got) == 1
    (ss,) = got.values()
    n = len(rd["aln_ref_pos"])
    e1, e2 = n - 1 - 15, n - 1 - 35        # the group's calling window is [15, 35]
    assert (e2 == 0) == (tail == 14)
    if tail == 14:
        with pytest.raises(IndexError):
            jax_meth.call_methylation_for_read(*args, rc=True)
    else:
        _same_sites(got, jax_meth.call_methylation_for_read(*args, rc=True), "tail 30")
    sub = rd["ref_seq"][15:36]
    rows = rd["event_means"][e1:e2 - 1 if e2 else None:-1]
    assert len(rows) == e1 - e2 + 1
    for variant, score in ((sub, ss.ll_unmethylated), (meth.methylate(sub), ss.ll_methylated)):
        ranks = meth.meth_kmer_ranks(variant, meth.reverse_complement_meth(variant), True)
        oracle = [meth.profile_hmm_score_oracle(ranks, rows, 1.0, 0.0, 1.0, *CPG, 1.1,
                                                dtype=dt) for dt in (np.float64, np.float32)]
        assert score == pytest.approx(oracle[1], rel=REL, abs=ABS)
        assert score == pytest.approx(oracle[0], rel=1e-3, abs=5e-2)
    assert ss.ll_ratio > 3          # the events came from the methylated sequence


def test_scored_sites_cross_as_dicts_and_frequency_matches():
    """JAX site maps cross as dicts (scored_sites_from_dicts) and give the
    same methylation_frequency; an unknown field raises TypeError."""
    mk = lambda pos, r: {pos: jax_meth.ScoredSite(pos, pos + 4, 2, "ACGTCG", 0.0, r)}
    maps = [mk(100, 5.0), mk(100, 4.0), mk(100, -6.0), mk(100, 1.0), mk(40, -3.0)]
    dicts = [{k: dataclasses.asdict(v) for k, v in m.items()} for m in maps]
    ported = meth.scored_sites_from_dicts(dicts)
    assert all(isinstance(v, meth.ScoredSite) for m in ported for v in m.values())
    for thr in (2.5, 4.5):
        assert meth.methylation_frequency(ported, thr) == jax_meth.methylation_frequency(
            maps, thr)
    with pytest.raises(TypeError):
        meth.scored_sites_from_dicts([{1: dict(dicts[0][100], extra=1)}])


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    """Six synthetic reads' signals (.npz) and sequences (.fa)."""
    d = tmp_path_factory.mktemp("meth_reads")
    raws, seqs = eventalign_reads_case(6, seed=11, lo=300, hi=500)
    names = [f"r{k}" for k in range(len(seqs))]
    np.savez(d / "s.npz", **dict(zip(names, raws)))
    (d / "r.fa").write_text("".join(f">{n}\n{''.join('ACGT'[c] for c in s)}\n"
                                    for n, s in zip(names, seqs)))
    return d


def test_cli_call_methylation_matches_jax_cli(read_files):
    """`call-methylation --signals x.npz -r x.fa --device cpu` prints the
    JAX CLI's header and rows: integer and string columns exactly, scores
    within the bound."""
    d = read_files
    argv = ["call-methylation", "--signals", str(d / "s.npz"), "-r", str(d / "r.fa")]
    got, err = _run(torch_cli_main, argv + ["--device", "cpu"])
    want, jerr = _run(jax_cli_main, argv)
    assert got.splitlines()[0] == want.splitlines()[0]
    ok, worst = same_meth_rows(got, want)
    assert ok, worst
    assert len(got.splitlines()) > 20
    assert err.split(" in ")[0] == jerr.split(" in ")[0]


def test_meth_freq_freq_merge_and_index_are_byte_identical(read_files, tmp_path):
    """meth-freq (two thresholds), freq-merge of two runs and index, on the
    same files through both CLIs: the same bytes."""
    d = read_files
    calls, _ = _run(jax_cli_main, ["call-methylation", "--signals", str(d / "s.npz"),
                                   "-r", str(d / "r.fa")])
    lines = calls.splitlines()
    (tmp_path / "a.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "b.tsv").write_text("\n".join(lines[:1] + lines[1::2]) + "\n")
    for thr in ("2.5", "0.5"):
        argv = ["meth-freq", "-i", str(tmp_path / "a.tsv"), "-c", thr]
        got, want = _run(torch_cli_main, argv)[0], _run(jax_cli_main, argv)[0]
        assert got == want and got.count("\n") > 5
        (tmp_path / f"f{thr}.tsv").write_text(got)
    argv = ["freq-merge", str(tmp_path / "f2.5.tsv"), str(tmp_path / "f0.5.tsv")]
    assert _run(torch_cli_main, argv)[0] == _run(jax_cli_main, argv)[0]
    argv = ["index", "--reads", str(d / "r.fa"), "--signals", str(d / "s.npz")]
    readdb = d / "r.fa.index.readdb"
    got_err = _run(torch_cli_main, argv)[1]
    got = readdb.read_bytes()
    readdb.unlink()
    want_err = _run(jax_cli_main, argv)[1]
    assert got == readdb.read_bytes() and got.count(b"\n") == 6 and got_err == want_err


def test_methylated_reads_score_positive():
    """Reads generated from the methylated model get a positive ratio and
    unmethylated ones a negative one (tests/test_methylation.py:72-103)."""
    rng = np.random.default_rng(2)
    ref = "".join(rng.choice(list("ACT"), 25)) + "CG" + "".join(rng.choice(list("ACT"), 25))
    for methylated in (False, True):
        seq = meth.methylate(ref) if methylated else ref
        ranks = meth.meth_kmer_ranks(seq, seq, rc=False)
        ev = (CPG[0][ranks] + rng.normal(0, 0.4, len(ranks))).astype(np.float32)
        sites = meth.call_methylation_for_read(ref, 0, np.arange(len(ranks)),
                                               np.arange(len(ranks)), ev, (1.0, 0.0, 1.0),
                                               *CPG, 1.1, device="cpu")
        (ss,) = sites.values()
        assert ss.n_cpg == 1 and (ss.ll_ratio > 3 if methylated else ss.ll_ratio < -3)


def test_a_read_without_groups_scores_nothing():
    rng = np.random.default_rng(4)
    rd = dict(ref_seq="ACT" * 30, ref_start_pos=0, aln_ref_pos=np.arange(85),
              aln_event_idx=np.arange(85), event_means=rng.normal(90, 5, 85).astype(np.float32),
              scalings3=(1.0, 0.0, 1.0), events_per_base=1.1, rc=False)
    assert meth.call_methylation_batch([rd, rd], *CPG, device="cpu") == [{}, {}]
    assert meth.call_methylation_batch([], *CPG, device="cpu") == []
    assert meth.profile_hmm_score_batch([], *CPG, device="cpu").shape == (0,)
    inst = instance(rng, CPG[0], 10, 20)
    assert meth.profile_hmm_score_batch([inst], *CPG, device="cpu").shape == (1,)
