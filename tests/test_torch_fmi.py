"""The PyTorch port's fmi (genomicsbench_tpu_torch) against the JAX package,
brute-force string matching and fmi_gold, on the CPU.

On the CPU `fmi_smem1`, `fmi_seed3` and `fmi_extend` take their plain
PyTorch versions.  The same numpy inputs (tests/torch_fmi_cases.py) go
through both packages.  Every value is an integer and every comparison is
exact (tolerance 0): the index's arrays, every pass's (rid, m, n, k, s) in
order, the e-table's e, k and s, fmi_gold's tuples, and the CLI's bytes.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.io.seqio import load_fastx_batch as jax_load_fastx_batch
from genomicsbench_tpu.ops import fmi as jax_fmi

from genomicsbench_tpu_torch import native
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.io.seqio import load_fastx_batch
from genomicsbench_tpu_torch.ops import fmi

import torch_fmi_cases as cases

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them and slow the run many times over
torch.set_num_threads(1)

FIELDS = ("rid", "m", "n", "k", "s")
EDGES = cases.edge_cases()
PIPE_CASES = sorted(k for k in EDGES if "items" not in k)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(got, want, what):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def indexes():
    """label -> (JAX FmdIndex, port FmdIndex) for every edge reference,
    the tests/test_fmi.py 800-base reference and a 200 kb one."""
    refs = {k: v["ref"] for k, v in EDGES.items()}
    refs["small"] = np.random.default_rng(7).integers(0, 4, 800).astype(np.uint8)
    refs["200k"] = cases.bench_fmi_reference(200_000, seed=3)
    built = {}
    for label, ref in refs.items():
        key = id(ref)
        if key not in built:
            built[key] = (jax_fmi.build_fmd_index(ref), fmi.build_fmd_index(ref))
        refs[label] = built[key]
    return refs


@pytest.fixture(scope="module")
def jax_runs(indexes):
    """JAX FmiPipeline.run on every edge case (compiled once per shape)."""
    out = {}
    for label in PIPE_CASES:
        c = EDGES[label]
        pipe = jax_fmi.FmiPipeline(indexes[label][0], min_seed_len=c["min_seed_len"],
                                   max_mem_intv=c["max_mem_intv"])
        out[label] = pipe.run(c["query"], c["qlen"])
    return out


def _port_pipe(indexes, label, **kw):
    c = EDGES[label]
    return fmi.FmiPipeline(indexes[label][1], min_seed_len=c["min_seed_len"],
                           max_mem_intv=c["max_mem_intv"], device="cpu", **kw)


# ------------------------------------------------------------------ the index
def test_suffix_array_matches_bruteforce_and_jax():
    rng = np.random.default_rng(0)
    for t in (rng.integers(0, 4, 200).astype(np.uint8),
              rng.integers(0, 5, 300).astype(np.uint8),
              np.zeros(64, np.uint8), np.array([2], np.uint8)):
        want = sorted(range(len(t)), key=lambda i: t[i:].tobytes())
        got = fmi.suffix_array(t)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_fmi.suffix_array(t))


@pytest.mark.parametrize("label", ["small", "200k", "repetitive", "poly_a"])
def test_index_matches_jax_field_by_field(indexes, label):
    j, t = indexes[label]
    assert (t.n, t.sentinel_row) == (j.n, j.sentinel_row)
    for f in ("C", "occ_cp", "plane0", "plane1", "valid", "sa"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_cleaned_bwt_reads_back_the_text(indexes):
    _, t = indexes["200k"]
    ref = cases.bench_fmi_reference(200_000, seed=3)
    text = np.concatenate([ref, cases.revcomp(ref)])
    want = np.where(t.sa > 0, text[np.maximum(t.sa - 1, 0)], 0).astype(np.uint8)
    np.testing.assert_array_equal(fmi.cleaned_bwt(t), want)
    assert want[t.sentinel_row] == 0 and t.sa[t.sentinel_row] == 0


def test_device_tables_hold_the_packed_line(indexes):
    j, t = indexes["small"]
    tab = t.device("cpu")
    jc, jtable, jsent = (np.asarray(a) for a in j.device())
    np.testing.assert_array_equal(tab.table.numpy(), jtable)
    np.testing.assert_array_equal(tab.C.numpy(), jc)
    assert int(tab.sent_row) == int(jsent) == tab.sent_host
    assert tab.c_host == tuple(int(c) for c in j.C)


@pytest.mark.parametrize("where", [0, 999, 1999])
def test_build_refuses_a_reference_with_n(where):
    """JAX's build turns code 4 into 255 and gb_sais then crashes the
    process, so only the port is called here."""
    ref = np.random.default_rng(2).integers(0, 4, 2000).astype(np.int32)
    ref[where] = 4
    ref[-1] = 4
    with pytest.raises(ValueError, match=f"position {where}\\b"):
        fmi.build_fmd_index(ref)
    with pytest.raises(ValueError, match="outside"):
        native.suffix_array(np.array([0, 1, 5], np.uint8), alphabet=5)


def test_build_refuses_rows_past_int32(monkeypatch):
    ref = np.zeros(10, np.uint8)
    monkeypatch.setattr(fmi, "MAX_ROWS", 21)
    with pytest.raises(ValueError, match="overflow"):
        fmi.build_fmd_index(ref)


def test_locate_positions_match_text(indexes):
    """FmdIndex.locate maps each pass-1 interval to the reference positions
    of its seed, reverse-strand hits in forward coordinates, as JAX's does
    (tests/test_fmi.py:283-317)."""
    ref = np.random.default_rng(7).integers(0, 4, 800).astype(np.uint8)
    j, t = indexes["small"]
    q, ql = cases.pad_batch([ref[100:140], cases.revcomp(ref[300:340])])
    res = fmi.FmiPipeline(t, device="cpu").pass1(q, ql)
    strands = set()
    for rid, m, n, k, s in zip(res.rid, res.m, res.n, res.k, res.s):
        seed_len = int(n - m + 1)
        pos, is_rev = t.locate(k, s, seed_len)
        want_pos, want_rev = j.locate(k, s, seed_len)
        np.testing.assert_array_equal(pos, want_pos)
        np.testing.assert_array_equal(is_rev, want_rev)
        seed = q[rid, m:n + 1]
        for p, rev in zip(pos, is_rev):
            np.testing.assert_array_equal(ref[p:p + seed_len],
                                          cases.revcomp(seed) if rev else seed)
            strands.add(bool(rev))
    assert strands == {False, True}
    assert len(t.locate(0, 50, 3, max_occ=2)[0]) == 2


# ------------------------------------------------------------ passes vs JAX
@pytest.mark.parametrize("label", PIPE_CASES)
def test_passes_match_jax_in_order(indexes, jax_runs, label):
    c = EDGES[label]
    got = _port_pipe(indexes, label).run(c["query"], c["qlen"])
    want = jax_runs[label]
    for p, (g, w) in enumerate(zip(got[:3], want[:3]), 1):
        _assert_same(g, w, f"{label} pass {p}")
    assert got[3] == want[3]


def test_passes_called_alone_match_run(indexes, jax_runs):
    label = "repetitive"
    c = EDGES[label]
    pipe = _port_pipe(indexes, label)
    p1 = pipe.pass1(c["query"], c["qlen"])
    p2 = pipe.pass2(c["query"], c["qlen"], p1)
    p3 = pipe.pass3(c["query"], c["qlen"])
    for p, (g, w) in enumerate(zip((p1, p2, p3), jax_runs[label][:3]), 1):
        _assert_same(g, w, f"pass {p}")
    assert p2.count > 0


def test_pivot_items_match_jax_walk(indexes):
    """Pass-2 work items straight into the walk, pivots at 0, qlen - 1 and
    the middle with floors 1-3, against JAX `_pass1_smem1_reg` with qrow."""
    c = EDGES["pivots"]
    j, t = indexes["pivots"]
    qrow, piv, mi = c["items"]
    q, ql = c["query"], c["qlen"]
    got = fmi.fmi_smem1(t.device("cpu"), _t(q), _t(ql), _t(qrow), _t(piv), _t(mi),
                        min_seed_len=c["min_seed_len"])
    sm_me, sm_k, sm_s, count, ovf, _, _ = (np.asarray(a) for a in jax_fmi._pass1_smem1_reg(
        *j.device(), jnp.asarray(q), jnp.asarray(ql[qrow]), jnp.asarray(mi), jnp.asarray(piv),
        jnp.asarray(qrow), min_seed_len=c["min_seed_len"], max_rounds=24 * q.shape[1],
        has_pivot=True, emit_ks=True))
    np.testing.assert_array_equal(got.ovf.numpy(), ovf.astype(np.int32))
    np.testing.assert_array_equal(got.count.numpy(), count)
    for it in range(len(qrow)):
        n = int(count[it])
        want = np.stack([sm_me[it, :n] & 0xFFFF, sm_me[it, :n] >> 16, sm_k[it, :n],
                         sm_s[it, :n]], 1)
        np.testing.assert_array_equal(got.slots[it, :n].numpy(), want, err_msg=str(it))
    assert int(count.sum()) > 0


def test_a_dead_pivot_walks_on_as_jax_does(indexes):
    """A pivot on an ambiguous base: the JAX walk (and so the port) goes on
    to the next position that seeds and walks from there, where JAX's own
    e-table formulation and brute force find nothing covering the pivot
    (ROADMAP.md section 3).  Pass 2 never hands the walk such a pivot."""
    c = EDGES["pivots"]
    qrow, piv, _ = c["items"]
    q, ql = c["query"], c["qlen"]
    # the read whose one ambiguous base is its midpoint
    it = next(i for i in range(len(qrow)) if q[qrow[i], piv[i]] == 4
              and (q[qrow[i], :ql[qrow[i]]] == 4).sum() == 1)
    r, p = int(qrow[it]), int(piv[it])
    got = fmi.fmi_smem1(indexes["pivots"][1].device("cpu"), _t(q), _t(ql),
                        _t(qrow[[it]]), _t(piv[[it]]), torch.ones(1, dtype=torch.int32),
                        min_seed_len=19)
    assert int(got.count[0]) > 0 and int(got.slots[0, 0, 0]) > p
    assert cases.brute_pass2(cases.text_bytes(c["ref"]), q[r], int(ql[r]), p, 1, 19) == []


def test_overflow_reads_take_the_etable(indexes, jax_runs):
    """The poly-A reads collect one interval per base: every walk overflows
    its list cap and the pipeline reroutes the reads through the e-table,
    with JAX's SMEMs."""
    c = EDGES["poly_a"]
    t = indexes["poly_a"][1].device("cpu")
    w = fmi.fmi_smem1(t, _t(c["query"]), _t(c["qlen"]), min_seed_len=19)
    assert w.ovf.all() and int(w.count.sum()) == 0
    pipe = _port_pipe(indexes, "poly_a")
    calls = []
    real = fmi.fmi_extend_reference

    def counted(*a, **kw):
        calls.append(a[3].numel())
        return real(*a, **kw)

    fmi.fmi_extend_reference = counted
    try:
        got = pipe.run(c["query"], c["qlen"])
    finally:
        fmi.fmi_extend_reference = real
    assert calls == [8 * 80]
    for p, (g, w_) in enumerate(zip(got[:3], jax_runs["poly_a"][:3]), 1):
        _assert_same(g, w_, f"pass {p}")
    assert got[0].count == 8


@pytest.mark.parametrize("label", ["ambiguous", "repetitive"])
def test_e_table_matches_jax(indexes, label):
    c = EDGES[label]
    j, t = indexes[label]
    mi = np.array([1, 2, 3] * 5, np.int32)[:len(c["qlen"])]
    want = jax_fmi.FmiPipeline(j)._e_table(c["query"], c["qlen"], mi, steps=int(c["qlen"].max()))
    got = fmi.FmiPipeline(t, device="cpu")._e_table(c["query"], c["qlen"], mi)
    for a, b, name in zip(got, want, "eks"):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_extend_lanes_match_jax_with_floors_and_ends(indexes):
    """fmi_extend with floor 0 (s may reach 0) and max_e below the read's
    end, against JAX `FmiPipeline._extend` on the same lanes."""
    c = EDGES["subfloor_5"]
    j, t = indexes["subfloor_5"]
    q, ql = c["query"], c["qlen"]
    rng = np.random.default_rng(9)
    n = 300
    rows = rng.integers(0, len(ql), n)
    starts = rng.integers(-2, q.shape[1] + 2, n).astype(np.int32)
    mi = rng.integers(0, 4, n).astype(np.int32)
    me = (starts + rng.integers(0, 40, n)).astype(np.int32)
    want = jax_fmi.FmiPipeline(j)._extend(q[rows], ql[rows], starts, mi, me, steps=q.shape[1])
    out = fmi.fmi_extend(t.device("cpu"), _t(q), _t(ql), _t(rows.astype(np.int32)), _t(starts),
                         _t(mi), _t(me))
    for a, b, name in zip(out[:3].numpy(), want, "eks"):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


# -------------------------------------------------------- vs brute force
@pytest.mark.parametrize("label", ["small", "ambiguous", "short", "repetitive"])
def test_pass1_and_pass2_match_bruteforce(indexes, label):
    if label == "small":
        ref = np.random.default_rng(7).integers(0, 4, 800).astype(np.uint8)
        rng = np.random.default_rng(1)
        reads = cases._mutated_slices(rng, ref, 6, 90, subs=4)
        r = reads[0].copy()
        r[10], r[50] = 4, 4
        reads += [r, cases.revcomp(reads[1])]
        q, ql = cases.pad_batch(reads)
    else:
        ref, q, ql = (EDGES[label][k] for k in ("ref", "query", "qlen"))
    text = cases.text_bytes(ref)
    pipe = fmi.FmiPipeline(indexes[label][1], min_seed_len=19, device="cpu")
    p1, p2, p3, _ = pipe.run(q, ql)
    for b in range(len(ql)):
        got = [(m, n, s) for rid, m, n, s in p1.sorted_tuples(True) if rid == b]
        assert got == cases.brute_smems(text, q[b], int(ql[b]), 19), b
    want2 = []
    for rid, m, n, s in zip(p1.rid, p1.m, p1.n, p1.s):
        if n + 1 - m >= pipe.split_len and s <= pipe.split_width:
            want2 += [(int(rid), *t) for t in cases.brute_pass2(
                text, q[rid], int(ql[rid]), int((m + n + 1) >> 1), int(s) + 1, 19)]
    assert sorted(zip(p2.rid.tolist(), p2.m.tolist(), p2.n.tolist(), p2.s.tolist())) \
        == sorted(want2)
    for rid, m, n, s in zip(p3.rid, p3.m, p3.n, p3.s):
        qb = q[int(rid)]
        assert n - m + 1 >= 21
        assert cases.count_occ(text, bytes(qb[m:n + 1])) == s < 20
        e20 = cases.longest_match_table(text, qb, int(ql[int(rid)]), 20)
        assert max(int(e20[m]), m + 20) == n


def test_plain_walks_count_their_rank_lines(indexes):
    """The loads counters: at least one line per extension step, at most
    two, and zero for a read with no extension."""
    c = EDGES["short"]
    t = indexes["short"][1].device("cpu")
    w = fmi.fmi_smem1(t, _t(c["query"]), _t(c["qlen"]), min_seed_len=19)
    w3 = fmi.fmi_seed3(t, _t(c["query"]), _t(c["qlen"]), min_intv=20, min_len=20)
    assert int(w.loads[0]) == 0 and int(w3.loads[0]) == 0     # the empty read
    assert int(w3.loads[1]) == 0                              # one base: a seed, no step
    assert int(w3.steps[2]) == int(c["qlen"][2]) - 1          # 18 bases: one walk to the end
    for walk in (w, w3):
        assert (walk.steps <= walk.loads).all() and (walk.loads <= 2 * walk.steps).all()
    assert int(w.steps.sum()) > 0


# ------------------------------------------------------------------ fmi_gold
def test_64_reads_match_fmi_gold(indexes, tmp_path):
    _, t = indexes["200k"]
    ref = cases.bench_fmi_reference(200_000, seed=3)
    q, ql = cases.bench_fmi_reads(ref, 64)
    q[5, 70] = 4                                      # an ambiguous base on the path
    got = cases.pipeline_tuples(*fmi.FmiPipeline(t, device="cpu").run(q, ql)[:3])
    cases.write_gold_index(tmp_path / "index.bin", t.n + 1, t.sentinel_row, t.C,
                           fmi.cleaned_bwt(t))
    cases.write_gold_reads(tmp_path / "reads.bin", q)
    want, summary = cases.run_fmi_gold(cases.build_fmi_gold(tmp_path), tmp_path / "index.bin",
                                       tmp_path / "reads.bin")
    assert got == want, summary
    assert len(got) > 64


def test_ssr_reads_match_fmi_gold(tmp_path):
    """Reads over simple sequence repeats: the e-table route in passes 1 and
    2 against fmi_gold."""
    ref, (starts, lens, units) = cases.ssr_reference(200_000, seed=3)
    t = fmi.build_fmd_index(ref)
    q, ql = cases.bench_fmi_reads(ref, 48)
    # reads that start in a run of 60 or more bases of a 1- or 2-base unit
    homo = starts[(lens >= 60) & (units <= 2)][:16]
    q[:len(homo)] = ref[homo[:, None] + 2 + np.arange(cases.READ_LEN)[None, :]]
    pipe = fmi.FmiPipeline(t, device="cpu")
    got = cases.pipeline_tuples(*pipe.run(q, ql)[:3])
    assert pipe.last_counts["pass1 overflowed reads"] > 0
    cases.write_gold_index(tmp_path / "index.bin", t.n + 1, t.sentinel_row, t.C,
                           fmi.cleaned_bwt(t))
    cases.write_gold_reads(tmp_path / "reads.bin", q)
    want, summary = cases.run_fmi_gold(cases.build_fmi_gold(tmp_path), tmp_path / "index.bin",
                                       tmp_path / "reads.bin")
    assert got == want, summary


# -------------------------------------------------------------------- I/O, CLI
def _write_fastq(path, reads, gz=False):
    text = "".join(f"@r{i} x\n{''.join('ACGTN'[c] for c in r)}\n+\n{'I' * len(r)}\n"
                   for i, r in enumerate(reads))
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)


@pytest.mark.parametrize("gz", [False, True])
def test_load_fastx_batch_matches_jax(tmp_path, gz):
    rng = np.random.default_rng(4)
    reads = [rng.integers(0, 5, int(n)) for n in rng.integers(0, 300, 12)]
    path = tmp_path / ("r.fq.gz" if gz else "r.fq")
    _write_fastq(path, reads, gz)
    for max_reads in (None, 5):
        a = load_fastx_batch(path, max_reads=max_reads)
        b = jax_load_fastx_batch(path, max_reads=max_reads)
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        assert a.names == b.names and a.codes.dtype == b.codes.dtype


@pytest.mark.parametrize("print_output", [True, False])
def test_cli_matches_jax_cli(tmp_path, capsys, print_output):
    ref = cases.bench_fmi_reference(20_000, seed=8)
    (tmp_path / "ref.fa").write_text(">chr\n" + "".join("ACGT"[c] for c in ref) + "\n")
    q, ql = cases.bench_fmi_reads(ref, 40, seed=6, length=100)
    reads = [q[i] for i in range(len(q))]
    reads[3] = np.concatenate([reads[3][:50], [4], reads[3][51:]])
    reads[7] = reads[7][:30]
    _write_fastq(tmp_path / "q.fq", reads)
    args = [str(tmp_path / "ref.fa"), str(tmp_path / "q.fq"), "16", "19", "1"]
    if print_output:
        args.append("--print-output")
    torch_cli_main(["fmi", *args, "--device", "cpu"])
    ours = capsys.readouterr()
    jax_cli_main(["fmi", *args])
    theirs = capsys.readouterr()
    assert ours.out == theirs.out
    assert (ours.out != "") == print_output
    total = [e.split("totalSmem: ")[1].strip() for e in (ours.err, theirs.err)]
    assert total[0] == total[1] and int(total[0]) > 0
