"""The PyTorch port's de Bruijn window graphs (Platypus dbg) against the JAX
package and the dict oracle, on the CPU.

As in tests/test_torch_pileup.py, every JAX call runs with
`genomicsbench_tpu.native._load` patched to return None, so the JAX package
takes its pure-numpy routes (the slab mention pass and the sort-reduce,
with its sorts on CPU XLA); the port's native/dbg.cpp is held against the
JAX package's C compiled into a temporary directory (`jax_c`).  Every
comparison is exact.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.io import bam as JB
from genomicsbench_tpu.ops import dbg as JD

from genomicsbench_tpu_torch import native
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.io import bam as B
from genomicsbench_tpu_torch.ops import dbg as D
from genomicsbench_tpu_torch.utils import offsets_from_lengths

import torch_dbg_cases as C
import torch_pileup_cases as PC
from test_torch_pileup import jax_c, jax_native_masked, on_library  # noqa: F401  (fixtures)

torch.set_num_threads(1)
EDGES = C.edge_windows()


def _same_arrays(got, want, what=""):
    assert len(got) == len(want), what
    for i, (x, y) in enumerate(zip(got, want)):
        assert sorted(x) == sorted(y)
        for key in x:
            assert np.array_equal(np.asarray(x[key]), np.asarray(y[key])), (what, i, key)


def _same_graphs(got, want, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.nodes == w.nodes, (what, i)
        assert g.edges == w.edges and list(g.edges) == list(w.edges), (what, i)


@pytest.mark.parametrize("name", sorted(EDGES))
def test_windows_match_jax_and_oracle(name):
    """Every formulation on the edge windows: the sort-reduce (sorts on the
    CPU) as graphs and as arrays, the native build, JAX's graphs and arrays,
    and the oracle."""
    windows = EDGES[name]
    oracle = [D.build_window_graph_oracle(*w) for w in windows]
    graphs = D.build_window_graphs(windows, device="cpu")
    _same_graphs(graphs, oracle, "sorted vs oracle")
    _same_graphs(graphs, JD.build_window_graphs(windows), "sorted vs JAX")
    want = [D._graph_to_arrays(g) for g in oracle]
    _same_arrays(D._build_window_graphs_sorted(windows, as_arrays=True, device="cpu"), want,
                 "sorted arrays")
    _same_arrays(D.build_window_graphs(windows, as_arrays=True), want, "native arrays")
    _same_arrays(JD.build_window_graphs(windows, as_arrays=True), want, "JAX arrays")


def test_edge_windows_cover_the_cases():
    assert any(w[0].max() == 4 for w in EDGES["n_window"])
    assert EDGES["n_on_last_base"][0][0][-1] == 4
    g = D.build_window_graphs(EDGES["period_4"], device="cpu")[0]
    assert g.node_count() == 4
    assert [g.node_count() for g in D.build_window_graphs(EDGES["short"], device="cpu")] \
        == [2, 2, 3, 285]


@pytest.mark.parametrize("k", [5, 15, 21, 27])
def test_mentions_match_jax_c(k, jax_c, monkeypatch):
    rng = np.random.default_rng(k)
    lens = rng.integers(0, 200, 300)
    seqs = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    seqs[rng.integers(0, len(seqs), 400)] = 4
    quals = rng.integers(17, 60, len(seqs)).astype(np.int32)
    offs = offsets_from_lengths(lens)
    got = native.dbg_mentions(seqs, quals, offs, lens, k, 20)
    with on_library(monkeypatch, jax_c):
        want = native.dbg_mentions(seqs, quals, offs, lens, k, 20)
    assert len(got[0]) > 1000
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_build_ranged_matches_jax_c(jax_c, monkeypatch):
    case = C.soa_case()
    args = (case["refs"], case["ref_starts"], case["seqs"], case["quals"],
            offsets_from_lengths(case["lens"]), case["lens"], case["lo"], case["hi"], 15, 20)
    got = _filled(native.dbg_build_soa(*args))
    with on_library(monkeypatch, jax_c):
        want = _filled(native.dbg_build_soa(*args))
    assert got[2].sum() == 1                      # the reference-N window
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _filled(out):
    """A native build's outputs cut to the entries it wrote."""
    node_off, edge_off, skip_n, *rest = out
    n, e = node_off[-1], edge_off[-1]
    return [node_off, edge_off, skip_n] + [a[:n] for a in rest[:4]] + [a[:e] for a in rest[4:]]


class _Counting:
    """A library whose gb_dbg_build_ranged counts its calls."""

    def __init__(self, lib):
        self.lib, self.calls = lib, 0

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def gb_dbg_build_ranged(self, *args):
        self.calls += 1
        return self.lib.gb_dbg_build_ranged(*args)


@pytest.fixture(scope="module")
def disjoint_reads():
    """20,000 random 150-base reads in one window: their distinct k-mers
    pass the capacity estimate (the build retries), and their 5.4 M node
    mentions pass HOST_SORT_ABOVE (the sort-reduce sorts on the host)."""
    rng = np.random.default_rng(9)
    n, L = 20_000, 150
    return dict(ref=rng.integers(0, 4, 400).astype(np.uint8),
                seqs=rng.integers(0, 4, n * L).astype(np.uint8),
                quals=np.full(n * L, 30, np.int32), lens=np.full(n, L, np.int64))


def test_capacity_retry_matches_jax_c(disjoint_reads, jax_c, monkeypatch):
    r = disjoint_reads
    args = ([r["ref"]], [7], r["seqs"], r["quals"], offsets_from_lengths(r["lens"]), r["lens"],
            [0], [len(r["lens"])], 15, 20)
    for lib in (native.load(), jax_c):
        counting = _Counting(lib)
        with on_library(monkeypatch, counting):
            out = _filled(native.dbg_build_soa(*args))
        assert counting.calls == 2
        if lib is jax_c:
            for a, b in zip(out, got):
                assert np.array_equal(a, b)
        got = out
    assert got[0][1] > 2_600_000 and got[1][1] > 2_600_000


def test_sorted_above_the_host_cutoff(disjoint_reads):
    """The sort-reduce with its node sort on the host (above 2^22 pairs)
    and its edge sort on the CPU device equals the native build."""
    r = disjoint_reads
    L = 150
    window = (r["ref"], 7, [(r["seqs"][i * L:(i + 1) * L], r["quals"][i * L:(i + 1) * L], False)
                            for i in range(len(r["lens"]))])
    launches = D._sort_pairs_on.launches
    got = D._build_window_graphs_sorted([window], as_arrays=True, device="cpu")
    assert D._sort_pairs_on.launches == launches + 1        # edges only
    _same_arrays(got, D.build_window_graphs([window], as_arrays=True))


@pytest.mark.parametrize("n", [1, 127, 129, 5_000, (1 << 22) - 3, (1 << 22) + 5])
def test_device_sort_pairs_matches_jax(n):
    """Many equal keys within and across windows: the port's permutation and
    keys equal JAX's, below and just above the 2^22 host cutoff."""
    rng = np.random.default_rng(n)
    wids = rng.integers(0, 7, n).astype(np.int32)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.int64)
    keys[rng.random(n) < 0.6] = 12345
    keys[: n // 3] = (1 << 32) - 1
    got = D._device_sort_pairs(wids, keys, "cpu")
    want = JD._device_sort_pairs(wids, keys)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_input_checks():
    keys = np.arange(10)
    with pytest.raises(ValueError, match="window ids"):
        D._device_sort_pairs(np.zeros(9, np.int32), keys, "cpu")
    with pytest.raises(ValueError, match="32-bit"):
        D._device_sort_pairs(np.zeros(2, np.int32), np.array([1, 1 << 32]), "cpu")
    with pytest.raises(ValueError, match="window id"):
        D._device_sort_pairs(np.array([-1, 0], np.int32), np.array([1, 2]), "cpu")
    windows = EDGES["test_dbg"][:1]
    with pytest.raises(ValueError, match="1..15"):
        D._build_window_graphs_sorted(windows, k=16, device="cpu")
    # JAX's sorted formulation truncates k = 16 edge keys to 32 bits and fails
    with pytest.raises(IndexError):
        JD.build_window_graphs(windows, k=16)
    with pytest.raises(ValueError, match="1..27"):
        native.dbg_mentions(np.zeros(4, np.uint8), np.zeros(4, np.int32), [0], [4], 28, 20)
    with pytest.raises(ValueError, match="outside"):
        native.dbg_mentions(np.zeros(4, np.uint8), np.zeros(4, np.int32), [2], [4], 5, 20)
    with pytest.raises(ValueError, match="read ranges"):
        native.dbg_build_soa([np.zeros(30, np.uint8)], [0], np.zeros(4, np.uint8),
                             np.zeros(4, np.int32), [0], [4], [0], [2], 15, 20)


def test_soa_build_matches_lists_and_jax():
    """build_window_graphs_soa over overlapping ranges (one call and chunked)
    equals the per-window lists' native build, the sort-reduce and JAX."""
    case = C.soa_case()
    args = (case["refs"], case["ref_starts"], case["seqs"], case["quals"], case["lens"],
            case["lo"], case["hi"])
    one = D.build_window_graphs_soa(*args, chunk_windows=0)
    assert len(one) > 20
    _same_arrays(D.build_window_graphs_soa(*args, chunk_windows=4), one, "chunked")
    _same_arrays(D.build_window_graphs(case["windows"], as_arrays=True), one, "lists")
    _same_arrays(D._build_window_graphs_sorted(case["windows"], as_arrays=True, device="cpu"),
                 one, "sorted")
    _same_arrays(JD.build_window_graphs_soa(*args), one, "JAX")


@pytest.fixture(scope="module")
def dbg_files(tmp_path_factory):
    ref, recs = C.bam_reads()
    d = tmp_path_factory.mktemp("dbg_bam")
    path = PC.write_indexed(str(d / "dbg.bam"), recs, len(ref))
    return ref, path, PC.write_fasta(str(d / "ref.fa"), "chr1", ref)


@pytest.mark.parametrize("reader", ["indexed", "whole"])
def test_dbg_from_bam_matches_jax(reader, dbg_files):
    ref, path, fa_path = dbg_files
    open_port = B.IndexedBam if reader == "indexed" else B.read_bam
    open_jax = JB.IndexedBam if reader == "indexed" else JB.read_bam
    fa, jfa = B.FastaIndex(fa_path), JB.FastaIndex(fa_path)
    assert np.array_equal(fa.fetch("chr1", 0, len(ref)), ref)
    arrays = D.dbg_from_bam(open_port(path), fa, "chr1", 3000, 21000, as_arrays=True)
    assert len(arrays) == 24 and sum(len(a["node_keys"]) for a in arrays) > 1000
    _same_arrays(arrays, JD.dbg_from_bam(open_jax(path), jfa, "chr1", 3000, 21000,
                                         as_arrays=True), "arrays vs JAX")
    graphs = D.dbg_from_bam(open_port(path), C.FastaStub(ref), "chr1", 3000, 21000,
                            device="cpu")
    _same_graphs(graphs, JD.dbg_from_bam(open_jax(path), jfa, "chr1", 3000, 21000), "graphs")
    _same_arrays([D._graph_to_arrays(g) for g in graphs], arrays, "graphs vs arrays")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("bai", [True, False])
def test_cli_matches_jax(bai, tmp_path):
    """`dbg x.bam region ref.fa 1`: JAX's windows and nodes on stderr."""
    ref, recs = PC.mixed_records(12_000, coverage=12)
    path = PC.write_indexed(str(tmp_path / "x.bam"), recs, len(ref), with_bai=bai)
    fa = PC.write_fasta(str(tmp_path / "ref.fa"), "chr1", ref)
    argv = ["dbg", path, "chr1:1000-9000", fa, "1"]
    (got_out, got), (_, want) = _run(torch_cli_main, argv), _run(jax_cli_main, argv)
    assert got_out == ""
    fields = [s.split("Kernel runtime: ")[1].split(" s  ")[1] for s in (got, want)]
    assert fields[0] == fields[1] and fields[0].startswith("windows: 11 nodes: ")
    assert int(fields[0].split()[-1]) > 10_000


def _graph(ref, reads, k=5):
    ref = np.asarray(ref, np.uint8)
    rds = [(np.asarray(r, np.uint8), np.full(len(r), 30, np.uint8), False) for r in reads]
    return (D.build_window_graph_oracle(ref, 0, rds, k=k, min_qual=20),
            JD.build_window_graph_oracle(ref, 0, rds, k=k, min_qual=20))


def test_cycles_bubbles_and_paths_match_jax():
    """tests/test_dbg.py's graphs: detect_cycles, find_bubbles,
    variant_paths_from_node and path_sequence equal JAX's."""
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 4, 50)
    read = ref[5:45].copy()
    read[20] = (read[20] + 1) % 4
    motif = np.array([0, 1, 2, 3, 0, 2] * 6, np.uint8)
    cases = [(ref, [read] * 3, 5), (motif, [], 5), (ref, [ref[5:40]], 8),
             (rng.integers(0, 4, 300), [rng.integers(0, 4, 60) for _ in range(20)], 5)]
    n_bubbles = 0
    for r, reads, k in cases:
        g, jg = _graph(r, reads, k)
        assert g.nodes == jg.nodes and g.edges == jg.edges
        assert D.detect_cycles(g, 40) == JD.detect_cycles(jg, 40)
        got, want = D.find_bubbles(g, 40, k), JD.find_bubbles(jg, 40, k)
        assert got == want
        n_bubbles += len(got)
        for key in list(g.nodes)[:40]:
            assert D.variant_paths_from_node(g, key, 40) == JD.variant_paths_from_node(jg, key, 40)
        for _, paths in got:
            for path, _w in paths:
                assert np.array_equal(D.path_sequence(g, path, k), JD.path_sequence(jg, path, k))
    assert n_bubbles >= 1


@pytest.mark.parametrize("case", ["motif", "window", "repeat"])
def test_assemble_window_matches_jax(case):
    """assemble_window: the graph, the k it stops at and the bubbles."""
    rng = np.random.default_rng(3)
    if case == "motif":
        ref, reads, k = np.tile(np.array([0, 1, 2, 3, 0, 2], np.uint8), 8), [], 5
    elif case == "window":
        ref, _, reads = C.mk_window(rng, ref_len=200, n_reads=6)
        k = 15
    else:
        unit = rng.integers(0, 4, 23).astype(np.uint8)
        ref = np.concatenate([rng.integers(0, 4, 40), unit, unit, unit, rng.integers(0, 4, 40)])
        reads = [(ref[i:i + 70].copy(), np.full(70, 35, np.uint8), False) for i in range(0, 80, 9)]
        k = 5
    g, k_used, bubbles = D.assemble_window(ref, 0, reads, k=k)
    jg, jk, jbubbles = JD.assemble_window(ref, 0, reads, k=k)
    assert (g.nodes, g.edges, k_used, bubbles) == (jg.nodes, jg.edges, jk, jbubbles)
    if case != "window":
        assert k_used > k
