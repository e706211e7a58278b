"""The PyTorch port's poa (genomicsbench_tpu_torch) against the JAX package,
the port's oracle copy and poa_gold, on the CPU.

On the CPU `poa_fill` and `poa_backtrack` take their plain PyTorch versions.
The same numpy inputs (tests/torch_poa_cases.py) go through both packages.
Every value is an integer and every comparison is exact (tolerance 0):
scores, best ranks, path lengths, the 4-bit code words word for word, the
int32 path entries as decoded (node, query position) pairs, the graph
planes and orders after every fusion round, and the consensus bytes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomicsbench_tpu import native as jax_native
from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.config import PoaParams as JaxPoaParams
from genomicsbench_tpu.io.msa_fasta import read_msa_windows as jax_read_msa_windows
from genomicsbench_tpu.ops import poa as jax_poa

from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.config import PoaParams, poa_params_from_dict
from genomicsbench_tpu_torch.io.msa_fasta import decode_seq, read_msa_windows
from genomicsbench_tpu_torch.ops import poa
from genomicsbench_tpu_torch.oracle.poa import PoaGraph, msa_consensus_oracle

import torch_poa_cases as cases

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them and slow the run many times over
torch.set_num_threads(1)

ALT = PoaParams(match=3, mismatch=-5, gap_open1=-6, gap_ext1=-3, gap_open2=-20, gap_ext2=-1)
PARAMS = {"default": PoaParams(), "alt": ALT}


def _jax_params(p: PoaParams):
    return JaxPoaParams(**dataclasses.asdict(p))


def _jax_dp(planes, pads, params, codes):
    n_pad, p_pad, q_pad = pads
    return [np.asarray(a) for a in jax_poa._poa_dp_packed(
        *[jnp.asarray(a) for a in planes], n_pad=n_pad, p_pad=p_pad, q_pad=q_pad,
        params=_jax_params(params), path_codes=codes)]


def _pairs(path, plen, qw):
    """Backward int32 entries -> forward (rank, jcode) pairs."""
    ent = np.asarray(path)[:int(plen)][::-1].astype(np.int64)
    return list(zip((ent // qw).tolist(), (ent % qw).tolist()))


def _check_against_jax(planes, pads, params):
    """The port's plain fill and backtrack against JAX `_poa_dp_packed`, in
    every path form the planes allow; returns the forms checked."""
    t = poa.upload_windows(*planes, "cpu")
    f = poa.poa_fill(t, params)
    forms = [False, True] if pads[1] <= poa.CODES_MAX_P_PAD else [False]
    for codes in forms:
        path, plen = poa.poa_backtrack(t, f, codes)
        got = _jax_dp(planes, pads, params, codes)
        np.testing.assert_array_equal(f.score.numpy(), got[0], err_msg="score")
        np.testing.assert_array_equal(plen.numpy(), got[2], err_msg="plen")
        if codes:
            np.testing.assert_array_equal(f.best_rank.numpy(), got[3], err_msg="best_rank")
            np.testing.assert_array_equal(path.numpy(), got[1], err_msg="code words")
        else:
            qw = pads[2] + 1
            for b in range(t.n_windows):
                assert _pairs(path[b], plen[b], qw) == _pairs(got[1][b], got[2][b], qw), b
    return forms


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("max_indeg", [1, 2, 3, 5, 7, 9])
def test_plain_versions_match_jax_on_random_dags(max_indeg, params):
    rng = np.random.default_rng(100 + max_indeg)
    dags = [cases.random_dag(rng, int(rng.integers(1, 60)), max_indeg,
                             int(rng.integers(0, 100))) for _ in range(3)]
    dags.append(cases.random_dag(rng, 60, max_indeg, 126))      # the widest query
    p_pad = poa._bucket(max(max(len(p) for p in d[1]) for d in dags), 2)
    pads = (256, p_pad, 128)
    forms = _check_against_jax(cases.dag_planes(dags, *pads), pads, PARAMS[params])
    assert forms == ([False, True] if p_pad <= 7 else [False])


def test_plain_versions_match_jax_on_a_4000_base_window():
    """Two reads of about 4,000 bases: q_pad 4,096, where JAX's int32 key
    value*(q_pad+1) wraps past qlen; the port's int64 key must still give
    JAX's score, best rank and code words."""
    rng = np.random.default_rng(41)
    a = rng.integers(0, 4, 4000).astype(np.int64)
    b = cases._mutate(rng, a, 0.04)
    g = poa.NativePoaGraph(PoaParams(), cap=len(a) + len(b) + 8)
    g.add_alignment([], a)
    pads = poa.pads(g.n, g.max_in_degree(), len(b))
    assert pads[2] >= 4096
    basep = np.zeros((1, pads[0]), np.uint8)
    predp = np.full((1, pads[0], pads[1]), 0xFFFF, np.uint16)
    g.export_packed(pads[0], pads[1], basep[0], predp[0])
    seq = np.zeros((1, pads[2]), np.int8)
    seq[0, 0] = -1
    seq[0, 1:len(b) + 1] = b
    planes = (basep, predp, np.array([g.n], np.int32), seq, np.array([len(b)], np.int32))
    t = poa.upload_windows(*planes, "cpu")
    f = poa.poa_fill(t)
    path, plen = poa.poa_backtrack(t, f, codes=True)
    got = _jax_dp(planes, pads, PoaParams(), True)
    assert int(f.score[0]) == int(got[0][0]) and int(f.best_rank[0]) == int(got[3][0])
    assert int(plen[0]) == int(got[2][0])
    np.testing.assert_array_equal(path.numpy(), got[1])


def _planes_equal(g_port, g_jax, g_or):
    assert g_port.n == g_jax.n == len(g_or.nodes)
    p_pad = max(g_port.max_in_degree(), g_jax.max_in_degree(), 2)
    assert g_port.max_in_degree() == g_jax.max_in_degree()
    n_pad = poa._round_up(g_port.n + 1, 256)
    rows = []
    for g in (g_port, g_jax):
        basep = np.zeros(n_pad, np.uint8)
        predp = np.full((n_pad, p_pad), 0xFFFF, np.uint16)
        order = g.export_packed(n_pad, p_pad, basep, predp)
        rows.append((basep, predp, np.asarray(order)))
    for x, y in zip(*rows):
        np.testing.assert_array_equal(x, y)
    a_or, o_or = jax_poa.export_graph_arrays(g_or, n_pad, p_pad)
    a_port, o_port = g_port.export_arrays(n_pad, p_pad)
    assert o_port == o_or == rows[0][2].tolist()
    for key in ("base", "pred", "pmask", "sink"):
        np.testing.assert_array_equal(a_port[key], a_or[key], err_msg=key)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_native_graph_matches_jax_and_oracle(seed):
    """The port's NativePoaGraph against the JAX package's and the port's
    oracle graph after every fusion round: packed planes, orders, the
    oracle's export and the consensus."""
    if not jax_native.available():
        pytest.skip("the JAX package's native library is unavailable")
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 4, int(rng.integers(60, 120))).astype(np.int64)
    seqs = [truth] + [cases._mutate(rng, truth, 0.12) for _ in range(6)]
    g_or = PoaGraph(PoaParams())
    cap = sum(len(s) for s in seqs) + 8
    g_port = poa.NativePoaGraph(PoaParams(), cap=cap)
    g_jax = jax_poa.NativePoaGraph(JaxPoaParams(), cap=cap)
    for k, s in enumerate(seqs):
        aln = [] if k == 0 else g_or.align(s)[1]
        for g in (g_or, g_port, g_jax):
            g.add_alignment(aln, s)
        _planes_equal(g_port, g_jax, g_or)
        np.testing.assert_array_equal(g_port.consensus(), g_or.consensus())
        np.testing.assert_array_equal(g_port.consensus(), g_jax.consensus())


@pytest.mark.parametrize("seed", [7, 8])
def test_msa_consensus_matches_jax_and_oracle(seed):
    windows = cases.small_windows(6, seed)
    got = poa.msa_consensus_batch(windows, device="cpu", slab=4)
    want = jax_poa.msa_consensus_batch(windows, JaxPoaParams())
    for w, g, j in zip(windows, got, want):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, msa_consensus_oracle(w))


def test_msa_consensus_with_other_params():
    windows = cases.small_windows(4, 9)
    got = poa.msa_consensus_batch(windows, ALT, device="cpu")
    for w, g in zip(windows, got):
        np.testing.assert_array_equal(g, msa_consensus_oracle(w, ALT))


EDGES = cases.edge_windows(longest=400)


@pytest.mark.parametrize("label", sorted(EDGES))
def test_edge_windows_match_oracle_and_jax(label):
    windows = EDGES[label]
    got = poa.msa_consensus_batch(windows, device="cpu", slab=2)
    want = jax_poa.msa_consensus_batch(windows, JaxPoaParams(), slab=2)
    for w, g, j in zip(windows, got, want):
        np.testing.assert_array_equal(g, msa_consensus_oracle(w))
        np.testing.assert_array_equal(g, j)
    if label == "one_read":
        np.testing.assert_array_equal(got[0], windows[0][0])
    if label == "identical":
        np.testing.assert_array_equal(got[0], windows[0][0])


def test_high_indegree_window_takes_the_entry_route(monkeypatch):
    """A node of in-degree 5 or more buckets p_pad to 8, which the 4-bit
    codes cannot carry: that slab's backtrack writes int32 entries."""
    forms = []
    real = poa.poa_backtrack

    def spy(t, f, codes=False):
        forms.append((t.p_pad, codes))
        return real(t, f, codes)

    monkeypatch.setattr(poa, "poa_backtrack", spy)
    window = cases.high_indegree_window()
    got = poa.msa_consensus_batch([window], device="cpu")
    np.testing.assert_array_equal(got[0], msa_consensus_oracle(window))
    assert (8, False) in forms and all(codes == (p <= 7) for p, codes in forms)
    g = PoaGraph(PoaParams())
    for s in window:
        g.add_sequence(s)
    assert jax_poa.max_in_degree(g) >= 5


def test_bench_windows_match_poa_gold(tmp_path):
    """The main path's first 4 windows (bench_poa, seed 19): the port's CPU
    consensus equals poa_gold's (tools/ref_drivers/poa_gold.cpp, built here
    with g++ -O2) byte for byte."""
    windows = cases.bench_poa_windows(4)
    exe = cases.build_poa_gold(tmp_path)
    cases.write_windows_fasta(tmp_path / "w.fa", windows)
    want = cases.run_poa_gold(exe, tmp_path / "w.fa")
    stats = {}
    got = poa.msa_consensus_batch(windows, device="cpu", stats=stats)
    assert [decode_seq(c) for c in got] == want
    assert stats["calls"] == 9 and stats["cells"] > 0


def test_align_batch_matches_oracle():
    """align_batch (list form and array form) against the oracle's align,
    graph by graph, an empty graph included."""
    rng = np.random.default_rng(5)
    graphs, g_or, seqs = [], [], []
    for k in range(4):
        truth = rng.integers(0, 4, int(rng.integers(20, 70))).astype(np.int64)
        reads = [truth] + [cases._mutate(rng, truth, 0.1) for _ in range(k)]
        g = poa.NativePoaGraph(PoaParams(), cap=500)
        o = PoaGraph(PoaParams())
        for s in reads:
            aln = o.align(s)[1] if o.nodes else []
            o.add_alignment(aln, s)
            g.add_alignment(aln, s)
        graphs.append(g)
        g_or.append(o)
        seqs.append(cases._mutate(rng, truth, 0.1))
    graphs.append(poa.NativePoaGraph(PoaParams(), cap=50))
    g_or.append(PoaGraph(PoaParams()))
    seqs.append(rng.integers(0, 4, 9))
    scores, alns = poa.align_batch(graphs, seqs, device="cpu")
    scores2, arrs = poa.align_batch(graphs, seqs, device="cpu", as_arrays=True)
    assert scores2 == scores
    for o, s, sc, aln, (an, aq) in zip(g_or, seqs, scores, alns, arrs):
        want_sc, want = o.align(s)
        assert (sc, aln) == (want_sc, want)
        assert [(None if a < 0 else a, None if q < 0 else q)
                for a, q in zip(an.tolist(), aq.tolist())] == want


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_read_msa_windows_matches_jax(tmp_path, gz):
    windows = cases.small_windows(5, 3)
    path = tmp_path / ("w.fa.gz" if gz else "w.fa")
    cases.write_windows_fasta(path, windows, gz)
    got, want = read_msa_windows(str(path)), jax_read_msa_windows(str(path))
    assert len(got) == len(want) == len(windows)
    for g, w, ws in zip(got, want, windows):
        assert len(g) == len(w) == len(ws)
        for a, b, c in zip(g, w, ws):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_cli_matches_jax_cli(tmp_path, capsys):
    """`poa -s x.fa --device cpu` prints the JAX CLI's stdout byte for byte;
    the runtime line goes to stderr."""
    windows = cases.small_windows(5, 4)
    path = tmp_path / "w.fa"
    cases.write_windows_fasta(path, windows)
    args = ["poa", "-s", str(path), "-o", "5,20", "-e", "2,1", "-x", "3"]
    torch_cli_main(args + ["--device", "cpu"])
    ours = capsys.readouterr()
    jax_cli_main(args)
    theirs = capsys.readouterr()
    assert ours.out == theirs.out and ours.out.count(">Consensus_sequence_") == len(windows)
    assert ours.err.startswith("Runtime: ") and "(5 windows)" in ours.err


@pytest.mark.parametrize("fields", [{}, dataclasses.asdict(ALT)])
def test_params_round_trip(fields):
    jp = JaxPoaParams(**fields)
    p = poa_params_from_dict(dataclasses.asdict(jp))
    assert isinstance(p, PoaParams)
    assert JaxPoaParams(**dataclasses.asdict(p)) == jp
    with pytest.raises(TypeError):
        poa_params_from_dict({**dataclasses.asdict(jp), "band": 3})


def test_pads_follow_jax_buckets():
    """The planes' buckets are JAX's (ops/poa.py:563-565), so the code words
    and entries compare word for word; column 0's gap origin is JAX's."""
    for n_max, indeg, q_max in ((0, 1, 0), (255, 2, 127), (256, 5, 128), (1238, 4, 999)):
        n_pad, p_pad, q_pad = poa.pads(n_max, indeg, q_max)
        assert n_pad == -(-(n_max + 1) // 256) * 256 and n_pad > n_max
        assert p_pad >= max(indeg, 2) and p_pad & (p_pad - 1) == 0
        assert q_pad % 128 == 0 and q_pad > q_max
    for q_pad in (128, 4096, 8064):
        run = -(1 << 30)
        best_v = run // (q_pad + 1)
        assert poa.col0_gap_origin(q_pad) == q_pad - (run - best_v * (q_pad + 1))


def test_stats_count_the_dp_cells():
    windows = cases.small_windows(3, 21)
    stats = {}
    poa.msa_consensus_batch(windows, device="cpu", stats=stats)
    cells, g = 0, [PoaGraph(PoaParams()) for _ in windows]
    for r in range(1, max(len(w) for w in windows)):
        for w, gr in zip(windows, g):
            if r == 1:
                gr.add_alignment([], w[0])
            if r < len(w):
                cells += len(gr.nodes) * len(w[r])
                gr.add_sequence(w[r])
    assert stats["cells"] == cells
    assert {"export and marshal", "fill kernel", "backtrack kernel", "decode", "fuse",
            "consensus"} <= set(stats)
