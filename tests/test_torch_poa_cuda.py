"""The poa CUDA kernels on the card, against their plain PyTorch versions.
Every test needs an NVIDIA GPU (marker `cuda`) and skips without one.
Tolerance: none; every value is an integer, so scores, best ranks, trace
cells, path words and lengths agree bit for bit.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_poa_cuda.py
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.config import PoaParams
from genomicsbench_tpu_torch.io.msa_fasta import decode_seq
from genomicsbench_tpu_torch.ops import poa
from genomicsbench_tpu_torch.oracle.poa import msa_consensus_oracle

import torch_poa_cases as cases

pytestmark = pytest.mark.cuda
ALT = PoaParams(match=3, mismatch=-5, gap_open1=-6, gap_ext1=-3, gap_open2=-20, gap_ext2=-1)
EDGES = cases.edge_windows()


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _kernels_vs_plain(t, params, fill=None):
    f = (fill or poa.poa_fill)(t, params)
    want = poa.poa_fill_reference(t, params)
    for name in ("score", "best_rank", "trace"):
        assert torch.equal(getattr(f, name), getattr(want, name)), name
    for codes in ([False, True] if t.p_pad <= poa.CODES_MAX_P_PAD else [False]):
        path, plen = poa.poa_backtrack(t, f, codes)
        want_path, want_plen = poa.poa_backtrack_reference(t, want, codes)
        assert torch.equal(plen, want_plen), ("plen", codes)
        assert torch.equal(path, want_path), ("path", codes)


@pytest.mark.parametrize("params", [PoaParams(), ALT], ids=["default", "alt"])
@pytest.mark.parametrize("max_indeg", [1, 3, 5, 9])
def test_random_dags_kernels_match_plain(card, max_indeg, params):
    """Random graph planes, queries from 0 to 1,300 bases (several tiles of
    512 columns per row)."""
    rng = np.random.default_rng(200 + max_indeg)
    dags = [cases.random_dag(rng, int(rng.integers(1, 300)), max_indeg,
                             int(rng.integers(0, 1300))) for _ in range(6)]
    dags.append(cases.random_dag(rng, 5, max_indeg, 0))
    pads = poa.pads(max(len(d[0]) for d in dags), max(max(map(len, d[1])) for d in dags),
                    max(len(d[2]) for d in dags))
    _kernels_vs_plain(poa.upload_windows(*cases.dag_planes(dags, *pads), card), params)


@pytest.mark.parametrize("label", sorted(EDGES))
def test_edge_windows_kernels_match_plain(card, label, monkeypatch):
    """Every slab of msa_consensus_batch on the edge windows goes through
    both kernels and their plain versions; the consensus equals the
    oracle's."""
    real, slabs = poa.poa_fill, []

    def checked(t, params=None):
        _kernels_vs_plain(t, params or PoaParams(), real)
        slabs.append(t.p_pad)
        return real(t, params)

    checked.launches = 0        # the real wrapper counts on the name it finds itself by
    monkeypatch.setattr(poa, "poa_fill", checked)
    windows = EDGES[label]
    got = poa.msa_consensus_batch(windows, device=card, slab=2)
    assert slabs or all(len(w) < 2 for w in windows)
    for w, g in zip(windows, got):
        np.testing.assert_array_equal(g, msa_consensus_oracle(w))
    if label == "high_indegree":
        assert max(slabs) == 8


def test_bench_windows_match_poa_gold(card, tmp_path):
    """16 windows of the main path (bench_poa, seed 19): the consensus on
    the card equals poa_gold's, with one launch of each kernel per (round,
    slab)."""
    windows = cases.bench_poa_windows(16)
    exe = cases.build_poa_gold(tmp_path)
    cases.write_windows_fasta(tmp_path / "w.fa", windows)
    want = cases.run_poa_gold(exe, tmp_path / "w.fa")
    before = (poa.poa_fill.launches, poa.poa_backtrack.launches)
    stats = {}
    got = poa.msa_consensus_batch(windows, device=card, slab=8, stats=stats)
    assert [decode_seq(c) for c in got] == want
    assert stats["calls"] == 9 * 2
    assert (poa.poa_fill.launches - before[0], poa.poa_backtrack.launches - before[1]) \
        == (stats["calls"], stats["calls"])


# q_pad -> the ring depth the wrapper picks there (ops/poa.py ring_depth)
RING_AT = {256: 32, 1024: 8, 2048: 4, 4096: 2, 5120: 1}


@pytest.mark.parametrize("q_pad", sorted(RING_AT))
@pytest.mark.parametrize("dist", ["R-1", "R", "R+1"])
def test_ring_edges(card, q_pad, dist):
    """Predecessors exactly R - 1, R and R + 1 ranks back, at every ring
    depth the wrapper picks: from the ring, and from the scratch, which
    only the rows read from beyond the ring reach.  q_pad 4,096 and 5,120
    take the int64 E keys, the others the int32 keys."""
    R = poa.ring_depth(q_pad)
    assert R == RING_AT[q_pad]
    d = max(1, R + {"R-1": -1, "R": 0, "R+1": 1}[dist])
    rng = np.random.default_rng(q_pad + d)
    qlens = [q_pad - 1, q_pad // 2 + 1, 3]
    dags = [cases.distance_dag(rng, 3 * R + 40, [d], ql) for ql in qlens]
    planes = cases.dag_planes(dags, 256, 4, q_pad)
    far, rows = poa.far_rows(planes[1], planes[2], R)
    assert (far > 0) == (d >= R)
    _kernels_vs_plain(poa.upload_windows(*planes, card), ALT)


@pytest.mark.parametrize("q_pad", [2048, 2176])
def test_key_routes(card, q_pad):
    """The last q_pad of the int32 E key (columns to 2,047 in 11 bits) and
    the first of the int64 key, each with a window at its widest query."""
    rng = np.random.default_rng(q_pad)
    dags = [cases.random_dag(rng, 30, 3, q_pad - 1), cases.random_dag(rng, 50, 3, 700)]
    for params in (PoaParams(), ALT):
        _kernels_vs_plain(poa.upload_windows(*cases.dag_planes(dags, 256, 4, q_pad), card),
                          params)


def test_empty_slot_before_a_valid_one(card):
    """An empty slot ahead of a live predecessor: at column 0 the live
    diagonal is NEG + mismatch, below the empty slot's NEG, so M's first
    maximal slot is the empty one, as in JAX's masked argmax."""
    rng = np.random.default_rng(9)
    dags = [cases.random_dag(rng, 40, 2, 60), cases.random_dag(rng, 25, 2, 0)]
    basep, predp, n, seq, qlen = cases.dag_planes(dags, 256, 4, 128)
    shifted = np.full_like(predp, poa.NO_PRED)
    shifted[:, :, 1:] = predp[:, :, :-1]       # slot 0 empty on every row
    _kernels_vs_plain(poa.upload_windows(basep, shifted, n, seq, qlen, card), ALT)


@pytest.mark.parametrize("p_pad", [1, 2, 4, 8, 12, 16])
def test_slot_counts(card, p_pad):
    """p_pad 1, 2, 4 and 8 take the fill's unrolled slot loops, 12 and 16
    the general one (and the int32 path entries only)."""
    rng = np.random.default_rng(40 + p_pad)
    dags = [cases.random_dag(rng, int(rng.integers(20, 120)), p_pad, int(rng.integers(0, 900)))
            for _ in range(5)]
    _kernels_vs_plain(poa.upload_windows(*cases.dag_planes(dags, 256, p_pad, 1024), card),
                      PoaParams())


# gb_poa_backtrack's trace tile: rows and columns (csrc/poa.cu kBtRows,
# kBtCols), and the largest p_pad whose predecessor slots the tile holds
BT_ROWS, BT_COLS, BT_PRED_CAP = 64, 64, 32


@pytest.mark.parametrize("dist", [BT_ROWS - 1, BT_ROWS, BT_ROWS + 1, 3 * BT_ROWS])
def test_backtrack_far_predecessor(card, dist):
    """Chains whose nodes read a predecessor exactly `dist` ranks back as
    well as the last one: where the walk takes the far one it leaves the
    tile through its first row and loads the next tile there."""
    rng = np.random.default_rng(dist)
    dags = [cases.distance_dag(rng, 4 * BT_ROWS + 20, [dist], ql) for ql in (200, 60, 3)]
    _kernels_vs_plain(poa.upload_windows(*cases.dag_planes(dags, 512, 4, 256), card), ALT)


def test_backtrack_long_query_gap(card):
    """A query with BT_COLS + 1 and 3 * BT_COLS bases inserted into a chain's
    sequence: the walk's query-gap runs cross the tile's first column,
    and its next node step loads a tile there."""
    rng = np.random.default_rng(21)
    dags = []
    for ins in (BT_COLS + 1, 3 * BT_COLS):
        basep, preds, _ = cases.distance_dag(rng, 120, [], 0)
        bases = (basep & 3).astype(np.int64)
        query = np.concatenate([bases[:60], rng.integers(0, 4, ins), bases[60:]])
        dags.append((basep, preds, query))
    t = poa.upload_windows(*cases.dag_planes(dags, 256, 2, 512), card)
    _kernels_vs_plain(t, ALT)
    f = poa.poa_fill_reference(t, ALT)
    path, plen = poa.poa_backtrack_reference(t, f, False)
    for b, ins in enumerate((BT_COLS + 1, 3 * BT_COLS)):
        gap = (path[b, :plen[b]] // (t.q_pad + 1) == 0).cpu().numpy()
        runs = np.diff(np.flatnonzero(np.diff(np.concatenate([[0], gap, [0]]))))[::2]
        assert runs.max() >= ins, (ins, runs.max())


@pytest.mark.parametrize("p_pad", [BT_PRED_CAP, BT_PRED_CAP + 1])
def test_backtrack_predecessor_slots_off_tile(card, p_pad):
    """The last p_pad whose predecessor slots the tile holds, and the first
    whose slots the walk loads from the plane."""
    rng = np.random.default_rng(p_pad)
    dags = [cases.random_dag(rng, int(rng.integers(40, 200)), p_pad, int(rng.integers(0, 400)))
            for _ in range(3)]
    _kernels_vs_plain(poa.upload_windows(*cases.dag_planes(dags, 256, p_pad, 512), card),
                      PoaParams())


@pytest.mark.parametrize("n_windows", [1, 33])
def test_backtrack_slab_sizes(card, n_windows):
    """A slab of one window and one of 33 (one block a window)."""
    rng = np.random.default_rng(n_windows)
    dags = [cases.random_dag(rng, int(rng.integers(1, 150)), 3, int(rng.integers(0, 300)))
            for _ in range(n_windows)]
    _kernels_vs_plain(poa.upload_windows(*cases.dag_planes(dags, 256, 4, 384), card), ALT)


def test_backtrack_refuses_misaligned_trace(card):
    """poa_backtrack reads the traces in 16-byte pieces: a trace plane one
    int16 into a buffer (an odd offset) is refused with ValueError before
    any launch; the same cells at an aligned address are taken."""
    rng = np.random.default_rng(4)
    dags = [cases.random_dag(rng, 40, 3, 60) for _ in range(2)]
    t = poa.upload_windows(*cases.dag_planes(dags, 256, 4, 128), card)
    f = poa.poa_fill(t, ALT)
    buf = torch.empty(f.trace.numel() + 1, dtype=f.trace.dtype, device=card)
    buf[1:].copy_(f.trace)
    odd = poa.FillResult(f.score, f.best_rank, buf[1:])
    assert odd.trace.data_ptr() % 16 != 0
    before = poa.poa_backtrack.launches
    with pytest.raises(ValueError, match="aligned"):
        poa.poa_backtrack(t, odd)
    assert poa.poa_backtrack.launches == before
    path, plen = poa.poa_backtrack(t, f)
    want_path, want_plen = poa.poa_backtrack_reference(t, f, False)
    assert torch.equal(plen, want_plen) and torch.equal(path, want_path)
