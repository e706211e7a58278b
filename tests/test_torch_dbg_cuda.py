"""dbg's device stage on the card: `_device_sort_pairs` (one stable
torch.sort over wid << 32 | key on the card) and the sort-reduce built on it
(`_build_window_graphs_sorted`, `build_window_graphs`, `dbg_from_bam`
without as_arrays) against the same calls on the CPU, the native build and
the dict oracle, exactly.  Every test needs an NVIDIA GPU (marker `cuda`)
and skips without one.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_dbg_cuda.py
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.io.bam import IndexedBam
from genomicsbench_tpu_torch.ops import dbg as D

import torch_dbg_cases as C
import torch_pileup_cases as PC

pytestmark = pytest.mark.cuda
EDGES = C.edge_windows()


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"


def _same_arrays(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        for key in x:
            assert np.array_equal(np.asarray(x[key]), np.asarray(y[key])), key


@pytest.mark.parametrize("n", [1, 127, 128, 129, 5_000, 1_000_000, D.HOST_SORT_ABOVE])
def test_sort_pairs_on_the_card(card, n):
    """Many equal keys within and across windows, keys at 2^32 - 1 beside
    the padding: the card's permutation and keys equal the CPU's."""
    rng = np.random.default_rng(n)
    wids = rng.integers(0, 9, n).astype(np.int32)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.int64)
    keys[rng.random(n) < 0.5] = 77
    keys[: n // 4] = (1 << 32) - 1
    wids[: n // 8] = np.iinfo(np.int32).max
    got = D._sort_pairs_on(torch.device(card), wids, keys)
    want = D._device_sort_pairs(wids, keys, "cpu")
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("name", sorted(EDGES))
def test_sorted_formulation_on_the_card(card, name):
    windows = EDGES[name]
    oracle = [D.build_window_graph_oracle(*w) for w in windows]
    graphs = D.build_window_graphs(windows, device=card)
    for g, w in zip(graphs, oracle):
        assert g.nodes == w.nodes and g.edges == w.edges
    _same_arrays(D._build_window_graphs_sorted(windows, as_arrays=True, device=card),
                 D.build_window_graphs(windows, as_arrays=True))


def test_bench_windows_on_the_card(card):
    """The first 8 bench_dbg windows (a 40 kb cut of its reference): the
    sort-reduce on the card equals the native build."""
    bench = C.bench_dbg(region=40_000)
    windows = C.bench_windows(bench, 8)
    _same_arrays(D._build_window_graphs_sorted(windows, as_arrays=True, device=card),
                 D.build_window_graphs_soa(bench["refs"][:8], bench["wstarts"][:8],
                                           bench["seqs"].ravel(), bench["quals_flat"],
                                           bench["lens"], bench["read_lo"][:8],
                                           bench["read_hi"][:8]))


def test_dbg_from_bam_on_the_card(card, tmp_path):
    ref, recs = C.bam_reads(region=20_000, n_reads=800)
    path = PC.write_indexed(str(tmp_path / "x.bam"), recs, len(ref))
    graphs = D.dbg_from_bam(IndexedBam(path), C.FastaStub(ref), "chr1", 1000, 12000, device=card)
    arrays = D.dbg_from_bam(IndexedBam(path), C.FastaStub(ref), "chr1", 1000, 12000,
                            as_arrays=True)
    _same_arrays([D._graph_to_arrays(g) for g in graphs], arrays)
