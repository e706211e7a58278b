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
    the card equals poa_gold's, with two launches per (round, slab)."""
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
