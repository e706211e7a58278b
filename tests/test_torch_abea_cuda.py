"""The abea CUDA kernels on the card, against their plain PyTorch versions.
Every test needs an NVIDIA GPU (marker `cuda`) and skips without one.
Tolerance: none; both kernels round every float operation once, in the
plain versions' order, so traces, corners, best scores and the backtrack's
buffer (pairs, sums, gaps) agree bit for bit.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_abea_cuda.py
"""

import io

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.ops import abea
from genomicsbench_tpu_torch.ops.eventalign import eventalign_reads

from torch_abea_cases import (_model, bench_abea_reads, edge_cases, eventalign_reads_case,
                              load_align_golden)

pytestmark = pytest.mark.cuda
EDGES = edge_cases()


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _kernels_vs_plain(t):
    f = abea.abea_fill(t)
    want = abea.abea_fill_reference(t)
    for name in ("traces", "bll_e", "trace1", "best_ev"):
        assert torch.equal(getattr(f, name), getattr(want, name)), name
    assert torch.equal(f.best.view(torch.int32), want.best.view(torch.int32)), "best"
    out = abea.abea_backtrack(t, f)
    assert torch.equal(out, abea.abea_backtrack_reference(t, want)), "backtrack"
    return out


@pytest.mark.parametrize("label", sorted(EDGES))
def test_edges_kernels_match_plain(card, label):
    seqs, evs, sc = EDGES[label]
    _kernels_vs_plain(abea.upload_reads(seqs, evs, *_model(), sc, card))


def test_goldens(card):
    mean, stdv, cases, expected = load_align_golden()
    sc = np.array([(c[2], c[3]) for c in cases], np.float32)
    seqs, evs = [c[0] for c in cases], [c[1] for c in cases]
    _kernels_vs_plain(abea.upload_reads(seqs, evs, mean, stdv, sc, card))
    res = abea.align_batch(seqs, evs, mean, stdv, sc, device=card)
    for got, exp in zip(res.pairs, expected):
        np.testing.assert_array_equal(got, exp)


def test_main_path_sample(card):
    """400 reads of the main path: kernels == plain versions, and
    align_batch on the card == on the CPU with one launch of each kernel."""
    seqs, evs, sc = bench_abea_reads(400)
    _kernels_vs_plain(abea.upload_reads(seqs, evs, *_model(), sc, card))
    before = (abea.abea_fill.launches, abea.abea_backtrack.launches)
    got = abea.align_batch(seqs, evs, *_model(), sc, device=card)
    assert (abea.abea_fill.launches - before[0], abea.abea_backtrack.launches - before[1]) \
        == (1, 1)
    want = abea.align_batch(seqs, evs, *_model(), sc, device="cpu")
    assert got.failed == want.failed
    for g, w in zip(got.pairs, want.pairs):
        np.testing.assert_array_equal(g, w)


def test_eventalign_tsv_matches_cpu(card):
    raws, seqs = eventalign_reads_case(24, seed=3)
    mean, stdv = _model()
    got, want = io.StringIO(), io.StringIO()
    eventalign_reads(raws, seqs, mean, stdv, tsv_fp=got, device=card)
    eventalign_reads(raws, seqs, mean, stdv, tsv_fp=want, device="cpu")
    assert got.getvalue() == want.getvalue() and got.getvalue().count("\n") > 1000


def test_wrappers_refuse_mixed_devices(card):
    seqs, evs, sc = EDGES["one_kmer"]
    t = abea.upload_reads(seqs, evs, *_model(), sc, card)
    t.model = t.model.cpu()
    with pytest.raises(ValueError, match="model"):
        abea.abea_fill(t)
