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

from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.ops import abea
from genomicsbench_tpu_torch.ops.eventalign import eventalign_reads

from torch_abea_cases import (_model, bench_abea_reads, edge_cases, eventalign_reads_case,
                              load_align_golden, tile_walk_backtrack, wave_reads)

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


@pytest.mark.parametrize("direction", ["shortest_first", "longest_first"])
def test_reads_in_either_length_order(card, direction):
    """Reads handed over sorted by length either way: the kernel's own
    longest-first order is then the identity or the reversal."""
    seqs, evs, sc = bench_abea_reads(96, seed=6, lo=100, hi=900)
    idx = np.argsort([len(s) + len(e) for s, e in zip(seqs, evs)], kind="stable")
    if direction == "longest_first":
        idx = idx[::-1]
    t = abea.upload_reads([seqs[i] for i in idx], [evs[i] for i in idx], *_model(), sc[idx],
                          card)
    nb = np.diff(t.host["band_off"])
    assert (np.diff(nb[t.host["order"]]) <= 0).all()
    _kernels_vs_plain(t)


def test_one_read(card):
    seqs, evs, sc = bench_abea_reads(1, seed=8)
    t = abea.upload_reads(seqs, evs, *_model(), sc, card)
    assert t.host["order"].tolist() == [0]
    _kernels_vs_plain(t)


def test_batch_straddling_the_waves(card):
    """More reads than the card holds warps at once (132 SMs x 32 one-warp
    blocks), their band counts spread from about 130 to 1,000, so reads
    start as others end, the last and shortest behind a full card."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    seqs, evs, sc = wave_reads(sms * 32 + 300, seed=9)
    t = abea.upload_reads(seqs, evs, *_model(), sc, card)
    assert t.n_reads > sms * 32
    _kernels_vs_plain(t)


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


@pytest.mark.parametrize("label", ["diagonal_walks", "short_walks", "no_walk", "main"])
def test_backtrack_tiles_match_model(card, label):
    """The backtrack kernel's tiles per walk (its C entry's optional
    `tiles` output) and buffer equal the model's (`tile_walk_backtrack`)
    read by read: diagonal moves across tile edges, walks shorter than a
    tile, a read with no walk, and 200 main-path reads."""
    seqs, evs, sc = bench_abea_reads(200) if label == "main" else EDGES[label]
    t = abea.upload_reads(seqs, evs, *_model(), sc, card)
    f = abea.abea_fill(t)
    out = torch.full((4 * t.n_reads + 2 * t.n_bands,), -1, dtype=torch.int32, device=card)
    tiles = torch.full((t.n_reads,), -1, dtype=torch.int32, device=card)
    ptrs = [x.data_ptr() for x in (t.ranks, t.events, t.k_off, t.e_off, t.band_off, t.params,
                                   t.model, t.order, f.traces, f.bll_e, f.best, f.best_ev)]
    rc = _kernels.load().gb_abea_backtrack(*ptrs, t.n_reads, out.data_ptr(), tiles.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    want, stats = tile_walk_backtrack(
        t.ranks.cpu().numpy(), t.events.cpu().numpy(), t.host["k_off"], t.host["e_off"],
        t.host["band_off"], t.params.cpu().numpy(), t.model.cpu().numpy(), t.host["order"],
        f.traces.cpu().numpy(), f.bll_e.cpu().numpy(), f.best.cpu().numpy(),
        f.best_ev.cpu().numpy())
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    np.testing.assert_array_equal(tiles.cpu().numpy(), stats["tiles"])


@pytest.mark.parametrize("which", ["traces", "bll_e"])
def test_backtrack_refuses_misaligned_traces(card, which):
    """The backtrack kernel stages the traces and corners by 16-byte
    copies: a fill output that does not start on 16 bytes is refused with
    ValueError before any launch."""
    seqs, evs, sc = EDGES["short_walks"]
    t = abea.upload_reads(seqs, evs, *_model(), sc, card)
    f = abea.abea_fill(t)
    x = getattr(f, which)
    shifted = torch.empty(x.numel() + 16, dtype=x.dtype, device=card)[1:x.numel() + 1]
    shifted.copy_(x)
    setattr(f, which, shifted)
    before = abea.abea_backtrack.launches
    with pytest.raises(ValueError, match="16-byte"):
        abea.abea_backtrack(t, f)
    assert abea.abea_backtrack.launches == before
