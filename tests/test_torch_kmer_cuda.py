"""The kmer-cnt CUDA kernels on the card, against their plain PyTorch
versions.  Every test needs an NVIDIA GPU (marker `cuda`) and skips without
one.  Every comparison is exact: the kernels compute integers.  The site
build's output order is free (one atomic per block), so its keys are
compared sorted.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_kmer_cuda.py
"""

import numpy as np
import pytest
import torch

import genomicsbench_tpu_torch.ops.kmer as T
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.oracle.kmer import count_kmers_oracle, yield_minimizers_oracle
from genomicsbench_tpu_torch.utils import offsets_from_lengths

from torch_kmer_cases import KS, WINDOWS, edge_batch, genome_reads, poly_a_batch, write_fasta

pytestmark = pytest.mark.cuda
CASES = {"edge": edge_batch(), "edge93": edge_batch(93),
         "genome": genome_reads(64, 3_000, genome_len=40_000, seed=9)}


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _on(dev, seq, lens):
    return torch.from_numpy(seq).to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_canonical_runs_freqs_match_plain(card, case, k):
    seq, lens = CASES[case]
    codes, lt = _on(card, seq, lens)
    for mode in (T.MODE_CODES, T.MODE_PACK_CODES):
        got = T.canonical_keys(codes, lt, k, mode)
        want = T.canonical_keys_reference(codes, lt, k, mode)
        assert torch.equal(got, want), mode
    s, order = torch.sort(want)
    assert torch.equal(T.kmer_runs(s), T.kmer_runs_reference(s))
    f, sat = T.kmer_freqs(s, order)
    wf, wsat = T.kmer_freqs_reference(s, order)
    assert torch.equal(f, wf) and torch.equal(sat, wsat)
    torch.cuda.synchronize()


def test_poly_a_freqs_saturate(card):
    seq, lens = poly_a_batch()
    codes, lt = _on(card, seq, lens)
    s, order = torch.sort(T.canonical_keys(codes, lt, 15))
    f, sat = T.kmer_freqs(s, order)
    wf, wsat = T.kmer_freqs_reference(s, order)
    assert torch.equal(f, wf) and int(sat) == int(wsat) == 1
    assert T.count_kmers(seq, lens, 15, device=card)[1].max() == 69_985


@pytest.mark.parametrize("window", WINDOWS + (63, 64, 70))
@pytest.mark.parametrize("k", KS)
def test_minimizers_and_sites_match_plain(card, k, window):
    """Windows of 64 and more keep the deque in the device scratch."""
    for seq, lens in (CASES["edge"], CASES["edge93"]):
        codes, lt = _on(card, seq, lens)
        raw, mask = T.minimizer_walk(codes, lt, k, window)
        wraw, wmask = T.minimizer_walk_reference(codes, lt, k, window)
        assert torch.equal(raw, wraw) and torch.equal(mask, wmask)
        # offsets past 2^32: the positions are int64 at any total of bases
        for base in (0, 1 << 33):
            offs = torch.from_numpy(offsets_from_lengths(lens) + base).to(card)
            reps, gpos = T.minimizer_sites(raw, mask, lt, offs, k)
            wreps, wgpos = T.minimizer_sites_reference(wraw, wmask, lt, offs, k)
            got = torch.stack([reps, gpos], 1).tolist()
            assert sorted(got) == sorted(torch.stack([wreps, wgpos], 1).tolist())


def test_genome_batch_against_oracles(card):
    seq, lens = CASES["genome"]
    u, c = T.count_kmers(seq, lens, 15, device=card)
    ou, oc = count_kmers_oracle(seq, lens, 15)
    assert np.array_equal(u, ou) and np.array_equal(c, oc)
    assert T.count_kmers_stats(seq, lens, 15, device=card) == (len(ou), int(oc.sum()))
    raw, mask = T.minimizer_mask(seq, lens, k=15, window=5, device=card)
    raw, mask = raw.cpu().numpy(), mask.cpu().numpy()
    for b in range(8):
        got = [(int(p), int(raw[b, p])) for p in np.nonzero(mask[b])[0]]
        assert got == sorted(yield_minimizers_oracle(seq[b, :lens[b]], 15, 5))


def test_indexes_match_cpu(card):
    seq, lens = CASES["genome"]
    for build, kw in ((T.build_index_minimizers, dict(k=15, window=5, repeat_kmer_rate=2.0)),
                      (T.build_index_uneven_coverage, dict(k=15, repeat_kmer_rate=100.0))):
        got, want = build(seq, lens, **kw, device=card), build(seq, lens, **kw, device="cpu")
        for f in ("kmers", "offsets", "positions", "repetitive", "mean_frequency"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("use_min", [0, 1])
def test_cli_card_equals_cpu(card, use_min, tmp_path, capfd):
    seq, lens = CASES["edge"]
    fa, cfg = tmp_path / "r.fa", tmp_path / "k.cfg"
    write_fasta(fa, seq, lens)
    cfg.write_text(f"use_minimizers={use_min}\n")
    out = []
    for dev in ("cuda", "cpu"):
        torch_cli_main(["kmer-cnt", "--reads", str(fa), "--config", str(cfg), "--kmer", "5",
                        "--device", dev])
        out.append(capfd.readouterr().err.split("sec")[1])
    assert out[0] == out[1]
