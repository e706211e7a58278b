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

from torch_kmer_cases import (KS, WINDOWS, batch_of, canon_sweep_batches, edge_batch,
                              FREQ_WINDOW, freq_tile_cases, genome_reads, keys_of_runs,
                              poly_a_batch, runs_view_cases, short_runs, site_cases,
                              write_fasta)

pytestmark = pytest.mark.cuda
TILE = 2048                 # positions a tile of gb_kmer_minimizers (csrc/kmer.cu kMinTile)
CASES = {"edge": edge_batch(), "edge93": edge_batch(93),
         "genome": genome_reads(64, 3_000, genome_len=40_000, seed=9)}
FREQ_CASES = freq_tile_cases()
SITE_CASES = site_cases()


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


@pytest.mark.parametrize("k", [1, 2, 15, 16])
def test_canonical_at_every_byte_offset(card, k):
    """The codes as a view at byte offsets 0-15 of a larger buffer on the
    card, rows of odd L and shorter than the kernel's 16-position unit,
    lengths 0, k - 1, k, k + 1 and L, N and codes 5-255 at every slot of a
    packed byte: both modes bit for bit."""
    for label, (seq, lens) in canon_sweep_batches(k).items():
        B, L = seq.shape
        lt = torch.from_numpy(lens).to(card)
        buf = torch.from_numpy(np.random.default_rng(k).integers(0, 256, B * L + 64)
                               .astype(np.uint8)).to(card)
        for off in range(16):
            codes = buf[off:off + B * L].view(B, L)
            codes.copy_(torch.from_numpy(seq))
            assert codes.data_ptr() % 16 == off
            for mode in (T.MODE_CODES, T.MODE_PACK_CODES):
                got = T.canonical_keys(codes, lt, k, mode)
                want = T.canonical_keys_reference(codes, lt, k, mode)
                assert torch.equal(got, want), (label, off, mode)
    torch.cuda.synchronize()


def test_poly_a_freqs_saturate(card):
    seq, lens = poly_a_batch()
    codes, lt = _on(card, seq, lens)
    s, order = torch.sort(T.canonical_keys(codes, lt, 15))
    f, sat = T.kmer_freqs(s, order)
    wf, wsat = T.kmer_freqs_reference(s, order)
    assert torch.equal(f, wf) and int(sat) == int(wsat) == 1
    assert T.count_kmers(seq, lens, 15, device=card)[1].max() == 69_985


@pytest.mark.parametrize("case", sorted(FREQ_CASES))
def test_freqs_and_runs_at_tile_edges(card, case):
    """gb_kmer_freqs' tile edges (runs ending one slot before, at and after
    them), a run over several whole tiles, sentinel-only tiles, runs of
    0xFFFE, 0xFFFF and 69,985 keys (the saturation flag), n of 1, below a
    tile and not a multiple of one: the frequencies, the flag and the run
    count bit for bit."""
    s, order = (torch.from_numpy(a).to(card) for a in FREQ_CASES[case])
    f, sat = T.kmer_freqs(s, order)
    wf, wsat = T.kmer_freqs_reference(s, order)
    assert torch.equal(f, wf) and torch.equal(sat, wsat)
    assert int(sat) == (case in ("poly_a", "at_saturation"))
    assert torch.equal(T.kmer_runs(s), T.kmer_runs_reference(s))


def test_freqs_across_windows(card):
    """Keys of 2.5 of the kernel's store windows (three passes), runs of
    1-40 and a long run across the first window edge, against the plain
    version on a random permutation."""
    n = FREQ_WINDOW * 5 // 2
    s = keys_of_runs(short_runs(FREQ_WINDOW - 5_000, 1, longest=40) + [90_000]
                     + short_runs(n - FREQ_WINDOW - 85_000, 2, longest=40), seed=3)
    order = np.random.default_rng(4).permutation(n)
    s, order = torch.from_numpy(s).to(card), torch.from_numpy(order).to(card)
    f, sat = T.kmer_freqs(s, order)
    wf, wsat = T.kmer_freqs_reference(s, order)
    assert torch.equal(f, wf) and torch.equal(sat, wsat) and int(sat) == 1


def test_freqs_unaligned_views(card):
    """Keys and permutation as views one slot into their buffers (not
    16-byte aligned: the kernel's one-at-a-time loads)."""
    s, order = FREQ_CASES["odd"]
    sb = torch.from_numpy(np.concatenate([[0], s]).astype(np.int32)).to(card)
    ob = torch.from_numpy(np.concatenate([[0], order]).astype(np.int64)).to(card)
    for sv, ov in ((sb[1:], ob[1:]), (sb[1:], torch.from_numpy(order).to(card)),
                   (torch.from_numpy(s).to(card), ob[1:])):
        f, sat = T.kmer_freqs(sv, ov)
        wf, wsat = T.kmer_freqs_reference(sv, ov)
        assert torch.equal(f, wf) and torch.equal(sat, wsat)


@pytest.mark.parametrize("off", [0, 4, 8, 12])
def test_runs_views_match_plain(card, off):
    """gb_kmer_runs on views s[j:] of sorted keys on the card: byte offsets
    0, 4, 8 and 12 from a 16-byte boundary, n 1-70 and around a warp's
    chunk; and the tile cases' keys from the same offsets."""
    buf, views = runs_view_cases()
    b = torch.from_numpy(buf).to(card)
    assert b.data_ptr() % 16 == 0
    for o, n in views:
        if o == off:
            v = b[off // 4:off // 4 + n]
            assert torch.equal(T.kmer_runs(v), T.kmer_runs_reference(v)), n
    for case, (s, _) in FREQ_CASES.items():
        v = torch.from_numpy(s).to(card)[off // 4:]
        assert torch.equal(T.kmer_runs(v), T.kmer_runs_reference(v)), case


@pytest.mark.parametrize("window", WINDOWS + (63, 64, 70))
@pytest.mark.parametrize("k", KS)
def test_minimizers_and_sites_match_plain(card, k, window):
    """Windows longer than a 96-base read among them."""
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


@pytest.mark.parametrize("case", sorted(SITE_CASES))
def test_sites_at_every_mask_offset(card, case):
    """gb_kmer_sites on masks at byte offsets 0-15 and raw planes at both
    8-byte phases, rows of 1 to 20,000, no sites, every site, offsets past
    2^33: its pairs == the plain version's, sorted."""
    raw, mask, lengths, offsets, k = SITE_CASES[case]
    B, L = raw.shape
    N = B * L
    lt, offs = torch.from_numpy(lengths).to(card), torch.from_numpy(offsets).to(card)
    want = T.minimizer_sites_reference(*map(torch.from_numpy, (raw, mask, lengths, offsets)), k)
    want = sorted(torch.stack(want, 1).tolist())
    mbuf = torch.zeros(N + 16, dtype=torch.bool, device=card)
    rbuf = torch.zeros(N + 1, dtype=torch.int64, device=card)
    for sh in range(16):
        m = mbuf[sh:sh + N].view(B, L)
        m.copy_(torch.from_numpy(mask))
        for phase in (0, 1):
            r = rbuf[phase:phase + N].view(B, L)
            r.copy_(torch.from_numpy(raw))
            reps, gpos = T.minimizer_sites(r, m, lt, offs, k)
            assert sorted(torch.stack([reps, gpos], 1).tolist()) == want, (sh, phase)


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


def _walk_equal(dev, seq, lens, k, window):
    codes, lt = _on(dev, seq, lens)
    raw, mask = T.minimizer_walk(codes, lt, k, window)
    wraw, wmask = T.minimizer_walk_reference(codes, lt, k, window)
    assert torch.equal(raw, wraw) and torch.equal(mask, wmask), (k, window)


@pytest.mark.parametrize("window", [1, 2, 5, 10, 70])
def test_minimizer_tile_edges(card, window):
    """Reads whose last k-mer, and whose length, fall at every offset of
    the window around the kernel's tile edges (TILE positions a tile), over
    random sequence, a homopolymer and a dinucleotide repeat, with random
    codes 0..4 past each read."""
    rng = np.random.default_rng(window)
    reads = []
    for edge in (TILE, 2 * TILE):
        for d in range(-window - 1, window + 2):
            n = max(0, edge + 15 + d)
            reads += [rng.integers(0, 4, n).astype(np.uint8), np.zeros(n, np.uint8),
                      np.tile(np.array([0, 1], np.uint8), n // 2 + 1)[:n]]
    seq, lens = batch_of(reads, pad=4, seed=window)
    _walk_equal(card, seq, lens, 15, window)


def test_minimizer_long_read(card):
    """A 100,000-base read (49 tiles) beside a poly-A read of the same
    length and a short read, at Flye's window."""
    rng = np.random.default_rng(3)
    seq, lens = batch_of([rng.integers(0, 4, 100_000).astype(np.uint8),
                          np.zeros(100_000, np.uint8), rng.integers(0, 4, 900).astype(np.uint8)])
    _walk_equal(card, seq, lens, 15, 5)


def test_minimizer_periodic_all_windows(card):
    """Periodic sequence (periods 1, 2, 3 and 5), where many hashes tie and
    the front is path dependent, across one tile edge, at every window
    from 1 to 70."""
    rng = np.random.default_rng(8)
    reads = []
    for period in (1, 2, 3, 5):
        unit = rng.integers(0, 4, period).astype(np.uint8)
        reads += [np.tile(unit, 2200 // period + 1)[:n] for n in (2200, TILE + 14)]
    seq, lens = batch_of(reads)
    for window in range(1, 71):
        _walk_equal(card, seq, lens, 15, window)


@pytest.mark.parametrize("window", [T.MIN_SHARED_WINDOW, T.MIN_SHARED_WINDOW + 1, 3000])
def test_minimizer_scratch_windows(card, window):
    """Windows past MIN_SHARED_WINDOW read the hashes from the device
    scratch; the last window that reads them from shared memory beside it."""
    rng = np.random.default_rng(window)
    seq, lens = batch_of([rng.integers(0, 4, 6000).astype(np.uint8), np.zeros(5000, np.uint8),
                          np.tile(np.array([0, 1, 1], np.uint8), 1500)], pad=4)
    _walk_equal(card, seq, lens, 15, window)
