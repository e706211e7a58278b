"""The kmer-cnt port (genomicsbench_tpu_torch.ops.kmer) against the JAX
package, on the CPU.

The same numpy inputs (tests/torch_kmer_cases.py) go through the JAX
function and the port's plain PyTorch versions; every comparison is exact
(integers; mean_frequency equal as a float).  The NumPy oracles (the count
by Horner roll and np.unique, yield_minimizers_oracle) are a second witness
on reads of codes 0..3.  The JAX package's kmer-cnt CLI raises in minimizer
mode (it sums the (raw, mask) pair, genomicsbench_tpu/cli.py:208-212), so
the port's CLI is held against `minimizer_mask(...)[1].sum()` there.
"""

import contextlib
import dataclasses
import gzip
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomicsbench_tpu.ops.kmer as J
from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.config import KmerParams as JaxKmerParams
from genomicsbench_tpu.config import load_keyvalue_config as jax_load_config
from genomicsbench_tpu.io.seqio import load_fastx_batch as jax_load_fastx
from genomicsbench_tpu.utils import offsets_from_lengths as jax_offsets

import genomicsbench_tpu_torch.ops.kmer as T
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.config import (KmerParams, kmer_params_from_dict,
                                            load_keyvalue_config)
from genomicsbench_tpu_torch.io.seqio import load_fastx_batch
from genomicsbench_tpu_torch.oracle.kmer import count_kmers_oracle, yield_minimizers_oracle
from genomicsbench_tpu_torch.utils import offsets_from_lengths

from torch_kmer_cases import (KS, WINDOWS, batch_of, edge_batch, genome_reads,
                              planted_minimizer_case, planted_uneven_case, poly_a_batch,
                              write_fasta)

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them
torch.set_num_threads(1)

EDGE = edge_batch()
GENOME = genome_reads(48, 1_500, genome_len=30_000, seed=5)
CPU = "cpu"


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _index_equal(a, b):
    for f in dataclasses.fields(J.MinimizerIndex):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "mean_frequency":
            assert type(x) is type(y) is float and x == y, (x, y)
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name


# ----------------------------------------------------------------- primitives
@pytest.mark.parametrize("k", KS)
def test_primitives_equal_jax(k):
    seq, _ = EDGE
    raw = np.asarray(J.extract_kmers(jnp.asarray(seq), k))
    assert np.array_equal(_np(T.extract_kmers(seq, k, device=CPU)), raw)
    assert np.array_equal(_np(T.revcomp(raw, k, device=CPU)), np.asarray(J.revcomp(raw, k)))
    can = np.asarray(J.canonical(jnp.asarray(raw), k))
    assert np.array_equal(_np(T.canonical(raw, k, device=CPU)), can)
    hi, lo = J.splitmix_hash(jnp.asarray(can))
    thi, tlo = T.splitmix_hash(can, device=CPU)
    assert np.array_equal(_np(thi), np.asarray(hi)) and np.array_equal(_np(tlo), np.asarray(lo))
    lens = EDGE[1]
    assert np.array_equal(_np(T.kmer_valid(lens, seq.shape[1], k, device=CPU)),
                          np.asarray(J.kmer_valid(jnp.asarray(lens), seq.shape[1], k)))


def test_pack_and_unpack_equal_jax():
    seq, _ = EDGE
    for width in (seq.shape[1], 93):        # a width that is not a multiple of 4
        codes = np.ascontiguousarray(seq[:, :width])
        packed = T.pack_codes_2bit(codes)
        assert np.array_equal(packed, J.pack_codes_2bit(codes))
        assert np.array_equal(_np(T._unpack_codes_2bit(packed, width, device=CPU)),
                              np.asarray(J._unpack_codes_2bit(jnp.asarray(packed), width)))
        assert np.array_equal(_np(T._pack_codes_torch(torch.from_numpy(codes))), packed)


@pytest.mark.parametrize("k", KS)
def test_canonical_keys_equal_jax(k):
    """The key plane in each input mode: codes as given (N carries) and
    codes read through their packed bytes, against JAX's `_canonical_kmers`
    of the codes and of `_unpack_codes_2bit` of `pack_codes_2bit`."""
    seq, lens = EDGE
    km, ok = J._canonical_kmers(jnp.asarray(seq), jnp.asarray(lens), k=k)
    keys, tok = T._canonical_kmers(seq, lens, k=k, device=CPU)
    assert keys.dtype == torch.int32
    assert np.array_equal(T.keys_to_u32(keys), np.asarray(km))
    assert np.array_equal(_np(tok), np.asarray(ok))
    B, L = seq.shape
    packed = J.pack_codes_2bit(seq)
    want, _ = J._canonical_kmers(J._unpack_codes_2bit(jnp.asarray(packed), L),
                                 jnp.asarray(lens), k=k)
    got = T.canonical_keys(torch.from_numpy(seq), torch.from_numpy(lens), k, T.MODE_PACK_CODES)
    assert np.array_equal(T.keys_to_u32(got).reshape(B, L), np.asarray(want))


# ------------------------------------------------------------------- counts
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", ["edge", "genome"])
def test_counts_equal_jax(case, k):
    seq, lens = EDGE if case == "edge" else GENOME
    u, c = J.count_kmers(seq, lens, k)
    tu, tc = T.count_kmers(seq, lens, k, device=CPU)
    assert tu.dtype == u.dtype and tc.dtype == c.dtype
    assert np.array_equal(tu, u) and np.array_equal(tc, c)
    assert T.count_kmers_stats(seq, lens, k, device=CPU) == J.count_kmers_stats(seq, lens, k)
    if case == "genome":                    # codes 0..3: the oracle too
        ou, oc = count_kmers_oracle(seq, lens, k)
        assert np.array_equal(tu, ou) and np.array_equal(tc, oc)


def test_stats_and_counts_read_n_apart_as_jax_does():
    """count_kmers adds an N's 4 into the next 2-bit group, count_kmers_stats
    packs it into the next slot of its byte: on reads with N their k-mers
    differ (each equals its JAX twin, held above), on codes 0..3 they agree."""
    seq, lens = EDGE
    lt = torch.from_numpy(lens)
    keys = [T.canonical_keys(torch.from_numpy(c), lt, 15, mode)
            for c, mode in ((seq, T.MODE_CODES), (seq, T.MODE_PACK_CODES),
                            (np.minimum(seq, 3), T.MODE_CODES),
                            (np.minimum(seq, 3), T.MODE_PACK_CODES))]
    assert not torch.equal(keys[0], keys[1]) and torch.equal(keys[2], keys[3])
    assert torch.equal(keys[0] == T.SENTINEL_KEY, keys[1] == T.SENTINEL_KEY)


def test_kmer_runs_of_sorted_keys():
    keys = torch.tensor([-5, -5, 0, 3, 3, 3, T.SENTINEL_KEY, T.SENTINEL_KEY], dtype=torch.int32)
    assert T.kmer_runs(keys).tolist() == [3, 6]
    assert T.kmer_runs(torch.full((3,), T.SENTINEL_KEY, dtype=torch.int32)).tolist() == [0, 0]
    assert T.kmer_runs(torch.zeros(0, dtype=torch.int32)).tolist() == [0, 0]


@pytest.mark.parametrize("k", KS)
def test_per_position_freqs_equal_jax(k):
    seq, lens = EDGE
    plane, sat = J._per_position_freqs(jnp.asarray(seq), jnp.asarray(lens), k=k)
    tp, tsat = T._per_position_freqs(seq, lens, k=k, device=CPU)
    assert tp.dtype == torch.uint16 and tp.shape == seq.shape
    assert np.array_equal(_np(tp), np.asarray(plane)) and tsat is bool(sat) is False


def test_per_position_freqs_saturate_on_poly_a():
    """A 70,000-base poly-A read: one canonical 15-mer 69,985 times, clipped
    to 0xFFFF with the flag set; then the uneven index counts by table."""
    seq, lens = poly_a_batch()
    plane, sat = J._per_position_freqs(jnp.asarray(seq), jnp.asarray(lens), k=15)
    tp, tsat = T._per_position_freqs(seq, lens, k=15, device=CPU)
    assert bool(sat) and tsat
    assert np.array_equal(_np(tp), np.asarray(plane)) and int(_np(tp).max()) == 0xFFFF
    u, c = J.count_kmers(seq, lens, 15)
    tu, tc = T.count_kmers(seq, lens, 15, device=CPU)
    assert np.array_equal(tu, u) and np.array_equal(tc, c) and c.max() == 69_985


# --------------------------------------------------------------- minimizers
def _oracle_rows(seq, lens):
    return [b for b in range(len(lens)) if seq[b, :lens[b]].max(initial=0) <= 3]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("k", KS)
def test_minimizer_mask_equal_jax(k, window):
    seq, lens = EDGE
    raw, mask = J.minimizer_mask(jnp.asarray(seq), jnp.asarray(lens), k=k, window=window)
    traw, tmask = T.minimizer_mask(seq, lens, k=k, window=window, device=CPU)
    assert traw.dtype == torch.int64 and tmask.dtype == torch.bool
    assert np.array_equal(_np(traw), np.asarray(raw))
    assert np.array_equal(_np(tmask), np.asarray(mask))
    for b in _oracle_rows(seq, lens):       # codes 0..3: the oracle's rolling reps agree
        want = sorted(yield_minimizers_oracle(seq[b, :lens[b]], k, window))
        got = [(int(p), int(traw[b, p])) for p in np.nonzero(_np(tmask[b]))[0]]
        assert got == want, b


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("k", KS)
def test_minimizer_sites_sorted_equal_jax(k, window):
    seq, lens = EDGE
    reps, gpos, n = J._minimizer_sites_sorted(jnp.asarray(seq), jnp.asarray(lens), k=k,
                                              window=window)
    n = int(n)
    treps, tgpos, tn = T._minimizer_sites_sorted(seq, lens, k=k, window=window, device=CPU)
    assert tn == n and n > 0
    assert np.array_equal(_np(treps), np.asarray(reps)[:n].astype(np.int64))
    assert np.array_equal(_np(tgpos), np.asarray(gpos)[:n].astype(np.int64))
    # the planes of JAX's `_minimizer_sites`, which gb_kmer_sites computes
    # in place of the site build: the walk's raw plane through `_site_planes`
    lt = torch.from_numpy(lens)
    raw, mask = T.minimizer_walk(torch.from_numpy(seq), lt, k, window)
    planes = J._minimizer_sites(jnp.asarray(seq), jnp.asarray(lens), k=k, window=window)
    for got, want in zip((*T._site_planes(raw, lt, k), mask), planes):
        assert np.array_equal(_np(got), np.asarray(want))     # canon, pos_std, mask


def test_minimizer_sites_sorted_genome_equal_jax():
    """The two stable sorts (by gpos, then by rep) give JAX's lexsort order
    on a genome-sampled batch, where most k-mers have many sites."""
    seq, lens = GENOME
    reps, gpos, n = J._minimizer_sites_sorted(jnp.asarray(seq), jnp.asarray(lens), k=15,
                                              window=5)
    stats = {}
    treps, tgpos, tn = T._minimizer_sites_sorted(seq, lens, k=15, window=5, device=CPU,
                                                 stats=stats)
    assert tn == int(n) == stats["sites_n"]
    assert np.array_equal(_np(treps), np.asarray(reps)[:tn].astype(np.int64))
    assert np.array_equal(_np(tgpos), np.asarray(gpos)[:tn].astype(np.int64))


# ------------------------------------------------------------------- indexes
@pytest.mark.parametrize("case", ["planted", "genome", "no_sites"])
def test_build_index_minimizers_equal_jax(case):
    if case == "planted":
        seq, lens, kw = planted_minimizer_case()
    elif case == "genome":
        (seq, lens), kw = GENOME, dict(k=15, window=5, repeat_kmer_rate=2.0)
    else:                                   # every read shorter than k + 1
        seq, lens = EDGE[0][:8], EDGE[1][:8]
        kw = dict(k=15, window=5)
    want = J.build_index_minimizers(seq, lens, **kw)
    stats = {}
    got = T.build_index_minimizers(seq, lens, **kw, device=CPU, stats=stats)
    _index_equal(got, want)
    assert (len(want.kmers) > 0 and len(want.repetitive) > 0) == (case != "no_sites")
    assert set(stats) == {"upload", "walk", "sites", "sort", "sites_n", "fetch", "host"}


@pytest.mark.parametrize("case", ["planted", "genome", "ambiguous", "poly_a", "no_kmers"])
def test_build_index_uneven_coverage_equal_jax(case):
    """The plane route (codes 0..3, no count at 0xFFFF) and the table route
    (an N in the batch; the poly-A read's saturated count); reads shorter
    than k + 1 give an empty index."""
    kw = dict(k=15, global_min_freq=2, select_rate=0.05, tandem_freq=10,
              repeat_kmer_rate=100.0)
    route = "table"
    if case == "planted":
        seq, lens, kw = planted_uneven_case()
        route = "plane"
    elif case == "genome":
        seq, lens = GENOME
        route = "plane"
    elif case == "ambiguous":
        seq, lens = EDGE
        kw.update(k=5, select_rate=0.3)
    elif case == "poly_a":
        seq, lens = poly_a_batch()
    else:
        seq, lens = np.minimum(EDGE[0][:8], 3), EDGE[1][:8]
        route = "plane"
    want = J.build_index_uneven_coverage(seq, lens, **kw)
    stats = {}
    got = T.build_index_uneven_coverage(seq, lens, **kw, device=CPU, stats=stats)
    _index_equal(got, want)
    assert stats["route"] == route and (len(want.kmers) > 0) == (case != "no_kmers")


def test_yield_frequent_kmers_equal_jax():
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 4, 300).astype(np.uint8)
    freq_map = {}

    def lookup(reps):
        return np.array([freq_map.setdefault(int(r), int(r) % 7) for r in reps], np.int64)

    for k, rate, tandem in ((7, 0.1, 0), (9, 0.3, 2), (15, 0.02, 10)):
        want = J.yield_frequent_kmers(seq, 300, k, lookup, rate, tandem)
        got = T.yield_frequent_kmers(seq, 300, k, lookup, rate, tandem)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------- host parts
def test_config_and_offsets_equal_jax(tmp_path):
    (tmp_path / "base.cfg").write_text("kmer_size = 17 ; comment\nuse_minimizers=false\n"
                                       "minimizer_window=7\nratio=0.5\n")
    (tmp_path / "m.cfg").write_text('%include "base.cfg"\n# note\nkmer_size=13\nname=x\n')
    assert load_keyvalue_config(tmp_path / "m.cfg") == jax_load_config(tmp_path / "m.cfg")
    for fields in ({}, dict(kmer_size=11, use_minimizers=False, minimizer_window=9)):
        d = dataclasses.asdict(JaxKmerParams(**fields))
        assert dataclasses.asdict(kmer_params_from_dict(d)) == d
    assert KmerParams() == kmer_params_from_dict(dataclasses.asdict(JaxKmerParams()))
    lens = np.array([3, 0, 10_000, 7], np.int32)
    for total in (False, True):
        a, b = offsets_from_lengths(lens, total), jax_offsets(lens, total)
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)


def test_load_fastx_batch_codes_n_as_4(tmp_path):
    """The port's loader gives the JAX package's batch: ACGT (either case)
    0..3, N and every other letter 4, also through gzip."""
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTNacgtn\nRYK\n>b\nNNNN\n>c\nGATTACA\n")
    fq = tmp_path / "r.fq.gz"
    with gzip.open(fq, "wt") as f:
        f.write("@a\nACGTN\n+\nIIIII\n@b\nnnA\n+\nIII\n")
    for path in (fa, fq):
        got, want = load_fastx_batch(path), jax_load_fastx(path)
        assert np.array_equal(got.codes, want.codes)
        assert np.array_equal(got.lengths, want.lengths) and got.names == want.names
    assert load_fastx_batch(fa).codes[0, :13].tolist() == [0, 1, 2, 3, 4] * 2 + [4, 4, 4]


# ---------------------------------------------------------------------- CLI
def _cli_err(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        main(argv)
    return err.getvalue()


@pytest.mark.parametrize("mode", ["count", "minimizers", "debug"])
def test_cli_kmer_cnt_equal_jax(mode, tmp_path):
    seq, lens = batch_of([EDGE[0][i, :EDGE[1][i]] for i in range(len(EDGE[1]))]
                         + list(GENOME[0][:4]))
    fa = tmp_path / "reads.fa"
    write_fasta(fa, seq, lens)
    cfg = tmp_path / "kmer.cfg"
    use_min = int(mode == "minimizers")
    cfg.write_text(f"kmer_size=15\nuse_minimizers={use_min}\nminimizer_window=4\n")
    argv = ["kmer-cnt", "--reads", str(fa), "--config", str(cfg), "--kmer", "13"]
    if mode == "debug":
        argv.append("--debug")
    err = _cli_err(torch_cli_main, argv + ["--device", "cpu"])
    if use_min:
        _, mask = J.minimizer_mask(jnp.asarray(seq), jnp.asarray(lens), k=13, window=4)
        n = int(np.asarray(mask).sum())
        assert re.fullmatch(rf"Kernel time: \d+\.\d{{3}} sec  minimizers: {n}\n", err), err
        with pytest.raises(AttributeError):     # the JAX CLI's own fault, not copied
            _cli_err(jax_cli_main, argv)
        return
    jax_err = _cli_err(jax_cli_main, argv)
    tail = re.compile(r"Kernel time: \d+\.\d{3} sec  (unique kmers: \d+  total: \d+)\n$")
    assert tail.search(err).group(1) == tail.search(jax_err).group(1)
    u, t = J.count_kmers_stats(seq, lens, 13)
    assert f"unique kmers: {u}  total: {t}" in err
    if mode == "debug":
        pat = r"\[\d\d:\d\d:\d\d\] \[DEBUG  \] config: (.*)\n"
        assert re.match(pat, err).group(1) == re.match(pat, jax_err).group(1)
