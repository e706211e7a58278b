"""The PyTorch port's pileup (medaka counts), its BAM/BAI readers and its
host-library copies, against the JAX package on the CPU.

Every JAX call runs with `genomicsbench_tpu.native._load` patched to return
None (the `jax_native_masked` fixture, on every test): the JAX package
builds its native library in place without a lock, which races between
test workers.  JAX then takes its pure-Python routes (the record walk, the
Python BGZF and BAI readers), which its own tests hold equal to its C.  The
port's C copies (native/bam.cpp, native/pileup.cpp) are held against the JAX
package's C another way: genomicsbench_tpu/native/gbingest.cpp is compiled
with its own flags into a temporary directory and the port's wrappers run
on it (`jax_c`).

Every comparison is exact: counts, positions and keys are integers.  The
in-place route returns int32 counts and the other two int64, in both
packages; values are compared.
"""

import contextlib
import ctypes
import io
import subprocess
import types

import numpy as np
import pytest
import torch

import genomicsbench_tpu.native as jax_native
from genomicsbench_tpu.cli import _iter_ref_alignments as jax_iter_ref_alignments
from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.io import bam as JB
from genomicsbench_tpu.ops import pileup as JP

from genomicsbench_tpu_torch import native
from genomicsbench_tpu_torch.cli import _iter_ref_alignments, main as torch_cli_main
from genomicsbench_tpu_torch.io import bam as B
from genomicsbench_tpu_torch.ops import pileup as P

import torch_pileup_cases as C

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_native_masked(monkeypatch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)


@pytest.fixture(scope="module")
def jax_c(tmp_path_factory):
    """The JAX package's native source compiled as its loader compiles it,
    with the port's argument types bound: a stand-in for native.load()."""
    d = tmp_path_factory.mktemp("gbingest")
    so = d / "libgbingest.so"
    subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", str(jax_native._SRC),
                    "-o", str(so), "-lz", "-pthread"], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for _, entries in native.SOURCES.values():
        for name, (restype, argtypes) in entries.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
                fns[name] = fn
    return types.SimpleNamespace(**fns)


@contextlib.contextmanager
def on_library(monkeypatch, lib):
    """Run the port's wrappers on `lib` in place of the port's own library."""
    with monkeypatch.context() as m:
        m.setattr(native, "load", lambda: lib)
        yield


def _files(tmp_path, records, ref_len, name="x"):
    path = str(tmp_path / f"{name}.bam")
    C.write_indexed(path, records, ref_len)
    return path


def _same_result(got, want):
    assert np.array_equal(got.major, want.major) and np.array_equal(got.minor, want.minor)
    assert got.matrix.shape == want.matrix.shape
    assert np.array_equal(got.matrix, want.matrix)
    assert got.text() == want.text()


RANDOM = [(0, 60, 600, False), (1, 900, 5000, True), (2, 60, 600, False), (5, 900, 5000, True)]


@pytest.fixture(scope="module")
def random_bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("random_bams")
    out = {}
    for seed, n, ref_len, big in RANDOM:
        recs = C.random_records(seed, n_rec=n, ref_len=ref_len, big=big)
        out[seed] = (C.write_indexed(str(d / f"r{seed}.bam"), recs, ref_len), ref_len)
    return out


# ------------------------------------------------------------ host library
@pytest.mark.parametrize("seed", [s for s, *_ in RANDOM])
def test_bam_parse_matches_jax_c(seed, random_bams, jax_c, monkeypatch):
    """gb_bam_parse's every SoA field, from the record stream's start and
    from a record in the middle."""
    path, _ = random_bams[seed]
    with open(path, "rb") as f:
        raw = B.bgzf_decompress(f.read())
    _, _, off = B._parse_header(raw)
    mid = int(native.bam_parse(raw, off)["tag_end"][10])
    for start in (off, mid, len(raw)):
        got = native.bam_parse(raw, start)
        with on_library(monkeypatch, jax_c):
            want = native.bam_parse(raw, start)
        assert got["n_rec"] == want["n_rec"]
        for name, dtype in native._SOA_FIELDS:
            assert got[name].dtype == dtype and np.array_equal(got[name], want[name]), name
    assert native.bam_parse(raw, off)["n_rec"] == len(B.read_bam(path).records)


@pytest.mark.parametrize("seed", [s for s, *_ in RANDOM])
def test_pileup_walks_match_jax_c(seed, random_bams, jax_c, monkeypatch):
    """gb_pileup_events as a sorted event multiset (equal to the per-record
    walk's), and gb_pileup_extents/gb_pileup_accumulate's matrix."""
    path, ref_len = random_bams[seed]
    ib = B.IndexedBam(path)
    for start, end in ((0, ref_len), (100, 250), (37, 41)):
        chunks = [(soa, hit) for soa, _, hit in ib.fetch_soa_chunks("chr1", start, end)]
        def events():
            return sorted(e for soa, hit in chunks for e in zip(
                *(a.tolist() for a in native.pileup_events(soa, hit, start, end))))

        got = events()
        with on_library(monkeypatch, jax_c):
            want = events()
            want_m = native.pileup_matrix(chunks, start, end, 5)
        walk = []
        for rec in B.read_bam(path).fetch("chr1", start, end):
            walk += list(zip(*(a.tolist() for a in P._read_events(rec, start, end, 1)[:4])))
        assert got == want == sorted(walk) and (len(got) > 100 or end - start < 200)
        for a, b in zip(native.pileup_matrix(chunks, start, end, 5), want_m):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_host_wrappers_check_rows():
    raw = b"BAM\x01" + bytes(8)
    with pytest.raises(ValueError, match="offset"):
        native.bam_parse(raw, 100)
    soa = native.bam_parse(raw, len(raw))
    with pytest.raises(ValueError, match="record rows"):
        native.pileup_events(soa, np.array([0]), 0, 10)
    with pytest.raises(ValueError, match="num_homop"):
        native.pileup_matrix([], 0, 10, 0)


# ----------------------------------------------------------------- BAM I/O
@pytest.mark.parametrize("case", ["random0", "random1", "random5", "mixed"])
def test_write_bai_bytes_match_jax(case, tmp_path):
    if case == "mixed":
        ref, recs = C.mixed_records(20_000, coverage=10)
        ref_len = len(ref)
    else:
        seed = int(case[-1])
        _, n, ref_len, big = next(r for r in RANDOM if r[0] == seed)
        recs = C.random_records(seed, n_rec=n, ref_len=ref_len, big=big)
    path = C.write_indexed(str(tmp_path / "x.bam"), recs, ref_len)
    with open(path, "rb") as f:
        data = f.read()
    assert len(B._bgzf_blocks(data)) > (2 if case in ("random1", "mixed") else 1)
    with open(path + ".bai", "rb") as f:
        mine = f.read()
    JB.write_bai(path)
    with open(path + ".bai", "rb") as f:
        assert f.read() == mine
    assert B.read_bai(path + ".bai") == JB.read_bai(path + ".bai")


def _rec_tuple(r):
    return (r.name, r.flag, r.ref_id, r.pos, r.mapq, tuple(r.cigar), r.seq.tobytes(),
            r.qual.tobytes(), r.tags, r.end_pos())


@pytest.mark.parametrize("seed", [s for s, *_ in RANDOM])
def test_indexed_fetch_matches_whole_file_and_jax(seed, random_bams):
    """IndexedBam.fetch and fetch_soa_chunks give read_bam(...).fetch's
    records in its order, and the JAX package's IndexedBam's."""
    path, ref_len = random_bams[seed]
    ib, jib, whole = B.IndexedBam(path), JB.IndexedBam(path), B.read_bam(path)
    assert (ib.ref_names, ib.ref_lens) == (jib.ref_names, jib.ref_lens) == (["chr1"], [ref_len])
    for start, stop in ((0, ref_len), (100, 250), (37, 41), (ref_len - 5, ref_len + 50)):
        got = [_rec_tuple(r) for r in ib.fetch("chr1", start, stop)]
        soa_rows = [_rec_tuple(r) for soa, buf, hit in ib.fetch_soa_chunks("chr1", start, stop)
                    for r in B._records_from_soa(soa, buf, hit)]
        assert got == soa_rows == [_rec_tuple(r) for r in whole.fetch("chr1", start, stop)]
        assert got == [_rec_tuple(r) for r in jib.fetch("chr1", start, stop)]


def test_fasta_index_matches_jax(tmp_path):
    codes = np.random.default_rng(4).integers(0, 5, 1234).astype(np.uint8)
    path = C.write_fasta(str(tmp_path / "g.fa"), "chr7", codes)
    with open(path, "a") as f:
        f.write(">chrM desc\nacgtnNRY\n")
    fa, jfa = B.FastaIndex(path), JB.FastaIndex(path)
    for name, s, e in (("chr7", 0, 1234), ("chr7", 100, 180), ("chr7", 1200, 2000),
                       ("chrM", 0, 8)):
        assert np.array_equal(fa.fetch(name, s, e), jfa.fetch(name, s, e))
        assert fa.length(name) == jfa.length(name)
    assert np.array_equal(fa.fetch("chr7", 0, 1234), codes)


# -------------------------------------------------------------- pileup
def _jax_reader(path, indexed):
    return JB.IndexedBam(path) if indexed else JB.read_bam(path)


def _three_routes(path, region, H, jax_indexed=True):
    """The port's three routes on one file, each against JAX's
    pileup_counts; the event route's plane 0 against the in-place matrix."""
    ib, bf = B.IndexedBam(path), B.read_bam(path)
    jr = _jax_reader(path, jax_indexed)
    in_place = P.pileup_counts(ib, region, num_homop=H)
    assert in_place.matrix.dtype == np.int32
    _same_result(in_place, JP.pileup_counts(jr, region, num_homop=H))
    events = P.pileup_counts(ib, region, num_dtypes=2, num_homop=H)
    _same_result(events, JP.pileup_counts(jr, region, num_dtypes=2, num_homop=H))
    assert np.array_equal(events.matrix[:, :10 * H], in_place.matrix)
    assert not events.matrix[:, 10 * H:].any()
    records = P.pileup_counts(bf, region, num_homop=H)
    assert records.matrix.dtype == np.int64
    _same_result(records, in_place)

    def dtype_of(r):
        return int(r.is_reverse)

    for reader in (bf, ib):
        got = P.pileup_counts(reader, region, num_dtypes=2, num_homop=H, dtype_of=dtype_of)
        _same_result(got, JP.pileup_counts(jr, region, num_dtypes=2, num_homop=H,
                                           dtype_of=dtype_of))
    return in_place


@pytest.mark.parametrize("name", sorted(C.edge_sets()))
def test_edge_sets_match_jax(name, tmp_path):
    """tests/test_pileup.py's record sets by all three routes."""
    recs, region, H = C.edge_sets()[name]
    path = _files(tmp_path, recs, 1000)
    got = _three_routes(path, region, H)
    if name == "simple_matches":
        assert got.major.tolist() == [100, 101, 102, 103, 104, 105]
    if name == "empty_region":
        assert got.matrix.shape == (0, 10)


@pytest.mark.parametrize("num_homop", [1, 5])
@pytest.mark.parametrize("seed", [s for s, *_ in RANDOM])
def test_random_bams_match_jax(seed, num_homop, random_bams):
    path, ref_len = random_bams[seed]
    for region in (f"chr1:1-{ref_len}", "chr1:50-320", "chr1:38-41"):
        _three_routes(path, region, num_homop, jax_indexed=region != "chr1:38-41")


@pytest.mark.parametrize("num_homop", [3, 5])
def test_weibull_summation_matches_jax(num_homop, tmp_path):
    recs = C.weibull_records(7)
    path = _files(tmp_path, recs, 400)
    for reader, jreader in ((B.read_bam(path), JB.read_bam(path)),
                            (B.IndexedBam(path), JB.IndexedBam(path))):
        for region in ("chr1:1-400", "chr1:120-200"):
            got = P.pileup_counts(reader, region, num_homop=num_homop, weibull_summation=True)
            _same_result(got, JP.pileup_counts(jreader, region, num_homop=num_homop,
                                               weibull_summation=True))
            assert got.matrix.max() > 1000
            got = P.pileup_counts(reader, region, num_dtypes=2, num_homop=num_homop,
                                  weibull_summation=True, dtype_of=lambda r: r.mapq % 2)
            _same_result(got, JP.pileup_counts(jreader, region, num_dtypes=2,
                                               num_homop=num_homop, weibull_summation=True,
                                               dtype_of=lambda r: r.mapq % 2))


def test_debug_keys_and_count_keys_match_jax_and_bincount(random_bams, monkeypatch):
    """The event route's DEBUG_KEYS, counted by _count_keys (the sort on the
    CPU), equal JAX's _count_keys and np.bincount, and the matrix."""
    path, ref_len = random_bams[1]
    seen = []
    monkeypatch.setattr(P, "DEBUG_KEYS", seen)
    res = P.pileup_counts(B.IndexedBam(path), f"chr1:1-{ref_len}", num_dtypes=2, num_homop=5)
    (keys, size), = seen
    assert size == res.matrix.size
    uniq, counts = P._count_keys(keys, device="cpu")
    juniq, jcounts = JP._count_keys(keys)
    assert np.array_equal(uniq, juniq) and np.array_equal(counts, jcounts)
    hist = np.bincount(keys, minlength=size)
    assert np.array_equal(uniq, np.nonzero(hist)[0]) and np.array_equal(counts, hist[uniq])
    assert np.array_equal(hist, res.matrix.ravel())


@pytest.mark.parametrize("n", [1, 127, 128, 129, 5000])
def test_count_keys_matches_jax(n):
    keys = np.random.default_rng(n).integers(0, 97, n)
    keys[: n // 2] = np.iinfo(np.int32).max - 1
    got, want = P._count_keys(keys, device="cpu"), JP._count_keys(keys)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert int(got[1].sum()) == n


def test_count_keys_edges():
    """An empty input gives empty arrays (JAX's RLE indexes an empty sort
    and raises IndexError); a key at int32's max is refused, where JAX
    fails its assert."""
    got = P._count_keys(np.zeros(0, np.int64), device="cpu")
    assert [len(a) for a in got] == [0, 0]
    with pytest.raises(IndexError):
        JP._count_keys(np.zeros(0, np.int64))
    with pytest.raises(ValueError, match="key space"):
        P._count_keys(np.array([3, np.iinfo(np.int32).max]), device="cpu")


# ------------------------------------------------------------------- CLI
def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("bai", [True, False])
@pytest.mark.parametrize("dtypes", [[], ["r9", "r10"]])
def test_cli_matches_jax(tmp_path, bai, dtypes):
    """`pileup x.bam region 1 [dtypes] --print-output` prints the JAX CLI's
    stdout byte for byte, with a .bai beside the BAM and without one."""
    ref, recs = C.mixed_records(6_000, coverage=8)
    path = C.write_indexed(str(tmp_path / "x.bam"), recs, len(ref), with_bai=bai)
    argv = ["pileup", path, "chr1:1001-4000", "1", *dtypes, "--print-output"]
    got, err = _run(torch_cli_main, argv)
    want, jerr = _run(jax_cli_main, argv)
    assert got == want and got.count("\n") > 3000
    assert err.splitlines()[-1].startswith("Kernel runtime: ")
    assert ("native in-place fast path requires a single dtype" in err) == bool(dtypes and bai)
    assert len(got.splitlines()[0].split("\t")) == 2 + 50 * max(1, len(dtypes))


def test_open_bam_with_index(tmp_path):
    """With a .bai beside the BAM the JAX CLI's reference-mode walk raises
    TypeError (its IndexedBam has neither records nor __iter__); the port's
    walk reads the whole file and yields the rows it yields without one."""
    from genomicsbench_tpu_torch.ops.eventalign import eventalign_reads
    from torch_abea_cases import _model
    from torch_meth_cases import ref_mode_case, write_ref_mode_files

    case = ref_mode_case(4, seed=5, genome_len=6_000, lo=200, hi=300)
    paths = write_ref_mode_files(str(tmp_path), case, B)
    mean, stdv = _model()
    results = eventalign_reads(case["signals"], case["seqs"], mean, stdv, keep_aux=True,
                               device="cpu")

    def rows():
        return [(ridx, rec.name, contig, ref_slice,
                 [(r.ref_position, r.event_idx) for r in rws])
                for ridx, rec, contig, ref_slice, rws, _ in _iter_ref_alignments(
                    paths["bam"], paths["genome"], case["names"], case["seqs"], results,
                    mean, stdv)]

    before = rows()
    B.write_bai(paths["bam"])
    assert rows() == before and len(before) == 4 and all(len(r[4]) > 50 for r in before)
    with pytest.raises(TypeError):
        list(jax_iter_ref_alignments(paths["bam"], paths["genome"], case["names"],
                                     case["seqs"], results, mean, stdv))
