"""The PyTorch port's phmm (genomicsbench_tpu_torch) against the JAX package.

Runs on the CPU, where `pairhmm_forward` takes its plain PyTorch version.
The same inputs (tests/torch_phmm_cases.py, made from numpy seeds) go
through both packages' `pairhmm_batch`, the reference's own float64 loop,
the oracle and an mpmath forward.  Tolerances:

* float32 pairs: |d log10| <= 1e-5 against JAX (the JAX package sums Y by a
  doubling scan and the last row by a reduction; measured 1.9e-6);
* the set of pairs routed to float64 is the same;
* float64 pairs: bit for bit against the reference's loop
  (gb_pairhmm_f64 of genomicsbench_tpu/native/gbingest.cpp) compiled
  without floating-point contraction, and against JAX pairhmm_batch with
  that loop as its fallback.  JAX's own native build (-O3 -march=native,
  where g++ contracts multiply-adds into FMAs by default) is held within
  1e-12 in log10 and 1e-13 relative in the scaled values.
"""

import dataclasses
import math
import re
import subprocess

import numpy as np
import pytest
import torch

import genomicsbench_tpu.oracle.pairhmm as jax_oracle
from genomicsbench_tpu import native as jax_native
from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.io.phmm_text import PhmmBatch as JaxPhmmBatch
from genomicsbench_tpu.io.phmm_text import PhmmRead as JaxPhmmRead
from genomicsbench_tpu.io.phmm_text import load_phmm_testfile as jax_load_phmm_testfile
from genomicsbench_tpu.ops import pairhmm as jax_pairhmm

from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.io.phmm_text import (PhmmBatch, PhmmRead, load_phmm_testfile,
                                                  phmm_batches_from_dicts,
                                                  write_phmm_testfile)
from genomicsbench_tpu_torch.ops import pairhmm
from genomicsbench_tpu_torch.oracle.pairhmm import (_PH2PR_F32, _PH2PR_F64, PH2PR_F64_CPOW,
                                                    pairhmm_forward_oracle,
                                                    pairhmm_forward_scaled,
                                                    pairhmm_forward_scaled_many)
from test_independent_contracts import _mp_forward_log10
from torch_phmm_cases import (edge_cases, gen_phmm_workload, lane_row_case, lane_row_forward)

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them and slow the run many times over
torch.set_num_threads(1)

EDGES = edge_cases()
SAMPLE_PAIRS = 300
F32_LOG10_TOL = 1e-5
NATIVE_LOG10_TOL = 1e-12
NATIVE_REL_TOL = 1e-13


def _cross(reads, haps, pairs):
    if pairs is None:
        return [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    return pairs


def _cases(reads, haps, pairs, idx):
    """The JAX package's fallback testcases (read, hap, q, i, d, c) of the
    listed pairs."""
    out = []
    for k in idx:
        r, h = pairs[k]
        rd = reads[r]
        out.append((rd["bases"], haps[h], rd["q"], rd["i"], rd["d"], rd["c"]))
    return out


@pytest.fixture(scope="module")
def reference_loop(tmp_path_factory):
    """gb_pairhmm_f64, cut from the JAX package's native source and compiled
    with -ffp-contract=off: the reference's float64 loop in its written
    operation order.  Returns f(cases) -> (P,) scaled float64, as
    native.pairhmm_f64 takes and returns them."""
    import ctypes

    src = open(jax_native._SRC).read()
    body = re.search(r"int64_t gb_pairhmm_f64\(.*?\n    return 0;\n\}\n", src, re.S)
    assert body, "gb_pairhmm_f64 not found in the native source"
    d = tmp_path_factory.mktemp("reference_loop")
    (d / "ph.cpp").write_text("#include <algorithm>\n#include <cmath>\n#include <cstdint>\n"
                              "#include <vector>\nextern \"C\" {\n" + body.group(0) + "}\n")
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(d / "ph.so"), str(d / "ph.cpp")], check=True, timeout=120)
    fn = ctypes.CDLL(str(d / "ph.so")).gb_pairhmm_f64
    fn.restype = ctypes.c_int64

    def run(cases):
        cat = lambda k, dt: np.ascontiguousarray(
            np.concatenate([np.asarray(c[k], dt) for c in cases]))
        rl = np.array([len(c[0]) for c in cases], np.int64)
        hl = np.array([len(c[1]) for c in cases], np.int64)
        ro = np.concatenate([[0], np.cumsum(rl)[:-1]]).astype(np.int64)
        ho = np.concatenate([[0], np.cumsum(hl)[:-1]]).astype(np.int64)
        arrs = [cat(0, np.uint8), ro, rl, cat(1, np.uint8), ho, hl] + \
            [cat(k, np.int64) for k in (2, 3, 4, 5)]
        out = np.empty(len(cases), np.float64)
        fn(*(ctypes.c_void_p(a.ctypes.data) for a in arrs), ctypes.c_int64(len(cases)),
           ctypes.c_void_p(out.ctypes.data))
        return out
    return run


def _jax_run(reads, haps, pairs, fallback=None):
    """JAX pairhmm_batch, recording the testcases of its float64 fallback;
    `fallback` replaces the batched float64 pass when given.  Returns
    (log10 values, fallback testcases)."""
    seen = []
    orig = jax_oracle.pairhmm_forward_scaled_many

    def spy(cases, dtype=np.float64):
        seen.extend(cases)
        return fallback(cases) if fallback is not None else orig(cases, dtype=dtype)

    jax_oracle.pairhmm_forward_scaled_many = spy
    try:
        out = jax_pairhmm.pairhmm_batch(reads, haps, pairs=pairs)
    finally:
        jax_oracle.pairhmm_forward_scaled_many = orig
    return out, seen


def _port_scaled(reads, haps, pairs):
    """The port's two passes on the CPU: (scaled f32 of every pair, fallback
    indices, scaled f64 of those)."""
    t = pairhmm.upload_pairs(reads, haps, _cross(reads, haps, pairs), "cpu")
    pending = pairhmm._phmm_dispatch(t)
    return pending.scaled32.numpy(), pending.fallback.numpy(), pending.scaled64.numpy()


@pytest.fixture(scope="module")
def sample():
    reads, haps, pairs, _ = gen_phmm_workload(SAMPLE_PAIRS)
    return reads, haps, pairs


@pytest.fixture(scope="module")
def sample_port(sample):
    return pairhmm.pairhmm_batch(*sample, device="cpu"), _port_scaled(*sample)


def _same_fallback(seen, reads, haps, pairs, fallback):
    """The JAX fallback's testcases are those of the port's fallback pairs,
    in order (compared by identity of the read and hap arrays)."""
    want = _cases(reads, haps, pairs, fallback)
    assert len(seen) == len(want)
    for a, b in zip(seen, want):
        assert a[0] is b[0] and a[1] is b[1]


def _check_against_jax(reads, haps, pairs, got, fallback, reference_loop):
    pairs = _cross(reads, haps, pairs)
    f32 = np.ones(len(pairs), bool)
    f32[fallback] = False
    # JAX with its own native fallback: the same routing; float64 within the
    # FMA contraction of its build
    want, seen = _jax_run(reads, haps, pairs)
    _same_fallback(seen, reads, haps, pairs, fallback)
    np.testing.assert_allclose(got[f32], want[f32], rtol=0, atol=F32_LOG10_TOL)
    np.testing.assert_allclose(got[~f32], want[~f32], rtol=0, atol=NATIVE_LOG10_TOL)
    # JAX with the reference loop as its fallback: float64 pairs bit for bit
    want, seen = _jax_run(reads, haps, pairs, fallback=reference_loop)
    _same_fallback(seen, reads, haps, pairs, fallback)
    np.testing.assert_array_equal(got[~f32], want[~f32])


def test_main_sample_matches_jax(sample, sample_port, reference_loop):
    """300 pairs of the main workload's generator (seed 17), with its
    fallback pairs."""
    got, (_, fallback, _) = sample_port
    assert 3 <= len(fallback) < SAMPLE_PAIRS // 10
    _check_against_jax(*sample, got, fallback, reference_loop)


@pytest.mark.parametrize("label", sorted(EDGES))
def test_edges_match_jax(label, reference_loop):
    reads, haps, pairs = EDGES[label]
    got = pairhmm.pairhmm_batch(reads, haps, pairs, device="cpu")
    _, fallback, _ = _port_scaled(reads, haps, pairs)
    if label in ("underflow", "mixed"):
        assert len(fallback)
    if label == "mixed":
        assert 0 < len(fallback) < len(pairs)
    _check_against_jax(reads, haps, pairs, got, fallback, reference_loop)


def test_cross_product_default(sample):
    """pairs=None is the read-major cross product in both packages."""
    reads, haps, _ = EDGES["strip_edges"]
    got = pairhmm.pairhmm_batch(reads, haps, device="cpu")
    explicit = pairhmm.pairhmm_batch(reads, haps, _cross(reads, haps, None), device="cpu")
    np.testing.assert_array_equal(got, explicit)
    np.testing.assert_allclose(got, jax_pairhmm.pairhmm_batch(reads, haps), rtol=0,
                               atol=F32_LOG10_TOL)
    assert len(got) == len(reads) * len(haps)


def test_f64_pass_is_the_reference_loop(sample, reference_loop):
    """The float64 plain version over every pair of the sample and the edge
    cases equals the reference's loop bit for bit, and the JAX package's
    native build within its contraction (native must be available here)."""
    assert jax_native.available()
    for reads, haps, pairs in [sample] + [EDGES[k] for k in sorted(EDGES)]:
        pairs = _cross(reads, haps, pairs)
        t = pairhmm.upload_pairs(reads, haps, pairs, "cpu")
        got = pairhmm.pairhmm_forward(t, None, torch.float64).numpy()
        cases = _cases(reads, haps, pairs, range(len(pairs)))
        np.testing.assert_array_equal(got, reference_loop(cases))
        np.testing.assert_allclose(got, jax_native.pairhmm_f64(cases), rtol=NATIVE_REL_TOL,
                                   atol=0)


def test_fallback_scaled_values_match_native(sample, sample_port, reference_loop):
    """The fallback pairs' scaled float64 values: the reference loop exactly,
    JAX's native batch within 1e-13 relative."""
    reads, haps, pairs = sample
    _, fallback, s64 = sample_port[1]
    cases = _cases(reads, haps, pairs, fallback)
    np.testing.assert_array_equal(s64, reference_loop(cases))
    np.testing.assert_allclose(s64, jax_native.pairhmm_f64(cases), rtol=NATIVE_REL_TOL, atol=0)


def _oracle_args(rd, hp):
    return (rd["bases"], hp, *(np.clip(rd[k], 0, 127) for k in "qidc"))


def test_against_oracle(sample, sample_port):
    """Every 15th sample pair, the first fallback pairs and the edge pairs.
    The port's oracle runs the reference loop's operation order, so the
    scaled values equal it bit for bit: float32 on its table, float64 on C
    pow's.  The JAX package's float32 oracle sums the last row with numpy:
    within 1e-6 relative.  log10 against pairhmm_forward_oracle (float64 on
    numpy's table) within 1e-5."""
    reads, haps, pairs = sample
    got, (s32, fallback, s64) = sample_port
    for k in list(range(0, SAMPLE_PAIRS, 15)) + list(fallback[:3]):
        r, h = pairs[k]
        args = _oracle_args(reads[r], haps[h])
        assert s32[k] == pairhmm_forward_scaled(*args, dtype=np.float32)
        if k not in fallback:
            assert s32[k] == pytest.approx(
                jax_oracle.pairhmm_forward_scaled(*args, dtype=np.float32), rel=1e-6, abs=0)
        assert got[k] == pytest.approx(pairhmm_forward_oracle(*args), abs=1e-5)
    for f, k in enumerate(fallback[:3]):
        r, h = pairs[k]
        assert s64[f] == pairhmm_forward_scaled(*_oracle_args(reads[r], haps[h]),
                                                dtype=np.float64, ph2pr=PH2PR_F64_CPOW)
    for label in ("qualities", "length1", "mixed"):
        reads, haps, pairs = EDGES[label]
        pairs = _cross(reads, haps, pairs)
        got = pairhmm.pairhmm_batch(reads, haps, pairs, device="cpu")
        t = pairhmm.upload_pairs(reads, haps, pairs, "cpu")
        f64 = pairhmm.pairhmm_forward(t, None, torch.float64).numpy()
        for k, (r, h) in enumerate(pairs):
            args = _oracle_args(reads[r], haps[h])
            assert got[k] == pytest.approx(pairhmm_forward_oracle(*args), abs=1e-5), (label, k)
            assert f64[k] == pairhmm_forward_scaled(*args, dtype=np.float64,
                                                    ph2pr=PH2PR_F64_CPOW), (label, k)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_oracle_is_the_per_pair_oracle(dtype):
    """The port's batched oracle equals its per-pair forward bit for bit,
    across the strip-edge and mixed edge batches (lengths padded apart)."""
    cases = []
    for label in ("strip_edges", "mixed"):
        reads, haps, pairs = EDGES[label]
        cases += _cases(reads, haps, _cross(reads, haps, pairs),
                        range(len(_cross(reads, haps, pairs))))
    got = pairhmm_forward_scaled_many(cases, dtype=dtype)
    np.testing.assert_array_equal(got, [pairhmm_forward_scaled(*c, dtype=dtype) for c in cases])


def test_against_mpmath():
    """The JAX package's own contract bounds: 5e-3 on float32 pairs, 1e-9 on
    a pair that underflows float32."""
    rng = np.random.default_rng(42)
    reads, haps = [], []
    for k in range(6):
        R, H = int(rng.integers(5, 40)), int(rng.integers(10, 60))
        read = rng.integers(0, 4, R).astype(np.uint8)
        hap = rng.integers(0, 4, H).astype(np.uint8)
        if k % 3 == 0:
            read[rng.integers(0, R)] = 4
            hap[rng.integers(0, H)] = 4
        mk = lambda lo, hi: rng.integers(lo, hi, R).astype(np.int32)
        reads.append(dict(bases=read, q=mk(6, 61), i=mk(20, 51), d=mk(20, 51), c=mk(8, 13)))
        haps.append(hap)
    pairs = [(k, k) for k in range(6)]
    got = pairhmm.pairhmm_batch(reads, haps, pairs, device="cpu")
    for k, rd in enumerate(reads):
        want = _mp_forward_log10(rd["bases"], haps[k], rd["q"], rd["i"], rd["d"], rd["c"])
        assert abs(got[k] - want) < 5e-3, (k, got[k], want)

    R, H = 80, 90
    read = np.zeros(R, np.uint8)
    hap = np.full(H, 1, np.uint8)
    rd = dict(bases=read, q=np.full(R, 40), i=np.full(R, 45), d=np.full(R, 45),
              c=np.full(R, 10))
    _, fallback, _ = _port_scaled([rd], [hap], [(0, 0)])
    assert list(fallback) == [0]
    got = pairhmm.pairhmm_batch([rd], [hap], [(0, 0)], device="cpu")[0]
    want = _mp_forward_log10(read, hap, rd["q"], rd["i"], rd["d"], rd["c"], dps=120)
    assert abs(got - want) < 1e-9, (got, want)


def test_ph2pr_tables():
    """PH2PR_F64_CPOW is C pow's table (math.pow); numpy's table differs from
    it by one ulp exactly at q = 22, 50, 61, 78, 118; their float32 casts
    are equal, and the port's tables are the JAX package's."""
    cpow = np.array([math.pow(10.0, -q / 10.0) for q in range(128)])
    np.testing.assert_array_equal(PH2PR_F64_CPOW, cpow)
    np.testing.assert_array_equal(pairhmm.PH2PR_F64, cpow)
    assert list(np.nonzero(PH2PR_F64_CPOW != _PH2PR_F64)[0]) == [22, 50, 61, 78, 118]
    diff = np.nonzero(PH2PR_F64_CPOW != _PH2PR_F64)[0]
    assert (np.abs(PH2PR_F64_CPOW[diff] - _PH2PR_F64[diff])
            == np.spacing(np.minimum(PH2PR_F64_CPOW[diff], _PH2PR_F64[diff]))).all()
    np.testing.assert_array_equal(PH2PR_F64_CPOW.astype(np.float32),
                                  _PH2PR_F64.astype(np.float32))
    np.testing.assert_array_equal(_PH2PR_F32, jax_oracle._PH2PR_F32)
    np.testing.assert_array_equal(_PH2PR_F64, jax_oracle._PH2PR_F64)
    np.testing.assert_array_equal(pairhmm.PH2PR_F32, jax_pairhmm._PH2PR_F32)


def _testfile_batches():
    """Two batches: the mixed edge batch's reads and haps, and one active
    region of the main workload."""
    reads, haps, _ = EDGES["mixed"]
    w_reads, w_haps, w_pairs, _ = gen_phmm_workload(40)
    r_ids = sorted({r for r, _ in w_pairs[:40]})[:6]
    h_ids = sorted({h for _, h in w_pairs[:40]})
    return [PhmmBatch(reads=[PhmmRead(**rd) for rd in reads], haps=haps),
            PhmmBatch(reads=[PhmmRead(**w_reads[r]) for r in r_ids],
                      haps=[w_haps[h] for h in h_ids])]


def test_cli_matches_jax_cli(tmp_path, capsys, reference_loop):
    """The CLI's rows on a written testfile: within 1e-4 of the JAX CLI's on
    float32 pairs and the same strings on float64 pairs (JAX with the
    reference loop as its fallback), then the JAX timing line."""
    path = tmp_path / "phmm.txt"
    write_phmm_testfile(str(path), _testfile_batches())
    torch_cli_main(["phmm", "-f", str(path), "--print-output", "--device", "cpu", "-l", "2"])
    ours = capsys.readouterr()
    orig = jax_oracle.pairhmm_forward_scaled_many
    jax_oracle.pairhmm_forward_scaled_many = lambda cases, dtype=np.float64: reference_loop(cases)
    try:
        jax_cli_main(["phmm", "-f", str(path), "--print-output"])
    finally:
        jax_oracle.pairhmm_forward_scaled_many = orig
    theirs = capsys.readouterr()
    assert re.fullmatch(r"PairHMM completed\. Kernel runtime: \d+\.\d\d sec\n", ours.err)
    a, b = ours.out.splitlines(), theirs.out.splitlines()
    assert len(a) == len(b) == sum(b.num_testcases for b in _testfile_batches())
    fallback = np.concatenate([
        _port_scaled([dataclasses.asdict(r) for r in bt.reads], bt.haps, None)[1] + off
        for bt, off in zip(load_phmm_testfile(str(path)), (0, 12))])
    assert len(fallback)
    for k, (x, y) in enumerate(zip(a, b)):
        if k in fallback:
            assert x == y, k
        else:
            assert abs(float(x) - float(y)) <= 1e-4, k


def test_phmm_batches_round_trip(tmp_path):
    """JAX PhmmBatches cross as plain dicts; the text format reads the same
    in both packages."""
    path = tmp_path / "phmm.txt"
    write_phmm_testfile(str(path), _testfile_batches())
    jax_batches = jax_load_phmm_testfile(str(path))
    ours = phmm_batches_from_dicts(dataclasses.asdict(b) for b in jax_batches)
    assert [type(b) for b in ours] == [PhmmBatch, PhmmBatch]
    loaded = load_phmm_testfile(str(path))
    for a, b, c in zip(ours, jax_batches, loaded):
        assert a.num_testcases == b.num_testcases == c.num_testcases
        for ra, rb, rc in zip(a.reads, b.reads, c.reads):
            assert isinstance(ra, PhmmRead)
            for k in ("bases", "q", "i", "d", "c"):
                np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k))
                np.testing.assert_array_equal(getattr(ra, k), getattr(rc, k))
        for ha, hb in zip(a.haps, b.haps):
            assert ha.dtype == np.uint8
            np.testing.assert_array_equal(ha, hb)
        back = JaxPhmmBatch(reads=[JaxPhmmRead(**dataclasses.asdict(r)) for r in a.reads],
                            haps=a.haps)
        assert [len(r.bases) for r in back.reads] == [len(r.bases) for r in b.reads]
    with pytest.raises(TypeError):
        phmm_batches_from_dicts([{**dataclasses.asdict(jax_batches[0]), "region": 1}])


# ------------------------------------------------ the kernel's schedule
# tests/torch_phmm_cases.py `lane_row_forward` is a numpy model of
# gb_pairhmm_f32 / gb_pairhmm_f64 (csrc/pairhmm.cu): a pair on g lanes of r
# rows each, in strips, bottom-aligned under rows that repeat row 0, the
# group's boundary and top-row hand-off, the result summed in column order.
# Held bit for bit against the plain version, for every class the host's
# picker returns.
def _picked(dtype):
    """(g, r) classes the picker returns, R past its table included."""
    table = pairhmm._class_table(dtype)
    return [pairhmm.phmm_classes(dtype)[c] for c in sorted(set(table.tolist()) | {0})]


LANE_ROW_CASES = [(np.float32, g, r) for g, r in _picked(torch.float32)] + \
    [(np.float64, g, r) for g, r in _picked(torch.float64)]
LANE_ROW = lane_row_case()


@pytest.fixture(scope="module")
def lane_row_plain():
    reads, haps, pairs = LANE_ROW
    t = pairhmm.upload_pairs(reads, haps, pairs, "cpu")
    return {np.float32: pairhmm.pairhmm_forward_reference(t, None, torch.float32).numpy(),
            np.float64: pairhmm.pairhmm_forward_reference(t, None, torch.float64).numpy()}


@pytest.mark.parametrize("dtype, g, r", LANE_ROW_CASES,
                         ids=[f"{np.dtype(d).name}-g{g}-r{r}" for d, g, r in LANE_ROW_CASES])
def test_lane_row_schedule_equals_plain(dtype, g, r, lane_row_plain):
    """Reads of 1-300 rows against haplotypes of 1-1,000 bases, N in both,
    qualities 0 and 127: every pair that the class takes (all for 32
    lanes, in strips; at most g * r rows otherwise)."""
    reads, haps, pairs = LANE_ROW
    sel = [k for k, (ri, _) in enumerate(pairs) if g == 32 or len(reads[ri]["bases"]) <= g * r]
    got = lane_row_forward(reads, haps, [pairs[k] for k in sel], g, r, dtype)
    np.testing.assert_array_equal(got, lane_row_plain[dtype][sel])


def test_picker_classes():
    """Each R takes a class that holds it (one strip below 32 lanes), R
    past the table the widest class; on the main workload's first 3,000
    pairs the picked classes fill 84% of their lane rows or more (cells
    over rows x steps, the ramps included: 84.7% there, 85.3% on all
    100,000; a warp per pair, one row a lane, filled 76%)."""
    for dtype in (torch.float32, torch.float64):
        classes = pairhmm.phmm_classes(dtype)
        assert classes[0] == (32, pairhmm.PHMM_MAX_ROWS[dtype])
        table = pairhmm._class_table(dtype)
        g = np.array([classes[c][0] for c in table])
        r = np.array([classes[c][1] for c in table])
        R = np.arange(len(table))
        assert ((g == 32) | (R <= g * r)).all()
        order, cls, vwarps, strips = pairhmm.phmm_order([pairhmm.PHMM_CLASS_R + 5], [7], dtype)
        assert cls.reshape(-1, 4)[0, 2] == 1 and vwarps == 1
        assert strips == -(-(pairhmm.PHMM_CLASS_R + 5) // (32 * pairhmm.PHMM_MAX_ROWS[dtype]))
    reads, haps, pairs, cells = gen_phmm_workload(3000)
    R = np.array([len(reads[a]["bases"]) for a, _ in pairs])
    H = np.array([len(haps[b]) for _, b in pairs])
    classes = pairhmm.phmm_classes(torch.float32)
    c = pairhmm._class_table(torch.float32)[R]
    g = np.array([classes[i][0] for i in c])
    r = np.array([classes[i][1] for i in c])
    S = -(-R // (g * r))
    assert cells / (S * (H + g - 1) * g * r).sum() >= 0.84


def test_order_by_class_and_device_twin():
    """phmm_order: a permutation of the list; each class's slots hold
    pairs of that class, strips then haplotype length descending; the
    classes' first warps and slots add up; `_phmm_order_device` (on CPU
    tensors here) gives the same order and table."""
    reads, haps, pairs, _ = gen_phmm_workload(3000)
    R = np.array([len(reads[a]["bases"]) for a, _ in pairs] + [0, 300, 5000])
    H = np.array([len(haps[b]) for _, b in pairs] + [50, 0, 20])
    for dtype in (torch.float32, torch.float64):
        order, table, vwarps, strips = pairhmm.phmm_order(R, H, dtype)
        assert np.array_equal(np.sort(order), np.arange(len(R)))
        classes = pairhmm.phmm_classes(dtype)
        table = table.reshape(-1, 4)
        pick = np.where(R < pairhmm.PHMM_CLASS_R,
                        pairhmm._class_table(dtype)[np.minimum(R, pairhmm.PHMM_CLASS_R - 1)], 0)
        warp = slot = most = 0
        for c, (first_warp, first_slot, count, code) in enumerate(table):
            g, r = classes[c]
            assert (first_warp, first_slot, code) == (warp, slot, (g << 8) | r)
            ks = order[first_slot:first_slot + count]
            assert (pick[ks] == c).all()
            S = -(-R[ks] // (g * r))
            key = list(zip(-S, -H[ks]))
            assert key == sorted(key)
            most = max([most, *S])
            warp += -(-count // (32 // g))
            slot += count
        assert (warp, slot) == (vwarps, len(R))
        # the 5,000-row read, on 32 lanes of the instance's most rows
        assert strips == most == -(-5000 // (32 * pairhmm.PHMM_MAX_ROWS[dtype]))
        dev_order, dev_table = pairhmm._phmm_order_device(torch.from_numpy(R),
                                                          torch.from_numpy(H), dtype)
        assert np.array_equal(dev_order.numpy(), order)
        assert np.array_equal(dev_table.numpy(), table.reshape(-1))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_ordered_schedule_scatters_to_pair_order(dtype):
    """The kernel's walk of its order: each class's pairs (in their order)
    through the lane-row model, out[order[slot]] written per pair, equals
    the plain version in pair order, on the main workload's first 400
    pairs with the lane-row reads against the shortest haplotypes."""
    reads, haps, pairs, _ = gen_phmm_workload(400)
    lr_reads, lr_haps, _ = LANE_ROW
    n_r, n_h = len(reads), len(haps)
    reads, haps = reads + lr_reads, haps + lr_haps[:3]
    pairs = pairs + [(n_r + a, n_h + b) for a in range(len(lr_reads)) for b in range(3)]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    R = np.array([len(reads[a]["bases"]) for a, _ in pairs])
    H = np.array([len(haps[b]) for _, b in pairs])
    order, table, _, _ = pairhmm.phmm_order(R, H, tdt)
    out = np.full(len(pairs), np.nan, dtype)
    for c, (_, first_slot, count, code) in enumerate(table.reshape(-1, 4)):
        if count:
            ks = order[first_slot:first_slot + count]
            out[ks] = lane_row_forward(reads, haps, [pairs[k] for k in ks], int(code >> 8),
                                       int(code & 0xFF), dtype)
    t = pairhmm.upload_pairs(reads, haps, pairs, "cpu")
    np.testing.assert_array_equal(out, pairhmm.pairhmm_forward_reference(t, None, tdt).numpy())
