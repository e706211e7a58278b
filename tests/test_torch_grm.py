"""The grm port (genomicsbench_tpu_torch.ops.grm, io/plink.py) against the
JAX package, on the CPU.

The same numpy genotypes (tests/torch_grm_cases.py) go through the JAX
function and the port's plain PyTorch versions.  The pair counts are exact
(sums of 0/1 products in f32, far below 2^24); the relationship entries are
held within rtol/atol 2e-5, the JAX package's own bound against the float64
oracle (tests/test_grm.py:25): the products sum in another order on each
side.  The float64 NumPy oracle is the second witness.  The plink readers
and writers are byte for byte the JAX package's; the port's `read_pgen`
decodes every record that tests/test_pgen_fixtures.py builds by hand from
the PGEN spec (its tests are run again with the port's reader and writer in
place of the JAX package's).
"""

import contextlib
import functools
import io
import os

import numpy as np
import pytest
import torch

import genomicsbench_tpu.io.plink as JP
import genomicsbench_tpu.ops.grm as J
from genomicsbench_tpu.cli import main as jax_cli_main

import genomicsbench_tpu_torch.io.plink as TP
import genomicsbench_tpu_torch.ops.grm as T
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.oracle.grm import grm_oracle

import test_pgen_fixtures as pgen_fixtures
from torch_grm_cases import EDGE_BLOCK, edge_cases, maf_boundary, rand_geno

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)        # tests/test_grm.py:25
EDGES = edge_cases()


def _grm_close(got, want):
    np.testing.assert_allclose(got, want, **TOL)


def _accumulate(packed, maf_ok, block):
    """The port's block loop on the CPU: (num, den) as `grm` accumulates them."""
    Nb = packed.shape[1] * 4
    num = torch.zeros(Nb, Nb)
    den = torch.zeros(Nb, Nb)
    pk, ok = torch.from_numpy(packed), torch.from_numpy(maf_ok)
    for s in range(0, len(packed), block):
        x, w = T.grm_standardize(pk[s:s + block], ok[s:s + block])
        num.addmm_(x.T, x)
        den.addmm_(w.T, w)
    return num.numpy(), den.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_block_accumulators_match_jax_scan(seed):
    """num and den after three blocks against JAX `_grm_scan` on the same
    packed bytes: den exact, num within 2e-5."""
    rng = np.random.default_rng(seed)
    block = EDGE_BLOCK
    geno = rand_geno(rng, 3 * block, 96)
    maf_ok = T.maf_filter(geno, 0.01)
    packed = T.pack_genotypes(geno)
    want_num, want_den = J._grm_scan(packed.reshape(3, block, -1), maf_ok.reshape(3, block))
    num, den = _accumulate(packed, maf_ok, block)
    np.testing.assert_array_equal(den, np.asarray(want_den))
    np.testing.assert_allclose(num, np.asarray(want_num), **TOL)


def test_pack_and_filter_are_jax_hosts():
    """The port's host filter and pack give the bytes and the verdicts that
    JAX `grm` builds (grm.py:103-116)."""
    geno = rand_geno(np.random.default_rng(4), 70, 13)
    miss = geno == 3
    n_obs = (~miss).sum(1)
    p = np.where(miss, 0, geno).sum(1) / np.maximum(2 * n_obs, 1)
    np.testing.assert_array_equal(T.maf_filter(geno, 0.05),
                                  (np.minimum(p, 1 - p) >= 0.05) & (n_obs > 0))
    packed = T.pack_genotypes(geno)
    assert packed.shape == (70, 32) and packed.dtype == np.uint8
    codes = np.stack([(packed >> (2 * lane)) & 3 for lane in range(4)], 2).reshape(70, -1)
    np.testing.assert_array_equal(codes[:, :13], geno)
    assert (codes[:, 13:] == 3).all()


@pytest.mark.parametrize("M, N, maf, seed", [(500, 96, 0.01, 0), (500, 96, 0.2, 0),
                                             (300, 64, 0.01, 1), (300, 64, 0.2, 1)])
def test_grm_matches_jax_and_oracle(M, N, maf, seed):
    geno = rand_geno(np.random.default_rng(seed), M, N)
    got, nobs = T.grm(geno, maf=maf, block=EDGE_BLOCK, device="cpu")
    want, want_n = J.grm(geno, maf=maf, block=EDGE_BLOCK)
    assert got.dtype == nobs.dtype == np.float32 and got.shape == nobs.shape == (N, N)
    np.testing.assert_array_equal(nobs, want_n)
    _grm_close(got, want)
    orc, orc_n = grm_oracle(geno, maf=maf)
    np.testing.assert_array_equal(nobs, orc_n)
    _grm_close(got, orc)


@pytest.mark.parametrize("case", sorted(EDGES))
def test_edge_cases_match_jax_and_oracle(case):
    geno, maf = EDGES[case]
    got, nobs = T.grm(geno, maf=maf, block=EDGE_BLOCK, device="cpu")
    want, want_n = J.grm(geno, maf=maf, block=EDGE_BLOCK)
    orc, orc_n = grm_oracle(geno, maf=maf)
    np.testing.assert_array_equal(nobs, want_n)
    np.testing.assert_array_equal(nobs, orc_n)
    _grm_close(got, want)
    _grm_close(got, orc)
    assert np.array_equal(got, got.T) and np.array_equal(nobs, nobs.T)
    if case == "special_rows":          # sample 5 is never observed
        assert not nobs[5].any() and not got[5].any()


def test_maf_boundary_is_kept_as_jax_keeps_it(capsys):
    """One het among 50 observed samples: p = 1 / 100 in float64, the
    double 0.01 itself, so `min(p, 1 - p) >= 0.01` keeps the variant.  An
    f32 p rounds below that double: held against the double it drops the
    variant, held against float32(0.01) it keeps it."""
    geno = maf_boundary()
    p64 = 1 / 100
    p32 = np.float32(1) / np.float32(100)
    assert T.maf_filter(geno, 0.01)[0]
    with capsys.disabled():
        print(f"\nmaf boundary: float64 p {p64!r} >= 0.01: kept; f32 p {float(p32)!r} "
              f">= 0.01 as a double: {float(p32) >= 0.01}; >= float32(0.01): "
              f"{bool(p32 >= np.float32(0.01))}")
    assert float(p32) < 0.01 <= p64
    without = geno.copy()
    without[0] = 0
    kept, _ = T.grm(geno, maf=0.01, block=EDGE_BLOCK, device="cpu")
    dropped, _ = T.grm(without, maf=0.01, block=EDGE_BLOCK, device="cpu")
    assert np.abs(kept - dropped).max() > 1e-3       # the variant counts
    want, _ = J.grm(geno, maf=0.01, block=EDGE_BLOCK)
    _grm_close(kept, want)


def test_standardize_and_finish_shapes():
    geno = rand_geno(np.random.default_rng(6), 9, 13)
    pk = torch.from_numpy(T.pack_genotypes(geno))
    ok = torch.from_numpy(T.maf_filter(geno, 0.01))
    x, w = T.grm_standardize(pk, ok)
    assert x.shape == w.shape == (9, 128) and x.dtype == w.dtype == torch.float32
    assert not x[:, 13:].any() and not w[:, 13:].any()
    np.testing.assert_array_equal(w[:, :13].numpy(), ((geno != 3) & ok.numpy()[:, None]))
    num, den = x.T @ x, w.T @ w
    tri = T.grm_finish(num, den, 13)
    rr, cc = np.tril_indices(13)
    assert tri.shape == (2, 91)
    np.testing.assert_array_equal(tri[1].numpy(), den.numpy()[rr, cc])
    np.testing.assert_array_equal(tri[0].numpy(),
                                  (num / torch.clamp(den, min=1.0)).numpy()[rr, cc])


# ------------------------------------------------------------------- plink io
@pytest.mark.parametrize("mode", [0x01, 0x02, 0x10, 0x11])
def test_write_pgen_bytes_equal_jax(tmp_path, mode):
    rng = np.random.default_rng(mode)
    geno = rng.integers(0, 4, (60, 37)).astype(np.uint8)
    geno[10:20] = 0
    geno[12, 3] = 2
    geno[20:30] = geno[19]
    ids = [f"id{i}" for i in range(37)]
    TP.write_pgen(str(tmp_path / "port"), geno, ids=ids, mode=mode)
    JP.write_pgen(str(tmp_path / "jax"), geno, ids=ids, mode=mode)
    for ext in (".pgen", ".pvar", ".psam"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    got, got_ids = TP.read_pgen(str(tmp_path / "jax"))
    want, want_ids = JP.read_pgen(str(tmp_path / "port"))
    np.testing.assert_array_equal(got, geno)
    np.testing.assert_array_equal(want, geno)
    assert got_ids == want_ids == ids


def test_write_bed_bytes_equal_jax(tmp_path):
    geno = np.random.default_rng(3).integers(0, 4, (40, 13)).astype(np.uint8)
    TP.write_bed(str(tmp_path / "port"), geno)
    JP.write_bed(str(tmp_path / "jax"), geno)
    for ext in (".bed", ".bim", ".fam"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    got, ids = TP.read_bed(str(tmp_path / "jax"))
    want, jids = JP.read_bed(str(tmp_path / "jax"))
    np.testing.assert_array_equal(got, want)
    assert ids == jids and len(ids) == 13


@pytest.mark.parametrize("fixture", ["test_pgen_mode02_fixture", "test_pgen_mode10_fixture",
                                     "test_pgen_mode10_multigroup_difflist",
                                     "test_write_pgen_decodes_against_fixture_reader"])
def test_read_pgen_decodes_the_hand_built_records(fixture, tmp_path, monkeypatch):
    """tests/test_pgen_fixtures.py's hand-built .pgen records, decoded by
    the port's read_pgen (and written by its write_pgen)."""
    monkeypatch.setattr(pgen_fixtures, "read_pgen", TP.read_pgen)
    monkeypatch.setattr(pgen_fixtures, "write_pgen", TP.write_pgen)
    getattr(pgen_fixtures, fixture)(tmp_path)


def test_grm_bin_byte_golden(tmp_path, monkeypatch):
    """tests/test_pgen_fixtures.py's hand-computed 4 x 3 GRM and its
    .grm.bin byte layout, with the port's grm and write_grm_bin."""
    monkeypatch.setattr(J, "grm", functools.partial(T.grm, device="cpu"))
    monkeypatch.setattr(J, "grm_oracle", grm_oracle)
    monkeypatch.setattr(J, "write_grm_bin", T.write_grm_bin)
    pgen_fixtures.test_grm_bin_byte_golden(tmp_path)


def test_write_grm_bin_bytes_equal_jax(tmp_path):
    geno = rand_geno(np.random.default_rng(8), 150, 23)
    mat, nobs = T.grm(geno, device="cpu")
    ids = [f"S{i}" for i in range(23)]
    T.write_grm_bin(str(tmp_path / "port"), mat, nobs, ids)
    J.write_grm_bin(str(tmp_path / "jax"), mat, nobs, ids)
    for ext in (".grm.bin", ".grm.N.bin", ".grm.id"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()


# ------------------------------------------------------------------------ CLI
def _run(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        main(argv)
    return err.getvalue()


@pytest.mark.parametrize("form", ["pgen", "bed", "bfile_pgen"])
def test_cli_matches_jax(form, tmp_path):
    """The grm CLI with --device cpu against JAX's cmd_grm on written
    inputs: .grm.N.bin and .grm.id byte for byte, .grm.bin within 2e-5, the
    GRM line's shape."""
    geno = rand_geno(np.random.default_rng(12), 150, 40)
    ids = [f"sample{i}" for i in range(40)]
    pre = str(tmp_path / "in")
    if form == "bed":
        TP.write_bed(pre, geno, ids)
        argv = ["grm", "--bfile", pre]
    else:
        TP.write_pgen(pre, geno, ids=ids, mode=0x10)
        argv = (["grm", "--pgen", pre + ".pgen"] if form == "pgen" else
                ["grm", "--bfile", pre])
    if form == "bfile_pgen":            # a .bed beside it that the .pgen must win over
        TP.write_bed(pre, np.zeros_like(geno), ids)
    argv += ["--maf", "0.01", "--make-grm-bin", "--threads", "4"]
    err = _run(torch_cli_main, argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    _run(jax_cli_main, argv + ["--out", str(tmp_path / "jax")])
    assert err.startswith("GRM: 40 samples, ") and err.endswith(" sec\n")
    for ext in (".grm.N.bin", ".grm.id"):
        assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()
    got = np.fromfile(tmp_path / "port.grm.bin", "<f4")
    want = np.fromfile(tmp_path / "jax.grm.bin", "<f4")
    assert got.shape == (40 * 41 // 2,)
    np.testing.assert_allclose(got, want, **TOL)
    if form == "bfile_pgen":
        assert np.fromfile(tmp_path / "port.grm.N.bin", "<f4").max() > 0


def test_cli_needs_an_input(tmp_path):
    with pytest.raises(SystemExit) as exc:
        _run(torch_cli_main, ["grm", "--device", "cpu"])
    assert exc.value.code == 2
    assert not os.listdir(tmp_path)
