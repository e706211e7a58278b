"""The data-parallel layer on the card: a one-rank NCCL world (the card's
machine has one H100 and NCCL refuses two ranks on one card), every
wrapper against its one-card entry point on the same inputs
(tests/torch_parallel_cases.py), the split backward-epilogue entries and
one mesh train step.  Every test needs an NVIDIA GPU (marker `cuda`) and
skips without one.  Bounds:

* every wrapper and sharded_count_kmers bit for bit against the one-card
  entry point; predict_sharded within rtol 2e-5, atol 2e-6 (the same
  forward on the same rows: in practice equal);
* gb_bc_bn_act_bwd_sums then gb_bc_bn_act_bwd_apply (called through
  ctypes, and through `bn_act_bwd` with a one-rank `BatchGroup`) bit for
  bit against the composed gb_bc_bn_act_bwd; the composed entry against
  the plain version as tests/test_torch_train_cuda.py holds it;
* one mesh train step against the one-card step from the same weights:
  the loss within 1e-4 relative, every gradient within 3% relative L2 and
  a cosine above 0.999 (the mesh takes the BatchNorm statistics as column
  sums over the ranks where one card takes torch.var_mean; cuBLAS, cuDNN
  and CUDA's CTC backward sum in their own orders).

This file imports neither JAX nor tests/conftest.py:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts
from genomicsbench_tpu_torch.models import basecaller as bc
from genomicsbench_tpu_torch.models import train as tr
from genomicsbench_tpu_torch.models import variant_caller as vc
from genomicsbench_tpu_torch.ops import abea, bsw, chain, fmi, kmer, pairhmm
from genomicsbench_tpu_torch.ops import basecaller as ops
from genomicsbench_tpu_torch.parallel import data_parallel as dp
from genomicsbench_tpu_torch.parallel.mesh import make_mesh
from genomicsbench_tpu_torch.parallel.sharded_count import sharded_count_kmers

import torch_parallel_cases as C
from torch_train_cases import (agreement, bn_bwd_scales, bn_bwd_sums64, bn_sums_depth,
                               kernel_sum_close, sums_close)

pytestmark = pytest.mark.cuda
_BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def _same(got, want, what):
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")


def test_bsw_sharded(mesh):
    got = dp.banded_sw_sharded(mesh, *C.bsw_inputs())
    want = bsw.banded_sw_batch(*C.bsw_inputs())
    _same(vars(got), vars(want), "bsw")


def test_pairhmm_sharded_with_its_float64_pairs(mesh):
    reads, haps, pairs = C.phmm_inputs()
    got = dp.pairhmm_sharded(mesh, reads, haps, pairs)
    want = pairhmm.pairhmm_batch(reads, haps, pairs)
    assert (want < -60).sum() == 2
    np.testing.assert_array_equal(got, want)


def test_chain_sharded_and_mesh_argument(mesh):
    calls = anchor_calls_from_dicts(C.chain_inputs())
    want = chain.chain_batch(calls)
    for got in (dp.chain_sharded(mesh, calls), chain.chain_batch(calls, mesh=mesh)):
        _same(vars(got), vars(want), "chain")


def test_abea_sharded(mesh):
    seqs, evs, sc, mm, ms = C.abea_inputs()
    got = C.abea_arrays(dp.abea_sharded(mesh, seqs, evs, mm, ms, sc))
    _same(got, C.abea_arrays(abea.align_batch(seqs, evs, mm, ms, sc)), "abea")


def test_fmi_sharded_and_mesh_pipeline(mesh):
    ref, q, qlen = C.fmi_inputs()
    index = fmi.build_fmd_index(ref)
    want = fmi.FmiPipeline(index).run(q, qlen)
    for got in (dp.fmi_sharded(mesh, index, q, qlen), fmi.FmiPipeline(index, mesh=mesh).run(q, qlen)):
        assert got[3] == want[3]
        for p in range(3):
            _same(C.smem_arrays("p", got[p]), C.smem_arrays("p", want[p]), f"fmi pass {p + 1}")


def test_sharded_count_through_all_to_all(mesh):
    for with_n in (False, True):
        seq, lens = C.kmer_inputs(with_n=with_n)
        want = kmer.count_kmers(seq, lens, C.K)
        for rep in (False, True):
            got = sharded_count_kmers(mesh, seq, lens, C.K, replicate_out=rep)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="capacity_factor"):
        sharded_count_kmers(mesh, seq, lens, C.K, capacity_factor=0.0)


def test_pileup_hist_sharded(mesh):
    keys = C.pileup_keys()
    got = dp.pileup_hist_sharded(mesh, keys, C.PILEUP_SIZE)
    np.testing.assert_array_equal(got, np.bincount(keys, minlength=C.PILEUP_SIZE))


def test_predict_sharded(mesh):
    cfg, tree, x = C.variant_inputs()
    state = vc.params_from_jax(tree, cfg)
    got = vc.predict_sharded(state, x, cfg, mesh)
    want = vc.predict_batches(state, [x], cfg)[0]
    for name, w in zip(vc.HEAD_NAMES, want):
        np.testing.assert_allclose(got[name].cpu().numpy(), w, rtol=2e-5, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("C_,N", [(48, 1), (34, 600), (256, 257), (280, 797), (464, 128_000)])
def test_split_bn_bwd_entries_equal_the_composed_entry(mesh, C_, N, res):
    from genomicsbench_tpu_torch.ops.basecaller import BatchGroup, bn_bwd_scratch_floats

    g = torch.Generator(device=mesh.device).manual_seed(C_ + N + res)
    rnd = lambda sd, loc: (torch.randn(N, C_, device=mesh.device, generator=g) * sd
                           + loc).to(_BF16)                                  # noqa: E731
    x, r, dout = rnd(2.0, 0.5), rnd(3.0, -1.0), rnd(1.0, 0.0)
    sc = 1 + 0.2 * torch.randn(C_, device=mesh.device, generator=g)
    bi = 0.2 * torch.randn(C_, device=mesh.device, generator=g)
    p = ops.bn_train_rows(x, sc, bi)
    rr, rp = (r, ops.bn_train_rows(r, bi + 1, sc - 1)) if res else (None, None)
    want = ops.bn_act_bwd(x, dout, p, rr, rp)
    nsum = 3 if res else 2
    part = torch.empty(bn_bwd_scratch_floats(N, C_, nsum), device=mesh.device)
    sums = torch.zeros(nsum, C_, device=mesh.device)
    dx, dres = torch.empty_like(x), torch.empty_like(x) if res else None
    ins = (x.data_ptr(), dout.data_ptr(), rr.data_ptr() if res else None, p.data_ptr(),
           rp.data_ptr() if res else None, N, C_, 1)
    _kernels.launch(mesh.device, "gb_bc_bn_act_bwd_sums", *ins, part.data_ptr(), part.numel(),
                    sums.data_ptr())
    _kernels.launch(mesh.device, "gb_bc_bn_act_bwd_apply", *ins, sums.data_ptr(), N,
                    dx.data_ptr(), dres.data_ptr() if res else None)
    grouped = ops.bn_act_bwd(x, dout, p, rr, rp, group=BatchGroup(mesh.data_group))
    torch.cuda.synchronize()
    for got in ((dx, dres, sums), grouped):
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    plain = ops.bn_act_bwd_reference(x, dout, p, rr, rp)
    exact, mags, term_err = bn_bwd_sums64(x, dout, p, rr, rp)
    kernel_sum_close(sums, exact, bn_sums_depth(N, C_, res), mags, f"sums C {C_} N {N}",
                     term_err)
    dx_s, dres_s, _ = bn_bwd_scales(x, dout, p, rr, rp)
    sums_close(dx, plain[0], N + 8, dx_s, f"dx C {C_} N {N}", 1e-3)
    if res:
        sums_close(dres, plain[1], N + 8, dres_s, f"dres C {C_} N {N}", 1e-3)


def test_mesh_train_step_against_one_card(mesh):
    cfg = bc.BasecallerConfig.tiny()
    batch = C.train_batch("scaled")
    out = {}
    for name, step in (("one", tr.make_train_step(cfg, learning_rate=C.TRAIN_LR)),
                       ("mesh", tr.make_train_step(cfg, learning_rate=C.TRAIN_LR, mesh=mesh))):
        got, *_ = C.train_run(step, batch, C.train_init(0), steps=1)
        out[name] = got
    assert abs(out["mesh"]["losses"][0] - out["one"]["losses"][0]) <= \
        1e-4 * abs(out["one"]["losses"][0])
    for k, want in out["one"].items():
        if k.startswith("grad:"):
            rel, cos = agreement(torch.from_numpy(out["mesh"][k]), torch.from_numpy(want))
            assert rel < 0.03 and cos > 0.999, (k, rel, cos)
