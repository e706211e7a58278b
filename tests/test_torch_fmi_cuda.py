"""The fmi CUDA kernels on the card, against their plain PyTorch versions,
brute force and fmi_gold.  Every test needs an NVIDIA GPU (marker `cuda`)
and skips without one.  Tolerance: none; every value is an integer, so the
emit slots, counts, overflow flags and rank-line counters agree exactly.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_fmi_cuda.py
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.ops import fmi

import torch_fmi_cases as cases

pytestmark = pytest.mark.cuda
EDGES = cases.edge_cases()


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _dev(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("label", sorted(EDGES))
def test_kernels_match_plain_on_edge_cases(card, label):
    c = EDGES[label]
    tab = fmi.build_fmd_index(c["ref"]).device(card)
    q, ql = _dev(c["query"], card), _dev(c["qlen"], card)
    msl = c["min_seed_len"]
    if "items" in c:
        items = [_dev(a, card) for a in c["items"]]
        got = fmi.fmi_smem1(tab, q, ql, *items, min_seed_len=msl)
        want = fmi.fmi_smem1_reference(tab, q, ql, *items, min_seed_len=msl)
        assert torch.equal(got.buf, want.buf)
        return
    got = fmi.fmi_smem1(tab, q, ql, min_seed_len=msl)
    assert torch.equal(got.buf, fmi.fmi_smem1_reference(tab, q, ql, min_seed_len=msl).buf)
    if label == "poly_a":
        assert bool(got.ovf.all())
    kw = dict(min_intv=c["max_mem_intv"], min_len=msl + 1)
    assert torch.equal(fmi.fmi_seed3(tab, q, ql, **kw).buf,
                       fmi.fmi_seed3_reference(tab, q, ql, **kw).buf)
    B, L = q.shape
    qrow = torch.arange(B, dtype=torch.int32, device=card).repeat_interleave(L)
    start = torch.arange(L, dtype=torch.int32, device=card).repeat(B)
    for floor, end in ((1, 1 << 30), (0, L // 2), (3, 1 << 30)):
        mi = torch.full_like(start, floor)
        me = torch.full_like(start, end)
        assert torch.equal(fmi.fmi_extend(tab, q, ql, qrow, start, mi, me),
                           fmi.fmi_extend_reference(tab, q, ql, qrow, start, mi, me)), floor


@pytest.mark.parametrize("label", ["ambiguous", "short", "poly_a", "repetitive"])
def test_pipeline_on_the_card_matches_bruteforce(card, label):
    c = EDGES[label]
    text = cases.text_bytes(c["ref"])
    q, ql = c["query"], c["qlen"]
    launches = fmi.fmi_extend.launches
    p1, p2, p3, _ = fmi.FmiPipeline(fmi.build_fmd_index(c["ref"]), device=card).run(q, ql)
    if label == "poly_a":       # the overflow route: one extension launch
        assert fmi.fmi_extend.launches == launches + 1
    for b in range(len(ql)):
        got = [(m, n, s) for rid, m, n, s in p1.sorted_tuples(True) if rid == b]
        assert got == cases.brute_smems(text, q[b], int(ql[b]), 19), b


def test_4096_reads_match_fmi_gold(card, tmp_path):
    ref = cases.bench_fmi_reference(1_000_000)
    idx = fmi.build_fmd_index(ref)
    q, ql = cases.bench_fmi_reads(ref, 4096)
    pipe = fmi.FmiPipeline(idx, device=card)
    got = cases.pipeline_tuples(*pipe.run(q, ql)[:3])
    cases.write_gold_index(tmp_path / "index.bin", idx.n + 1, idx.sentinel_row, idx.C,
                           fmi.cleaned_bwt(idx))
    cases.write_gold_reads(tmp_path / "reads.bin", q)
    want, summary = cases.run_fmi_gold(cases.build_fmi_gold(tmp_path), tmp_path / "index.bin",
                                       tmp_path / "reads.bin")
    assert got == want, summary
    tab = pipe.tables
    qd, qld = _dev(q, card), _dev(ql, card)
    assert torch.equal(fmi.fmi_smem1(tab, qd, qld, min_seed_len=19).buf,
                       fmi.fmi_smem1_reference(tab, qd, qld, min_seed_len=19).buf)
    assert torch.equal(fmi.fmi_seed3(tab, qd, qld, min_intv=20, min_len=20).buf,
                       fmi.fmi_seed3_reference(tab, qd, qld, min_intv=20, min_len=20).buf)
