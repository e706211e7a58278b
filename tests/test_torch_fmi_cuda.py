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
CAPS = cases.cap_cases()
SEED3 = cases.seed3_cases()


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



def _smem1_with_rounds(tab, q, ql, items, msl):
    """gb_fmi_smem1 through its C entry with the rounds each item took;
    returns (the outputs, the rounds)."""
    from genomicsbench_tpu_torch import _kernels

    B, L = q.shape
    N = items[0].numel() if items else B
    CP, ME = fmi.walk_caps(L)
    full = torch.zeros(N * (fmi.SMEM1_HEAD + 4 * ME) + 1, dtype=torch.int32, device=q.device)
    rounds = torch.zeros(N, dtype=torch.int32, device=q.device)
    qrow, pivot, mi = (list(items) + [None] * 3)[:3]
    ptr = [t.data_ptr() if t is not None else None for t in (qrow, pivot, mi)]
    rc = _kernels.load().gb_fmi_smem1(
        tab.table.data_ptr(), q.data_ptr(), L, ql.data_ptr(), *ptr, N, int(bool(items)), msl, CP,
        ME, *fmi._launch_consts(tab), full.data_ptr(), rounds.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    return full[:-1], rounds


@pytest.mark.parametrize("label", sorted(CAPS) + sorted(EDGES))
def test_smem1_follows_the_model(card, label):
    """Walks that overflow CP and ME inside a column and columns of CP
    intervals, and every edge case: gb_fmi_smem1 == the plain version bit
    for bit, and each item takes the rounds of `lane_group_smem1`, the
    model of the kernel's schedule."""
    c = CAPS.get(label) or EDGES[label]
    index = fmi.build_fmd_index(c["ref"])
    tab = index.device(card)
    q, ql = _dev(c["query"], card), _dev(c["qlen"], card)
    items = [_dev(a, card) for a in c.get("items", ())]
    msl = c["min_seed_len"]
    got, rounds = _smem1_with_rounds(tab, q, ql, items, msl)
    want = fmi.fmi_smem1_reference(tab, q, ql, *items, min_seed_len=msl)
    assert torch.equal(got, want.buf)
    assert torch.equal(fmi.fmi_smem1(tab, q, ql, *items, min_seed_len=msl).buf, want.buf)
    model = cases.lane_group_smem1(index, c["query"], c["qlen"], *c.get("items", ()),
                                   min_seed_len=msl)
    np.testing.assert_array_equal(rounds.cpu().numpy(), model["rounds"])
    if label == "me_cap":
        assert bool(want.ovf.all())


@pytest.mark.parametrize("width", [1001, 1500])
def test_smem1_wide_reads_from_global_memory(card, width):
    """A 1,000-base read padded to widths whose rows pass the kernel's
    staging (read from global memory) or sit one byte past 1,000."""
    c = EDGES["long_read"]
    q = np.zeros((len(c["qlen"]), width), np.uint8)
    q[:, :c["query"].shape[1]] = c["query"]
    tab = fmi.build_fmd_index(c["ref"]).device(card)
    qd, qld = _dev(q, card), _dev(c["qlen"], card)
    assert torch.equal(fmi.fmi_smem1(tab, qd, qld, min_seed_len=19).buf,
                       fmi.fmi_smem1_reference(tab, qd, qld, min_seed_len=19).buf)

def _seed3_with_rounds(tab, q, ql, min_intv, min_len, em3):
    """gb_fmi_seed3 through its C entry with the rounds each read took, at
    `em3` slots; returns (the outputs, the rounds)."""
    from genomicsbench_tpu_torch import _kernels

    B, L = q.shape
    full = torch.zeros(B * (fmi.SEED3_HEAD + 4 * em3) + 1, dtype=torch.int32, device=q.device)
    rounds = torch.zeros(B, dtype=torch.int32, device=q.device)
    rc = _kernels.load().gb_fmi_seed3(
        tab.table.data_ptr(), q.data_ptr(), L, ql.data_ptr(), B, min_intv, min_len, em3,
        *fmi._launch_consts(tab), full.data_ptr(), rounds.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    return full[:-1], rounds


@pytest.mark.parametrize("label", sorted(SEED3) + sorted(k for k in EDGES
                                                       if "items" not in EDGES[k]))
def test_seed3_follows_the_model(card, label):
    """Reads of length 0, 1 and under min_len, N runs and an N at the last
    base, emits past a small EM3, widths 1,001 and 1,500 past the staged
    width, qlen past the width, and every edge case's pass 3: gb_fmi_seed3
    == the plain version (at the wrapper's EM3) and == `staged_seed3`, the
    model of its schedule, bit for bit, with each read's rounds."""
    c = SEED3.get(label) or dict(EDGES[label], min_intv=EDGES[label]["max_mem_intv"],
                                  min_len=EDGES[label]["min_seed_len"] + 1)
    index = fmi.build_fmd_index(c["ref"])
    tab = index.device(card)
    q, ql = _dev(c["query"], card), _dev(c["qlen"], card)
    kw = dict(min_intv=c["min_intv"], min_len=c["min_len"])
    em3 = c.get("em3") or fmi.seed3_cap(q.shape[1], c["min_len"])
    got, rounds = _seed3_with_rounds(tab, q, ql, c["min_intv"], c["min_len"], em3)
    model = cases.staged_seed3(index, c["query"], c["qlen"], em3=em3, **kw)
    res = fmi._walk_out(got, q.shape[0], em3, fmi.SEED3_HEAD)
    for f in ("count", "loads", "steps", "slots"):
        np.testing.assert_array_equal(getattr(res, f).cpu().numpy(), model[f], err_msg=f)
    np.testing.assert_array_equal(rounds.cpu().numpy(), model["rounds"])
    if "em3" not in c:
        assert torch.equal(got, fmi.fmi_seed3_reference(tab, q, ql, **kw).buf)
        assert torch.equal(fmi.fmi_seed3(tab, q, ql, **kw).buf, got)


@pytest.mark.parametrize("label", ["qlen_past_width", "width1001", "width1500"] +
                         sorted(k for k in EDGES if "items" not in EDGES[k]))
def test_extend_on_every_start(card, label):
    """gb_fmi_extend on every start -1 .. width + 1 of every read, floors 0,
    1, 3 and 40 and max_e at half the width, its lines loaded before its
    tests: == the plain version."""
    c = EDGES[label] if label in EDGES else SEED3[label]
    tab = fmi.build_fmd_index(c["ref"]).device(card)
    q, ql = _dev(c["query"], card), _dev(c["qlen"], card)
    lanes = [_dev(a, card) for a in cases.extend_lanes(c["query"], c["qlen"])]
    assert torch.equal(fmi.fmi_extend(tab, q, ql, *lanes),
                       fmi.fmi_extend_reference(tab, q, ql, *lanes))


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
