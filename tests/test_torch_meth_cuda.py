"""The methylation CUDA kernel on the card, against its plain PyTorch version.
Every test needs an NVIDIA GPU (marker `cuda`) and skips without one.
Tolerance: the JAX package's own bound, rel 2e-4 and abs 2e-3
(tests/test_methylation.py:52): the kernel's expf/log1pf and its K chain's
order of sums (a scan over the lanes of an instance's group) differ from
the plain version's in the last bits; every key, count and sequence is
exact.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_meth_cuda.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.ops import methylation as meth
from genomicsbench_tpu_torch.ops.eventalign import eventalign_reads

from torch_abea_cases import _model, eventalign_reads_case
from torch_meth_cases import (edge_instances, lane_k_batch, reversed_read, same_meth_rows,
                              strong_skip)

pytestmark = pytest.mark.cuda
CPG = meth.synthetic_cpg_model()
EDGES = edge_instances(CPG[0])
REL, ABS = 2e-4, 2e-3


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool((np.abs(got - want) <= ABS + REL * np.abs(want)).all())


@pytest.mark.parametrize("label", sorted(EDGES))
@pytest.mark.parametrize("flags", [3, 0])
def test_edges_kernel_matches_plain(card, label, flags):
    t = meth.upload_profile_instances(EDGES[label], *CPG, card)
    got = meth.meth_forward(t, flags)
    want = meth.meth_forward_reference(t, flags)
    torch.cuda.synchronize()
    assert _close(got.cpu(), want.cpu()), (got - want).abs().max().item()


@pytest.mark.parametrize("stride", [1, -1])
def test_both_row_directions_match_plain(card, stride):
    """The same instances with their events stored backwards and read from
    the last to the first (ev_first > ev_last)."""
    insts = EDGES["ragged"][:16]
    t = meth.upload_profile_instances(insts, *CPG, card)
    if stride < 0:
        t = meth.upload_profile_instances(
            [dict(i, event_means=np.asarray(i["event_means"])[::-1].copy()) for i in insts],
            *CPG, card)
        t.ev_first, t.ev_last = t.ev_last.clone(), t.ev_first.clone()
        t.host["ev_first"], t.host["ev_last"] = t.host["ev_last"], t.host["ev_first"]
    got = meth.meth_forward(t).cpu()
    want = meth.profile_hmm_score_batch(insts, *CPG, device="cpu")
    assert _close(got, want)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("flags", [3, 0])
def test_one_launch_holds_every_lane_group(card, flags, strong):
    """K at every lane-group edge and the 256 cap in one launch (every class
    of 1 to 32 lanes present), within the bound of the plain version; with
    `strong`, under a skip chain that carries weight in the score."""
    t = meth.upload_profile_instances(lane_k_batch(CPG[0]), *CPG, card)
    assert (t.host["class_n"] > 0).all()
    if strong:
        t.params = torch.from_numpy(strong_skip(t.params.cpu().numpy())).to(card)
    before = meth.meth_forward.launches
    got = meth.meth_forward(t, flags)
    assert meth.meth_forward.launches == before + 1
    want = meth.meth_forward_reference(t, flags)
    torch.cuda.synchronize()
    assert _close(got.cpu(), want.cpu()), (got - want).abs().max().item()


def test_scores_in_instance_order_for_a_shuffled_batch(card):
    insts = EDGES["ragged"] + lane_k_batch(CPG[0], seed=14)
    perm = np.random.default_rng(2).permutation(len(insts))
    got = meth.meth_forward(meth.upload_profile_instances(insts, *CPG, card)).cpu().numpy()
    shuffled = meth.upload_profile_instances([insts[i] for i in perm], *CPG, card)
    got_perm = meth.meth_forward(shuffled).cpu().numpy()
    np.testing.assert_array_equal(got_perm, got[perm])
    assert _close(got_perm, meth.meth_forward_reference(shuffled).cpu())


def test_reversed_range_ending_at_event_0_on_the_card(card):
    rd = reversed_read(CPG[0])
    on_card = meth.call_methylation_batch([rd], *CPG, device="cuda")[0]
    on_cpu = meth.call_methylation_batch([rd], *CPG, device="cpu")[0]
    assert list(on_card) == list(on_cpu) == [25]
    a, b = on_card[25], on_cpu[25]
    assert _close([a.ll_methylated, a.ll_unmethylated], [b.ll_methylated, b.ll_unmethylated])


def test_batch_on_the_card_equals_the_cpu_in_one_launch(card):
    raws, seqs = eventalign_reads_case(24, seed=7, lo=500, hi=800)
    res = eventalign_reads(raws, seqs, *_model(), keep_aux=True, device="cuda")
    _, reads = meth.event_space_reads(res, seqs)
    before = meth.meth_forward.launches
    stats = {}
    on_card = meth.call_methylation_batch(reads, *CPG, device="cuda", stats=stats)
    assert meth.meth_forward.launches == before + 1
    on_cpu = meth.call_methylation_batch(reads, *CPG, device="cpu")
    assert stats["groups"] == sum(len(s) for s in on_card) > 100
    for a, b in zip(on_card, on_cpu):
        assert list(a) == list(b)
        for k in a:
            assert (a[k].end_position, a[k].n_cpg, a[k].sequence) == (
                b[k].end_position, b[k].n_cpg, b[k].sequence)
            assert _close([a[k].ll_methylated, a[k].ll_unmethylated],
                          [b[k].ll_methylated, b[k].ll_unmethylated])


def test_cli_on_the_card_equals_the_cpu(card, tmp_path):
    raws, seqs = eventalign_reads_case(8, seed=9, lo=400, hi=600)
    names = [f"r{k}" for k in range(len(seqs))]
    np.savez(tmp_path / "s.npz", **dict(zip(names, raws)))
    (tmp_path / "r.fa").write_text("".join(f">{n}\n{''.join('ACGT'[c] for c in s)}\n"
                                           for n, s in zip(names, seqs)))
    outs = []
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            torch_cli_main(["call-methylation", "--signals", str(tmp_path / "s.npz"),
                            "-r", str(tmp_path / "r.fa"), "--device", dev])
        outs.append(buf.getvalue())
    ok, worst = same_meth_rows(*outs)
    assert ok and outs[0].count("\n") > 50, worst
