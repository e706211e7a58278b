"""The PyTorch port's chain (genomicsbench_tpu_torch) against the JAX package.

Runs on the CPU, where `chain_dp` takes its plain PyTorch version.  The same
inputs (tests/torch_chain_cases.py, made from numpy seeds) go through both
packages, the goldens of the compiled reference and the scalar oracle.
Tolerance: none, every output is int32 and must agree bit for bit on each
read's first n anchors (the JAX package leaves junk past n).
"""

import dataclasses

import numpy as np
import pytest
import torch

from genomicsbench_tpu.cli import main as jax_cli_main
from genomicsbench_tpu.io.anchors import AnchorCall as JaxAnchorCall
from genomicsbench_tpu.io.anchors import load_anchor_calls as jax_load_anchor_calls
from genomicsbench_tpu.ops import chain as jax_chain

from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.io.anchors import (AnchorCall, anchor_calls_from_dicts,
                                                write_anchor_calls)
from genomicsbench_tpu_torch.ops import chain
from genomicsbench_tpu_torch.oracle.chain import chain_dp_oracle

from torch_chain_cases import (GOLDEN, RING, bench_chain_calls, edge_cases, lane_group_chain,
                               load_golden)

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them and slow the run many times over
torch.set_num_threads(1)

EDGES = edge_cases()


def _rows(res, r, n):
    return np.stack([res.scores[r, :n], res.parents[r, :n], res.peak_scores[r, :n]], 1)


def _jax_batch(dicts, **kw):
    return jax_chain.chain_batch([JaxAnchorCall(**d) for d in dicts], **kw)


def _oracle_rows(c, **kw):
    """The oracle, with avg_qspan rounded through float32 as the reference
    and both packages round it."""
    o = chain_dp_oracle(c.x, c.y, avg_qspan=float(np.float32(c.avg_qspan)),
                        max_dist_x=c.max_dist_x, max_dist_y=c.max_dist_y, bw=c.bw,
                        n_segs=c.n_segs, **kw)
    return np.stack([o.scores, o.parents, o.peak_scores], 1)


@pytest.fixture(scope="module")
def golden_jax():
    """JAX chain_batch on the 11 golden calls, the 6,000-anchor call (its
    window 5,001 wide) in a group of its own, as test_chain_kernel.py runs
    it: one ChainBatchResult in call order."""
    calls, _ = load_golden()
    big = [k for k, c in enumerate(calls) if len(c["x"]) > 5000]
    small = [k for k in range(len(calls)) if k not in big]
    R, N = len(calls), max(len(c["x"]) for c in calls)
    out = [np.zeros((R, N), np.int32) for _ in range(3)]
    for group in (small, big):
        res = _jax_batch([calls[k] for k in group])
        for r, k in enumerate(group):
            n = len(calls[k]["x"])
            for plane, got in zip(out, (res.scores, res.parents, res.peak_scores)):
                plane[k, :n] = got[r, :n]
    return jax_chain.ChainBatchResult(*out, n=np.array([len(c["x"]) for c in calls]))


@pytest.fixture(scope="module")
def golden_port():
    """The port's chain_batch on all 11 golden calls in one batch."""
    calls, _ = load_golden()
    return chain.chain_batch(anchor_calls_from_dicts(calls), device="cpu")


@pytest.fixture(scope="module")
def edge_results():
    """The port's chain_batch on every edge case, run once."""
    return {label: chain.chain_batch(anchor_calls_from_dicts(dicts), device="cpu", **kw)
            for label, (dicts, kw) in EDGES.items()}


@pytest.fixture(scope="module")
def edge_jax():
    """JAX chain_batch on every edge case, run once."""
    return {label: _jax_batch(dicts, **kw) for label, (dicts, kw) in EDGES.items()}


def test_goldens(golden_port, golden_jax):
    """All 11 golden calls in one batch: equal to the .gold rows of the
    compiled reference and to JAX chain_batch."""
    calls, gold = load_golden()
    res = golden_port
    for k, (c, exp) in enumerate(zip(calls, gold)):
        n = len(c["x"])
        np.testing.assert_array_equal(_rows(res, k, n), exp, err_msg=f"call {k}")
        np.testing.assert_array_equal(_rows(res, k, n), _rows(golden_jax, k, n),
                                      err_msg=f"call {k} against JAX")
    np.testing.assert_array_equal(res.n, [len(c["x"]) for c in calls])


@pytest.mark.parametrize("label", sorted(EDGES))
def test_edges_match_jax(label, edge_results, edge_jax):
    """Multi-rid reads, n_segs = 2 with sid 0/1 and both is_cdna values,
    integer and 4-decimal avg_qspan, max_skip = 2, max_iter = 50, reads of
    0 and 1 anchors, unsorted anchors, window = 128 below the requirement,
    dense anchors whose walks visit their whole windows."""
    dicts, kw = EDGES[label]
    got = edge_results[label]
    want = edge_jax[label]
    for r, d in enumerate(dicts):
        n = len(d["x"])
        np.testing.assert_array_equal(_rows(got, r, n), _rows(want, r, n),
                                      err_msg=f"{label} read {r}")


@pytest.mark.parametrize("label", sorted(set(EDGES) - {"window128"}))
def test_edges_match_oracle(label, edge_results):
    """The scalar oracle on the same reads (it has no window cap, so the
    window case is left to JAX)."""
    dicts, kw = EDGES[label]
    got = edge_results[label]
    for r, c in enumerate(anchor_calls_from_dicts(dicts)):
        np.testing.assert_array_equal(_rows(got, r, c.n), _oracle_rows(c, **kw),
                                      err_msg=f"{label} read {r}")


def test_edge_rows_of_tiny_reads(edge_results):
    """A read of no anchors has no row; a read of one anchor scores its span
    with no parent; padding past n is 0, -1, 0."""
    dicts, _ = EDGES["n0_n1"]
    res = edge_results["n0_n1"]
    assert list(res.n) == [len(d["x"]) for d in dicts] == [0, 1, 40, 0, 1]
    for r in (1, 4):
        assert _rows(res, r, 1).tolist() == [[12, -1, 12]]
    assert (res.scores[[0, 1, 3, 4], 1:] == 0).all()
    assert (res.parents[[0, 1, 3, 4], 1:] == -1).all()
    assert (res.peak_scores[[0, 1, 3, 4], 1:] == 0).all()


def test_main_workload_sample():
    """Two reads of the main path's generator (818 anchors, 4-decimal
    avg_qspan) against JAX chain_batch and the oracle."""
    dicts = bench_chain_calls(2)
    calls = anchor_calls_from_dicts(dicts)
    got = chain.chain_batch(calls, device="cpu")
    want = _jax_batch(dicts)
    for r, c in enumerate(calls):
        np.testing.assert_array_equal(_rows(got, r, c.n), _rows(want, r, c.n))
        np.testing.assert_array_equal(_rows(got, r, c.n), _oracle_rows(c))


@pytest.mark.parametrize("label, max_skip", [("avg_4dec", 25), ("avg_4dec", 1 << 30),
                                             ("window128", 1 << 30), ("unsorted", 1 << 30)])
def test_visited_counts_the_window(label, max_skip):
    """visited is the oracle's loop count: the whole window (the two-pointer
    start, max_iter, window) when nothing breaks, fewer with the break."""
    dicts, kw = EDGES[label]
    calls = anchor_calls_from_dicts(dicts)
    pending = chain._chain_dispatch(calls, kw.get("window"), 5000, max_skip,
                                    False, "cpu")
    visited = pending.out[3].numpy()
    for r, c in enumerate(calls):
        w = np.arange(c.n) - chain.compute_window_starts(c.x, c.max_dist_x, 5000)
        if kw.get("window"):
            w = np.minimum(w, kw["window"])
        if max_skip < (1 << 30):
            assert 0 < visited[r] < w.sum()
        else:
            assert visited[r] == w.sum()


def _model(dicts, kw):
    """`lane_group_chain` (the model of gb_chain_dp's schedule) and the plain
    version on the same flat inputs."""
    calls = anchor_calls_from_dicts(dicts)
    t, _, _ = chain.upload_calls(calls, "cpu")
    args = [t[k] for k in chain.CHAIN_DP_INPUTS]
    opts = (kw.get("max_iter", 5000), kw.get("max_skip", 25), kw.get("is_cdna", False),
            kw.get("window") or 0)
    got = lane_group_chain(*(a.numpy() for a in args), *opts)
    want = chain.chain_dp_reference(*args, *opts)
    return calls, t["offs"].numpy(), got, [w.numpy() for w in want]


@pytest.mark.parametrize("label", sorted(EDGES))
def test_lane_group_model_on_edges(label, edge_jax):
    """The chain kernel's schedule (8 lanes x 4 candidates a read, the ring
    of 96 anchors filled a block ahead with deeper candidates from the
    outputs, the max_skip marks OR-reduced in the chunk and kept past it in
    a bitmap, the segmented scans, the break and improvement ballots, the
    two-pointer 8 lanes a round) equals the plain version's four outputs
    and JAX chain_batch's rows bit for bit."""
    dicts, kw = EDGES[label]
    calls, offs, got, want = _model(dicts, kw)
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(g, w)
    jx = edge_jax[label]
    for r, c in enumerate(calls):
        rows = np.stack([g[offs[r]:offs[r + 1]] for g in got[:3]], 1)
        np.testing.assert_array_equal(rows, _rows(jx, r, c.n), err_msg=f"{label} read {r}")
    stats = got[4]
    assert (stats["deep"] <= stats["loaded"]).all()
    if label == "deep_window":     # walks deeper than twice the ring, past it in memory
        assert stats["most"].max() >= 2 * RING and stats["deep"].sum() > 0


def test_lane_group_model_on_goldens(golden_port):
    """The model on the 11 golden calls: the plain version's outputs and
    the .gold rows."""
    calls, gold = load_golden()
    _, offs, got, want = _model(calls, {})
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(g, w)
    for k, exp in enumerate(gold):
        rows = np.stack([g[offs[k]:offs[k + 1]] for g in got[:3]], 1)
        np.testing.assert_array_equal(rows, exp, err_msg=f"call {k}")


def test_lane_group_model_main_path_sample():
    """24 reads of the main path's generator: the model equals the plain
    version and JAX chain_batch, and every candidate comes from the ring
    (the main path's windows are shallow: about 27 visited an anchor)."""
    dicts = bench_chain_calls(24)
    calls, offs, got, want = _model(dicts, {})
    for g, w in zip(got[:4], want):
        np.testing.assert_array_equal(g, w)
    jx = _jax_batch(dicts)
    for r, c in enumerate(calls):
        rows = np.stack([g[offs[r]:offs[r + 1]] for g in got[:3]], 1)
        np.testing.assert_array_equal(rows, _rows(jx, r, c.n), err_msg=f"read {r}")
    stats = got[4]
    assert stats["deep"].sum() == 0 and stats["loaded"].sum() > got[3].sum()


def test_kernel_window_bounds():
    """The kernel's bitmap width (`_max_window`) bounds every anchor's
    window on the edge cases, and a warp's shared memory
    (`_warp_shared_bytes`) fits a Hopper block up to windows of some
    440,000 candidates, which the wrapper refuses past that."""
    for label, (dicts, kw) in EDGES.items():
        calls = anchor_calls_from_dicts(dicts)
        offs = np.concatenate([[0], np.cumsum([c.n for c in calls])])
        mi, win = kw.get("max_iter", 5000), kw.get("window") or 0
        bound = chain._max_window(offs, mi, win)
        for c in calls:
            w = np.arange(c.n) - chain.compute_window_starts(c.x, c.max_dist_x, mi)
            if win:
                w = np.minimum(w, win)
            assert c.n == 0 or w.max() <= bound, label
    assert chain._max_window(np.array([0, 3000]), 5000, 0) == 2999
    assert chain._max_window(np.array([0, 3000]), 50, 0) == 50
    assert chain._max_window(np.array([0, 3000]), 5000, 128) == 128
    assert chain._warp_shared_bytes(0) == chain._warp_shared_bytes(29) == 4 * (2816 + 16)
    assert chain._warp_shared_bytes(440_000) <= chain.SHARED_MAX
    assert chain._warp_shared_bytes(460_000) > chain.SHARED_MAX


@pytest.mark.parametrize("avg", [15.0, 19.5, 13.0, 17.0,
                                 11.4817, 12.3456, 14.0713, 16.9999, 18.2203])
def test_gap_cost_is_the_c_double_expression(avg):
    """(int)(((double)dd * .01) * (double)(float)avg) for every dd in
    [0, 100000], at the goldens' avg values and five 4-decimal ones."""
    dd = np.arange(100_001, dtype=np.int64)
    want = ((dd.astype(np.float64) * np.float64(0.01))
            * np.float64(np.float32(avg))).astype(np.int64)
    got = chain.gap_linear(torch.from_numpy(dd), np.float32(avg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the float32 pitfall the double path avoids (dd = 20 at avg 15)
    assert int(np.float32(20) * np.float32(0.01) * np.float32(15.0)) == 2
    assert int(chain.gap_linear(torch.tensor([20]), 15.0)) == 3


def test_cli_matches_jax_cli(tmp_path, monkeypatch, golden_port, golden_jax):
    """The port's CLI output file on the golden input, byte for byte against
    the JAX CLI's.  Each CLI is given its own package's chain_batch result
    on the golden calls (golden_port, golden_jax), computed once for this
    file: the JAX package in one batch would run all 11 calls at the
    5,120-wide window, some 100 s on a CPU.  Both CLIs run for real in
    test_cli_matches_jax_cli_end_to_end."""
    inp = str(GOLDEN / "chain_default.in")
    ours, theirs = tmp_path / "torch.out", tmp_path / "jax.out"

    def port_batch(calls, device):
        assert device == "cpu" and len(calls) == len(golden_port.n)
        return golden_port

    monkeypatch.setattr(chain, "chain_batch", port_batch)
    torch_cli_main(["chain", "-i", inp, "-o", str(ours), "--device", "cpu", "-t", "4"])
    monkeypatch.setattr(jax_chain, "chain_batch", lambda calls: golden_jax)
    jax_cli_main(["chain", "-i", inp, "-o", str(theirs)])
    assert ours.read_bytes() == theirs.read_bytes()
    _, gold = load_golden()
    text = "".join(f"{len(g)}\n" + "".join(f"{s}\t{p}\n" for s, p, _ in g) + "EOR\n"
                   for g in gold)
    assert ours.read_text() == text


def test_cli_matches_jax_cli_end_to_end(tmp_path, capsys):
    """Both CLIs run for real on a file of the multi-rid edge reads."""
    path = tmp_path / "anchors.in"
    write_anchor_calls(str(path), anchor_calls_from_dicts(EDGES["multi_rid"][0]))
    ours, theirs = tmp_path / "torch.out", tmp_path / "jax.out"
    torch_cli_main(["chain", "-i", str(path), "-o", str(ours), "--device", "cpu"])
    assert "Time in kernel:" in capsys.readouterr().err
    jax_cli_main(["chain", "-i", str(path), "-o", str(theirs)])
    assert ours.read_bytes() == theirs.read_bytes()


def test_anchor_calls_round_trip(tmp_path):
    """JAX AnchorCalls cross as plain dicts; the text format reads the same
    in both packages."""
    calls, _ = load_golden()
    jax_calls = [JaxAnchorCall(**d) for d in calls[:5]]
    ours = anchor_calls_from_dicts(dataclasses.asdict(c) for c in jax_calls)
    assert all(isinstance(c, AnchorCall) for c in ours)
    for a, b in zip(ours, jax_calls):
        back = JaxAnchorCall(**dataclasses.asdict(a))
        assert a.x.dtype == a.y.dtype == np.uint64
        np.testing.assert_array_equal(back.x, b.x)
        np.testing.assert_array_equal(back.y, b.y)
        assert (a.avg_qspan, a.max_dist_x, a.max_dist_y, a.bw, a.n_segs, a.n) == \
            (b.avg_qspan, b.max_dist_x, b.max_dist_y, b.bw, b.n_segs, b.n)
    path = tmp_path / "calls.in"
    write_anchor_calls(str(path), ours)
    for a, b in zip(jax_load_anchor_calls(str(path)), jax_calls):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        np.testing.assert_array_equal(a.x, b.x)
        assert a.avg_qspan == b.avg_qspan
    with pytest.raises(TypeError):
        anchor_calls_from_dicts([{**dataclasses.asdict(jax_calls[0]), "rid": 1}])


def test_both_packages_refuse_large_max_dist_x():
    dicts, _ = EDGES["avg_integer"]
    d = {**dicts[0], "max_dist_x": 1 << 22}
    with pytest.raises(AssertionError):
        _jax_batch([d])
    with pytest.raises(ValueError, match="max_dist_x"):
        chain.chain_batch(anchor_calls_from_dicts([d]), device="cpu")
    d["max_dist_x"] = (1 << 22) - 1
    chain.chain_batch(anchor_calls_from_dicts([d]), device="cpu")


def test_window_starts_match_jax():
    for label in ("unsorted", "multi_rid", "max_iter50"):
        for c in EDGES[label][0]:
            for max_iter in (50, 5000):
                np.testing.assert_array_equal(
                    chain.compute_window_starts(c["x"], c["max_dist_x"], max_iter),
                    jax_chain.compute_window_starts(c["x"], c["max_dist_x"], max_iter))
