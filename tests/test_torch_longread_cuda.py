"""The long-read banded NW kernel on the card, against its plain PyTorch
version and the oracle.  Every test needs an NVIDIA GPU (marker `cuda`) and
skips without one.  Scores are int32: every comparison is exact.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_longread_cuda.py
"""

import numpy as np
import pytest
import torch

import genomicsbench_tpu_torch.ops.longread as T
from genomicsbench_tpu_torch.oracle.longread import banded_nw_oracle

from torch_longread_cases import band_binds, edge_cases, outside_band, pair, with_end_lane

pytestmark = pytest.mark.cuda
CASES = edge_cases()
BINDS = band_binds()
ORACLE_CELLS = 2_000_000


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_and_oracle(card, case):
    q, t, W = CASES[case]
    qt, tt = _on(card, q, t)
    got = int(T.longread_nw(qt, tt, W))
    assert got == int(T.longread_nw_reference(qt, tt, W)) == banded_nw_oracle(q, t, W)
    assert T.banded_nw(q, t, W) == got


def _same(card, q, t, W, *scores):
    """The kernel == the plain version on the card, and == the oracle where
    its Python loop over the cells stays under about 2 s (the CPU tests hold
    the plain version against the oracle and JAX)."""
    qt, tt = _on(card, q, t)
    got = int(T.longread_nw(qt, tt, W, *scores))
    assert got == int(T.longread_nw_reference(qt, tt, W, *scores))
    if W * len(t) <= ORACLE_CELLS:
        assert got == banded_nw_oracle(q, t, W, *scores)


@pytest.mark.parametrize("W", [1, 63, 64, 65, 1_023, 1_025, 2_048, 4_096, 6_145, 8_192, 8_193,
                               16_384])
def test_wide_bands(card, W):
    """Bands from one lane to 16,384: narrower than a stripe of the kernel,
    one stripe exactly, and many stripes' worth of rows a column."""
    q, t = pair(np.random.default_rng(W), 600, div=0.1, indels=W >= 64)
    _same(card, q, t, W)


@pytest.mark.parametrize("n", [127, 129, 1_001, 3_333])
def test_lengths_off_the_tile(card, n):
    """Reads whose length is no multiple of the 128-column stripe, the
    4-stripe group or the 32-row chunk."""
    q, t = pair(np.random.default_rng(n), n, div=0.12)
    _same(card, q, t, 256)


@pytest.mark.parametrize("W", [64, 2_048, 16_384])
@pytest.mark.parametrize("end", ["first", "last"])
def test_end_cell_on_the_band_edge(card, W, end):
    kend = 0 if end == "first" else W - 1
    q, t = with_end_lane(np.random.default_rng(W + kend), max(3_000, W), W, kend)
    assert len(q) - len(t) + W // 2 == kend
    _same(card, q, t, W)


@pytest.mark.parametrize("case", sorted(BINDS))
def test_band_binds(card, case):
    """Paths the band cuts off, and cheap gaps at one and two lanes, where a
    cell outside the band that were not NEG would win."""
    q, t, W, scores = BINDS[case]
    _same(card, q, t, W, *scores)


@pytest.mark.parametrize("scores", [(2, -3, 1), (5, 0, 3)])
def test_scores_are_parameters(card, scores):
    q, t, W = CASES["mid2000"]
    qt, tt = _on(card, q, t)
    assert int(T.longread_nw(qt, tt, W, *scores)) == int(
        T.longread_nw_reference(qt, tt, W, *scores))


def test_launch_count(card):
    q, t, W = CASES["single200"]
    T.longread_nw.launches = 0
    T.banded_nw(q, t, W)
    T.banded_nw(q, t, W)
    assert T.longread_nw.launches == 2


@pytest.mark.parametrize("fault", ["device", "dtype", "shape", "contiguity", "band", "end_cell",
                                   "kernel_range"])
def test_wrapper_refuses_on_the_card(card, fault):
    q, t, W = CASES["single200"]
    qt, tt = _on(card, q, t)
    err = ValueError
    if fault == "device":
        calls = [lambda: T.longread_nw(qt, tt.cpu(), W)]
    elif fault == "dtype":
        err, calls = TypeError, [lambda: T.longread_nw(qt.long(), tt, W)]
    elif fault == "shape":
        calls = [lambda: T.longread_nw(qt[None], tt, W)]
    elif fault == "contiguity":
        calls = [lambda: T.longread_nw(torch.stack([qt, qt], 1)[:, 0], tt, W)]
    elif fault == "band":
        calls = [lambda: T.longread_nw(qt, tt, 0), lambda: T.longread_nw(qt, tt, 64.0)]
    elif fault == "kernel_range":
        calls = [lambda: T.longread_nw(qt, tt, W, 10**7, -10**7, 10**7)]
    else:
        oq, ot, oW = outside_band()
        calls = [lambda: T.longread_nw(*_on(card, oq, ot), oW)]
    before = T.longread_nw.launches
    for call in calls:
        with pytest.raises(err):
            call()
    assert T.longread_nw.launches == before
