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

from torch_longread_cases import edge_cases, outside_band, pair

pytestmark = pytest.mark.cuda
CASES = edge_cases()


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


@pytest.mark.parametrize("W", [1_023, 1_025, 4_096, 6_145, T.MAX_BAND])
def test_wide_bands(card, W):
    """Several lanes a thread, and past 48 KB of shared memory (W above
    6,144) the opt-in."""
    q, t = pair(np.random.default_rng(W), 120, div=0.1)
    qt, tt = _on(card, q, t)
    got = int(T.longread_nw(qt, tt, W))
    assert got == int(T.longread_nw_reference(qt, tt, W)) == banded_nw_oracle(q, t, W)


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


@pytest.mark.parametrize("fault", ["device", "dtype", "shape", "contiguity", "band", "end_cell"])
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
        calls = [lambda: T.longread_nw(qt, tt, 0), lambda: T.longread_nw(qt, tt, T.MAX_BAND + 1)]
    else:
        oq, ot, oW = outside_band()
        calls = [lambda: T.longread_nw(*_on(card, oq, ot), oW)]
    before = T.longread_nw.launches
    for call in calls:
        with pytest.raises(err):
            call()
    assert T.longread_nw.launches == before
