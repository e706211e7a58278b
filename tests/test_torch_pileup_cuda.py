"""Pileup's device stage on the card: `_count_keys` (a torch.sort of the
histogram's keys on the card, then the host run-length encode) against the
same call on the CPU and np.bincount, exactly.  Every test needs an NVIDIA
GPU (marker `cuda`) and skips without one.

This file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_pileup_cuda.py
"""

import numpy as np
import pytest
import torch

from genomicsbench_tpu_torch.io.bam import IndexedBam
from genomicsbench_tpu_torch.ops import pileup as P

import torch_pileup_cases as C

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    # decided here, not at import or in skipif, so that every pytest-xdist
    # worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"


def _check(keys, card):
    got = P._count_keys(keys, device=card)
    want = P._count_keys(keys, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    if len(keys):
        hist = np.bincount(keys)
        assert np.array_equal(got[0], np.nonzero(hist)[0])
        assert np.array_equal(got[1], hist[got[0]])


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 4097, 1_000_000])
def test_count_keys_on_the_card(card, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(n // 3, 1), n)
    keys[: n // 5] = np.iinfo(np.int32).max - 1      # beside the padding value
    _check(keys, card)


def test_count_keys_of_a_pileup_histogram(card, tmp_path, monkeypatch):
    recs = C.random_records(5, n_rec=900, ref_len=5000, big=True)
    path = C.write_indexed(str(tmp_path / "x.bam"), recs, 5000)
    seen = []
    monkeypatch.setattr(P, "DEBUG_KEYS", seen)
    res = P.pileup_counts(IndexedBam(path), "chr1:1-5000", num_dtypes=2, num_homop=5)
    (keys, size), = seen
    _check(keys, card)
    uniq, counts = P._count_keys(keys, device=card)
    flat = np.zeros(size, np.int64)
    flat[uniq] = counts
    assert np.array_equal(flat, res.matrix.ravel())
