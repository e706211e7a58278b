"""The one-card long-read banded NW (genomicsbench_tpu_torch.ops.longread)
against the JAX package's `sharded_banded_nw` and the NumPy oracle, on the
CPU.

The same numpy reads (tests/torch_longread_cases.py) go through JAX's
band-sharded function on the 8-device CPU mesh (where W divides by 8) and on
a 1-device mesh, through the port's `banded_nw(device="cpu")` (the plain
version, the JAX package's `step` at D = 1) and through the oracle.  Scores
are int32: every comparison is exact.  Where the end cell lies outside the
band the port raises ValueError and JAX fails its assert.
"""

import jax
import numpy as np
import pytest
import torch

from genomicsbench_tpu.ops.longread import banded_nw_oracle as jax_oracle
from genomicsbench_tpu.ops.longread import sharded_banded_nw
from genomicsbench_tpu.parallel.mesh import make_mesh

import genomicsbench_tpu_torch.ops.longread as T
from genomicsbench_tpu_torch.oracle.longread import banded_nw_oracle

from torch_longread_cases import band_binds, edge_cases, outside_band

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them
torch.set_num_threads(1)

CASES = edge_cases()
BINDS = band_binds()


@pytest.fixture(scope="module")
def meshes():
    n = min(8, jax.device_count())
    return make_mesh(jax.devices()[:n]), make_mesh(jax.devices()[:1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_banded_nw_matches_jax_and_oracle(case, meshes):
    q, t, W = CASES[case]
    want = banded_nw_oracle(q, t, W)
    assert want is not None and want == jax_oracle(q, t, W)
    got = T.banded_nw(q, t, W, device="cpu")
    assert got == want
    wide, one = meshes
    if not len(t):      # JAX's row scan indexes the empty target and raises
        with pytest.raises(IndexError):
            sharded_banded_nw(one, q, t, W)
        return
    if W % wide.shape["data"] == 0:
        assert sharded_banded_nw(wide, q, t, W) == want
    if case in ("single200", "odd_band", "one_lane", "kend_first", "query_longer"):
        assert sharded_banded_nw(one, q, t, W) == want


def test_identical_reads_score_their_length():
    q, t, W = CASES["identical500"]
    assert T.banded_nw(q, t, W, device="cpu") == 500


@pytest.mark.parametrize("scores", [(2, -3, 1), (1, -1, 2), (5, 0, 3)])
def test_scores_are_parameters(scores):
    q, t, W = CASES["random300_1"]
    assert T.banded_nw(q, t, W, *scores, device="cpu") == banded_nw_oracle(q, t, W, *scores)


def test_wrapper_takes_tensors():
    q, t, W = CASES["kend_last"]
    out = T.longread_nw(torch.from_numpy(q.astype(np.int32)),
                        torch.from_numpy(t.astype(np.int32)), W)
    assert out.dtype == torch.int32 and out.shape == (1,)
    assert int(out) == banded_nw_oracle(q, t, W)


def test_end_cell_outside_the_band(meshes):
    q, t, W = outside_band()
    assert banded_nw_oracle(q, t, W) is None
    with pytest.raises(ValueError, match="outside the band.*W = 64"):
        T.banded_nw(q, t, W, device="cpu")
    with pytest.raises(AssertionError, match="outside the band"):
        sharded_banded_nw(meshes[0], q, t, W)
    with pytest.raises(ValueError, match="outside the band"):
        T.banded_nw(q[:10], t, W, device="cpu")       # the other side


@pytest.mark.parametrize("case", sorted(BINDS))
def test_band_binds_matches_jax_and_oracle(case, meshes):
    """Where the band cuts off the best path (and, with gaps cheaper than a
    mismatch, a path around the band's edge would win), the plain version
    equals JAX on one device and the oracle."""
    q, t, W, scores = BINDS[case]
    want = banded_nw_oracle(q, t, W, *scores)
    assert want is not None
    assert T.banded_nw(q, t, W, *scores, device="cpu") == want
    assert sharded_banded_nw(meshes[1], q, t, W, *scores) == want


def test_kernel_range_refusals():
    """The kernel's exactness bounds: int32 coordinates, and scores that
    keep every in-band cell above NEG / 2; the main read passes both."""
    T.check_kernel_range(100_000, 100_000, 2_048, 1, -1, 2)
    T.check_kernel_range(0, 0, 1, 10**6, -10**6, 10**6)
    with pytest.raises(ValueError, match="int32 coordinates"):
        T.check_kernel_range(1 << 29, 1 << 29, 16, 1, -1, 2)
    with pytest.raises(ValueError, match="NEG / 2"):
        T.check_kernel_range(300, 300, 128, 10**6, -10**6, 10**6)
