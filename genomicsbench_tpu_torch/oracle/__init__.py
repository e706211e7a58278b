"""NumPy scalar oracles: the reference semantics, a second witness beside
the JAX package in the tests and on the card."""

from genomicsbench_tpu_torch.oracle.bsw import banded_sw_oracle
from genomicsbench_tpu_torch.oracle.chain import chain_dp_oracle, make_anchors

__all__ = ["banded_sw_oracle", "chain_dp_oracle", "make_anchors"]
