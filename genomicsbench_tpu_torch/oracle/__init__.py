"""NumPy scalar oracles: the reference semantics, a second witness beside
the JAX package in the tests and on the card."""

from genomicsbench_tpu_torch.oracle.bsw import banded_sw_oracle
from genomicsbench_tpu_torch.oracle.chain import chain_dp_oracle, make_anchors
from genomicsbench_tpu_torch.oracle.dbg import WindowGraph, build_window_graph_oracle
from genomicsbench_tpu_torch.oracle.grm import grm_oracle
from genomicsbench_tpu_torch.oracle.kmer import count_kmers_oracle, yield_minimizers_oracle
from genomicsbench_tpu_torch.oracle.longread import banded_nw_oracle
from genomicsbench_tpu_torch.oracle.pairhmm import (PH2PR_F64_CPOW, encode_bases,
                                                    pairhmm_forward_oracle,
                                                    pairhmm_forward_scaled,
                                                    pairhmm_forward_scaled_many)
from genomicsbench_tpu_torch.oracle.poa import PoaGraph, msa_consensus_oracle

__all__ = ["PH2PR_F64_CPOW", "PoaGraph", "WindowGraph", "banded_nw_oracle", "banded_sw_oracle",
           "build_window_graph_oracle", "chain_dp_oracle",
           "count_kmers_oracle", "encode_bases", "grm_oracle", "make_anchors",
           "msa_consensus_oracle", "pairhmm_forward_oracle", "pairhmm_forward_scaled",
           "pairhmm_forward_scaled_many", "yield_minimizers_oracle"]
