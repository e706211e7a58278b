"""Host-side input loaders (pair and anchor-call text formats)."""

from genomicsbench_tpu_torch.io.anchors import (AnchorCall, anchor_calls_from_dicts,
                                                load_anchor_calls, write_anchor_calls,
                                                write_returns)
from genomicsbench_tpu_torch.io.pairs import PairBatch, load_pairs, pack_pairs, write_pairs

__all__ = ["AnchorCall", "PairBatch", "anchor_calls_from_dicts", "load_anchor_calls",
           "load_pairs", "pack_pairs", "write_anchor_calls", "write_pairs",
           "write_returns"]
