"""Host-side input loaders (pair, anchor-call and phmm text formats; FASTA/Q
sequences, poa windows and raw signals)."""

from genomicsbench_tpu_torch.io.anchors import (AnchorCall, anchor_calls_from_dicts,
                                                load_anchor_calls, write_anchor_calls,
                                                write_returns)
from genomicsbench_tpu_torch.io.pairs import PairBatch, load_pairs, pack_pairs, write_pairs
from genomicsbench_tpu_torch.io.msa_fasta import decode_seq, encode_seq, read_msa_windows
from genomicsbench_tpu_torch.io.phmm_text import (PhmmBatch, PhmmRead, load_phmm_testfile,
                                                  phmm_batches_from_dicts,
                                                  write_phmm_testfile)
from genomicsbench_tpu_torch.io.seqio import read_fastx
from genomicsbench_tpu_torch.io.signals import load_signals

__all__ = ["AnchorCall", "PairBatch", "PhmmBatch", "PhmmRead", "anchor_calls_from_dicts",
           "decode_seq", "encode_seq", "load_anchor_calls", "load_pairs", "load_phmm_testfile",
           "load_signals", "pack_pairs", "phmm_batches_from_dicts", "read_fastx", "read_msa_windows",
           "write_anchor_calls", "write_pairs", "write_phmm_testfile", "write_returns"]
