"""gbench in PyTorch — the port's CLI.

One entry point with a subcommand per ported benchmark, with the argument
names and defaults of the JAX package's CLI and of each reference binary's
getopt loop, plus `--device` (default `cuda`; `cpu` runs the plain
PyTorch versions).  Every subcommand prints the reference's timing-line
format.

    python -m genomicsbench_tpu_torch <subcommand> [args]

Subcommands: fmi, bsw, phmm, chain, poa, eventalign.
"""

from __future__ import annotations

import argparse
import sys
import time
import types

import numpy as np

from genomicsbench_tpu_torch import resolve_device


def cmd_fmi(args):
    """fmi ref.fa query.fastq batch_size minSeedLen n_threads (fmi.cpp:56).

    Prints, with --print-output, each batch's SMEMs sorted as the
    reference's sortSMEMs does (fmi.cpp:312-344): "rid:" headers and
    "[m,n+1]" lines, byte for byte as the JAX package's CLI prints them;
    then the timing line with totalSmem on stderr."""
    from genomicsbench_tpu_torch.io.msa_fasta import encode_seq
    from genomicsbench_tpu_torch.io.seqio import load_fastx_batch, read_fastx
    from genomicsbench_tpu_torch.ops.fmi import FmiPipeline, build_fmd_index

    resolve_device(args.device)
    ref = encode_seq(read_fastx(args.ref, max_reads=1)[0][1].decode())
    idx = build_fmd_index(ref)
    batch = load_fastx_batch(args.query, max_reads=args.max_reads)
    pipe = FmiPipeline(idx, min_seed_len=args.min_seed_len, device=args.device)
    t0 = time.perf_counter()
    total = 0
    out = []
    for s in range(0, batch.n, args.batch_size):
        sl = slice(s, min(s + args.batch_size, batch.n))
        p1, p2, p3, count = pipe.run(batch.codes[sl], batch.lengths[sl])
        total += count
        if args.print_output:
            out.append((s, p1, p2, p3))
    dt = time.perf_counter() - t0
    if args.print_output:
        lines, prev_rid = [], -1
        for s0, *passes in out:
            rows = sorted((s0 + int(r), int(m), int(n)) for smems in passes
                          for r, m, n in zip(smems.rid, smems.m, smems.n))
            for rid, m, n in rows:
                if rid != prev_rid:
                    lines += [f"{j}:" for j in range(prev_rid + 1, rid + 1)]
                    prev_rid = rid
                lines.append(f"[{m},{n + 1}]")
        if lines:
            sys.stdout.write("\n".join(lines) + "\n")
    print(f"Consumed: {dt:.2f} sec, totalSmem: {total}", file=sys.stderr)


def cmd_bsw(args):
    """bsw -pairs FILE -b batch [-match -mismatch -gapo -gape] (main_banded.cpp:84-129).

    Prints the rows (--print-output), then on stderr the timing line and
    what the device work spanned: on the CPU the bucket padding, as the
    JAX package prints it; on the card the band cells it evaluated."""
    from genomicsbench_tpu_torch.config import BswParams
    from genomicsbench_tpu_torch.io.pairs import load_pairs
    from genomicsbench_tpu_torch.ops.bsw import BswScorer

    # BswParams stores the mismatch penalty positive and score_matrix()
    # negates it, so the flag's value goes in as its absolute value.
    params = BswParams(
        match=args.match, mismatch=abs(args.mismatch),
        o_del=args.gapo, e_del=args.gape, o_ins=args.gapo, e_ins=args.gape,
    )
    batch = load_pairs(args.pairs)
    scorer = BswScorer(batch, params, batch_size=args.batch_size, device=args.device)
    t0 = time.perf_counter()
    res = scorer.score()
    dt = time.perf_counter() - t0
    if args.print_output:
        for i in range(len(res.score)):
            print(*res.row(i))
    cells = int((batch.qlen.astype(np.int64) * batch.tlen).sum())
    rep = scorer.padding_report()
    print(f"Overall SW cycles(sec): {dt:.4f}  pairs: {len(res.score)} "
          f"cells/s: {cells / dt:.3e}", file=sys.stderr)
    if scorer.device.type == "cuda":
        # the card pads nothing; it evaluates the band of each pair
        print(f"band cells evaluated: {rep['band_share']:.2f} of logical "
              f"({rep['band_cells']} / {rep['logical_cells']} cells)",
              file=sys.stderr)
    else:
        print(f"bucket padding efficiency: {rep['efficiency']:.2f} "
              f"({rep['logical_cells']} / {rep['padded_cells']} cells)",
              file=sys.stderr)


def cmd_phmm(args):
    """phmm -f testfile [-l loop] (PairHMMUnitTest.cpp:61-64).

    Scores each batch's read-major cross product, prints the rows as the
    JAX package's CLI does (--print-output), then the timing line on
    stderr."""
    from genomicsbench_tpu_torch.io.phmm_text import load_phmm_testfile
    from genomicsbench_tpu_torch.ops.pairhmm import pairhmm_batch

    batches = load_phmm_testfile(args.f)
    t0 = time.perf_counter()
    for _ in range(args.loop):
        results = []
        for b in batches:
            reads = [dict(bases=r.bases, q=r.q, i=r.i, d=r.d, c=r.c) for r in b.reads]
            results.append(pairhmm_batch(reads, b.haps, device=args.device))
    dt = time.perf_counter() - t0
    if args.print_output:
        for r in results:
            for v in r:
                print(f"{v:E}")
    print(f"PairHMM completed. Kernel runtime: {dt:.2f} sec", file=sys.stderr)


def cmd_chain(args):
    """chain -i in.txt -o out.txt (chain/src/main.cpp:22-37).

    Writes the print_return format (host_data_io.cpp:52-59) byte for byte
    as the JAX package's CLI does, then the timing line on stderr."""
    from genomicsbench_tpu_torch.io.anchors import load_anchor_calls, write_returns
    from genomicsbench_tpu_torch.ops.chain import chain_batch

    calls = load_anchor_calls(args.input)
    t0 = time.perf_counter()
    res = chain_batch(calls, device=args.device)
    dt = time.perf_counter() - t0
    if args.output:
        write_returns(args.output, [
            types.SimpleNamespace(scores=res.scores[r, :n], parents=res.parents[r, :n])
            for r, n in enumerate(res.n)])
    print(f"Time in kernel: {dt:.2f} sec", file=sys.stderr)


def cmd_poa(args):
    """poa -s input.fasta [-m -x -o g1,g2 -e e1,e2] (msa_spoa_omp.cpp:119-148).

    Prints each window's consensus as the JAX package's CLI does, byte for
    byte, then the runtime line on stderr."""
    from genomicsbench_tpu_torch.config import PoaParams
    from genomicsbench_tpu_torch.io.msa_fasta import decode_seq, read_msa_windows
    from genomicsbench_tpu_torch.ops.poa import msa_consensus_batch

    o = [int(x) for x in args.gap_open.split(",")]
    e = [int(x) for x in args.gap_ext.split(",")]
    params = PoaParams(
        match=args.match, mismatch=-abs(args.mismatch),
        gap_open1=-abs(o[0]), gap_ext1=-abs(e[0]),
        gap_open2=-abs(o[-1]), gap_ext2=-abs(e[-1]),
    )
    windows = read_msa_windows(args.seqfile)
    t0 = time.perf_counter()
    cons = msa_consensus_batch(windows, params, device=args.device)
    dt = time.perf_counter() - t0
    for i, c in enumerate(cons):
        print(f">Consensus_sequence_{i}\n{decode_seq(c)}")
    print(f"Runtime: {dt:.2f} sec ({len(windows)} windows)", file=sys.stderr)


def cmd_eventalign(args):
    """f5c eventalign in event-space mode over raw-signal and read-sequence
    inputs (run-gpu.sh:34,45; TSV format eventalign.c:1651-1941): signals
    from an .npz (one array per read name) paired with a FASTA/Q.  The TSV
    goes to stdout, byte for byte as the JAX package's CLI writes it, then
    the summary line on stderr."""
    from genomicsbench_tpu_torch.config import load_abea_profile
    from genomicsbench_tpu_torch.io import encode_seq, load_signals, read_fastx
    from genomicsbench_tpu_torch.ops import abea
    from genomicsbench_tpu_torch.ops.eventalign import eventalign_reads

    if args.bam or args.genome or args.sam:
        raise NotImplementedError(
            "eventalign -b/-g and --sam (reference coordinates through ref_align and "
            "BAM input) are not ported yet; run without them for event-space rows")
    resolve_device(args.device)
    if args.model:
        model_mean, model_stdv = abea.load_model_tsv(args.model)
    else:
        model_mean, model_stdv = abea.synthetic_model(seed=0)
    sig = load_signals(args.signals)
    seqs, raws = [], []
    for name, seq in read_fastx(args.reads):
        if name in sig:
            seqs.append(encode_seq(seq.decode()))
            raws.append(np.asarray(sig[name], np.float32))
    profile = load_abea_profile(args.profile) if args.profile else None
    t0 = time.perf_counter()
    results = eventalign_reads(raws, seqs, model_mean, model_stdv, tsv_fp=sys.stdout,
                               sample_rate=args.sample_rate, profile=profile,
                               device=args.device)
    dt = time.perf_counter() - t0
    n_ok = sum(1 for r in results if r.flag == 0)
    entries = sum(len(r.alignment.event_idx) for r in results if r.alignment)
    print(f"[eventalign] {n_ok}/{len(results)} reads aligned, total entries: {entries}; "
          f"Data processing time: {dt:.3f} sec", file=sys.stderr)


def build_parser():
    p = argparse.ArgumentParser(prog="gbench", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("fmi", help="FM-index SMEM seeding")
    s.add_argument("ref")
    s.add_argument("query")
    s.add_argument("batch_size", type=int, nargs="?", default=512)
    s.add_argument("min_seed_len", type=int, nargs="?", default=19)
    s.add_argument("n_threads", type=int, nargs="?", default=1,
                   help="accepted for run-cpu.sh parity (ignored)")
    s.add_argument("--max-reads", type=int, default=None)
    s.add_argument("--print-output", action="store_true")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_fmi)

    s = sub.add_parser("bsw", help="banded Smith-Waterman extension")
    s.add_argument("-pairs", required=True)
    s.add_argument("-t", type=int, default=1,
                   help="accepted for run-cpu.sh parity (ignored)")
    s.add_argument("-b", "--batch-size", type=int, default=512)
    s.add_argument("-match", type=int, default=1)
    s.add_argument("-mismatch", type=int, default=4)
    s.add_argument("-gapo", type=int, default=6)
    s.add_argument("-gape", type=int, default=1)
    s.add_argument("--print-output", action="store_true")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_bsw)

    s = sub.add_parser("phmm", help="pair-HMM forward likelihood")
    s.add_argument("-f", required=True)
    s.add_argument("-t", type=int, default=1,
                   help="accepted for run-cpu.sh parity (ignored)")
    s.add_argument("-l", "--loop", type=int, default=1)
    s.add_argument("--print-output", action="store_true")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_phmm)

    s = sub.add_parser("chain", help="minimap2 anchor chaining")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("-o", "--output")
    s.add_argument("-t", type=int, default=1,
                   help="accepted for run-cpu.sh parity (ignored)")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_chain)

    s = sub.add_parser("poa", help="partial-order MSA consensus")
    s.add_argument("-s", "--seqfile", required=True)
    s.add_argument("-t", type=int, default=1,
                   help="accepted for run-cpu.sh parity (ignored)")
    s.add_argument("-m", "--match", type=int, default=2)
    s.add_argument("-x", "--mismatch", type=int, default=4)
    s.add_argument("-o", "--gap-open", default="4,24")
    s.add_argument("-e", "--gap-ext", default="2,1")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_poa)

    s = sub.add_parser("eventalign", help="adaptive banded event alignment")
    s.add_argument("--signals", required=True, help=".npz of raw signals")
    s.add_argument("-r", "--reads", required=True,
                   help="FASTA/Q of read sequences")
    s.add_argument("-b", "--bam", help="alignments (with -g; not ported yet)")
    s.add_argument("-g", "--genome", help="reference FASTA (with -b; not ported yet)")
    s.add_argument("-B", "--batch-bases", default=None,
                   help="accepted for f5c parity (use --profile for "
                        "batch control)")
    s.add_argument("--sam", metavar="OUT_BAM", help="with -b/-g (not ported yet)")
    s.add_argument("--model", help="pore model TSV (else synthetic)")
    s.add_argument("--sample-rate", type=float, default=4000.0)
    s.add_argument("--profile",
                   help="runtime batching profile: preset name (v5e, "
                        "v5e-lite, cpu-test) or a file in f5c's 7-field "
                        "--profile format (f5c.c:1795-1844)")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_eventalign)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
