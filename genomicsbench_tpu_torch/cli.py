"""gbench in PyTorch — the port's CLI.

One entry point with a subcommand per ported benchmark, with the argument
names and defaults of the JAX package's CLI and of each reference binary's
getopt loop, plus `--device` (default `cuda`; `cpu` runs the plain
PyTorch versions).  Every subcommand prints the reference's timing-line
format.

    python -m genomicsbench_tpu_torch <subcommand> [args]

Subcommands: fmi, bsw, phmm, chain, poa, eventalign (event space, or
reference coordinates with -b/-g, or event-space records with --sam),
call-methylation (event space, or on the genome with -b/-g), kmer-cnt,
nn-base, nn-variant, grm, and the host-only pileup, dbg, meth-freq, index
and freq-merge.
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


def cmd_kmer_cnt(args):
    """kmer-cnt --reads f --config cfg [--kmer k] (kmer_cnt.cpp:31-106).

    Counts canonical k-mers (use_minimizers=0, the default) or window
    minimizers (use_minimizers=1) and prints the JAX package's stderr line.
    In minimizer mode it prints the number of emitted minimizers, the sum of
    the emission mask: the JAX CLI sums the (raw, mask) pair there and
    raises (genomicsbench_tpu/cli.py:208-212)."""
    from genomicsbench_tpu_torch.config import load_keyvalue_config
    from genomicsbench_tpu_torch.io.seqio import load_fastx_batch
    from genomicsbench_tpu_torch.ops.kmer import count_kmers_stats, minimizer_mask

    resolve_device(args.device)
    cfg = load_keyvalue_config(args.config) if args.config else {}
    if args.debug:      # the JAX package's Logger line (utils/observability.py:42)
        print(f"[{time.strftime('%H:%M:%S')}] [{'DEBUG':7s}] config: {cfg}", file=sys.stderr)
    k = args.kmer or int(cfg.get("kmer_size", 15))
    use_min = bool(cfg.get("use_minimizers", False))
    window = int(cfg.get("minimizer_window", 5))
    batch = load_fastx_batch(args.reads)
    t0 = time.perf_counter()
    if use_min:
        _, mask = minimizer_mask(batch.codes, batch.lengths, k=k, window=window,
                                 device=args.device)
        n = int(mask.sum())
        print(f"Kernel time: {time.perf_counter() - t0:.3f} sec  minimizers: {n}",
              file=sys.stderr)
    else:
        uniq, total = count_kmers_stats(batch.codes, batch.lengths, k, device=args.device)
        print(f"Kernel time: {time.perf_counter() - t0:.3f} sec  unique kmers: {uniq}  "
              f"total: {total}", file=sys.stderr)


def cmd_nn_base(args):
    """basecall.py: chunked CTC basecalling of raw signals (.npz of float
    arrays, or a fast5 file or directory) to FASTQ on stdout
    (basecall.py:630-645), in either of the JAX CLI's argument shapes
    (genomicsbench_tpu/cli.py:398-459): `--signals x.npz`, or the
    reference's positional `nn-base <model_directory> <reads_directory>
    --device cuda:0 --fastq` (run-gpu.sh:28).  A weights_*.tar in the model
    directory (the last in name order) is imported as bonito's state dict;
    otherwise the weights are `init_params`' deterministic random init,
    which differs from the JAX CLI's.  --beamsize 1 takes the greedy path
    with per-base qualities; else the qualities are all 'I'."""
    import glob
    import os

    from genomicsbench_tpu_torch.io.signals import load_signals
    from genomicsbench_tpu_torch.models.basecaller import (
        BasecallerConfig, basecall_signals, basecall_with_quals, build_model,
        import_torch_state_dict, init_params)

    cfg = BasecallerConfig()
    params = None
    if args.model_directory:
        tars = sorted(glob.glob(os.path.join(args.model_directory, "weights_*.tar")))
        if tars:
            import torch

            params = import_torch_state_dict(torch.load(tars[-1], map_location="cpu"), cfg)
            print(f"> loaded {os.path.basename(tars[-1])}", file=sys.stderr)
        else:
            print("> model directory has no weights_*.tar; using the deterministic random "
                  "init", file=sys.stderr)
    signals_src = args.signals or args.reads_directory
    if not signals_src:
        print("nn-base: --signals or a reads directory is required", file=sys.stderr)
        raise SystemExit(2)
    model = build_model(init_params(cfg) if params is None else params, cfg, args.device)
    sig = load_signals(signals_src)
    names = list(sig.keys())
    t0 = time.perf_counter()
    raws = [np.asarray(sig[n], np.float32) for n in names]
    if args.beamsize <= 1:
        pairs = basecall_with_quals(model, raws, chunksize=args.chunksize,
                                    overlap=args.overlap, device=args.device)
        seqs = [s for s, _ in pairs]
        quals = [q for _, q in pairs]
    else:
        seqs = basecall_signals(model, raws, chunksize=args.chunksize, overlap=args.overlap,
                                beamsize=args.beamsize, device=args.device)
        quals = ["I" * len(s) for s in seqs]
    dt = time.perf_counter() - t0
    n_samples = sum(len(sig[n]) for n in names)
    for n, s, q in zip(names, seqs, quals):
        print(f"@{n}\n{s}\n+\n{q}")
    print(f"> completed reads: {len(names)}", file=sys.stderr)
    print(f"> samples per second {n_samples / dt:.1E}", file=sys.stderr)


def cmd_nn_variant(args):
    """prediction.py: h5 mini-batch inference of the Clair 2BiLSTM model
    (prediction.py:70-116), as the JAX package's `cmd_nn_variant`
    (genomicsbench_tpu/cli.py:462-482).  --chkpnt_fn is a TF V2 checkpoint
    prefix (prediction.py:66 restore_parameters); without it the weights
    are `init_params`' deterministic random init, which differs from the
    JAX CLI's.  The four heads of each batch, concatenated, go to
    --output_fn with write_batches; the time of the prediction loop to
    stderr."""
    from genomicsbench_tpu_torch.io.h5_batches import read_batches, write_batches
    from genomicsbench_tpu_torch.models import variant_caller as vc

    resolve_device(args.device)
    cfg = vc.ClairConfig()
    params = vc.load_tf_checkpoint(args.chkpnt_fn, cfg) if args.chkpnt_fn else vc.init_params(cfg)
    model = vc.build_model(params, cfg, args.device)
    batches = read_batches(args.input_fn)
    t0 = time.perf_counter()
    outs = vc.predict_batches(model, [x for x, _ in batches], device=args.device)
    dt = time.perf_counter() - t0
    if args.output_fn:
        write_batches(args.output_fn, [np.concatenate(o, axis=1) for o in outs])
    print(f"Time taken: {dt:.4f} s", file=sys.stderr)


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


def _load_reads(args):
    """The names, 0..3-coded sequences and raw signals of the reads of
    args.reads that args.signals holds, in the reads file's order."""
    from genomicsbench_tpu_torch.io import encode_seq, load_signals, read_fastx

    sig = load_signals(args.signals)
    names, seqs, raws = [], [], []
    for name, seq in read_fastx(args.reads):
        if name in sig:
            names.append(name)
            seqs.append(encode_seq(seq.decode()))
            raws.append(np.asarray(sig[name], np.float32))
    return names, seqs, raws


def _pore_model(path):
    from genomicsbench_tpu_torch.ops import abea

    return abea.load_model_tsv(path) if path else abea.synthetic_model(seed=0)


def cmd_eventalign(args):
    """f5c eventalign over raw-signal and read-sequence inputs
    (run-gpu.sh:34,45; TSV format eventalign.c:1651-1941): signals from an
    .npz (one array per read name) paired with a FASTA/Q.  Without -b/-g
    the event-space TSV goes to stdout; with -b/-g the rows are realigned to
    the genome and come out in BAM record order (reference coordinates), or
    with --sam as event-space alignment records in a BAM container, byte
    for byte as the JAX package's CLI writes them; then the summary lines
    on stderr."""
    from genomicsbench_tpu_torch.config import load_abea_profile
    from genomicsbench_tpu_torch.ops.eventalign import TSV_HEADER, eventalign_reads
    from genomicsbench_tpu_torch.ops.ref_align import (emit_ref_alignment_tsv,
                                                        ref_rows_to_sam_record)

    resolve_device(args.device)
    model_mean, model_stdv = _pore_model(args.model)
    names, seqs, raws = _load_reads(args)
    profile = load_abea_profile(args.profile) if args.profile else None
    ref_mode = bool(args.bam and args.genome)
    t0 = time.perf_counter()
    results = eventalign_reads(raws, seqs, model_mean, model_stdv,
                               tsv_fp=None if ref_mode else sys.stdout,
                               sample_rate=args.sample_rate, profile=profile,
                               keep_aux=ref_mode, device=args.device)
    if ref_mode:
        # f5c's -b/-g shape: the events realigned to the genome segments of
        # each BAM record (align_read_to_ref); read_index = the record's
        # index in the BAM
        sam_records = [] if args.sam else None
        if not args.sam:
            sys.stdout.write(TSV_HEADER + "\n")
        n_rows = 0
        for ridx, rec, contig, _, rows, r in _iter_ref_alignments(
                args.bam, args.genome, names, seqs, results, model_mean, model_stdv):
            if sam_records is not None:
                sam_rec = ref_rows_to_sam_record(rows, rec.name, rec.ref_id, rec.mapq)
                if sam_rec is not None:
                    sam_records.append(sam_rec)
            else:
                emit_ref_alignment_tsv(sys.stdout, rows, r.events[0], r.events[1], r.events[2],
                                       r.scalings, model_mean, model_stdv, read_index=ridx,
                                       ref_name=contig, sample_rate=args.sample_rate)
            n_rows += len(rows)
        if sam_records is not None:
            from genomicsbench_tpu_torch.io.bam import BamFile, write_bam

            src = _open_bam(args.bam)
            write_bam(args.sam, BamFile(header_text=src.header_text, ref_names=src.ref_names,
                                        ref_lens=src.ref_lens, records=sam_records))
            print(f"[eventalign --sam] {len(sam_records)} event-space "
                  f"records -> {args.sam}", file=sys.stderr)
        print(f"[eventalign -b/-g] {n_rows} reference-coordinate rows", file=sys.stderr)
    dt = time.perf_counter() - t0
    n_ok = sum(1 for r in results if r.flag == 0)
    entries = sum(len(r.alignment.event_idx) for r in results if r.alignment)
    print(f"[eventalign] {n_ok}/{len(results)} reads aligned, total entries: {entries}; "
          f"Data processing time: {dt:.3f} sec", file=sys.stderr)


def _open_region_bam(path):
    """The reader of the region subcommands (pileup, dbg), as the JAX
    package's CLI opens it (JAX cli.py:29-38): an IndexedBam when a .bai sits
    beside the file (only the region's blocks are inflated), else the whole
    file."""
    import os

    from genomicsbench_tpu_torch.io.bam import IndexedBam, read_bam

    if os.path.exists(path + ".bai"):
        return IndexedBam(path)
    return read_bam(path)


def cmd_pileup(args):
    """pileup <bam> <region> [threads] [dtypes...] (medaka_counts.c:487): the
    counts matrix, printed with --print-output as print_pileup_data does,
    and the timing line on stderr.  As the JAX package's CLI, it passes
    num_dtypes = len(dtypes) and no dtype_of, so every count lands in dtype
    plane 0.  Host code."""
    from genomicsbench_tpu_torch.ops.pileup import pileup_counts

    bam = _open_region_bam(args.bam)
    t0 = time.perf_counter()
    res = pileup_counts(bam, args.region, num_dtypes=max(1, len(args.dtypes)),
                        num_homop=args.num_homop)
    dt = time.perf_counter() - t0
    if args.print_output:
        sys.stdout.write(res.text())
    print(f"Kernel runtime: {dt:.2f} s", file=sys.stderr)


def cmd_dbg(args):
    """dbg file.bam chr:start-stop ref.fa [threads] (debruijn.cpp:1442): the
    region's window graphs by the host library's build (the reference's ROI
    is build and destroy, debruijn.cpp:1429, so the array dicts are its
    product), and the timing line with the window and node counts."""
    from genomicsbench_tpu_torch.io.bam import FastaIndex
    from genomicsbench_tpu_torch.ops.dbg import dbg_from_bam

    bam = _open_region_bam(args.bam)
    fa = FastaIndex(args.ref)
    chrom, se = args.region.rsplit(":", 1)
    beg, end = (int(x) for x in se.split("-"))
    t0 = time.perf_counter()
    graphs = dbg_from_bam(bam, fa, chrom, beg, end, as_arrays=True)
    dt = time.perf_counter() - t0
    nodes = sum(len(g["node_keys"]) for g in graphs)
    print(f"Kernel runtime: {dt:.2f} s  windows: {len(graphs)} nodes: {nodes}", file=sys.stderr)


def _open_bam(path):
    """The whole BAM, record by record, whether or not a .bai sits beside
    it: the reference-mode walk needs every record in file order, which the
    JAX package's IndexedBam does not offer (with a .bai the JAX CLI's -b/-g
    raises TypeError)."""
    from genomicsbench_tpu_torch.io.bam import read_bam

    return read_bam(path)


_CIGAR_CODE = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}


def _iter_ref_alignments(bam_path, genome_path, names, seqs, results, model_mean,
                         model_stdv):
    """The -b/-g projection (JAX cli.py:365-395): walk the BAM records in
    order, realign each passing read's events onto its reference span, and
    yield (record index, record, contig, reference slice, rows,
    ReadResult)."""
    from genomicsbench_tpu_torch.io import read_fastx
    from genomicsbench_tpu_torch.ops.ref_align import align_read_to_ref

    genome = {n: s.decode().upper() for n, s in read_fastx(genome_path)}
    bam = _open_bam(bam_path)
    by_name = {n: (i, r) for i, (n, r) in enumerate(zip(names, results))}
    for ridx, rec in enumerate(bam.records):
        got = by_name.get(rec.name)
        if (got is None or got[1].flag != 0 or rec.is_unmapped
                or rec.is_secondary or rec.is_supplementary):
            continue
        i, r = got
        contig = bam.ref_names[rec.ref_id]
        ops = [_CIGAR_CODE[c] for c, _ in rec.cigar]
        lens = [ln for _, ln in rec.cigar]
        consumed = sum(ln for (c, ln) in rec.cigar if c in "MDN=X")
        ref_slice = genome[contig][rec.pos:rec.pos + consumed]
        rows = align_read_to_ref(
            ref_slice, rec.pos, ops, lens, rec.pos, rec.is_reverse,
            len(seqs[i]), r.b2e, r.events[0], r.scalings,
            model_mean, model_stdv, r.events_per_base)
        yield ridx, rec, contig, ref_slice, rows, r


METH_HEADER = ("chromosome\tstart\tend\tread_name\tlog_lik_ratio\t"
               "log_lik_methylated\tlog_lik_unmethylated\tnum_cpgs\tsequence")


def cmd_call_methylation(args):
    """f5c call-methylation (main.c:49-117 mode 0): eventalign every read,
    then score its CpG groups with the profile HMM, all reads' groups in
    one batch, and print per-site log-likelihood ratios as the JAX
    package's CLI does (JAX cli.py:486-567).  With -b/-g the events are
    realigned to the genome first and the groups scored on the reference,
    in genomic coordinates."""
    from genomicsbench_tpu_torch.ops import methylation as meth
    from genomicsbench_tpu_torch.ops.eventalign import eventalign_reads

    resolve_device(args.device)
    model_mean, model_stdv = _pore_model(args.model)
    if args.cpg_model:
        from genomicsbench_tpu_torch.ops.abea import load_model_tsv

        cpg_mean, cpg_stdv = load_model_tsv(args.cpg_model)
    else:
        cpg_mean, cpg_stdv = meth.synthetic_cpg_model(seed=0)
    names, seqs, raws = _load_reads(args)
    ref_mode = bool(args.bam and args.genome)
    t0 = time.perf_counter()
    # every read's results keep their events: event space scores the read's
    # own detected events (the JAX CLI detects them again, cli.py:563-566)
    results = eventalign_reads(raws, seqs, model_mean, model_stdv, keep_aux=True,
                               device=args.device)
    print(METH_HEADER)
    if ref_mode:
        keys, reads = [], []
        for _, rec, contig, ref_slice, rows, r in _iter_ref_alignments(
                args.bam, args.genome, names, seqs, results, model_mean, model_stdv):
            if not rows:
                continue
            keys.append((contig, rec.name))
            reads.append(dict(
                ref_seq=ref_slice, ref_start_pos=rec.pos,
                aln_ref_pos=np.array([row.ref_position for row in rows], np.int64),
                aln_event_idx=np.array([row.event_idx for row in rows], np.int64),
                event_means=r.events[0], scalings3=r.scalings,
                events_per_base=r.events_per_base, rc=rec.is_reverse))
    else:
        idx, reads = meth.event_space_reads(results, seqs)
        keys = [("read", names[b]) for b in idx]
    site_maps = meth.call_methylation_batch(reads, cpg_mean, cpg_stdv, device=args.device)
    lines = meth_lines(keys, site_maps)
    sys.stdout.write("".join(lines))
    print(f"[call-methylation] {len(lines)} site groups from {len(site_maps)} reads in "
          f"{time.perf_counter() - t0:.2f} sec", file=sys.stderr)


def meth_lines(keys, site_maps) -> list[str]:
    """The call-methylation rows of each read's sites, in position order:
    keys[i] = (chromosome, read name) of site_maps[i]."""
    return [f"{contig}\t{ss.start_position}\t{ss.end_position}\t{name}\t"
            f"{ss.ll_ratio:.2f}\t{ss.ll_methylated:.2f}\t"
            f"{ss.ll_unmethylated:.2f}\t{ss.n_cpg}\t{ss.sequence}\n"
            for (contig, name), sites in zip(keys, site_maps)
            for _, ss in sorted(sites.items())]


FREQ_HEADER = ("start\tend\tnum_cpgs_in_group\tcalled_sites\t"
               "called_sites_methylated\tmethylated_frequency\tgroup_sequence")


def cmd_meth_freq(args):
    """f5c meth-freq (main.c:53): aggregate a call-methylation TSV into
    per-site methylation frequencies (JAX cli.py:570-594)."""
    from genomicsbench_tpu_torch.ops.methylation import ScoredSite, methylation_frequency

    maps = []
    with open(args.input) as f:
        f.readline()
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 9:
                continue
            ss = ScoredSite(int(t[1]), int(t[2]), int(t[7]), t[8], float(t[6]), float(t[5]))
            maps.append({ss.start_position: ss})
    out = methylation_frequency(maps, call_threshold=args.call_threshold)
    print(FREQ_HEADER)
    for rec in out:
        print(f"{rec['start']}\t{rec['end']}\t{rec['n_cpg']}\t"
              f"{rec['called_sites']}\t{rec['called_sites_methylated']}\t"
              f"{rec['methylated_frequency']:.3f}\t{rec['sequence']}")


def cmd_index(args):
    """f5c index (main.c:49-117): write the readdb, readname -> signal
    source, of the reads in args.reads that args.signals holds (JAX
    cli.py:597-613)."""
    import os

    from genomicsbench_tpu_torch.io import load_signals, read_fastx

    sig = load_signals(args.signals)
    n = 0
    with open(args.reads + ".index.readdb", "w") as out:
        for name, _ in read_fastx(args.reads):
            if name in sig:
                out.write(f"{name}\t{os.path.abspath(args.signals)}\n")
                n += 1
    print(f"[index] {n} reads mapped", file=sys.stderr)


def cmd_freq_merge(args):
    """f5c freq-merge (main.c:54): merge meth-freq TSVs by site, summing the
    called and methylated counts and recomputing the frequencies (JAX
    cli.py:616-635)."""
    agg = {}
    for path in args.inputs:
        with open(path) as f:
            f.readline()
            for line in f:
                t = line.rstrip("\n").split("\t")
                if len(t) < 7:
                    continue
                rec = agg.setdefault((int(t[0]), int(t[1])), [int(t[2]), 0, 0, t[6]])
                rec[1] += int(t[3])
                rec[2] += int(t[4])
    print(FREQ_HEADER)
    for (start, end), (ncpg, called, meth, seq) in sorted(agg.items()):
        freq = meth / called if called else 0.0
        print(f"{start}\t{end}\t{ncpg}\t{called}\t{meth}\t{freq:.3f}\t{seq}")


def cmd_grm(args):
    """plink2 --pgen/--pvar/--psam --maf --make-grm-bin --out (run-cpu.sh:53,84;
    --bfile covers plink1 bed/bim/fam, or a .pgen beside the prefix, the
    shape the JAX package's suite writes).  The GRM line on stderr is the
    JAX CLI's."""
    import os

    from genomicsbench_tpu_torch.io.plink import read_bed, read_pgen
    from genomicsbench_tpu_torch.ops.grm import grm, write_grm_bin

    resolve_device(args.device)
    if args.pgen:
        prefix = args.pgen[:-5] if args.pgen.endswith(".pgen") else args.pgen
        geno, ids = read_pgen(prefix)
    elif args.bfile and os.path.exists(args.bfile + ".pgen"):
        geno, ids = read_pgen(args.bfile)
    elif args.bfile:
        geno, ids = read_bed(args.bfile)
    else:
        print("grm: one of --pgen or --bfile is required", file=sys.stderr)
        raise SystemExit(2)
    t0 = time.perf_counter()
    mat, nobs = grm(geno, maf=args.maf, device=args.device)
    dt = time.perf_counter() - t0
    if args.out:
        write_grm_bin(args.out, mat, nobs, ids)
    print(f"GRM: {mat.shape[0]} samples, {dt:.2f} sec", file=sys.stderr)


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
    s.add_argument("-b", "--bam",
                   help="alignments; with -g, emit REFERENCE-coordinate "
                        "rows (f5c's -b/-g mode, run-gpu.sh:45)")
    s.add_argument("-g", "--genome", help="reference FASTA (with -b)")
    s.add_argument("-B", "--batch-bases", default=None,
                   help="accepted for f5c parity (use --profile for "
                        "batch control)")
    s.add_argument("--sam", metavar="OUT_BAM",
                   help="with -b/-g: write event-space alignment records "
                        "(f5c --sam; BAM container) instead of TSV rows")
    s.add_argument("--model", help="pore model TSV (else synthetic)")
    s.add_argument("--sample-rate", type=float, default=4000.0)
    s.add_argument("--profile",
                   help="runtime batching profile: preset name (v5e, "
                        "v5e-lite, cpu-test) or a file in f5c's 7-field "
                        "--profile format (f5c.c:1795-1844)")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_eventalign)

    s = sub.add_parser("call-methylation", help="CpG methylation calling")
    s.add_argument("--signals", required=True)
    s.add_argument("-r", "--reads", required=True)
    s.add_argument("-b", "--bam",
                   help="with -g: score CpGs on the GENOME via the "
                        "reference-coordinate realignment (f5c meth flow)")
    s.add_argument("-g", "--genome")
    s.add_argument("--model")
    s.add_argument("--cpg-model")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_call_methylation)

    s = sub.add_parser("kmer-cnt", help="k-mer counting / minimizers")
    s.add_argument("--reads", required=True)
    s.add_argument("--config")
    s.add_argument("--kmer", type=int)
    s.add_argument("--threads", type=int, default=1,
                   help="accepted for run-cpu.sh parity (ignored)")
    s.add_argument("--debug", action="store_true",
                   help="debug-level logging (kmer_cnt.cpp:144-152)")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_kmer_cnt)

    s = sub.add_parser("nn-base", help="neural basecalling")
    s.add_argument("model_directory", nargs="?",
                   help="bonito model dir (basecall.py shape; "
                        "weights_*.tar imported if present)")
    s.add_argument("reads_directory", nargs="?",
                   help="fast5 directory (basecall.py shape)")
    s.add_argument("--signals", help=".npz of raw signals, or a fast5 file or directory")
    s.add_argument("--fastq", action="store_true",
                   help="accepted for parity (FASTQ is the only output)")
    s.add_argument("--chunksize", type=int, default=6000)
    s.add_argument("--overlap", type=int, default=300)
    s.add_argument("--beamsize", type=int, default=5)
    s.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:N for card N; raises without a card) or cpu")
    s.set_defaults(fn=cmd_nn_base)

    s = sub.add_parser("nn-variant", help="neural variant calling")
    s.add_argument("--input_fn", required=True)
    s.add_argument("--output_fn")
    s.add_argument("--chkpnt_fn", help="TF V2 checkpoint prefix (Clair weights)")
    # run-gpu.sh:31 parity (prediction.py flags; inference ignores them)
    s.add_argument("--sampleName", default="SAMPLE")
    s.add_argument("--threads", type=int, default=1)
    s.add_argument("--qual", type=int, default=100)
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_nn_variant)

    s = sub.add_parser("grm", help="genetic relationship matrix")
    s.add_argument("--bfile", help="plink1 bed/bim/fam prefix (or a .pgen beside it)")
    s.add_argument("--pgen", help="plink2 .pgen path or prefix (run-cpu.sh:53 shape)")
    s.add_argument("--pvar")
    s.add_argument("--psam")
    s.add_argument("--make-grm-bin", action="store_true",
                   help="accepted for parity (grm.bin written when --out)")
    s.add_argument("--threads", type=int, default=1,
                   help="accepted for run-cpu.sh parity (ignored)")
    s.add_argument("--maf", type=float, default=0.01)
    s.add_argument("--out")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    s.set_defaults(fn=cmd_grm)

    s = sub.add_parser("pileup", help="pileup counts matrix")
    s.add_argument("bam")
    s.add_argument("region")
    s.add_argument("n_threads", type=int, nargs="?", default=1,
                   help="accepted for run-cpu.sh parity (ignored); "
                        "medaka_counts.c:487 usage <bam> <region> <threads>")
    s.add_argument("dtypes", nargs="*", default=[])
    s.add_argument("--num-homop", type=int, default=5)  # medaka_counts.c:503
    s.add_argument("--print-output", action="store_true")
    s.set_defaults(fn=cmd_pileup)

    s = sub.add_parser("dbg", help="de Bruijn graph construction")
    s.add_argument("bam")
    s.add_argument("region")
    s.add_argument("ref")
    s.add_argument("n_threads", type=int, nargs="?", default=1,
                   help="accepted for run-cpu.sh parity (ignored)")
    s.set_defaults(fn=cmd_dbg)

    s = sub.add_parser("meth-freq", help="methylation frequency aggregation")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("-c", "--call-threshold", type=float, default=2.5)
    s.set_defaults(fn=cmd_meth_freq)

    s = sub.add_parser("index", help="readname -> signal source map (f5c index)")
    s.add_argument("--reads", required=True)
    s.add_argument("--signals", required=True)
    s.set_defaults(fn=cmd_index)

    s = sub.add_parser("freq-merge", help="merge meth-freq outputs")
    s.add_argument("inputs", nargs="+")
    s.set_defaults(fn=cmd_freq_merge)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
