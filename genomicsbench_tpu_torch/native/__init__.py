"""The port's host library (C++), built with g++ and loaded with ctypes.

Eight sources, listed in `SOURCES` with their C entry points: `peaks.cpp`,
the sequential peak state machine of event detection; `poa.cpp`, the
partial-order-alignment graph engine (fusion, topological export, path
decoding, consensus); `sais.cpp`, the linear-time suffix array of the
FM-index build; `psr9.cpp`, the PSR9 profile-HMM Viterbi of eventalign's
reference-coordinate realignment; `ctc.cpp`, the basecaller's CTC
prefix beam search; `bam.cpp`, the BAM record batch parse into arrays;
`pileup.cpp`, pileup's CIGAR walks (the event stream, and the in-place
count into the matrix); and `dbg.cpp`, the de Bruijn read mentions and the
per-window graph build.  At first use each source is
compiled with `g++ -O2 -ffp-contract=off` (no multiply-add contracted into
an FMA, so every float operation rounds as written) into its own library
under `build/genomicsbench_tpu_torch/` at the repo root, named with a hash
of the source and the flags.  The build holds a
module lock, writes a temporary file named by process and thread, and moves
it into place with `os.replace`, so a process that loads the library
concurrently sees all of it or nothing.  There is no Python fallback:
without g++ the build raises.  Nothing is built or loaded when this module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "genomicsbench_tpu_torch"
CXX_FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")

_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
# Each source's C entry points: (return type, argument types).  Every array
# is a c_void_p, passed as an address (numpy's `ctypes.data`).
SOURCES = {
    "peaks": (HERE / "peaks.cpp", {
        "gb_peak_detector": (_I64, [_P, _P, _I64, _I32, _I32, _F32, _F32, _F32, _P, _I64]),
    }),
    "poa": (HERE / "poa.cpp", {
        "gb_poa_fuse": (_I64, [_P] * 12 + [_P, _P, _I64, _I64, _P, _P, _I64, _P, _I32]),
        "gb_poa_export": (_I64, [_P] * 10 + [_I64] * 3 + [_P] * 5),
        "gb_poa_export_packed": (_I64, [_P] * 10 + [_I64] * 3 + [_P] * 3),
        "gb_poa_decode_path": (None, [_P, _I64, _I32, _I32, _P, _I64, _P, _P, _P]),
        "gb_poa_consensus": (_I64, [_P] * 11 + [_I64, _P]),
    }),
    "sais": (HERE / "sais.cpp", {
        "gb_sais": (_I64, [_P, _I64, _I32, _P]),
    }),
    "psr9": (HERE / "psr9.cpp", {
        "gb_psr9_viterbi": (_I64, [ctypes.c_char_p, ctypes.c_char_p, _I64, _P, _I64,
                                   _F32, _F32, _F32, _P, _P, ctypes.c_double]
                            + [_I64] * 5 + [_P, _P, _P, _I64]),
    }),
    "ctc": (HERE / "ctc.cpp", {
        "gb_ctc_beam_search": (_I64, [_P, _I64, _I32, _I32, _F32, _P, _I64]),
    }),
    "bam": (HERE / "bam.cpp", {
        "gb_bam_scan": (_I64, [_P, _I64, _I64, _P]),
        "gb_bam_parse": (_I64, [_P, _I64, _I64] + [_P] * 17),
    }),
    "pileup": (HERE / "pileup.cpp", {
        "gb_pileup_events": (_I64, [_P] * 9 + [_I64] * 3 + [_P] * 4),
        "gb_pileup_extents": (None, [_P] * 6 + [_I64] * 3 + [_P] * 2),
        "gb_pileup_accumulate": (None, [_P] * 9 + [_I64] * 3 + [_I32, _P, _P]),
    }),
    "dbg": (HERE / "dbg.cpp", {
        "gb_dbg_mentions": (_I64, [_P] * 4 + [_I64, _I32, _I32] + [_P] * 6),
        "gb_dbg_build": (_I64, [_P] * 4 + [_I64] + [_P] * 5 + [_I32, _I32, _I64, _I64]
                         + [_P] * 10),
        "gb_dbg_build_ranged": (_I64, [_P] * 4 + [_I64] + [_P] * 6 + [_I32, _I32, _I64, _I64]
                                + [_P] * 10),
    }),
}

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None
_cdlls: list[ctypes.CDLL] = []


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name][0].read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgb{name}-{digest.hexdigest()[:16]}.so"


def _build_one(name: str) -> Path:
    lib = library_path(name)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host library cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    source = SOURCES[name][0]
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)        # atomic: a concurrent loader sees all or nothing
    return lib


def build() -> dict[str, Path]:
    """Compile every source whose library is missing; returns {name: library
    path}.  Raises if g++ is missing or fails."""
    with _lock:
        return {name: _build_one(name) for name in SOURCES}


def load() -> types.SimpleNamespace:
    """Every C entry point of the host library, as attributes (e.g.
    `load().gb_poa_fuse`), built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            fns = {}
            for name, (_, entries) in SOURCES.items():
                lib = ctypes.CDLL(str(_build_one(name)))
                _cdlls.append(lib)      # kept open for the life of the process
                for fn_name, (restype, argtypes) in entries.items():
                    fn = getattr(lib, fn_name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                    fns[fn_name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


def peak_detector(t1: np.ndarray, t2: np.ndarray, w1: int, w2: int,
                  th1: float, th2: float, peak_height: float) -> np.ndarray:
    """The peak positions (int64) of the short/long t-statistics t1, t2."""
    lib = load()
    t1 = np.ascontiguousarray(t1, np.float32)
    t2 = np.ascontiguousarray(t2, np.float32)
    if t1.shape != t2.shape or t1.ndim != 1:
        raise ValueError(f"t1 and t2 must be one-dimensional of one length, got "
                         f"{t1.shape} and {t2.shape}")
    out = np.empty(len(t1) + 1, np.int64)
    n = lib.gb_peak_detector(t1.ctypes.data, t2.ctypes.data, len(t1), w1, w2, th1, th2,
                             peak_height, out.ctypes.data, len(out))
    if n < 0:
        raise ValueError("peak buffer overflow")
    return out[:n]


def suffix_array(codes: np.ndarray, alphabet: int = 5) -> np.ndarray:
    """The suffix array (int32) of codes in [0, alphabet), by SA-IS; on tied
    prefixes the shorter suffix sorts first.  A code at or above `alphabet`
    is refused: SA-IS would index past its buckets."""
    codes = np.ascontiguousarray(codes, np.uint8)
    if len(codes) and int(codes.max()) >= alphabet:
        raise ValueError(f"suffix_array: code {int(codes.max())} is outside [0, {alphabet})")
    out = np.empty(len(codes), np.int32)
    got = load().gb_sais(codes.ctypes.data, len(codes), alphabet, out.ctypes.data)
    if got != len(codes):
        raise ValueError(f"gb_sais failed ({got}) for {len(codes)} symbols")
    return out


def psr9_viterbi(fwd_seq: bytes, rc_seq: bytes, ev_mean, scale, shift, var,
                 model_mean, model_stdv, events_per_base,
                 e_start: int, e_end: int, event_stride: int, rc: bool,
                 k: int = 6):
    """One PSR9 profile-HMM Viterbi segment alignment (gb_psr9_viterbi,
    the inner kernel of f5c eventalign's align_read_to_ref).  Returns
    (event_idx, kmer_idx, state_char) int32/int32/uint8 arrays in forward
    order."""
    lib = load()
    ev_mean = np.ascontiguousarray(ev_mean, np.float32)
    mm = np.ascontiguousarray(model_mean, np.float32)
    ms = np.ascontiguousarray(model_stdv, np.float32)
    n_events = abs(int(e_end) - int(e_start)) + 1
    n_kmers = max(len(fwd_seq) - k + 1, 0)
    cap = (n_events + n_kmers) * 2 + 16
    out_e = np.empty(cap, np.int32)
    out_k = np.empty(cap, np.int32)
    out_s = np.empty(cap, np.uint8)
    n = lib.gb_psr9_viterbi(
        fwd_seq, rc_seq, len(fwd_seq), ev_mean.ctypes.data, len(ev_mean),
        float(scale), float(shift), float(var), mm.ctypes.data, ms.ctypes.data,
        float(events_per_base), int(e_start), int(e_end), int(event_stride), int(bool(rc)),
        int(k), out_e.ctypes.data, out_k.ctypes.data, out_s.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("psr9_viterbi: output capacity exceeded")
    return out_e[:n].copy(), out_k[:n].copy(), out_s[:n].copy()


def ctc_beam_search(probs, beamsize: int = 5, threshold: float = 1e-3) -> np.ndarray:
    """CTC prefix beam search over (T, L) posteriors (gb_ctc_beam_search):
    the decoded class ids (int32, 1-based; blank is class 0)."""
    probs = np.ascontiguousarray(probs, np.float32)
    if probs.ndim != 2 or not 1 <= probs.shape[1] <= 9:
        raise ValueError(f"probs must be (T, L) with 1 to 9 classes, got {probs.shape}")
    if beamsize < 1:
        raise ValueError(f"beamsize must be at least 1, got {beamsize}")
    T, L = probs.shape
    out = np.empty(T + 1, np.int32)
    n = load().gb_ctc_beam_search(probs.ctypes.data, T, L, beamsize, threshold,
                                  out.ctypes.data, len(out))
    if n < 0:
        raise ValueError("ctc_beam_search: decoded sequence overflow")
    return out[:n].copy()


# ------------------------------------------------------------------ BAM
_SOA_FIELDS = (("ref_id", np.int32), ("pos", np.int32), ("flag", np.int32),
               ("mapq", np.int32), ("n_cig", np.int32), ("cig_off", np.int64),
               ("cigars", np.uint32), ("l_seq", np.int32), ("seq_off", np.int64),
               ("seqs", np.uint8), ("quals", np.uint8), ("name_len", np.int32),
               ("name_off", np.int64), ("names", np.uint8), ("end_pos", np.int32),
               ("tag_beg", np.int64), ("tag_end", np.int64))


def bam_parse(raw, off: int) -> dict:
    """Every whole BAM record from `off` of a decompressed BAM stream, as
    arrays (gb_bam_scan + gb_bam_parse; a truncated tail is left out).

    The dict holds n_rec and the fields of `_SOA_FIELDS`: cig_off, seq_off
    and name_off carry n_rec + 1 prefix offsets into cigars, seqs/quals and
    names; tag_beg/tag_end index `raw` itself; end_pos is pos plus the
    reference-consuming CIGAR lengths."""
    lib = load()
    buf = np.frombuffer(raw, np.uint8)
    if not 0 <= off <= len(buf):
        raise ValueError(f"bam_parse: offset {off} outside a stream of {len(buf)} bytes")
    totals = np.zeros(3, np.int64)
    n_rec = lib.gb_bam_scan(buf.ctypes.data, len(buf), off, totals.ctypes.data)
    sizes = dict(cigars=totals[0], seqs=totals[1], quals=totals[1], names=totals[2],
                 cig_off=n_rec + 1, seq_off=n_rec + 1, name_off=n_rec + 1)
    out = {name: np.empty(int(sizes.get(name, n_rec)), dt) for name, dt in _SOA_FIELDS}
    got = lib.gb_bam_parse(buf.ctypes.data, len(buf), off,
                           *(out[name].ctypes.data for name, _ in _SOA_FIELDS))
    if got != n_rec:
        raise RuntimeError(f"gb_bam_parse read {got} records where gb_bam_scan counted {n_rec}")
    out["n_rec"] = n_rec
    return out


def _walk_args(soa, hit, start: int, end: int):
    """The record arrays, the selected rows and the region of a CIGAR walk
    over a bam_parse batch, checked: (arrays kept alive, C arguments)."""
    arrays = [np.ascontiguousarray(soa[name], dt) for name, dt in
              (("pos", np.int32), ("flag", np.int32), ("n_cig", np.int32),
               ("cig_off", np.int64), ("cigars", np.uint32), ("seq_off", np.int64),
               ("seqs", np.uint8), ("quals", np.uint8))]
    hit = np.ascontiguousarray(hit, np.int64)
    if len(hit) and (int(hit.min()) < 0 or int(hit.max()) >= len(arrays[0])):
        raise ValueError(f"record rows outside a batch of {len(arrays[0])} records")
    arrays.append(hit)
    return arrays, [a.ctypes.data for a in arrays] + [len(hit), start, end]


def pileup_events(soa, hit, start: int, end: int):
    """Pileup's observations of the records `hit` of a bam_parse batch over
    [start, end) (gb_pileup_events): (pos, j, feature, qual) int32 arrays,
    one entry per counted base or deletion and one width-only marker
    (feature -1, j = the insertion's length) per anchored insertion."""
    lib = load()
    arrays, args = _walk_args(soa, hit, start, end)
    n_ev = lib.gb_pileup_events(*args, None, None, None, None)
    out = tuple(np.empty(n_ev, np.int32) for _ in range(4))
    got = lib.gb_pileup_events(*args, *(a.ctypes.data for a in out))
    if got != n_ev:
        raise RuntimeError(f"gb_pileup_events wrote {got} events where it counted {n_ev}")
    return out


def pileup_matrix(chunks, start: int, end: int, num_homop: int, stats: dict | None = None):
    """The counts matrix of [start, end), incremented in place during the
    CIGAR walk (gb_pileup_extents + gb_pileup_accumulate) over (soa, hit)
    chunks: (matrix int32 (n_cols, 10 * num_homop), major, minor).  With a
    dict as `stats`, the seconds of the two passes go there ("extents" with
    the column layout, "accumulate")."""
    lib = load()
    t0 = time.perf_counter()
    if num_homop < 1:
        raise ValueError(f"num_homop must be at least 1, got {num_homop}")
    span = max(end - start, 0)
    max_ins = np.zeros(span, np.int32)
    cov_diff = np.zeros(span + 1, np.int64)
    walks = [_walk_args(soa, hit, start, end) for soa, hit in chunks]
    for _arrays, args in walks:
        lib.gb_pileup_extents(*args[:5], *args[8:], max_ins.ctypes.data,
                              cov_diff.ctypes.data)
    covered = np.cumsum(cov_diff[:-1]) > 0
    covered |= max_ins > 0
    if not covered.any():
        z = np.zeros(0, np.int64)
        if stats is not None:
            stats.update(extents=time.perf_counter() - t0, accumulate=0.0)
        return np.zeros((0, 10 * num_homop), np.int32), z, z
    positions = np.nonzero(covered)[0].astype(np.int64) + start
    widths = max_ins[covered].astype(np.int64) + 1
    wcum = np.cumsum(widths.astype(np.float64)).astype(np.int64)
    n_cols = int(wcum[-1])
    starts_cols = wcum - widths
    major = np.repeat(positions, widths)
    minor = np.arange(n_cols, dtype=np.int64) - np.repeat(starts_cols, widths)
    base_cols = np.full(span, -1, np.int64)
    base_cols[covered] = starts_cols
    plane = 10 * num_homop
    matrix = np.zeros(n_cols * plane, np.int32)
    t1 = time.perf_counter()
    for _arrays, args in walks:
        lib.gb_pileup_accumulate(*args, num_homop, base_cols.ctypes.data, matrix.ctypes.data)
    if stats is not None:
        stats.update(extents=t1 - t0, accumulate=time.perf_counter() - t1)
    return matrix.reshape(n_cols, plane), major, minor


# ------------------------------------------------------------------ dbg
def _read_soa(seqs_flat, quals_flat, offs, lens, k: int):
    """The shared read arrays of a de Bruijn call, checked: each row's
    [off, off + len) inside the flat bases, the qualities as long, k in
    1..27 (a base-5 key of k digits overflows int64 past 27)."""
    if not 1 <= k <= 27:
        raise ValueError(f"k must be in 1..27, got {k}")
    seqs_flat = np.ascontiguousarray(seqs_flat, np.uint8)
    quals_flat = np.ascontiguousarray(quals_flat, np.int32)
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    if len(quals_flat) != len(seqs_flat) or len(offs) != len(lens):
        raise ValueError("seqs/quals and offs/lens must come in pairs of one length")
    if len(lens) and (int(lens.min()) < 0 or int(offs.min()) < 0
                      or int((offs + lens).max()) > len(seqs_flat)):
        raise ValueError("a read row lies outside the flat read arrays")
    return seqs_flat, quals_flat, offs, lens


def dbg_mentions(seqs_flat, quals_flat, offs, lens, k: int, min_qual: int):
    """Every read's edge mentions (gb_dbg_mentions): (key1, key2, ekey) int64
    and (w, t, c) int32 arrays, t the read row and c the span's start."""
    lib = load()
    seqs_flat, quals_flat, offs, lens = _read_soa(seqs_flat, quals_flat, offs, lens, k)
    base = (seqs_flat.ctypes.data, quals_flat.ctypes.data, offs.ctypes.data,
            lens.ctypes.data, len(lens), k, min_qual)
    n = lib.gb_dbg_mentions(*base, *([None] * 6))
    out = tuple(np.empty(n, dt) for dt in (np.int64,) * 3 + (np.int32,) * 3)
    got = lib.gb_dbg_mentions(*base, *(a.ctypes.data for a in out))
    if got != n:
        raise RuntimeError(f"gb_dbg_mentions wrote {got} mentions where it counted {n}")
    return out


def _dbg_build_call(refs, ref_starts, seqs_flat, quals_flat, offs, lens, read_lo, read_hi,
                    k, min_qual):
    """gb_dbg_build_ranged over a shared read SoA, window w taking read rows
    [read_lo[w], read_hi[w]) (ranges may overlap), with one retry at the
    exact totals when the estimated output capacity runs short.  Returns
    (node_off, edge_off, skip_n, node_keys5, colours, weights, positions,
    edge_start5, edge_succ5, edge_weight)."""
    lib = load()
    seqs_flat, quals_flat, offs, lens = _read_soa(seqs_flat, quals_flat, offs, lens, k)
    nw = len(refs)
    ref_lens = np.array([len(r) for r in refs], np.int64)
    ref_offs = np.concatenate([[0], np.cumsum(ref_lens)])[:-1].astype(np.int64)
    refs_flat = (np.concatenate([np.asarray(r, np.uint8) for r in refs])
                 if nw else np.zeros(0, np.uint8))
    ref_starts = np.ascontiguousarray(ref_starts, np.int64)
    read_lo = np.ascontiguousarray(read_lo, np.int64)
    read_hi = np.ascontiguousarray(read_hi, np.int64)
    if not len(ref_starts) == len(read_lo) == len(read_hi) == nw:
        raise ValueError("refs, ref_starts, read_lo and read_hi must have one entry per window")
    if nw and (int(read_lo.min()) < 0 or int(read_hi.max()) > len(lens)
               or bool((read_hi < read_lo).any())):
        raise ValueError(f"read ranges must lie in [0, {len(lens)}] with lo <= hi")
    # mention-count bounds give the output capacities, with one exact retry:
    # distinct nodes run about 0.10x the spans on 30x windowed data and edges
    # about 0.05x, so the capacities are sized 1.5-2x that (allocating for
    # every span cost more than the build at chromosome scale); inputs that
    # overflow (disjoint random reads) retry at the totals the first pass
    # counted.  Ranges may overlap, so each window counts its own slice.
    span_pre = np.concatenate([[0], np.cumsum(np.maximum(lens - k - 1, 0))])
    spans = int((span_pre[read_hi] - span_pre[read_lo]).sum()) \
        + int(np.maximum(ref_lens - k - 1, 0).sum())
    node_cap = int(min(2 * spans, spans // 5 + (1 << 21)))
    edge_cap = int(min(spans, spans // 10 + (1 << 21)))
    for _ in range(2):
        node_off = np.zeros(nw + 1, np.int64)
        edge_off = np.zeros(nw + 1, np.int64)
        skip_n = np.zeros(nw, np.uint8)
        nodes = [np.empty(node_cap, np.int64) for _ in range(4)]
        edges = [np.empty(edge_cap, np.int64) for _ in range(3)]
        rc = lib.gb_dbg_build_ranged(
            refs_flat.ctypes.data, ref_offs.ctypes.data, ref_lens.ctypes.data,
            ref_starts.ctypes.data, nw, seqs_flat.ctypes.data, quals_flat.ctypes.data,
            offs.ctypes.data, lens.ctypes.data, read_lo.ctypes.data, read_hi.ctypes.data,
            k, min_qual, node_cap, edge_cap, node_off.ctypes.data, edge_off.ctypes.data,
            skip_n.ctypes.data, *(a.ctypes.data for a in nodes + edges))
        if rc == 0:
            return (node_off, edge_off, skip_n, *nodes, *edges)
        if rc == -2:
            raise ValueError("gb_dbg_build_ranged: a window holds 2^24 or more mentions")
        node_cap = int(node_off[nw])
        edge_cap = int(edge_off[nw])
    raise RuntimeError("gb_dbg_build_ranged overflowed the exact capacities of its first pass")


def dbg_build(refs, ref_starts, reads_per_window, k: int, min_qual: int):
    """Every window's graph in one native call (gb_dbg_build_ranged).

    refs: (L,) uint8 reference slices; reads_per_window: per window a list
    of (seq_codes, quals), QC-fail reads already removed.  Returns the
    tuple of `_dbg_build_call`; windows flagged in skip_n (an N in the
    reference slice) are left to the caller.  The per-read lists cost
    O(total reads) of marshalling: callers holding one flat read SoA use
    dbg_build_soa."""
    seqs, quals, lens, row = [], [], [], [0]
    for rd in reads_per_window:
        for s, q in rd:
            seqs.append(np.asarray(s, np.uint8))
            quals.append(np.asarray(q, np.int32))
            lens.append(len(s))
        row.append(len(lens))
    lens = np.array(lens, np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])[:-1].astype(np.int64)
    seqs_flat = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    quals_flat = np.concatenate(quals).astype(np.int32) if quals else np.zeros(0, np.int32)
    row = np.array(row, np.int64)
    return _dbg_build_call(refs, ref_starts, seqs_flat, quals_flat, offs, lens, row[:-1],
                           row[1:], k, min_qual)


def dbg_build_soa(refs, ref_starts, seqs_flat, quals_flat, offs, lens, read_lo, read_hi,
                  k: int, min_qual: int):
    """dbg_build over one shared read SoA: window w takes read rows
    [read_lo[w], read_hi[w]), so a read in several 750-base-shift windows is
    stored and marshalled once; marshalling is O(windows)."""
    return _dbg_build_call(refs, ref_starts, seqs_flat, quals_flat, offs, lens, read_lo,
                           read_hi, k, min_qual)
