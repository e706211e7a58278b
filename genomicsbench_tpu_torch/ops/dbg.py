"""de Bruijn window graphs: Platypus's assembler kernel (benchmarks/dbg), in
the port.

The port's copy of genomicsbench_tpu/ops/dbg.py.  Semantics, debruijn.cpp:
* per 1,500-base assembly window (shift 750, debruijn.cpp:1539-1555) a k=15
  graph of the window's reference slice ([start - 1500, end + 1500)) and
  the reads that start inside the window;
* the reference pass (loadReferenceIntoGraph:1262-1288): one edge per
  position i in [0, len - k - 1), weight 1, colour REF; both end nodes OR
  in the colour and add the weight per mention; a node's position is its
  first insertion;
* the read pass (loadReadIntoGraph:1322-1367, QC-fail reads skipped): the
  k + 1 bases of the edge must all be A/C/G/T with quality >= min_qual (20);
  the edge's and its nodes' weight is the span's least quality, colour READ;
* a node keeps at most 4 outgoing edges, in first-mention order
  (DeBruijnGraph_AddEdge:888-920); edge weights add per mention.

Two formulations give the same graphs:
* the host library's hash build (native.dbg_build_soa, gb_dbg_build_ranged):
  `build_window_graphs(as_arrays=True)`, `build_window_graphs_soa` and
  `dbg_from_bam(as_arrays=True)`, which the `dbg` CLI runs.  Host code;
* the sort-reduce (`_build_window_graphs_sorted`): 2-bit k-mer keys and
  (k-mer << 2 | next base) edge keys of every mention, every window in one
  key space (the window id in the high 32 bits), one stable sort per
  mention type on the card (`_device_sort_pairs`), segment reductions on
  the host.  `build_window_graphs(as_arrays=False)` and
  `dbg_from_bam(as_arrays=False)` run it and return `WindowGraph`s.

A reference slice with N takes the dict oracle (oracle/dbg.py) in both: N
has no 2-bit code.  The inputs are numpy arrays, lists of (seq, quals,
qcfail) and BAM/FASTA readers; nothing crosses from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from genomicsbench_tpu_torch import native, resolve_device
from genomicsbench_tpu_torch.oracle.dbg import (K_DEFAULT, READ, REF, WindowGraph,
                                                build_window_graph_oracle)
from genomicsbench_tpu_torch.utils import offsets_from_lengths

# above this many mention pairs the sort runs on the host, as the JAX
# package's does: the sorted mentions come back for the host reductions anyway
HOST_SORT_ABOVE = 1 << 22
# the sorted formulation packs a (k + 1)-base edge key into 32 bits
MAX_SORTED_K = 15


def _kmers_2bit(codes: np.ndarray, k: int):
    """(L,) codes -> (L - k + 1,) int64 2-bit keys and their valid mask (no N)."""
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    keys = np.zeros(n, np.int64)
    valid = np.ones(n, bool)
    c = codes.astype(np.int64)
    for j in range(k):
        keys = (keys << 2) | np.clip(c[j : j + n], 0, 3)
        valid &= c[j : j + n] <= 3
    return keys, valid


def _sort_pairs_on(dev: torch.device, wids: np.ndarray, keys: np.ndarray):
    """The stable order of (window id, 32-bit key) pairs, sorted on `dev`:
    one stable torch.sort over int64 wid << 32 | key, padded to a power of
    two (at least 128) with pairs that sort last.  Stable on the input
    order, it gives the order of the JAX package's two stable 32-bit passes.
    Returns (sorted combined keys, order), both int64 numpy."""
    n = len(keys)
    pad = max(128, 1 << (max(n, 1) - 1).bit_length())
    combined = (torch.from_numpy(np.ascontiguousarray(wids, np.int64)) << 32) \
        | torch.from_numpy(np.ascontiguousarray(keys, np.int64))
    buf = torch.full((pad,), (np.iinfo(np.int32).max << 32) | np.iinfo(np.uint32).max,
                     dtype=torch.int64, device=dev)
    buf[:n] = combined.to(dev)
    values, order = torch.sort(buf, stable=True)
    _sort_pairs_on.launches += 1
    return values[:n].cpu().numpy(), order[:n].cpu().numpy()


_sort_pairs_on.launches = 0


def _device_sort_pairs(wids: np.ndarray, keys: np.ndarray, device="cuda"):
    """Stable lexsort by (window id, 32-bit key): (combined int64 keys
    wid << 32 | key in sorted order, the order).  Up to HOST_SORT_ABOVE pairs
    sort on `device`, more on the host (np.argsort, stable).  Window ids must
    lie in [0, 2^31) and keys in [0, 2^32)."""
    dev = resolve_device(device)
    if len(wids) != len(keys):
        raise ValueError(f"_device_sort_pairs: {len(wids)} window ids for {len(keys)} keys")
    n = len(keys)
    if n and (int(keys.min()) < 0 or int(keys.max()) >= 1 << 32):
        raise ValueError("_device_sort_pairs: a key lies outside the 32-bit key space")
    if n and (int(wids.min()) < 0 or int(wids.max()) >= 1 << 31):
        raise ValueError("_device_sort_pairs: a window id lies outside [0, 2^31)")
    if n > HOST_SORT_ABOVE:
        combined = (wids.astype(np.int64) << 32) | keys.astype(np.int64)
        order = np.argsort(combined, kind="stable")
        return combined[order], order
    return _sort_pairs_on(dev, wids, keys)


def _to5_vec(keys2bit: np.ndarray, k: int) -> np.ndarray:
    """2-bit keys -> base-5 node keys (the key space that holds N)."""
    out = np.zeros(len(keys2bit), np.int64)
    for shift in range(2 * (k - 1), -2, -2):
        out = out * 5 + ((keys2bit >> shift) & 3)
    return out


def _empty_arrays():
    z = np.zeros(0, np.int64)
    return dict(node_keys=z, colours=z, weights=z, positions=z, edge_start=z, edge_succ=z,
                edge_weight=z)


def _graph_to_arrays(g: WindowGraph):
    keys = np.array(sorted(g.nodes), np.int64)
    vals = [g.nodes[int(kk)] for kk in keys]
    ekeys = list(g.edges)
    return dict(
        node_keys=keys,
        colours=np.array([v[0] for v in vals], np.int64),
        weights=np.array([v[1] for v in vals], np.int64),
        positions=np.array([v[2] for v in vals], np.int64),
        edge_start=np.array([e[0] for e in ekeys], np.int64),
        edge_succ=np.array([e[1] for e in ekeys], np.int64),
        edge_weight=np.array([g.edges[e] for e in ekeys], np.int64),
    )


def _native_arrays(got, n_windows, fallback):
    """Per-window array dicts from a native build's flat outputs; a window
    flagged in skip_n (N in its reference slice) takes fallback(wid)."""
    node_off, edge_off, skip_n, nk5, nc, nw_, npos, es5, eu5, ew = got
    results = []
    for wid in range(n_windows):
        if skip_n[wid]:
            results.append(_graph_to_arrays(fallback(wid)))
            continue
        ns_ = slice(node_off[wid], node_off[wid + 1])
        es_ = slice(edge_off[wid], edge_off[wid + 1])
        results.append(dict(node_keys=nk5[ns_], colours=nc[ns_], weights=nw_[ns_],
                            positions=npos[ns_], edge_start=es5[es_], edge_succ=eu5[es_],
                            edge_weight=ew[es_]))
    return results


def _build_window_graphs_native(windows, k, min_qual):
    """Every window's graph in one host-library call (gb_dbg_build_ranged);
    a window with N in its reference slice takes the dict oracle."""
    got = native.dbg_build(
        [np.asarray(w[0], np.uint8) for w in windows], [w[1] for w in windows],
        [[(np.asarray(s), np.asarray(q)) for s, q, qc in w[2] if not qc] for w in windows],
        k, min_qual)

    def oracle(wid):
        ref, ref_start, reads = windows[wid]
        return build_window_graph_oracle(np.asarray(ref), ref_start, reads, k=k,
                                         min_qual=min_qual)

    return _native_arrays(got, len(windows), oracle)


def build_window_graphs_soa(refs, ref_starts, seqs_flat, quals_flat, lens, read_lo, read_hi,
                            k=K_DEFAULT, min_qual=20, chunk_windows=8192, offs=None):
    """The chromosome-scale array build over one shared read SoA.

    refs: (L,) uint8 reference slices; window w takes read rows
    [read_lo[w], read_hi[w]) of the flat seqs_flat / quals_flat / lens, and
    the ranges may overlap: that is the reference's 750-base window tiling
    (assemRegionShift, debruijn.cpp:1389-1432), a read in several windows
    stored once.  QC-fail reads must already be out.  Returns the per-window
    array dicts of build_window_graphs(as_arrays=True); marshalling is
    O(windows), every per-mention pass runs in the host library.

    chunk_windows bounds each call's output capacity (a whole chromosome in
    one call would allocate tens of GB); the read SoA is shared by every
    chunk, never copied.  Callers that loop over window subsets of one SoA
    pass `offs` (offsets_from_lengths(lens)), which is O(reads) to build."""
    lens = np.ascontiguousarray(lens, np.int64)
    if offs is None:
        offs = offsets_from_lengths(lens)
    read_lo = np.ascontiguousarray(read_lo, np.int64)
    read_hi = np.ascontiguousarray(read_hi, np.int64)
    nw = len(refs)
    if chunk_windows and nw > chunk_windows:
        out = []
        for c0 in range(0, nw, chunk_windows):
            c1 = min(c0 + chunk_windows, nw)
            out.extend(build_window_graphs_soa(
                refs[c0:c1], ref_starts[c0:c1], seqs_flat, quals_flat, lens, read_lo[c0:c1],
                read_hi[c0:c1], k=k, min_qual=min_qual, chunk_windows=0, offs=offs))
        return out
    got = native.dbg_build_soa([np.ascontiguousarray(r, np.uint8) for r in refs], ref_starts,
                               seqs_flat, quals_flat, offs, lens, read_lo, read_hi, k, min_qual)

    def oracle(wid):
        reads = [(seqs_flat[offs[r]:offs[r] + lens[r]], quals_flat[offs[r]:offs[r] + lens[r]],
                  False) for r in range(read_lo[wid], read_hi[wid])]
        return build_window_graph_oracle(np.asarray(refs[wid]), ref_starts[wid], reads, k=k,
                                         min_qual=min_qual)

    return _native_arrays(got, nw, oracle)


def build_window_graphs(windows, k=K_DEFAULT, min_qual=20, as_arrays=False, device="cuda"):
    """Every window's graph.

    windows: [(ref codes, ref start, reads)], reads = [(seq codes, quals,
    qcfail)].  Returns [WindowGraph] from the sort-reduce on `device`
    (`_build_window_graphs_sorted`), or with as_arrays=True per-window dicts
    of arrays (node keys, colours, weights, positions; edge start, successor,
    weight) from the host library, without the per-node dicts that cost most
    at chromosome scale (the reference's ROI is the build itself,
    debruijn.cpp:1429 destroys the graph at once).  The array route never
    touches the card."""
    if as_arrays:
        return _build_window_graphs_native(windows, k, min_qual)
    return _build_window_graphs_sorted(windows, k, min_qual, False, device)


def _build_window_graphs_sorted(windows, k=K_DEFAULT, min_qual=20, as_arrays=False,
                                device="cuda"):
    """The sort-reduce formulation (the JAX package's build_window_graphs
    without its native route): every window's mention records share one
    stable (window id, 32-bit key) sort per record type on `device`; the
    colours, weights, first positions and the 4-slot edge rule reduce on the
    host.  Returns [WindowGraph], or the array dicts with as_arrays=True.
    Refuses k above MAX_SORTED_K: the (k + 1)-base edge keys must fit 32 bits."""
    dev = resolve_device(device)
    if not 1 <= k <= MAX_SORTED_K:
        raise ValueError(f"the sorted formulation takes k in 1..{MAX_SORTED_K}, got {k}")
    nw_, nc_, np_, no_, nk_, nwid = [], [], [], [], [], []
    ek_, ew_, eo_, ewid = [], [], [], []
    has_n = []
    read_entries = []  # (wid, seq, quals, order base)
    order_counter = 0
    for wid, (ref, ref_start, reads) in enumerate(windows):
        ref = np.asarray(ref)
        keys, valid = _kmers_2bit(ref, k)
        nE = len(ref) - k - 1
        window_has_n = bool((~valid[: max(nE + 1, 0)]).any()) if len(valid) else False
        has_n.append(window_has_n)
        if window_has_n:
            continue  # the dict oracle builds the whole window
        if nE > 0:
            sk = keys[:nE]
            ek = keys[1 : nE + 1]
            pos = ref_start + np.arange(nE, dtype=np.int64)
            nk_ += [sk, ek]
            nwid += [np.full(nE, wid, np.int32)] * 2
            nc_ += [np.full(nE, REF, np.int64)] * 2
            nw_ += [np.ones(nE, np.int64)] * 2
            np_ += [pos, pos + 1]
            no_ += [np.arange(nE, dtype=np.int64) * 2 + order_counter,
                    np.arange(nE, dtype=np.int64) * 2 + order_counter + 1]
            ek_.append((sk << 2) | ref[k : k + nE].astype(np.int64))
            ewid.append(np.full(nE, wid, np.int32))
            ew_.append(np.ones(nE, np.int64))
            eo_.append(np.arange(nE, dtype=np.int64) + order_counter)
            order_counter += 2 * nE + 1
        for seq, quals, qcfail in reads:
            if qcfail:
                continue
            seq = np.asarray(seq)
            nE2 = len(seq) - k - 1
            if nE2 <= 0:
                continue
            read_entries.append((wid, seq, np.asarray(quals), order_counter))
            order_counter += 2 * nE2 + 1

    # every read's mentions in one host-library pass (loadReadIntoGraph's walk
    # over a flat read buffer), each with its read's order base
    if read_entries:
        lens_all = np.array([len(s) for _, s, _, _ in read_entries], np.int64)
        seqs_flat = np.concatenate([s for _, s, _, _ in read_entries])
        quals_flat = np.concatenate([q for _, _, q, _ in read_entries]).astype(np.int32)
        key1, key2, ekey, w32, t_idx, c_idx = native.dbg_mentions(
            seqs_flat, quals_flat, offsets_from_lengths(lens_all), lens_all, k, min_qual)
        widv = np.array([e[0] for e in read_entries], np.int64)
        basev = np.array([e[3] for e in read_entries], np.int64)
        w = w32.astype(np.int64)
        base = basev[t_idx]
        c64 = c_idx.astype(np.int64)
        nk_ += [key1, key2]
        nwid += [widv[t_idx].astype(np.int32)] * 2
        nc_ += [np.full(len(key1), READ, np.int64)] * 2
        nw_ += [w, w]
        np_ += [np.full(len(key1), -1, np.int64)] * 2
        no_ += [c64 * 2 + base, c64 * 2 + base + 1]
        ek_.append(ekey)
        ewid.append(widv[t_idx].astype(np.int32))
        ew_.append(w)
        eo_.append(c64 + base)

    results: list = [None] * len(windows)
    for wid in range(len(windows)):
        if not has_n[wid]:
            results[wid] = _empty_arrays() if as_arrays else WindowGraph(nodes={}, edges={})
    mask2k = (1 << (2 * k)) - 1

    def to5(key2bit):
        v, out = int(key2bit), 0
        digits = []
        for _ in range(k):
            digits.append(v & 3)
            v >>= 2
        for d in reversed(digits):
            out = out * 5 + d
        return out

    if nk_:
        nk = np.concatenate(nk_)
        nc = np.concatenate(nc_)
        nw = np.concatenate(nw_)
        npos = np.concatenate(np_)
        nord = np.concatenate(no_)
        ks, order = _device_sort_pairs(np.concatenate(nwid), nk, dev)
        nc, nw, npos, nord = nc[order], nw[order], npos[order], nord[order]
        starts = np.concatenate([[0], np.nonzero(ks[1:] != ks[:-1])[0] + 1])
        colours = np.bitwise_or.reduceat(nc, starts)
        weights = np.add.reduceat(nw, starts)
        # the sort is stable: a segment's first element is its first mention
        positions = npos[starts]
        node_keys = ks[starts]
        node_wids = (node_keys >> 32).astype(np.int64)

        ew = np.concatenate(ew_)
        eord = np.concatenate(eo_)
        eks, eorder = _device_sort_pairs(np.concatenate(ewid), np.concatenate(ek_), dev)
        ew, eord = ew[eorder], eord[eorder]
        estarts = np.concatenate([[0], np.nonzero(eks[1:] != eks[:-1])[0] + 1])
        eweights = np.add.reduceat(ew, estarts)
        efirst = eord[estarts]

        if as_arrays:
            n5 = _to5_vec(node_keys & mask2k, k)
            # edges in first-mention order, at most 4 per (window, start node)
            fo = np.argsort(efirst, kind="stable")
            ekeys = eks[estarts][fo]
            ewids = (ekeys >> 32).astype(np.int64)
            prefix = (ekeys >> 2) & mask2k
            start5 = _to5_vec(prefix, k)
            succ5 = _to5_vec(((prefix << 2) | (ekeys & 3)) & mask2k, k)
            # each edge's rank within its (window, start) group, in
            # first-mention order (a stable grouped rank)
            _ukey, inv = np.unique((ewids << (2 * k + 2)) | prefix, return_inverse=True)
            by_grp = np.argsort(inv, kind="stable")
            sg = inv[by_grp]
            gstart = np.concatenate([[0], np.nonzero(sg[1:] != sg[:-1])[0] + 1])
            glen = np.diff(np.concatenate([gstart, [len(inv)]]))
            ranks_sorted = np.arange(len(inv)) - np.repeat(gstart, glen)
            rank = np.empty(len(inv), np.int64)
            rank[by_grp] = ranks_sorted
            keep = rank < 4
            # per-window slices without a mask per window (quadratic at
            # chromosome scale): nodes are sorted by window, so searchsorted
            # bounds them; edges group by a stable window argsort that keeps
            # first-mention order inside each window
            nW = len(windows)
            nb_ = np.searchsorted(node_wids, np.arange(nW + 1))
            kept = np.nonzero(keep)[0]
            e_by_wid = kept[np.argsort(ewids[kept], kind="stable")]
            eb_ = np.searchsorted(ewids[e_by_wid], np.arange(nW + 1))
            colours64 = colours.astype(np.int64)
            weights64 = weights.astype(np.int64)
            ewq = eweights[fo].astype(np.int64)
            for wid in range(nW):
                if has_n[wid]:
                    continue
                ns_ = slice(nb_[wid], nb_[wid + 1])
                es_ = e_by_wid[eb_[wid] : eb_[wid + 1]]
                results[wid] = dict(node_keys=n5[ns_], colours=colours64[ns_],
                                    weights=weights64[ns_], positions=positions[ns_],
                                    edge_start=start5[es_], edge_succ=succ5[es_],
                                    edge_weight=ewq[es_])
        else:
            for i in range(len(starts)):
                key = int(ks[starts[i]])
                results[key >> 32].nodes[to5(key & mask2k)] = [
                    int(colours[i]), int(weights[i]), int(positions[i])]
            # the 4-slot first-mention rule per (window, start node)
            slot_count: dict = {}
            for i in np.argsort(efirst, kind="stable"):
                key = int(eks[estarts[i]])
                wid = key >> 32
                prefix = (key >> 2) & mask2k
                start5 = to5(prefix)
                succ5 = to5(((prefix << 2) | (key & 3)) & mask2k)
                cnt = slot_count.get((wid, start5), 0)
                if cnt < 4:
                    slot_count[(wid, start5)] = cnt + 1
                    results[wid].edges[(start5, succ5)] = int(eweights[i])

    for wid, flag in enumerate(has_n):
        if flag:
            ref, ref_start, reads = windows[wid]
            g = build_window_graph_oracle(np.asarray(ref), ref_start, reads, k=k,
                                          min_qual=min_qual)
            results[wid] = _graph_to_arrays(g) if as_arrays else g
    return results


def _expand_ranges(starts, lengths):
    """The flat gather index of ragged rows: concatenate(arange(s, s + L) per
    row) without a loop per row (the cumsum in float64, exact below 2^53)."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    out_off = np.concatenate([[0], np.cumsum(lengths.astype(np.float64)).astype(np.int64)])
    total = int(out_off[-1])
    if total == 0:
        return np.empty(0, np.int64), out_off
    return (np.repeat(starts - out_off[:-1], lengths)
            + np.arange(total, dtype=np.int64)), out_off


def _region_read_soa(bam, chrom: str, beg: int, end: int, min_mapq: int):
    """The region's reads as one flat SoA (seqs, quals, lens, pos), straight
    from the indexed reader's parsed chunks, with no record objects; sorted
    by start, stably.  None when the reader has no indexed arrays."""
    fetch_chunks = getattr(bam, "fetch_soa_chunks", None)
    if fetch_chunks is None:
        return None
    s_parts, q_parts, l_parts, p_parts = [], [], [], []
    for soa, _buf, hit in fetch_chunks(chrom, beg, end):
        if not len(hit):
            continue
        flag = soa["flag"][hit]
        keep = hit[((flag & 0x200) == 0) & (soa["mapq"][hit] >= min_mapq)]
        if not len(keep):
            continue
        so = soa["seq_off"]
        lens = (so[keep + 1] - so[keep]).astype(np.int64)
        idx, _ = _expand_ranges(so[keep].astype(np.int64), lens)
        s_parts.append(soa["seqs"][idx])
        q_parts.append(soa["quals"][idx])
        l_parts.append(lens)
        p_parts.append(soa["pos"][keep].astype(np.int64))
    if not p_parts:
        z = np.zeros(0, np.int64)
        return np.zeros(0, np.uint8), np.zeros(0, np.int32), z, z
    pos = np.concatenate(p_parts)
    lens = np.concatenate(l_parts)
    seqs_flat = np.concatenate(s_parts)
    quals_flat = np.concatenate(q_parts).astype(np.int32)
    # a stable sort by start, as the record route's list.sort
    order = np.argsort(pos, kind="stable")
    if not np.array_equal(order, np.arange(len(order))):
        off = np.concatenate([[0], np.cumsum(lens.astype(np.float64)).astype(np.int64)])
        byte_idx, _ = _expand_ranges(off[order], lens[order])
        seqs_flat = seqs_flat[byte_idx]
        quals_flat = quals_flat[byte_idx]
        pos, lens = pos[order], lens[order]
    return seqs_flat, quals_flat, lens, pos


def dbg_from_bam(bam, fasta_index, chrom: str, beg: int, end: int, k=K_DEFAULT, min_qual=20,
                 min_mapq=20, as_arrays=False, device="cuda"):
    """The reference's windows over a BAM region (debruijn.cpp:1539-1584):
    1,500-base windows shifted by 750, each with the reference slice
    [start - 1500, end + 1500) and the reads whose start lies inside it.

    as_arrays=True is the chromosome-scale route: with an indexed reader the
    region's reads come out of the parsed chunks as one flat SoA into
    build_window_graphs_soa (no record objects, no per-window read copies),
    giving per-window array dicts, and the card is never touched.
    as_arrays=False builds [WindowGraph] by the sort-reduce on `device`."""
    region_size, shift = 1500, 750
    if not as_arrays:
        resolve_device(device)
    got = _region_read_soa(bam, chrom, beg, end, min_mapq) if as_arrays else None
    if got is not None:
        seqs_flat, quals_flat, lens, pos = got
        a_starts = np.arange(beg, end, shift, dtype=np.int64)
        a_ends = np.minimum(a_starts + region_size, end)
        r_starts = np.maximum(0, a_starts - region_size)
        r_ends = np.minimum(a_ends + region_size, fasta_index.length(chrom))
        refs = [fasta_index.fetch(chrom, int(s), int(e)) for s, e in zip(r_starts, r_ends)]
        lo = np.searchsorted(pos, a_starts, "left")
        hi = np.searchsorted(pos, a_ends, "left")
        return build_window_graphs_soa(refs, r_starts, seqs_flat, quals_flat, lens, lo, hi,
                                       k=k, min_qual=min_qual)
    recs = [r for r in bam.fetch(chrom, beg, end)
            if not r.is_unmapped and not r.is_qcfail and r.mapq >= min_mapq]
    recs.sort(key=lambda r: r.pos)
    starts = np.array([r.pos for r in recs])
    windows = []
    for a_start in range(beg, end, shift):
        a_end = min(a_start + region_size, end)
        r_start = max(0, a_start - region_size)
        r_end = min(a_end + region_size, fasta_index.length(chrom))
        lo = np.searchsorted(starts, a_start, "left")
        hi = np.searchsorted(starts, a_end, "left")
        reads = [(recs[i].seq, recs[i].qual, False) for i in range(lo, hi)]
        windows.append((fasta_index.fetch(chrom, r_start, r_end), r_start, reads))
    return build_window_graphs(windows, k=k, min_qual=min_qual, as_arrays=as_arrays,
                               device=device)


# ---------------------------------------------------------------------------
# cycle detection and variant paths: in the reference but compiled out of
# the benchmark's ROI (debruijn.cpp:923-1091 dfsVisit /
# detectCyclesInGraph_Recursive, 1147-1239 getVariantPathsThroughGraphFromNode,
# and the k escalation in the commented block 1408-1428)
# ---------------------------------------------------------------------------

REF_AND_READ = REF | READ


def _successors(graph: WindowGraph):
    """Each node's successors in edge insertion order (the reference's
    edges[] slot order)."""
    succ = {key: [] for key in graph.nodes}
    for (k1, k2), w in graph.edges.items():
        succ[k1].append((k2, w))
    return succ


def detect_cycles(graph: WindowGraph, min_weight: float) -> bool:
    """debruijn.cpp:923-997: a white/grey/black DFS; edges into READ-only
    nodes lighter than min_weight are ignored.  Iterative (the reference's
    recursion can overflow the stack on long windows), in the same visit
    order."""
    succ = _successors(graph)
    colour = {key: "w" for key in graph.nodes}
    for root in graph.nodes:
        if colour[root] != "w":
            continue
        stack = [(root, iter(succ[root]))]
        colour[root] = "g"
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt, w in it:
                if graph.nodes[nxt][0] == READ and w < min_weight:
                    continue
                c = colour[nxt]
                if c == "g":
                    return True
                if c == "w":
                    colour[nxt] = "g"
                    stack.append((nxt, iter(succ[nxt])))
                    advanced = True
                    break
            if not advanced:
                colour[node] = "b"
                stack.pop()
    return False


def _successors_cached(graph: WindowGraph):
    if not hasattr(graph, "_succ_cache"):
        graph._succ_cache = _successors(graph)
    return graph._succ_cache


def variant_paths_from_node(graph: WindowGraph, start_key, min_weight: float,
                            max_paths: int = 20):
    """debruijn.cpp:1147-1239: the read-supported paths that leave
    `start_key` until they rejoin the reference (bubbles), as (node key
    list, path weight); None when the 20-path cap fires (the reference then
    gives up on the node)."""
    stack = [([start_key], 0.0)]
    finished = []
    while stack:
        path, weight = stack.pop()
        if len(stack) > max_paths or len(finished) > max_paths:
            return None
        if len(set(path)) != len(path):  # checkPathForCycles
            continue
        end = path[-1]
        colours = graph.nodes[end][0]
        if len(path) > 1 and colours == REF_AND_READ:
            finished.append((path, weight))  # the bubble closes
            continue
        if len(path) > 1 and colours == REF:
            continue  # a reference-only dead end (debruijn.cpp:1196)
        for nxt, w in _successors_cached(graph)[end]:
            nxt_colours = graph.nodes[nxt][0]
            if w >= min_weight or nxt_colours in (REF_AND_READ, REF):
                stack.append((path + [nxt], weight + w))
    return finished


def path_sequence(graph: WindowGraph, path, k=K_DEFAULT) -> np.ndarray:
    """createSequenceFromPath (debruijn.cpp:1094-1113): each node's first
    base (keys are base-5 packed, the first base most significant)."""
    top = 5 ** (k - 1)
    return np.array([int(key) // top for key in path], np.int64)


def find_bubbles(graph: WindowGraph, min_weight: float, k=K_DEFAULT):
    """The variant-path sweep: from every REF_AND_READ node with a heavy
    enough out-edge into a node off the reference, the closed bubbles, as
    [(start key, paths)] with paths as variant_paths_from_node gives them."""
    out = []
    succ = _successors_cached(graph)
    for key, (colours, _, _) in graph.nodes.items():
        if colours != REF_AND_READ:
            continue
        diverges = any(graph.nodes[nxt][0] & READ and graph.nodes[nxt][0] != REF_AND_READ
                       and w >= min_weight for nxt, w in succ[key])
        if not diverges:
            continue
        paths = variant_paths_from_node(graph, key, min_weight)
        if paths:
            out.append((key, paths))
    return out


def assemble_window(ref_codes, ref_start, reads, k=K_DEFAULT, min_qual=20, min_reads=2,
                    max_k=50, detect_variants=True):
    """assembleReadsAndDetectVariants with the reference's k escalation
    (commented out in debruijn.cpp:1408-1428) turned on: rebuild with k += 5
    while the graph has a cycle, giving up past max_k.  Returns (graph, the
    k it stopped at, bubbles)."""
    min_weight = min_reads * min_qual
    while True:
        g = build_window_graph_oracle(ref_codes, ref_start, reads, k=k, min_qual=min_qual)
        if not detect_cycles(g, min_weight) or k > max_k:
            break
        k += 5
    bubbles = find_bubbles(g, min_weight, k) if detect_variants else []
    return g, k, bubbles
