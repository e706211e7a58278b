"""The de Bruijn window graph, one window at a time with dicts: the port's
copy of genomicsbench_tpu/ops/dbg.py:37-110 (`WindowGraph`,
`build_window_graph_oracle`), the exact transliteration of Platypus's build
(debruijn.cpp:1262-1367, DeBruijnGraph_AddEdge:888-920)."""

from __future__ import annotations

import dataclasses

REF, READ = 1, 2
K_DEFAULT = 15


@dataclasses.dataclass
class WindowGraph:
    """One window's graph (the parity surface)."""

    nodes: dict      # kmer key -> [colours, weight, position]
    edges: dict      # (kmer key, successor key) -> weight

    def node_count(self):
        return len(self.nodes)

    def edge_count(self):
        return len(self.edges)


def build_window_graph_oracle(ref_codes, ref_start, reads, k=K_DEFAULT,
                              min_qual=20) -> WindowGraph:
    """One window's graph, dict by dict.  Keys are base-5 packed k-mers, so
    a reference k-mer with N keeps its node.  reads: [(seq codes, quals,
    qcfail)]; QC-fail reads are skipped."""
    nodes, edges = {}, {}
    edge_slots = {}

    def kkey(codes):
        v = 0
        for c in codes:
            v = v * 5 + int(min(c, 4))
        return v

    def upsert(key, colour, weight, position):
        if key in nodes:
            nodes[key][0] |= colour
            nodes[key][1] += weight
        else:
            nodes[key] = [colour, weight, position]

    def add_edge(k1, k2, colour, weight, p1, p2):
        upsert(k1, colour, weight, p1)
        upsert(k2, colour, weight, p2)
        slots = edge_slots.setdefault(k1, [])
        if k2 in slots:
            edges[(k1, k2)] += weight
        elif len(slots) < 4:
            slots.append(k2)
            edges[(k1, k2)] = weight

    L = len(ref_codes)
    for i in range(0, L - k - 1):
        add_edge(kkey(ref_codes[i : i + k]), kkey(ref_codes[i + 1 : i + 1 + k]),
                 REF, 1, ref_start + i, ref_start + i + 1)
    for seq, quals, qcfail in reads:
        if qcfail:
            continue
        n = len(seq)
        for i in range(0, n - k - 1):
            span_q = quals[i : i + k + 1]
            span_s = seq[i : i + k + 1]
            if span_q.min() >= min_qual and (span_s <= 3).all():
                w = int(span_q.min())
                add_edge(kkey(seq[i : i + k]), kkey(seq[i + 1 : i + 1 + k]),
                         READ, w, -1, -1)
    return WindowGraph(nodes=nodes, edges=edges)
