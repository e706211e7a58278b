"""NumPy oracle for partial-order alignment MSA (spoa semantics): the port's
copy of genomicsbench_tpu/oracle/poa.py, for the tests and chip_smoke.py.

Capability target: the reference poa benchmark (benchmarks/poa/
msa_spoa_omp.cpp:237-252) which, per window of ~10 sequences, does
`createGraph()` -> for each sequence `align(seq, graph)` +
`graph->add_alignment(alignment, seq)` -> `graph->generate_consensus()`,
with global (Needleman-Wunsch) alignment and a convex (dual-affine) gap
model, defaults m=2, x=-4, o1=-4/e1=-2, o2=-24/e2=-1
(msa_spoa_omp.cpp:157-162).  The spoa kernel itself lives in an empty
submodule (tools/spoa), so the algorithm here is the published SPOA/POA
method re-specified from first principles; this oracle IS the parity
contract for the kernels of ops/poa.py.

Alignment recurrence (graph nodes i in topological order, query positions
j = 1..q; virtual start node is rank 0):

    M(i,j)   = max_{p in preds(i)} H(p, j-1) + sub(base_i, q_j)
    Fl(i,j)  = max_{p in preds(i)} max(H(p,j) - ol - el, Fl(p,j) - el)
    GF(i,j)  = max(M, F1, F2)
    El(i,j)  = max_{k < j} GF(i,k) - ol - (j-k)*el        (closed form)
    H(i,j)   = max(GF, E1, E2)

i.e. each affine gap piece opens from H (graph gaps) / GF (query gaps) and
never from the *other* piece mid-gap.  For any parameters satisfying
e1 <= o2+e2 and e2 <= o1+e1 (true for the reference defaults) a mid-gap
piece switch is never optimal, so this is exactly the convex gap model;
the constructor asserts that condition.  The closed-form E makes the row
computation embarrassingly parallel, which is what the kernels
exploit; the oracle uses the *same* formulation (including tie-breaking)
so kernel-vs-oracle parity is bit-exact.

Tie-breaking (documented, deterministic):
  * H move priority: M > F1-open > F1-ext > F2-open > F2-ext > E1 > E2.
  * Among predecessors: smallest topological rank wins.
  * Within El's max over k: smallest k (prefer the longest gap / earliest
    open), equivalently "extend beats open" in the sequential recurrence.
  * Alignment end: max H(i, q) over sink nodes (no out-edges), smallest
    rank on ties.

Graph fusion (spoa Graph::AddAlignment semantics): aligned (node, base)
pairs reuse the node if bases match, else reuse a node from the aligned
ring with a matching base, else create a new node added to the ring;
unaligned query bases create fresh nodes; consecutive chosen nodes are
connected with edges whose weight counts traversing sequences.

Consensus (spoa Graph::GenerateConsensus heaviest-bundle): topo scan,
per node pick the in-edge with max weight (tie: predecessor with larger
bundle score, then smaller rank); bundle score = edge weight + pred
score; backtrack from the best-scoring node, preferring sink nodes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from genomicsbench_tpu_torch.config import PoaParams

NEG = -(1 << 30)

# H-move codes (shared with ops/poa.py trace encoding).
MOVE_M = 0
MOVE_F1_OPEN = 1
MOVE_F1_EXT = 2
MOVE_F2_OPEN = 3
MOVE_F2_EXT = 4
MOVE_E1 = 5
MOVE_E2 = 6
MOVE_NONE = 7


@dataclasses.dataclass
class _Node:
    base: int
    preds: list  # in-neighbour node ids
    succs: list  # out-neighbour node ids
    ring: list  # aligned-node ring (node ids sharing a column)


class PoaGraph:
    """Mutable partial-order graph over integer base codes (0..3 = ACGT)."""

    def __init__(self, params: PoaParams | None = None):
        self.params = params or PoaParams()
        p = self.params
        o1, e1 = -p.gap_open1, -p.gap_ext1
        o2, e2 = -p.gap_open2, -p.gap_ext2
        assert o1 >= 0 and e1 >= 0 and o2 >= 0 and e2 >= 0
        # Mid-gap piece switch must never pay off (see module docstring).
        assert e1 <= o2 + e2 and e2 <= o1 + e1, (
            "parameters outside the convex regime supported by the closed-form DP"
        )
        self.nodes: list[_Node] = []
        self.edge_w: dict = {}  # (u, v) -> weight
        self.n_seqs = 0

    # ------------------------------------------------------------------ graph
    def _new_node(self, base: int) -> int:
        self.nodes.append(_Node(int(base), [], [], []))
        return len(self.nodes) - 1

    def _add_edge(self, u: int, v: int, w: int = 1):
        if (u, v) in self.edge_w:
            self.edge_w[(u, v)] += w
        else:
            self.edge_w[(u, v)] = w
            self.nodes[u].succs.append(v)
            self.nodes[v].preds.append(u)

    def topo_order(self) -> list:
        """Kahn topological order; aligned-ring members kept adjacent
        (spoa keeps ring columns consecutive so consensus sees columns)."""
        indeg = {i: len(n.preds) for i, n in enumerate(self.nodes)}
        ready = sorted(i for i, d in indeg.items() if d == 0)
        order, seen = [], set()
        while ready:
            u = ready.pop(0)
            if u in seen:
                continue
            # Pull in ring members that are also ready so columns stay adjacent.
            group = [u] + [r for r in self.nodes[u].ring if indeg[r] == 0 and r not in seen]
            for g in group:
                seen.add(g)
                order.append(g)
                for v in self.nodes[g].succs:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        ready.append(v)
            ready.sort()
        assert len(order) == len(self.nodes), "cycle in POA graph"
        return order

    # -------------------------------------------------------------- alignment
    def align(self, seq: np.ndarray):
        """Global alignment of seq (int codes) to the graph.

        Returns (score, alignment) where alignment is a list of
        (node_id | None, qpos | None) pairs, qpos 0-based, in order.
        """
        seq = np.asarray(seq, dtype=np.int64)
        q = len(seq)
        if not self.nodes:
            return 0, [(None, j) for j in range(q)]
        p = self.params
        o1, e1 = -p.gap_open1, -p.gap_ext1
        o2, e2 = -p.gap_open2, -p.gap_ext2
        order = self.topo_order()
        rank = {nid: r for r, nid in enumerate(order, start=1)}
        n = len(order)

        H = np.full((n + 1, q + 1), NEG, dtype=np.int64)
        F1 = np.full((n + 1, q + 1), NEG, dtype=np.int64)
        F2 = np.full((n + 1, q + 1), NEG, dtype=np.int64)
        move = np.full((n + 1, q + 1), MOVE_NONE, dtype=np.int64)
        predr = np.zeros((n + 1, q + 1), dtype=np.int64)  # winning pred rank
        gapk = np.zeros((n + 1, q + 1), dtype=np.int64)  # E gap origin col

        # Virtual start row: leading query gap with convex cost.
        H[0, 0] = 0
        for j in range(1, q + 1):
            H[0, j] = max(-o1 - j * e1, -o2 - j * e2)

        for r, nid in enumerate(order, start=1):
            node = self.nodes[nid]
            preds = sorted(rank[pn] for pn in node.preds) or [0]
            base = node.base
            sub = np.where(seq == base, p.match, p.mismatch)
            # M / F from predecessor rows (priority: M, F1o, F1e, F2o, F2e;
            # among preds smallest rank first — ">" comparisons keep the
            # first maximiser).
            Mv = np.full(q + 1, NEG, dtype=np.int64)
            Mp = np.zeros(q + 1, dtype=np.int64)
            F1v = np.full(q + 1, NEG, dtype=np.int64)
            F1m = np.full(q + 1, MOVE_NONE, dtype=np.int64)
            F1p = np.zeros(q + 1, dtype=np.int64)
            F2v = np.full(q + 1, NEG, dtype=np.int64)
            F2m = np.full(q + 1, MOVE_NONE, dtype=np.int64)
            F2p = np.zeros(q + 1, dtype=np.int64)
            for pr in preds:
                diag = np.concatenate(([NEG], H[pr, :q] + sub))
                upd = diag > Mv
                Mp = np.where(upd, pr, Mp)
                Mv = np.maximum(Mv, diag)
            # F per piece: open-max across preds, then ext-max across preds,
            # open preferred on overall ties (smallest pred rank within each).
            for (Fv, Fm, Fp, Fprev, oo, ee, mo, me) in (
                (F1v, F1m, F1p, F1, o1, e1, MOVE_F1_OPEN, MOVE_F1_EXT),
                (F2v, F2m, F2p, F2, o2, e2, MOVE_F2_OPEN, MOVE_F2_EXT),
            ):
                opv = np.full(q + 1, NEG, dtype=np.int64)
                opp = np.zeros(q + 1, dtype=np.int64)
                exv = np.full(q + 1, NEG, dtype=np.int64)
                exp_ = np.zeros(q + 1, dtype=np.int64)
                for pr in preds:
                    op = H[pr] - oo - ee
                    upd = op > opv
                    opp = np.where(upd, pr, opp)
                    np.maximum(opv, op, out=opv)
                    ex = Fprev[pr] - ee
                    upd = ex > exv
                    exp_ = np.where(upd, pr, exp_)
                    np.maximum(exv, ex, out=exv)
                sel_ext = exv > opv
                Fv[:] = np.where(sel_ext, exv, opv)
                Fm[:] = np.where(sel_ext, me, mo)
                Fp[:] = np.where(sel_ext, exp_, opp)
            GF = np.maximum(Mv, np.maximum(F1v, F2v))
            # E closed form per piece: smallest-k tie-break via packing.
            E1v = np.full(q + 1, NEG, dtype=np.int64)
            E2v = np.full(q + 1, NEG, dtype=np.int64)
            K1 = np.zeros(q + 1, dtype=np.int64)
            K2 = np.zeros(q + 1, dtype=np.int64)
            for (Ev, K, oo, ee) in ((E1v, K1, o1, e1), (E2v, K2, o2, e2)):
                pack = (GF + np.arange(q + 1) * ee) * (q + 2) + (q + 1 - np.arange(q + 1))
                run = np.maximum.accumulate(pack)
                best = run[:-1] // (q + 2)
                bestk = (q + 1) - (run[:-1] - best * (q + 2))
                Ev[1:] = best - oo - np.arange(1, q + 1) * ee
                K[1:] = bestk
            Hr = np.maximum(GF, np.maximum(E1v, E2v))
            # Move priority.
            mv = np.full(q + 1, MOVE_E2, dtype=np.int64)
            pr_ = np.zeros(q + 1, dtype=np.int64)
            gk = K2.copy()
            sel = E1v == Hr
            mv[sel] = MOVE_E1
            gk[sel] = K1[sel]
            sel = F2v == Hr
            mv[sel] = F2m[sel]
            pr_[sel] = F2p[sel]
            sel = F1v == Hr
            mv[sel] = F1m[sel]
            pr_[sel] = F1p[sel]
            sel = Mv == Hr
            mv[sel] = MOVE_M
            pr_[sel] = Mp[sel]
            H[r], F1[r], F2[r] = Hr, F1v, F2v
            move[r], predr[r], gapk[r] = mv, pr_, gk
            move[r, 0] = mv[0]

        # End: best H(sink, q), smallest rank on tie.
        sinks = [rank[nid] for nid in order if not self.nodes[nid].succs]
        best_r = min(sinks, key=lambda rr: (-H[rr, q], rr))
        score = int(H[best_r, q])

        # Backtrack.
        aln = []
        r, j = best_r, q
        while r > 0 or j > 0:
            if r == 0:
                aln.append((None, j - 1))
                j -= 1
                continue
            m = move[r, j]
            nid = order[r - 1]
            if m == MOVE_M:
                aln.append((nid, j - 1))
                r, j = int(predr[r, j]), j - 1
            elif m in (MOVE_F1_OPEN, MOVE_F2_OPEN):
                aln.append((nid, None))
                r = int(predr[r, j])
            elif m in (MOVE_F1_EXT, MOVE_F2_EXT):
                aln.append((nid, None))
                r = int(predr[r, j])
            elif m in (MOVE_E1, MOVE_E2):
                k = int(gapk[r, j])
                for jj in range(j, k, -1):
                    aln.append((None, jj - 1))
                j = k
            else:  # MOVE_NONE at (r, 0): leading graph gap through this node
                aln.append((nid, None))
                r = int(predr[r, 0]) if predr[r, 0] else r - 1
        aln.reverse()
        return score, aln

    # ----------------------------------------------------------------- fusion
    def add_alignment(self, alignment, seq: np.ndarray, weight: int = 1):
        """Fuse an alignment of seq into the graph (spoa AddAlignment)."""
        seq = np.asarray(seq, dtype=np.int64)
        if not self.nodes:
            alignment = [(None, j) for j in range(len(seq))]
        chosen = []  # node ids of this sequence's path
        for node_id, qpos in alignment:
            if qpos is None:
                continue  # graph gap: sequence skips this node
            base = int(seq[qpos])
            if node_id is None:
                nid = self._new_node(base)
            elif self.nodes[node_id].base == base:
                nid = node_id
            else:
                nid = None
                for r_ in self.nodes[node_id].ring:
                    if self.nodes[r_].base == base:
                        nid = r_
                        break
                if nid is None:
                    nid = self._new_node(base)
                    ring = [node_id] + list(self.nodes[node_id].ring)
                    for member in ring:
                        self.nodes[member].ring.append(nid)
                    self.nodes[nid].ring = ring
            chosen.append(nid)
        for u, v in zip(chosen, chosen[1:]):
            self._add_edge(u, v, weight)
        self.n_seqs += 1

    def add_sequence(self, seq: np.ndarray):
        score, aln = self.align(seq)
        self.add_alignment(aln, seq)
        return score

    # -------------------------------------------------------------- consensus
    def consensus(self) -> np.ndarray:
        """Heaviest-bundle consensus (int base codes)."""
        if not self.nodes:
            return np.zeros(0, dtype=np.int64)
        order = self.topo_order()
        score = {nid: 0 for nid in order}
        pred = {nid: None for nid in order}
        rank = {nid: r for r, nid in enumerate(order)}
        for nid in order:
            best_w, best_p = -1, None
            for pn in self.nodes[nid].preds:
                w = self.edge_w[(pn, nid)]
                if (
                    best_p is None
                    or w > best_w
                    or (w == best_w and (score[pn], -rank[pn]) > (score[best_p], -rank[best_p]))
                ):
                    best_w, best_p = w, pn
            if best_p is not None:
                score[nid] = best_w + score[best_p]
                pred[nid] = best_p
        # Prefer sinks; fall back to global best (branch completion lite).
        sinks = [nid for nid in order if not self.nodes[nid].succs]
        pool = sinks if sinks else order
        start = max(pool, key=lambda nid: (score[nid], -rank[nid]))
        best_overall = max(order, key=lambda nid: (score[nid], -rank[nid]))
        if score[best_overall] > score[start]:
            start = best_overall
        out, cur = [], start
        while cur is not None:
            out.append(self.nodes[cur].base)
            cur = pred[cur]
        return np.array(out[::-1], dtype=np.int64)


def msa_consensus_oracle(seqs, params: PoaParams | None = None) -> np.ndarray:
    """Full window oracle: build graph from seqs, return consensus codes."""
    g = PoaGraph(params)
    for s in seqs:
        g.add_sequence(np.asarray(s))
    return g.consensus()
