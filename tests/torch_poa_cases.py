"""Inputs of the poa (partial-order MSA consensus) tests and of chip_smoke.py.

Imports neither JAX nor the JAX package, so the card's machine can use it.
Every input is made from a numpy seed and handed to both packages as numpy
arrays:

* `bench_poa_windows`: the JAX package's poa scale bench
  (tools/scale_bench.py:843-857 `bench_poa`, seed 19: windows of 10 reads of
  600-999 bases with 4% substitutions, called in blocks of 1,024 windows,
  the racon window scale), copied call for call;
* `edge_windows`: a window of one read, reads of length 0 and 1, identical
  reads, a node of in-degree 5 or more, lengths around multiples of 128,
  windows that end at different rounds, and reads of `longest` bases;
* `random_dag`: random graph planes (basep, predp) in topological order with
  in-degrees from 1 to a maximum, for the kernels alone;
* `distance_dag`: graph planes whose nodes read predecessors exactly
  given distances back in rank, for the fill kernel's ring of rows;
* `small_windows`: tests/test_poa.py-sized windows (30-120 bases) with
  deletions, insertions and substitutions;
* `write_windows_fasta` / `build_poa_gold` / `run_poa_gold`: the window
  FASTA that both CLIs and tools/ref_drivers/poa_gold.cpp read, poa_gold's
  build with g++ and its run.
"""

from __future__ import annotations

import gzip
import os
import pathlib
import subprocess

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
POA_GOLD_SRC = ROOT / "tools" / "ref_drivers" / "poa_gold.cpp"
MAIN_SEED = 19
MAIN_WINDOWS = 1024


def bench_poa_windows(n_windows=MAIN_WINDOWS, seed=MAIN_SEED):
    """The first n_windows windows of `bench_poa` (scale_bench.py:846-857)."""
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(n_windows):
        L = int(rng.integers(600, 1000))
        base = rng.integers(0, 4, L).astype(np.int64)
        seqs = []
        for _ in range(10):
            s = base.copy()
            mut = rng.random(L) < 0.04
            s[mut] = rng.integers(0, 4, mut.sum())
            seqs.append(s)
        windows.append(seqs)
    return windows


def _mutate(rng, seq, rate):
    """tests/test_poa.py's _mutate: deletions, substitutions and insertions
    at rate / 3 each."""
    out = []
    for c in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(int(rng.integers(0, 4)))
        elif r < rate:
            out.append(int(c))
            out.append(int(rng.integers(0, 4)))
        else:
            out.append(int(c))
    return np.array(out, dtype=np.int64)


def small_windows(n_windows, seed, lo=30, hi=120, rate=0.1):
    """Windows of a random truth (lo..hi bases) and 1-6 mutated copies."""
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(n_windows):
        truth = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.int64)
        windows.append([truth] + [_mutate(rng, truth, rate)
                                  for _ in range(int(rng.integers(1, 7)))])
    return windows


def high_indegree_window(seed=3, length=60, at=30):
    """Reads around one column that gets four bases, a deletion and an
    insertion, so the node after it has five or more predecessors."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 4, length).astype(np.int64)
    reads = [truth]
    for b in range(4):
        if b != truth[at]:
            s = truth.copy()
            s[at] = b
            reads.append(s)
    reads.append(np.delete(truth, at))
    reads.append(np.insert(truth, at + 1, (truth[at] + 1) % 4))
    reads.append(np.insert(truth, at + 1, (truth[at] + 2) % 4))
    reads.append(truth.copy())
    return reads


def edge_windows(longest=5000, seed=7):
    """{label: list of windows} of the edge cases."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.int64)

    s = rand(80)
    empty = np.zeros(0, np.int64)
    lengths = [127, 128, 129, 255, 256, 257]
    base = rand(257)
    ragged = []
    for k in range(2, 11):          # 2..10 reads: the windows end at different rounds
        t = rand(int(rng.integers(40, 90)))
        ragged.append([t] + [_mutate(rng, t, 0.08) for _ in range(k - 1)])
    long_truth = rand(longest)
    return {
        "one_read": [[s]],
        "empty_read": [[s, empty, _mutate(rng, s, 0.1)], [empty, s, _mutate(rng, s, 0.1)],
                       [s, _mutate(rng, s, 0.1), empty]],
        "one_base": [[s, np.array([2]), _mutate(rng, s, 0.1)], [np.array([1]), np.array([1]),
                                                                 np.array([3])]],
        "identical": [[s, s.copy(), s.copy(), s.copy()]],
        "high_indegree": [high_indegree_window()],
        "len_128": [[base[:n] for n in lengths], [base[:n] for n in lengths[::-1]]],
        "ragged_rounds": ragged,
        "long": [[long_truth] + [_mutate(rng, long_truth, 0.04) for _ in range(2)]],
    }


def random_dag(rng, n, max_indeg, q_len):
    """Random graph planes of n nodes in topological order, as the upload
    takes them: basep (n,) uint8 (base 0..4, sink in bit 7) and preds, a
    list per node of its sorted predecessor ranks (0 = the virtual start,
    node r0 has rank r0 + 1); and a query of q_len bases (0..3)."""
    preds, used = [], np.zeros(n + 1, bool)
    for r0 in range(n):
        k = int(rng.integers(1, min(max_indeg, r0 + 1) + 1))
        p = np.sort(rng.choice(r0 + 1, k, replace=False))
        # keep most edges local, as a real graph's, with a few long ones
        if rng.random() < 0.8 and r0 not in p:
            p[-1] = r0
            p = np.unique(p)
        preds.append(p.tolist())
        used[p] = True
    basep = rng.integers(0, 5, n).astype(np.uint8)
    basep |= np.where(used[1:], 0, 0x80).astype(np.uint8)
    return basep, preds, rng.integers(0, 4, q_len).astype(np.int64)


def distance_dag(rng, n, dists, q_len):
    """random_dag's outputs for a chain of n nodes where node r0 (rank
    r0 + 1) reads rank r0 (distance 1) and, where they exist, the ranks
    exactly `dists` back, so a ring of R rows serves distance R - 1 and
    sends distance R and R + 1 to the scratch."""
    preds = []
    for r0 in range(n):
        rank = r0 + 1
        preds.append(sorted({rank - 1} | {rank - d for d in dists if rank - d >= 0}))
    basep = rng.integers(0, 4, n).astype(np.uint8)
    basep[-1] |= 0x80
    return basep, preds, rng.integers(0, 4, q_len).astype(np.int64)


def dag_planes(dags, n_pad, p_pad, q_pad):
    """Pack random_dag outputs into JAX `_poa_dp_packed`'s planes: basep
    (B, n_pad) uint8, predp (B, n_pad, p_pad) uint16 (0xFFFF = no slot), n,
    seq (B, q_pad) int8 (lane 0 = -1), qlen."""
    B = len(dags)
    basep = np.zeros((B, n_pad), np.uint8)
    predp = np.full((B, n_pad, p_pad), 0xFFFF, np.uint16)
    seq = np.zeros((B, q_pad), np.int8)
    seq[:, 0] = -1
    n = np.zeros(B, np.int32)
    qlen = np.zeros(B, np.int32)
    for b, (bp, preds, q) in enumerate(dags):
        basep[b, :len(bp)] = bp
        for r0, p in enumerate(preds):
            predp[b, r0, :len(p)] = p
        seq[b, 1:len(q) + 1] = q
        n[b], qlen[b] = len(bp), len(q)
    return basep, predp, n, seq, qlen


def write_windows_fasta(path, windows, gz=False):
    """The window FASTA of msa_spoa_omp.cpp's readFile, which both CLIs and
    tools/ref_drivers/poa_gold.cpp read: a header whose second character is
    '0' opens a window.  gzip-compressed with gz."""
    with (gzip.open if gz else open)(path, "wt") as f:
        for w, seqs in enumerate(windows):
            for s, seq in enumerate(seqs):
                f.write(f">0w{w}\n" if s == 0 else f">x{w}_{s}\n")
                f.write("".join("ACGT"[int(v)] for v in seq) + "\n")


def build_poa_gold(out_dir) -> str:
    """Compile tools/ref_drivers/poa_gold.cpp with g++ -O2 into out_dir;
    returns the binary's path."""
    exe = os.path.join(str(out_dir), "poa_gold")
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe, str(POA_GOLD_SRC)], check=True,
                   capture_output=True, timeout=300)
    return exe


def run_poa_gold(exe, fasta) -> list[str]:
    """poa_gold's consensus strings, one per window."""
    out = subprocess.run([exe, str(fasta)], capture_output=True, text=True, check=True,
                         timeout=3600).stdout
    return [ln for ln in out.splitlines() if not ln.startswith(">")]
