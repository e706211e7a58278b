"""Time the port's chain DP and abea backtrack kernels of one or more
checkouts on one card, in the turns given (e.g. A B B A), so that the
versions meet the same card, clocks and host.

    python3 tools/chain_abea_ab.py ROOT [ROOT ...]

Each root is the top of a checkout of this repository (e.g. a `git archive`
of the parent commit unpacked under build/, and the working tree).  The
10,000 abea reads of the main path (`bench_abea_reads`, seed 29) are made
once, before the turns, into build/chain_abea_ab/.  Each turn is a child
process that imports that root's genomicsbench_tpu_torch, builds its
kernels into that root's build directory and measures, on the main paths of
chip_smoke.py (10,000 chain reads of `bench_chain_calls`, seed 11; the
10,000 abea reads):
  - `gb_chain_dp` and `gb_abea_backtrack` by device time of their C entries,
    best of 20 launches each timed alone with the card held busy while the
    host enqueues (chip_smoke.py's `device_ms`), their outputs held equal to
    their wrappers';
  - each wrapper's mean of 20 launches back to back, its host checks
    included;
  - `chain_batch` and `align_batch`: one warm-up, then the wall time of
    each of 3 calls.
It prints the card's name and power limit, one JSON line per turn and,
last, each measure's best per root.

    python3 tools/chain_abea_ab.py --scaling ROOT

    python3 tools/chain_abea_ab.py --ablate ROOT

builds ROOT's csrc/chain.cu and csrc/abea.cu again with parts of the
kernels cut out (ABLATIONS: a wrong result, timed only) into
build/chain_abea_ab/, and times each variant's C entry (device time, best
of 20) on the main paths beside the intact kernel's, so the parts' shares
of the time show.

The scaling mode instead times each kernel's C entry (device time, best of 20) at 1, 2, 4,
8 and 16 or 18 warps an SM, four reads a warp, on reads of one length:
chain reads of `bench_chain_calls(20_000)` cut to 1,000 anchors, abea
reads of the main path whose walks take 1,300-1,500 steps; time per step
flat in the warps means the kernel waits on its dependent chain, time
growing with them that it waits on issue.  Needs one CUDA card; exits 1
without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import ctypes, json, os, sys, time
root, cache = sys.argv[1], sys.argv[2]
here = os.path.dirname(os.path.dirname(os.path.abspath(sys.argv[3])))
sys.path[:0] = [root, os.path.join(here, "tests")]
import numpy as np
import torch
from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts
from genomicsbench_tpu_torch.ops import abea, chain
from torch_abea_cases import _model, load_bench_abea_reads
from torch_chain_cases import bench_chain_calls

REPS = 20
SLEEP_CYCLES = 1_000_000

def device_ms(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times)

def mean_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS

def walls(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out

lib = _kernels.load()
stream = lambda: torch.cuda.current_stream().cuda_stream
res = {"root": root, "card": torch.cuda.get_device_name(0)}

calls = anchor_calls_from_dicts(bench_chain_calls(10_000, 11))
t, ns, offs = chain.upload_calls(calls, "cuda")
args = [t[k] for k in chain.CHAIN_DP_INPUTS]
want = chain.chain_dp(*args, host_offs=offs)
R, T = len(ns), int(offs[-1])
order = torch.from_numpy(chain._launch_order(offs)).cuda()
got = torch.empty((3, T), dtype=torch.int32, device="cuda")
vis = torch.empty(R, dtype=torch.int64, device="cuda")
head = [a.data_ptr() for a in args[:3]] + [order.data_ptr()] + [a.data_ptr() for a in args[3:]]
tail = [got[0].data_ptr(), got[1].data_ptr(), got[2].data_ptr(), vis.data_ptr()]
if len(lib.gb_chain_dp.argtypes) == 20:       # before the redesign: a targets scratch
    targets = torch.empty(T, dtype=torch.int32, device="cuda")
    chain_args = head + [R, 5000, 25, 0, 0, targets.data_ptr()] + tail
else:
    chain_args = head + [R, 5000, 25, 0, 0, chain._max_window(offs, 5000, 0)] + tail + [None]

def chain_launch():
    rc = lib.gb_chain_dp(*chain_args, stream())
    assert rc == 0, rc

res["chain_dp_device_ms"] = device_ms(chain_launch)
torch.cuda.synchronize()
assert all(torch.equal(g, w) for g, w in zip(got, want[:3])) and torch.equal(vis, want[3])
res["chain_dp_wrapper_mean_ms"] = mean_ms(lambda: chain.chain_dp(*args, host_offs=offs))
res["chain_batch_ms"] = walls(lambda: chain.chain_batch(calls, device="cuda"))
del t, args, want, got

seqs, evs, sc = load_bench_abea_reads(cache)
mean, stdv = _model()
ta = abea.upload_reads(seqs, evs, mean, stdv, sc, "cuda")
f = abea.abea_fill(ta)
want = abea.abea_backtrack(ta, f)
out = torch.full_like(want, -1)
B = ta.n_reads
head = [ta.ranks, ta.events, ta.k_off, ta.e_off, ta.band_off, ta.params, ta.model]
fill = [f.traces, f.bll_e, f.best, f.best_ev]
if len(lib.gb_abea_backtrack.argtypes) == 14:   # before the redesign: no order
    bt_args = [x.data_ptr() for x in head + fill] + [B, out.data_ptr()]
else:
    bt_args = ([x.data_ptr() for x in head + [ta.order] + fill] + [B, out.data_ptr(), None])

def bt_launch():
    rc = lib.gb_abea_backtrack(*bt_args, stream())
    assert rc == 0, rc

res["abea_backtrack_device_ms"] = device_ms(bt_launch)
torch.cuda.synchronize()
assert torch.equal(out, want)
res["abea_backtrack_wrapper_mean_ms"] = mean_ms(lambda: abea.abea_backtrack(ta, f))
res["align_batch_ms"] = walls(lambda: abea.align_batch(seqs, evs, mean, stdv, sc, device="cuda"))
print(json.dumps(res), flush=True)
"""


SCALING = r"""
import json, os, sys
root, cache = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, os.path.join(root, "tests")]
import numpy as np
import torch
from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts
from genomicsbench_tpu_torch.ops import abea, chain
from torch_abea_cases import _model, load_bench_abea_reads
from torch_chain_cases import bench_chain_calls, call

def device_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times)

lib = _kernels.load()
sms = torch.cuda.get_device_properties(0).multi_processor_count
stream = lambda: torch.cuda.current_stream().cuda_stream
n_anchor = 1000
long = [d for d in bench_chain_calls(20_000) if len(d["x"]) >= n_anchor]
rows = []
for w in (1, 2, 4, 8, 18):
    R = 4 * w * sms
    calls = anchor_calls_from_dicts([call(d["x"][:n_anchor], d["y"][:n_anchor], d["avg_qspan"])
                                     for d in long[:R]])
    t, ns, offs = chain.upload_calls(calls, "cuda")
    args = [t[k] for k in chain.CHAIN_DP_INPUTS]
    order = torch.from_numpy(chain._launch_order(offs)).cuda()
    out = torch.empty((3, len(calls) * n_anchor), dtype=torch.int32, device="cuda")
    vis = torch.empty(len(calls), dtype=torch.int64, device="cuda")
    ptr = [a.data_ptr() for a in args]
    mw = chain._max_window(offs, 5000, 0)
    fn = lambda: lib.gb_chain_dp(*ptr[:3], order.data_ptr(), *ptr[3:], len(calls), 5000, 25, 0,
                                 0, mw, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                                 vis.data_ptr(), None, stream())
    ms = device_ms(fn)
    rows.append(dict(kernel="chain_dp", warps_per_sm=w, reads=len(calls), ms=ms,
                     ns_per_anchor=ms * 1e6 / n_anchor, visited=int(vis.sum())))
seqs, evs, sc = load_bench_abea_reads(cache)
mean, stdv = _model()
t = abea.upload_reads(seqs, evs, mean, stdv, sc, "cuda")
f = abea.abea_fill(t)
steps = abea.abea_backtrack(t, f)[:4 * t.n_reads].view(-1, 4)[:, 0].cpu().numpy()
pick = np.nonzero((steps >= 1300) & (steps < 1500))[0]
for w in (1, 2, 4, 8, 16):
    R = min(4 * w * sms, len(pick))
    idx = pick[:R]
    s2 = [seqs[i] for i in idx]; e2 = [evs[i] for i in idx]
    t2 = abea.upload_reads(s2, e2, mean, stdv, sc[idx], "cuda")
    f2 = abea.abea_fill(t2)
    out = torch.full((4 * R + 2 * t2.n_bands,), -1, dtype=torch.int32, device="cuda")
    ptrs = [x.data_ptr() for x in (t2.ranks, t2.events, t2.k_off, t2.e_off, t2.band_off,
                                   t2.params, t2.model, t2.order, f2.traces, f2.bll_e, f2.best,
                                   f2.best_ev)]
    fn = lambda: lib.gb_abea_backtrack(*ptrs, R, out.data_ptr(), None, stream())
    ms = device_ms(fn)
    st = out[:4 * R].view(-1, 4)[:, 0].cpu().numpy()
    rows.append(dict(kernel="abea_backtrack", warps_per_sm=R / 4 / sms, reads=R, ms=ms,
                     longest=int(st.max()), ns_per_step=ms * 1e6 / int(st.max())))
for r in rows:
    print(json.dumps(r), flush=True)
"""


# name -> (source, [(text, replacement)]): each cuts one part of a kernel
ABLATIONS = {
    "chain_one_chunk": ("chain.cu", [
        ("if (kR * (qd - (c0 >> 2)) - kChunk + 3 < lo) live = false;", "live = false;")]),
    "chain_no_scans": ("chain.cu", [
        ("if (gl >= s) incl = max(incl, v);", "incl += 0 * v;"),
        ("""        if (gl >= s) {
          M = min(mv, sv + M);
          S = sv + S;
        }""", "        M += 0 * (mv + sv);")]),
    "abea_no_terms": ("abea.cu", [
        ("if (flush) {                   // the buffered steps' terms and pairs",
         "if (need >= 4) {")]),
    "abea_no_kahan": ("abea.cu", [("if (flush && walker) {", "if (need >= 4 && walker) {")]),
    "abea_walk_only": ("abea.cu", [
        ("if (flush) {                   // the buffered steps' terms and pairs",
         "if (need >= 4) {"),
        ("if (flush && walker) {", "if (need >= 4 && walker) {")]),
}

ABLATE = r"""
import ctypes, json, os, subprocess, sys
root, cache, work = sys.argv[1], sys.argv[2], sys.argv[3]
ablations = json.loads(sys.argv[4])
sys.path[:0] = [root, os.path.join(root, "tests")]
import torch
from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts
from genomicsbench_tpu_torch.ops import abea, chain
from torch_abea_cases import _model, load_bench_abea_reads
from torch_chain_cases import bench_chain_calls

def device_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times)

def build(name, source, edits):
    text = open(os.path.join(root, "genomicsbench_tpu_torch", "csrc", source)).read()
    for a, b in edits:
        assert text.count(a) == 1, (name, a)
        text = text.replace(a, b)
    src = os.path.join(work, name + ".cu")
    lib = os.path.join(work, name + ".so")
    open(src, "w").write(text)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    return ctypes.CDLL(lib)

stream = lambda: torch.cuda.current_stream().cuda_stream
calls = anchor_calls_from_dicts(bench_chain_calls(10_000, 11))
t, ns, offs = chain.upload_calls(calls, "cuda")
args = [t[k] for k in chain.CHAIN_DP_INPUTS]
R, T = len(ns), int(offs[-1])
order = torch.from_numpy(chain._launch_order(offs)).cuda()
got = torch.empty((3, T), dtype=torch.int32, device="cuda")
vis = torch.empty(R, dtype=torch.int64, device="cuda")
ptr = [a.data_ptr() for a in args]
chain_args = (ptr[:3] + [order.data_ptr()] + ptr[3:] + [R, 5000, 25, 0, 0,
              chain._max_window(offs, 5000, 0), got[0].data_ptr(), got[1].data_ptr(),
              got[2].data_ptr(), vis.data_ptr(), None])
seqs, evs, sc = load_bench_abea_reads(cache)
ta = abea.upload_reads(seqs, evs, *_model(), sc, "cuda")
f = abea.abea_fill(ta)
out = torch.full((4 * ta.n_reads + 2 * ta.n_bands,), -1, dtype=torch.int32, device="cuda")
bt_args = ([x.data_ptr() for x in (ta.ranks, ta.events, ta.k_off, ta.e_off, ta.band_off,
                                   ta.params, ta.model, ta.order, f.traces, f.bll_e, f.best,
                                   f.best_ev)] + [ta.n_reads, out.data_ptr(), None])
entries = {"chain.cu": ("gb_chain_dp", chain_args), "abea.cu": ("gb_abea_backtrack", bt_args)}
lib = _kernels.load()
for source, (fn, a) in entries.items():
    print(json.dumps({"variant": source + " intact",
                      "ms": device_ms(lambda: getattr(lib, fn)(*a, stream()))}), flush=True)
for name, (source, edits) in ablations.items():
    fn, a = entries[source]
    entry = getattr(build(name, source, edits), fn)
    entry.argtypes = getattr(lib, fn).argtypes
    print(json.dumps({"variant": name, "ms": device_ms(lambda: entry(*a, stream()))}), flush=True)
"""


def main() -> int:
    scaling = sys.argv[1:2] == ["--scaling"]
    ablate = sys.argv[1:2] == ["--ablate"]
    roots = [os.path.abspath(r) for r in sys.argv[1 + (scaling or ablate):]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chain_abea_ab: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(here, "tests"))
    from torch_abea_cases import save_bench_abea_reads

    cache_dir = os.path.join(here, "build", "chain_abea_ab")
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, "abea_main.npz")
    if not os.path.exists(cache):
        save_bench_abea_reads(cache)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    if scaling or ablate:
        argv = ([sys.executable, "-c", SCALING, roots[0], cache] if scaling else
                [sys.executable, "-c", ABLATE, roots[0], cache, cache_dir, json.dumps(ABLATIONS)])
        proc = subprocess.run(argv, capture_output=True, text=True)
        print(proc.stdout + proc.stderr, flush=True)
        return proc.returncode
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", CHILD, root, cache, os.path.abspath(__file__)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    best = {}
    for r in runs:
        b = best.setdefault(r["root"], {})
        for key, v in r.items():
            if key.endswith("_ms"):
                v = min(v) if isinstance(v, list) else v
                b[key] = min(b.get(key, v), v)
    print(json.dumps({"best": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
