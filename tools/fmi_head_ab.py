"""Time the port's fmi smem1 walk and basecaller decoder head kernels of one
or more checkouts on one card, in the turns given (e.g. A B B A), so that
the versions meet the same card, clocks and host.

    python3 tools/fmi_head_ab.py ROOT [ROOT ...]

Each root is the top of a checkout of this repository (e.g. a `git archive`
of the parent commit unpacked under build/, and the working tree).  The
100 Mb FMD index of chip_smoke.py's fmi main path (`bench_fmi_reference`,
seed 0) and its 65,536 reads (`bench_fmi_reads`, seed 23) are made once,
before the turns, into build/fmi_head_ab/ (about a minute of host time).
Each turn is a child process that imports that root's
genomicsbench_tpu_torch, builds its kernels into that root's build
directory and measures:
  - `gb_fmi_smem1` on pass 1 of the 65,536 reads and on the pass-2 items
    that pass 1 gives (`FmiPipeline.pass2_items`), by device time of its C
    entry, best of 20 launches each timed alone with the card held busy
    while the host enqueues (chip_smoke.py's `device_ms`), each output held
    equal to the wrapper's;
  - `gb_bc_head` on one forward batch of the basecaller's main path (64
    chunks of 2,000 frames, 48 channels, 5 labels; random bf16 from seed 9)
    the same way, its output held within one float16 ulp of the plain
    version's;
  - `FmiPipeline.run` on the 65,536 reads: one warm-up, then the wall time
    of each of 3 calls.
It prints the card's name and power limit, one JSON line per turn and,
last, each measure's best per root.

    python3 tools/fmi_head_ab.py --variants ROOT

builds ROOT's csrc/fmi.cu and csrc/basecaller.cu again with other
lane-group sizes and warps a block, or a part of the head cut out
(VARIANTS), into build/fmi_head_ab/ and times each variant's C entry (smem1
on both passes, the head on its batch) beside the intact kernels', the
outputs held equal (but an ablation's).

    python3 tools/fmi_head_ab.py --probe ROOT

times ROOT's smem1 C entry on both passes with the rounds each item took
(their largest, mean and sum; the steps and rank lines beside), then on
the same items ordered longest first (by rounds), and on the 1, 32, 1,024
and 8,192 longest alone: ns a round of the longest item at each load;
then both passes with the L2's DRAM fetch granularity at 32 bytes (in
that process only), the launch floor of `device_ms` (an empty kernel) and
the head on one frame.
Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

COMMON = r"""
import ctypes, json, os, subprocess, sys, time
root, cache = sys.argv[1], sys.argv[2]
here = os.path.dirname(os.path.dirname(os.path.abspath(sys.argv[3])))
sys.path[:0] = [root, os.path.join(here, "tests")]
import numpy as np
import torch
from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.ops import basecaller as bc_ops
from genomicsbench_tpu_torch.ops import fmi

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

def stream():
    return torch.cuda.current_stream().cuda_stream

d = np.load(os.path.join(cache, "fmi_main.npz"))
index = fmi.FmdIndex(n=int(d["n"]), C=d["C"], occ_cp=d["occ_cp"], plane0=d["plane0"],
                     plane1=d["plane1"], valid=np.zeros((0, 2), np.uint32),
                     sentinel_row=int(d["sentinel_row"]), sa=np.zeros(0, np.int64))
q_h, ql_h = d["query"], d["qlen"]
pipe = fmi.FmiPipeline(index, device="cuda")
tab = pipe.tables
q, ql = pipe._put_query(q_h, ql_h)
p1 = pipe.run(q_h, ql_h)[0]
items = [torch.from_numpy(a.astype(np.int32)).cuda() for a in pipe.pass2_items(p1)]

# A launch of a gb_fmi_smem1 C entry: pass 2 on `its` (qrow, pivot,
# min_intv), else pass 1 on every read or, with `order`, on the reads in
# that order (a qrow without pivots).
def smem1_launcher(entry, its, rounds=None, order=None):
    B, L = q.shape
    n = its[0].numel() if its is not None else (order.numel() if order is not None else B)
    CP, ME = fmi.walk_caps(L)
    full = torch.zeros(n * (fmi.SMEM1_HEAD + 4 * ME) + 1, dtype=torch.int32, device="cuda")
    ptrs = ([t.data_ptr() for t in its] if its is not None else
            [None if order is None else order.data_ptr(), None, None])
    head = [tab.table.data_ptr(), q.data_ptr(), L, ql.data_ptr(), *ptrs, n, int(its is not None),
            19, CP, ME, *fmi._launch_consts(tab), full.data_ptr()]
    if len(entry.argtypes) == 21:       # since the lane-group design: an optional rounds
        head.append(None if rounds is None else rounds.data_ptr())

    def launch():
        rc = entry(*head, stream())
        assert rc == 0, rc

    return launch, full[:-1]
"""

CHILD = COMMON + r"""
lib = _kernels.load()
res = {"root": root, "card": torch.cuda.get_device_name(0),
       "pass2_items": int(items[0].numel())}
for name, its in (("smem1_pass1", None), ("smem1_pass2", items)):
    launch, got = smem1_launcher(lib.gb_fmi_smem1, its)
    res[name + "_device_ms"] = device_ms(launch)
    want = fmi.fmi_smem1(tab, q, ql, *(its or ()), min_seed_len=19)
    torch.cuda.synchronize()
    assert torch.equal(got, want.buf), name

g = torch.Generator(device="cuda").manual_seed(9)
x = torch.randn(64, 2000, 48, device="cuda", generator=g).to(torch.bfloat16)
w = (torch.randn(48, 5, device="cuda", generator=g) * 0.5).to(torch.bfloat16)
out = torch.empty(64, 2000, 5, dtype=torch.float16, device="cuda")

def head_launch():
    rc = lib.gb_bc_head(x.data_ptr(), w.data_ptr(), 64 * 2000, 48, 5, out.data_ptr(), stream())
    assert rc == 0, rc

res["head_device_ms"] = device_ms(head_launch)
want = bc_ops.decoder_head_reference(x, w)
torch.cuda.synchronize()
o, r = (t.view(torch.int16).int() for t in (out, want))
o, r = (torch.where(t < 0, -32768 - t, t) for t in (o, r))
assert int((o - r).abs().max()) <= 1

walls = []
for _ in range(4):
    t0 = time.perf_counter()
    pipe.run(q_h.copy(), ql_h.copy())
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
res["fmi_run_ms"] = walls[1:]
print(json.dumps(res), flush=True)
"""

# name -> (source in csrc/, [(text, replacement)]); an "ablate" variant cuts
# a part of the kernel out (a wrong result, timed only)
VARIANTS = {
    "group8": ("fmi.cu", [("constexpr int kGroup = 4;", "constexpr int kGroup = 8;")]),
    "group2": ("fmi.cu", [("constexpr int kGroup = 4;", "constexpr int kGroup = 2;")]),
    "warps8": ("fmi.cu", [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")]),
    "unbounded": ("fmi.cu", [("__launch_bounds__(kWarps * 32, kMinBlocks)\nfmi_smem1_kernel(",
                              "__launch_bounds__(kWarps * 32)\nfmi_smem1_kernel(")]),
    "min_blocks10": ("fmi.cu", [("constexpr int kMinBlocks = 8;",
                                 "constexpr int kMinBlocks = 10;")]),
    "min_blocks12": ("fmi.cu", [("constexpr int kMinBlocks = 8;",
                                 "constexpr int kMinBlocks = 12;")]),
    "head_warps2": ("basecaller.cu", [("constexpr int kHeadWarps = 4;",
                                       "constexpr int kHeadWarps = 2;")]),
    "head_warps8": ("basecaller.cu", [("constexpr int kHeadWarps = 4;",
                                       "constexpr int kHeadWarps = 8;")]),
    "ablate_head_loads": ("basecaller.cu", [
        ("cp_async(xs + r * t.stride + (q - r * cpr) * 16, src + q * 16, 16, true);", "")]),
    "ablate_head_arithmetic": ("basecaller.cu", [
        ("  if (lane < nf) {\n    float acc[kL];", "  if (lane < 0) {\n    float acc[kL];")]),
}

VARIANT = COMMON + r"""
work, variants = sys.argv[4], json.loads(sys.argv[5])
lib = _kernels.load()
want = {"smem1_pass1": fmi.fmi_smem1(tab, q, ql, min_seed_len=19).buf,
        "smem1_pass2": fmi.fmi_smem1(tab, q, ql, *items, min_seed_len=19).buf}
g = torch.Generator(device="cuda").manual_seed(9)
x = torch.randn(64, 2000, 48, device="cuda", generator=g).to(torch.bfloat16)
w = (torch.randn(48, 5, device="cuda", generator=g) * 0.5).to(torch.bfloat16)
out = torch.empty(64, 2000, 5, dtype=torch.float16, device="cuda")
head_want = bc_ops.decoder_head_reference(x, w)

def timed(label, lib_v, source):
    row = {"variant": label}
    if source == "fmi.cu":
        for name, its in (("smem1_pass1", None), ("smem1_pass2", items)):
            launch, got = smem1_launcher(lib_v.gb_fmi_smem1, its)
            row[name + "_device_ms"] = device_ms(launch)
            torch.cuda.synchronize()
            assert torch.equal(got, want[name]), (label, name)
    else:
        def launch():
            rc = lib_v.gb_bc_head(x.data_ptr(), w.data_ptr(), 64 * 2000, 48, 5, out.data_ptr(),
                                  stream())
            assert rc == 0, rc
        row["head_device_ms"] = device_ms(launch)
        torch.cuda.synchronize()
        if not label.startswith("ablate"):
            o, r = (t.view(torch.int16).int() for t in (out, head_want))
            o, r = (torch.where(t < 0, -32768 - t, t) for t in (o, r))
            assert int((o - r).abs().max()) <= 1, label
    print(json.dumps(row), flush=True)

timed("intact", lib, "fmi.cu")
timed("intact", lib, "basecaller.cu")
for label, (source, edits) in variants.items():
    text = open(os.path.join(root, "genomicsbench_tpu_torch", "csrc", source)).read()
    for a, b in edits:
        assert text.count(a) == 1, (label, a)
        text = text.replace(a, b)
    src, so = os.path.join(work, label + ".cu"), os.path.join(work, label + ".so")
    open(src, "w").write(text)
    p = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True, check=True)
    regs = [l.strip() for l in p.stdout.splitlines() + p.stderr.splitlines()
            if "registers" in l or "stack frame" in l]
    print(json.dumps({"variant": label, "ptxas": regs}), flush=True)
    lib_v = ctypes.CDLL(so)
    for fn in ("gb_fmi_smem1", "gb_bc_head"):
        if hasattr(lib_v, fn):
            getattr(lib_v, fn).argtypes = getattr(lib, fn).argtypes
            getattr(lib_v, fn).restype = ctypes.c_int
    timed(label, lib_v, source)
"""


PROBE = COMMON + r"""
lib = _kernels.load()
entry = lib.gb_fmi_smem1
for name, its in (("pass1", None), ("pass2", items)):
    want = fmi.fmi_smem1(tab, q, ql, *(its or ()), min_seed_len=19)
    n = want.count.numel()
    steps = want.steps.long()
    rounds = torch.zeros(n, dtype=torch.int32, device="cuda")
    launch, got = smem1_launcher(entry, its, rounds=rounds)
    ms = device_ms(launch)
    torch.cuda.synchronize()
    assert torch.equal(got, want.buf)
    r = rounds.long()
    row = {"launch": name, "items": n, "device_ms": ms, "rounds_max": int(r.max()),
           "rounds_mean": float(r.float().mean()), "rounds_sum": int(r.sum()),
           "steps_max": int(steps.max()), "steps_mean": float(steps.float().mean()),
           "steps_sum": int(steps.sum()), "loads_sum": int(want.loads.long().sum()),
           "rounds_of_most_steps": int(r[steps.argmax()])}
    print(json.dumps(row), flush=True)
    # the items longest first (by rounds), and the longest alone
    by_rounds = torch.argsort(r, descending=True)
    for k in (n, 1, 32, 1024, 8192):
        pick = by_rounds[:k]
        if its is None:
            order = pick.to(torch.int32).contiguous()
            launch_k, got_k = smem1_launcher(entry, None, order=order)
        else:
            sub = [t[pick].contiguous() for t in its]
            launch_k, got_k = smem1_launcher(entry, sub)
        ms_k = device_ms(launch_k)
        print(json.dumps({"launch": name, "longest_first": k, "device_ms": ms_k,
                          "rounds_max": int(r[pick].max()),
                          "ns_per_round_of_longest": ms_k * 1e6 / int(r[pick].max())}),
              flush=True)

# the same launches with the L2's DRAM fetch granularity at 32 bytes (this
# process's context only; the default is read back and restored): a walk
# held by DRAM bytes moves with it
cu = ctypes.CDLL("libcuda.so.1")
FETCH = 5                       # CU_LIMIT_MAX_L2_FETCH_GRANULARITY
default = ctypes.c_size_t()
assert cu.cuCtxGetLimit(ctypes.byref(default), FETCH) == 0
for gran in (32, default.value):
    assert cu.cuCtxSetLimit(FETCH, ctypes.c_size_t(gran)) == 0
    row = {"fetch_granularity": gran}
    for name, its in (("pass1", None), ("pass2", items)):
        launch, got = smem1_launcher(entry, its)
        row[name + "_device_ms"] = device_ms(launch)
    print(json.dumps(row), flush=True)

# the launch floor of device_ms (a kernel that spins no cycles), and the
# head's on one frame
print(json.dumps({"empty_kernel_device_ms": device_ms(lambda: torch.cuda._sleep(0))}),
      flush=True)
x1 = torch.randn(1, 1, 48, device="cuda").to(torch.bfloat16)
w1 = torch.randn(48, 5, device="cuda").to(torch.bfloat16)
o1 = torch.empty(1, 1, 5, dtype=torch.float16, device="cuda")
print(json.dumps({"head_one_frame_device_ms": device_ms(
    lambda: lib.gb_bc_head(x1.data_ptr(), w1.data_ptr(), 1, 48, 5, o1.data_ptr(), stream()))}),
      flush=True)
"""


def save_index(path):
    """The fmi main path's 100 Mb index and 65,536 reads into `path`."""
    import numpy as np
    import torch_fmi_cases as fc
    from genomicsbench_tpu_torch.ops.fmi import build_fmd_index

    ref = fc.bench_fmi_reference()
    query, qlen = fc.bench_fmi_reads(ref)
    idx = build_fmd_index(ref)
    np.savez(path, n=idx.n, C=idx.C, occ_cp=idx.occ_cp, plane0=idx.plane0,
             plane1=idx.plane1, sentinel_row=idx.sentinel_row, query=query, qlen=qlen)


def main() -> int:
    variants = sys.argv[1:2] == ["--variants"]
    probe = sys.argv[1:2] == ["--probe"]
    roots = [os.path.abspath(r) for r in sys.argv[1 + (variants or probe):]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("fmi_head_ab: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [here, os.path.join(here, "tests")]
    cache = os.path.join(here, "build", "fmi_head_ab")
    os.makedirs(cache, exist_ok=True)
    if not os.path.exists(os.path.join(cache, "fmi_main.npz")):
        save_index(os.path.join(cache, "fmi_main.npz"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    me = os.path.abspath(__file__)
    if probe:
        proc = subprocess.run([sys.executable, "-c", PROBE, roots[0], cache, me],
                              capture_output=True, text=True)
        print(proc.stdout + proc.stderr, flush=True)
        return proc.returncode
    if variants:
        proc = subprocess.run([sys.executable, "-c", VARIANT, roots[0], cache, me, cache,
                               json.dumps(VARIANTS)], capture_output=True, text=True)
        print(proc.stdout + proc.stderr, flush=True)
        return proc.returncode
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", CHILD, root, cache, me],
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
