"""Time the port's kmer run count and frequency scatter kernels of one or
more checkouts on one card, in the turns given (e.g. A B B A), so that the
versions meet the same card, clocks and host.

    python3 tools/kmer_ab.py ROOT [ROOT ...]

Each root is the top of a checkout of this repository (e.g. a `git archive`
of the parent commit unpacked under build/, and the working tree).  The
kmer main batch of chip_smoke.py (tests/torch_kmer_cases.py MAIN: 25,000
reads of 10,000 bases, seed 47) is made once, before the turns, into
build/kmer_ab/ (about half a minute of host time).  Each turn is a child
process that imports that root's genomicsbench_tpu_torch, builds its
kernels into that root's build directory and measures:
  - `gb_kmer_runs` on the 250 M sorted keys of `count_kmers_stats` (mode 1),
    and `gb_kmer_freqs` on the 25 M sorted keys and permutation of the
    uneven index (the first 2,500 reads, mode 0), by device time of the C
    entry: best of 20 launches, each timed alone with the card held busy
    while the host enqueues (chip_smoke.py's `device_ms`); each output held
    equal to the plain version's, the run count also on the keys from byte
    offsets 4, 8 and 12;
  - each wrapper's best of 20 (CUDA events around the call, its host time
    and the run count's `torch.zeros` included);
  - `count_kmers_stats` on the 25,000 reads: one warm-up, then the wall
    time of each of 3 calls;
  - both kernels' registers, stack and spills from ptxas.
It prints the card's name and power limit, one JSON line per turn and,
last, each measure's best per root.

    python3 tools/kmer_ab.py --probe ROOT

times ROOT's `gb_kmer_freqs` beside the same kernel writing freq[i] (its
sorted slot, coalesced) instead of freq[order[i]] (PROBE_EDIT), both by
`device_ms` on the uneven index's keys; the scatter's sector floor (32
bytes a key at 3.35 TB/s); the card's copy of the 250 M keys (1 GB read, 1
GB written) by `device_ms` and the read floor of the run count at that
rate; and the launch floor of `device_ms` (an empty kernel).

    python3 tools/kmer_ab.py --variants ROOT

builds ROOT's csrc/kmer.cu again with other unroll depths, blocks an SM or
waves (run count), slots a thread, windows, cached loads or plain stores
(frequencies), and probes at other windows (VARIANTS), all at once,
into build/kmer_ab/, and times each variant's C entry beside the intact
kernels', the outputs held equal (but a probe's).
Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
SECTOR = 32                     # bytes an L2 sector moves

# The probe: the frequency kernel's stores to its own sorted slot.
STORE = "store_evict_last(freq + dst[j], f, policy);"
PROBE_EDIT = (STORE, STORE.replace("dst[j]", "b0 + j"))

# the frequency kernel's window, slots a thread, loads and stores
WINDOW = "constexpr int64_t kFreqWindow = int64_t{1} << 24;"
SLOTS = "constexpr int kFreqSlots = 8;"
LDG = [("const int4 x = __ldcs(sv + q);", "const int4 x = __ldg(sv + q);"),
       ("const longlong2 y = __ldcs(ov + q);", "const longlong2 y = __ldg(ov + q);")]
PLAIN_STORES = [(STORE, "freq[dst[j]] = f;")]


def window(bits):
    return [(WINDOW, WINDOW.replace("<< 24", f"<< {bits}"))]


def slots(k):
    return [(SLOTS, SLOTS.replace("= 8", f"= {k}"))]


# name -> [(text, replacement)] on csrc/kmer.cu; a "probe" variant writes
# each count to its sorted slot (timed only)
VARIANTS = {
    "runs_unroll2": [("constexpr int kRunsUnroll = 4;", "constexpr int kRunsUnroll = 2;")],
    "runs_unroll8": [("constexpr int kRunsUnroll = 4;", "constexpr int kRunsUnroll = 8;")],
    "runs_blocks4": [("constexpr int kRunsBlocksPerSm = 8;",
                      "constexpr int kRunsBlocksPerSm = 4;")],
    "runs_waves1": [("constexpr int kRunsWaves = 4;", "constexpr int kRunsWaves = 1;")],
    "runs_waves8": [("constexpr int kRunsWaves = 4;", "constexpr int kRunsWaves = 8;")],
    "freqs_slots4": slots(4),
    "freqs_slots16": slots(16),
    "freqs_ldg_loads": LDG,
    "freqs_plain_stores": PLAIN_STORES,
    "freqs_window23": window(23),
    "freqs_window25": window(25),
    "freqs_one_pass": window(40),
    "freqs_plain_stores_window23": PLAIN_STORES + window(23),
    "freqs_ldg_plain_stores_one_pass": LDG + PLAIN_STORES + window(40),
    "freqs_slots16_ldg_plain_stores_one_pass": slots(16) + LDG + PLAIN_STORES + window(40),
    "probe": [PROBE_EDIT],
    "probe_window23": [PROBE_EDIT] + window(23),
    "probe_one_pass": [PROBE_EDIT] + window(40),
}


def edited_source(root, edits):
    text = open(os.path.join(root, "genomicsbench_tpu_torch", "csrc", "kmer.cu")).read()
    for a, b in edits:
        if text.count(a) != 1:
            raise ValueError(f"kmer_ab: {a!r} is not in {root}'s kmer.cu exactly once")
        text = text.replace(a, b)
    return text


def start_build(root, work, label, edits):
    """nvcc of ROOT's kmer.cu with `edits` into work/label.so, started (the
    flags of the package's own build); returns (Popen, .so path)."""
    sys.path.insert(0, root)
    from genomicsbench_tpu_torch import _kernels

    os.makedirs(work, exist_ok=True)
    src, so = os.path.join(work, label + ".cu"), os.path.join(work, label + ".so")
    with open(src, "w") as f:
        f.write(edited_source(root, edits))
    proc = subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def finish_build(build):
    """Wait for a start_build; the library's gb_kmer_runs and gb_kmer_freqs
    bound with the package's argument types, and nvcc's ptxas lines."""
    import ctypes

    from genomicsbench_tpu_torch import _kernels

    proc, so = build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"kmer_ab: nvcc failed for {so}:\n{log}")
    lib = ctypes.CDLL(so)
    for fn in ("gb_kmer_runs", "gb_kmer_freqs"):
        getattr(lib, fn).argtypes = _kernels.SOURCES["kmer"][1][fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, log


def start_probe_build(root, work):
    """The probe's nvcc (the frequency kernel writing freq[i]), started."""
    return start_build(root, work, "probe", [PROBE_EDIT])


def resources(log, part):
    """(registers, stack, spill stores, spill loads) of the one kernel whose
    mangled name holds `part`, from nvcc's -Xptxas -v log."""
    import re

    name, out = None, {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            out.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    (r,) = [v for k, v in out.items() if part in k]
    return r


COMMON = r"""
import json, os, sys, time
root, cache = sys.argv[1], sys.argv[2]
here = os.path.dirname(os.path.dirname(os.path.abspath(sys.argv[3])))
sys.path[:0] = [root, os.path.join(here, "tests"), os.path.join(here, "tools")]
import numpy as np
import torch
from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.ops import kmer
import kmer_ab
import torch_kmer_cases as kc

REPS = 20
SLEEP_CYCLES = 1_000_000

def timer(fn, busy):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if busy:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times)

def device_ms(fn):
    return timer(fn, True)

def stream():
    return torch.cuda.current_stream().cuda_stream

codes = np.load(os.path.join(cache, "main.npy"))
lens = np.full(len(codes), kc.MAIN["read_len"], np.int32)
dc, dl = torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()
k, nu = kc.MAIN_K, kc.INDEX_UNEVEN_READS
s = torch.sort(kmer.canonical_keys(dc, dl, k, kmer.MODE_PACK_CODES)).values
fs, forder = torch.sort(kmer.canonical_keys(dc[:nu], dl[:nu], k))
n, nf = s.numel(), fs.numel()
runs_out = torch.zeros(2, dtype=torch.int64, device="cuda")
freq = torch.empty(nf, dtype=torch.uint16, device="cuda")
sat = torch.zeros(1, dtype=torch.int32, device="cuda")

def runs_launch(lib, keys=s):
    def launch():
        rc = lib.gb_kmer_runs(keys.data_ptr(), keys.numel(), runs_out.data_ptr(), stream())
        assert rc == 0, rc
    return launch

def freqs_launch(lib):
    def launch():
        rc = lib.gb_kmer_freqs(fs.data_ptr(), forder.data_ptr(), nf, freq.data_ptr(),
                               sat.data_ptr(), stream())
        assert rc == 0, rc
    return launch

want_runs = kmer.kmer_runs_reference(s)
want_freq, want_sat = kmer.kmer_freqs_reference(fs, forder)

def check(lib, label):
    for j in range(4):              # byte offsets 0, 4, 8, 12
        runs_out.zero_()
        runs_launch(lib, s[j:])()
        want = want_runs if j == 0 else kmer.kmer_runs_reference(s[j:])
        torch.cuda.synchronize()
        assert torch.equal(runs_out, want), (label, j, runs_out.tolist(), want.tolist())
    sat.zero_()
    freqs_launch(lib)()
    torch.cuda.synchronize()
    assert torch.equal(freq, want_freq) and torch.equal(sat, want_sat), label
"""

CHILD = COMMON + r"""
lib = _kernels.load()
res = {"root": root, "card": torch.cuda.get_device_name(0), "keys": n, "freq_keys": nf}
res["runs_device_ms"] = device_ms(runs_launch(lib))
res["freqs_device_ms"] = device_ms(freqs_launch(lib))
check(lib, root)
res["runs_wrapper_ms"] = timer(lambda: kmer.kmer_runs(s), False)
res["freqs_wrapper_ms"] = timer(lambda: kmer.kmer_freqs(fs, forder), False)
log = _kernels.library_path("kmer").with_suffix(".log").read_text()
res["runs_ptxas"] = kmer_ab.resources(log, "runs_kernel")
res["freqs_ptxas"] = kmer_ab.resources(log, "freqs_kernel")
walls = []
for _ in range(4):
    t0 = time.perf_counter()
    kmer.count_kmers_stats(codes, lens, k, device="cuda")
    walls.append((time.perf_counter() - t0) * 1e3)
res["count_kmers_stats_ms"] = walls[1:]
print(json.dumps(res), flush=True)
"""

PROBE = COMMON + r"""
lib = _kernels.load()
probe, log = kmer_ab.finish_build(kmer_ab.start_probe_build(root, cache))
intact = device_ms(freqs_launch(lib))
probe_ms = device_ms(freqs_launch(probe))
torch.cuda.synchronize()
assert torch.equal(freq.int(), want_freq.int()[forder]), "the probe: each count at its slot"
copy_src, copy_dst = s.clone(), torch.empty_like(s)
copy_ms = device_ms(lambda: copy_dst.copy_(copy_src))
rate = 2 * 4 * n / (copy_ms * 1e-3)
print(json.dumps({
    "freqs_device_ms": intact, "freqs_probe_device_ms": probe_ms,
    "probe_ptxas": kmer_ab.resources(log, "freqs_kernel"),
    "freqs_bound_ms": (14 * nf + 4) / kmer_ab.HBM_BYTES_PER_S * 1e3,
    "freqs_sector_floor_ms": kmer_ab.SECTOR * nf / kmer_ab.HBM_BYTES_PER_S * 1e3,
    "runs_device_ms": device_ms(runs_launch(lib)),
    "runs_bound_ms": (4 * n + 16) / kmer_ab.HBM_BYTES_PER_S * 1e3,
    "copy_1gb_device_ms": copy_ms, "copy_rate_bytes_per_s": rate,
    "runs_copy_rate_floor_ms": 4 * n / rate * 1e3,
    "empty_kernel_device_ms": device_ms(lambda: torch.cuda._sleep(0))}), flush=True)
"""

VARIANT = COMMON + r"""
variants = json.loads(sys.argv[4])
lib = _kernels.load()
builds = {label: kmer_ab.start_build(root, cache, label, edits)
          for label, edits in variants.items()}

def row(label, lib_v, log=None):
    r = {"variant": label, "runs_device_ms": device_ms(runs_launch(lib_v)),
         "freqs_device_ms": device_ms(freqs_launch(lib_v))}
    if not label.startswith("probe"):
        check(lib_v, label)
    if log is not None:
        r["runs_ptxas"] = kmer_ab.resources(log, "runs_kernel")
        r["freqs_ptxas"] = kmer_ab.resources(log, "freqs_kernel")
    print(json.dumps(r), flush=True)

row("intact", lib)
for label, build in builds.items():
    lib_v, log = kmer_ab.finish_build(build)
    row(label, lib_v, log)
row("intact", lib)
"""


def main() -> int:
    variants = sys.argv[1:2] == ["--variants"]
    probe = sys.argv[1:2] == ["--probe"]
    roots = [os.path.abspath(r) for r in sys.argv[1 + (variants or probe):]]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kmer_ab: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [os.path.join(here, "tests")]
    cache = os.path.join(here, "build", "kmer_ab")
    os.makedirs(cache, exist_ok=True)
    if not os.path.exists(os.path.join(cache, "main.npy")):
        import numpy as np
        import torch_kmer_cases as kc

        np.save(os.path.join(cache, "main.npy"), kc.genome_reads(**kc.MAIN)[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    me = os.path.abspath(__file__)
    if probe or variants:
        extra = [json.dumps(VARIANTS)] if variants else []
        proc = subprocess.run([sys.executable, "-c", VARIANT if variants else PROBE, roots[0],
                               cache, me, *extra], capture_output=True, text=True)
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
