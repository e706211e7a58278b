"""Time the port's kmer site build and fmi seed walk and extension kernels
of one or more checkouts on one card, in the turns given (e.g. A B B A),
so that the versions meet the same card, clocks and host.

    python3 tools/sites_seed3_ab.py ROOT [ROOT ...]

Each root is the top of a checkout of this repository (e.g. a `git archive`
of the parent commit unpacked under build/, and the working tree).  The
inputs are made once, before the turns, into build/sites_seed3_ab/ (about
four minutes of host time): the first 5,000 reads of the kmer main batch
(tests/torch_kmer_cases.py MAIN, seed 47: the minimizer index's 50 M
positions) and chip_smoke.py's two fmi batches, the 100 Mb FMD index
(`bench_fmi_reference`, seed 0) with its 65,536 reads (`bench_fmi_reads`,
seed 23) and that reference with simple sequence repeats (`ssr_reference`)
with 65,536 reads of seed 43.  Each turn is a child process that imports that root's
genomicsbench_tpu_torch, builds its kernels into that root's build
directory and measures:
  - `gb_kmer_sites` on the (raw, mask) planes that `minimizer_walk` gives
    for the 5,000 reads (k 15, window 5), by device time of its C entry:
    best of 20 launches, each timed alone with the card held busy while
    the host enqueues (chip_smoke.py's `device_ms`), its count zeroed
    before the timed span; its pairs held equal, sorted, to the plain
    version's;
  - `gb_fmi_seed3` on the 65,536 reads (min_intv 20, min_len 20) the same
    way, its buffer held equal to the plain version's;
  - `gb_fmi_extend` on the SSR batch's pass-1 e-table lanes (every start of
    each read whose pass-1 walk overflowed, floor 1) the same way, its
    output held equal to the plain version's;
  - each wrapper's best of 20 (CUDA events around the call);
  - `FmiPipeline.run` on the 65,536 reads and `build_index_minimizers` on
    the 5,000: one warm-up, then the wall time of each of 3 calls;
  - the kernels' registers, stack and spills from ptxas.
It prints the card's name and power limit, one JSON line per turn and,
last, each measure's best per root.

    python3 tools/sites_seed3_ab.py --variants ROOT

builds ROOT's csrc/fmi.cu again with other lane-group sizes, warps a
block, staging and line loads for seed3, and the tests first or 16 blocks
an SM for extend (VARIANTS), all at once, into build/sites_seed3_ab/, and
times each variant's seed3 and extend beside the intact kernels', the
outputs held equal.

    python3 tools/sites_seed3_ab.py --probe ROOT

records each bench read's sequence of rank lines (a thread a read running
the sequential walk, PROBE_SOURCE) and replays it: in dependent order with
no arithmetic (the chain floor) and as independent loads (the line-rate
floor), both by `device_ms`, beside ROOT's seed3 and the launch floor of
`device_ms` (an empty kernel).
Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
SSR_READ_SEED = 43              # chip_smoke.py's reads over the SSR reference

# The probe kernels (a plain C interface, built by nvcc beside the
# package's kernels).  record: a thread a read runs the sequential
# bwt_seed_strategy1 walk (gb_fmi_seed3's first design) and writes, step t
# of read w at lines[(t * n + w) * 2], the block of row a and the block of
# row a + s (-1 where both rows share it), and the steps to nsteps[w].
# chain: a thread a read loads its recorded lines in order, each step's one
# or two lines (both 16-byte halves) issued together, the next step's
# addresses depending on the loaded words through `zero` (0 at run time);
# rate: a thread a recorded line of the flat list, every load independent.
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ int sel4(int v0, int v1, int v2, int v3, int c) {
  const int lo = (c & 1) ? v1 : v0;
  const int hi = (c & 1) ? v3 : v2;
  return c < 2 ? lo : hi;
}

__device__ __forceinline__ void rank4(const int4 cnt, const int4 pl, int row, int sent, int r[4]) {
  const int off = row & 63;
  const uint32_t m_lo = off >= 32 ? 0xFFFFFFFFu : ((1u << off) - 1u);
  const uint32_t m_hi = off > 32 ? ((1u << (off - 32)) - 1u) : 0u;
  const uint32_t a0 = (uint32_t)pl.x, a1 = (uint32_t)pl.y;
  const uint32_t b0 = (uint32_t)pl.z, b1 = (uint32_t)pl.w;
  r[0] = cnt.x + __popc(~a0 & ~b0 & m_lo) + __popc(~a1 & ~b1 & m_hi);
  r[1] = cnt.y + __popc(a0 & ~b0 & m_lo) + __popc(a1 & ~b1 & m_hi);
  r[2] = cnt.z + __popc(~a0 & b0 & m_lo) + __popc(~a1 & b1 & m_hi);
  r[3] = cnt.w + __popc(a0 & b0 & m_lo) + __popc(a1 & b1 & m_hi);
  r[0] -= ((sent >> 6) == (row >> 6)) & (sent < row);
}

__global__ void record_kernel(const int4* __restrict__ t, const uint8_t* __restrict__ query,
                              int L, const int* __restrict__ qlen, int n, int mi, int min_len,
                              int C0, int C1, int C2, int C3, int C4, int sent,
                              int* __restrict__ lines, int* __restrict__ nsteps) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;
  const int C[5] = {C0, C1, C2, C3, C4};
  const uint8_t* q = query + (int64_t)w * L;
  const int ql = qlen[w];
  int steps = 0, x = 0;
  auto base = [&](int p) { return (int)q[p < L ? p : L - 1]; };
  while (x < ql) {
    const int nb = base(x);
    if (nb >= 4) { ++x; continue; }
    int k = C[nb], l = C[3 - nb], s = C[nb + 1] - C[nb];
    bool tail = s < mi;
    int exr = tail ? x : x + 1, ee = x + 1;
    for (;;) {
      const int pos = ee;
      const int c = pos < ql ? base(pos) : 4;
      if (c >= 4) { x = pos >= ql ? ql : pos + 1; break; }
      const int a = l, b = l + s, cc = 3 - c;
      const int ba = a >> 6, bb = b >> 6;
      int64_t at = ((int64_t)steps * n + w) * 2;
      lines[at] = ba;
      lines[at + 1] = bb == ba ? -1 : bb;
      int lo[4], hi[4];
      rank4(t[2 * (int64_t)ba], t[2 * (int64_t)ba + 1], a, sent, lo);
      rank4(t[2 * (int64_t)bb], t[2 * (int64_t)bb + 1], b, sent, hi);
      const int s0 = hi[0] - lo[0], s1 = hi[1] - lo[1], s2 = hi[2] - lo[2], s3 = hi[3] - lo[3];
      const int sc = (sent >= a) & (sent < b);
      const int k_n = k + sc + sel4(s1 + s2 + s3, s2 + s3, s3, 0, cc);
      const int l_n = sel4(C[0], C[1], C[2], C[3], cc) + sel4(lo[0], lo[1], lo[2], lo[3], cc);
      const int s_n = sel4(s0, s1, s2, s3, cc);
      ++steps;
      if (!tail && s_n < mi) { exr = ee; tail = true; }
      const int istar = exr > x + min_len ? exr : x + min_len;
      k = k_n; l = l_n; s = s_n;
      ee = pos + 1;
      if (tail && pos >= istar) { x = istar + 1; break; }
    }
  }
  nsteps[w] = steps;
}

__global__ void chain_kernel(const int4* __restrict__ t, const int* __restrict__ lines,
                             const int* __restrict__ nsteps, int n, int zero,
                             int* __restrict__ sink) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;
  const int m = nsteps[w];
  int dep = 0, acc = 0;
  for (int i = 0; i < m; ++i) {
    const int64_t at = ((int64_t)i * n + w) * 2;
    const int ba = lines[at] + dep, bb = lines[at + 1];
    const int4 c = __ldg(t + 2 * (int64_t)ba), p = __ldg(t + 2 * (int64_t)ba + 1);
    int v = c.x ^ p.w;
    if (bb >= 0) {
      const int64_t at2 = 2 * (int64_t)(bb + dep);
      const int4 c2 = __ldg(t + at2), p2 = __ldg(t + at2 + 1);
      v ^= c2.x ^ p2.w;
    }
    acc ^= v;
    dep = v & zero;
  }
  if (acc == 0x7eadbeef) sink[0] = acc;
}

__global__ void rate_kernel(const int4* __restrict__ t, const int* __restrict__ flat, int64_t m,
                            int* __restrict__ sink) {
  int acc = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int b = flat[i];
    const int4 c = __ldg(t + 2 * (int64_t)b), p = __ldg(t + 2 * (int64_t)b + 1);
    acc ^= c.x ^ p.w;
  }
  if (acc == 0x7eadbeef) sink[0] = acc;
}

}  // namespace

extern "C" {
int gb_probe_seed3_record(const void* table, const uint8_t* query, int L, const int* qlen, int n,
                          int mi, int min_len, int c0, int c1, int c2, int c3, int c4, int sent,
                          int* lines, int* nsteps, void* stream) {
  record_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const int4*)table, query, L, qlen, n, mi, min_len, c0, c1, c2, c3, c4, sent, lines, nsteps);
  return (int)cudaGetLastError();
}
int gb_probe_chain(const void* table, const int* lines, const int* nsteps, int n, int zero,
                   int* sink, void* stream) {
  chain_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const int4*)table, lines, nsteps, n, zero, sink);
  return (int)cudaGetLastError();
}
int gb_probe_rate(const void* table, const int* flat, int64_t m, int* sink, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  rate_kernel<<<sms * 16, 256, 0, (cudaStream_t)stream>>>((const int4*)table, flat, m, sink);
  return (int)cudaGetLastError();
}
}
"""


def start_probe_build(work):
    """nvcc of PROBE_SOURCE into work/seed3_probe.so, started (the package's
    flags); returns (Popen, .so path)."""
    from genomicsbench_tpu_torch import _kernels

    os.makedirs(work, exist_ok=True)
    src, so = os.path.join(work, "seed3_probe.cu"), os.path.join(work, "seed3_probe.so")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    proc = subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def finish_probe_build(build):
    """Wait for start_probe_build; the probe library, bound."""
    import ctypes

    proc, so = build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"sites_seed3_ab: nvcc failed for {so}:\n{log}")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib = ctypes.CDLL(so)
    for fn, args in (("gb_probe_seed3_record", [P, P, I, P] + [I] * 9 + [P] * 3),
                     ("gb_probe_chain", [P, P, P, I, I, P, P]),
                     ("gb_probe_rate", [P, P, L, P, P])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def seed3_floors(probe, tab, q, ql, device_ms, min_intv=20, min_len=20):
    """The seed walk's chain floor and line-rate floor on (q, ql): each read's
    rank lines recorded by the probe's sequential walk, then replayed
    dependent and independent, by `device_ms`.  Returns a dict with both
    floors, the recorded steps and lines, and the recorded steps a read."""
    import torch

    from genomicsbench_tpu_torch.ops import fmi

    B, L = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    lines = torch.full((L, B, 2), -1, dtype=torch.int32, device=q.device)
    nsteps = torch.zeros(B, dtype=torch.int32, device=q.device)
    sink = torch.zeros(1, dtype=torch.int32, device=q.device)
    rc = probe.gb_probe_seed3_record(tab.table.data_ptr(), q.data_ptr(), L, ql.data_ptr(), B,
                                     min_intv, min_len, *fmi._launch_consts(tab),
                                     lines.data_ptr(), nsteps.data_ptr(), stream)
    assert rc == 0, rc
    flat = lines[lines >= 0].contiguous()

    def chain():
        assert probe.gb_probe_chain(tab.table.data_ptr(), lines.data_ptr(), nsteps.data_ptr(),
                                    B, 0, sink.data_ptr(), stream) == 0

    def rate():
        assert probe.gb_probe_rate(tab.table.data_ptr(), flat.data_ptr(), flat.numel(),
                                   sink.data_ptr(), stream) == 0

    out = {"chain_floor_ms": device_ms(chain), "line_rate_floor_ms": device_ms(rate),
           "recorded_steps": int(nsteps.long().sum()), "recorded_lines": int(flat.numel()),
           "longest_steps": int(nsteps.max())}
    out["nsteps"] = nsteps
    return out


COMMON = r"""
import ctypes, json, os, subprocess, sys, time
root, cache = sys.argv[1], sys.argv[2]
here = os.path.dirname(os.path.dirname(os.path.abspath(sys.argv[3])))
sys.path[:0] = [root, os.path.join(here, "tests"), os.path.join(here, "tools")]
import numpy as np
import torch
from genomicsbench_tpu_torch import _kernels
from genomicsbench_tpu_torch.ops import fmi, kmer
import sites_seed3_ab

REPS = 20
SLEEP_CYCLES = 1_000_000
K, W = 15, 5

def timer(fn, busy, pre=None):
    if pre is not None:
        pre()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if busy:
            torch.cuda._sleep(SLEEP_CYCLES)
        if pre is not None:
            pre()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return min(times)

def device_ms(fn, pre=None):
    return timer(fn, True, pre)

def stream():
    return torch.cuda.current_stream().cuda_stream

# kmer: the minimizer index's planes
codes = np.load(os.path.join(cache, "sites_codes.npy"))
sc = torch.from_numpy(codes).cuda()
sl = torch.full((len(codes),), codes.shape[1], dtype=torch.int32, device="cuda")
raw, mask = kmer.minimizer_walk(sc, sl, K, W)
offs = torch.zeros(len(sl), dtype=torch.int64, device="cuda")
offs[1:] = torch.cumsum(sl.long(), 0)[:-1]
B_s, L_s = raw.shape
reps = torch.empty(B_s * L_s, dtype=torch.int64, device="cuda")
gpos = torch.empty_like(reps)
count = torch.zeros(1, dtype=torch.int64, device="cuda")
wr, wg = kmer.minimizer_sites_reference(raw, mask, sl, offs, K)
want_pairs = torch.sort((wr << 31) | wg).values
del wr, wg

def sites_launch(lib):
    def launch():
        rc = lib.gb_kmer_sites(raw.data_ptr(), mask.data_ptr(), sl.data_ptr(), offs.data_ptr(),
                               B_s, L_s, K, reps.data_ptr(), gpos.data_ptr(), count.data_ptr(),
                               stream())
        assert rc == 0, rc
    return launch

def sites_check(label):
    n = int(count)
    got = torch.sort((reps[:n] << 31) | gpos[:n]).values
    assert torch.equal(got, want_pairs), label

# fmi: the bench batch
d = np.load(os.path.join(cache, "fmi_main.npz"))
index = fmi.FmdIndex(n=int(d["n"]), C=d["C"], occ_cp=d["occ_cp"], plane0=d["plane0"],
                     plane1=d["plane1"], valid=np.zeros((0, 2), np.uint32),
                     sentinel_row=int(d["sentinel_row"]), sa=np.zeros(0, np.int64))
q_h, ql_h = d["query"], d["qlen"]
pipe = fmi.FmiPipeline(index, device="cuda")
tab = pipe.tables
q, ql = pipe._put_query(q_h, ql_h)
B_q, L_q = q.shape
EM3 = fmi.seed3_cap(L_q, 20)
seed_buf = torch.zeros(B_q * (fmi.SEED3_HEAD + 4 * EM3) + 1, dtype=torch.int32, device="cuda")
want_seed = fmi.fmi_seed3_reference(tab, q, ql, min_intv=20, min_len=20).buf

# the SSR batch's pass-1 e-table lanes
d = np.load(os.path.join(cache, "fmi_ssr.npz"))
s_index = fmi.FmdIndex(n=int(d["n"]), C=d["C"], occ_cp=d["occ_cp"], plane0=d["plane0"],
                       plane1=d["plane1"], valid=np.zeros((0, 2), np.uint32),
                       sentinel_row=int(d["sentinel_row"]), sa=np.zeros(0, np.int64))
s_pipe = fmi.FmiPipeline(s_index, device="cuda")
s_tab = s_pipe.tables
s_q, s_ql = s_pipe._put_query(d["query"], d["qlen"])
over = np.nonzero(fmi.fmi_smem1(s_tab, s_q, s_ql, min_seed_len=19).ovf.cpu().numpy())[0]
lanes = s_pipe.etable_lanes(over, np.ones(len(over), np.int32), s_q.shape[1])
N_e = lanes[0].numel()
ext_buf = torch.zeros(5 * N_e, dtype=torch.int32, device="cuda")
want_ext = fmi.fmi_extend_reference(s_tab, s_q, s_ql, *lanes)

def seed3_launch(lib, rounds=None):
    entry = lib.gb_fmi_seed3
    args = [tab.table.data_ptr(), q.data_ptr(), L_q, ql.data_ptr(), B_q, 20, 20, EM3,
            *fmi._launch_consts(tab), seed_buf.data_ptr()]
    if len(entry.argtypes) == 17:       # since the lane-group design: an optional rounds
        args.append(None if rounds is None else rounds.data_ptr())
    def launch():
        rc = entry(*args, stream())
        assert rc == 0, rc
    return launch

def seed3_check(label):
    torch.cuda.synchronize()
    assert torch.equal(seed_buf[:-1], want_seed), label

def extend_launch(lib):
    entry = lib.gb_fmi_extend
    args = [s_tab.table.data_ptr(), s_q.data_ptr(), s_q.shape[1], s_ql.data_ptr(),
            *[t.data_ptr() for t in lanes], N_e, *fmi._launch_consts(s_tab), ext_buf.data_ptr()]
    def launch():
        rc = entry(*args, stream())
        assert rc == 0, rc
    return launch

def extend_check(label):
    torch.cuda.synchronize()
    assert torch.equal(ext_buf.view(5, N_e), want_ext), label

def resources(log, part):
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
    return {k: v for k, v in out.items() if part in k}
"""

CHILD = COMMON + r"""
lib = _kernels.load()
res = {"root": root, "card": torch.cuda.get_device_name(0), "positions": B_s * L_s,
       "sites": int(want_pairs.numel()), "reads": B_q, "extend_lanes": N_e}
res["sites_device_ms"] = device_ms(sites_launch(lib), pre=count.zero_)
sites_check(root)
res["seed3_device_ms"] = device_ms(seed3_launch(lib))
seed3_check(root)
res["extend_device_ms"] = device_ms(extend_launch(lib))
extend_check(root)
res["sites_wrapper_ms"] = timer(lambda: kmer.minimizer_sites(raw, mask, sl, offs, K), False)
res["seed3_wrapper_ms"] = timer(lambda: fmi.fmi_seed3(tab, q, ql, min_intv=20, min_len=20),
                                False)
res["extend_wrapper_ms"] = timer(lambda: fmi.fmi_extend(s_tab, s_q, s_ql, *lanes), False)
res["sites_ptxas"] = resources(_kernels.library_path("kmer").with_suffix(".log").read_text(),
                               "sites_kernel")
fmi_log = _kernels.library_path("fmi").with_suffix(".log").read_text()
res["seed3_ptxas"] = resources(fmi_log, "seed3_kernel")
res["extend_ptxas"] = resources(fmi_log, "extend_kernel")
walls = []
for _ in range(4):
    t0 = time.perf_counter()
    pipe.run(q_h.copy(), ql_h.copy())
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
res["fmi_run_ms"] = walls[1:]
walls = []
for _ in range(4):
    t0 = time.perf_counter()
    kmer.build_index_minimizers(codes, sl.cpu().numpy(), k=K, window=W, device="cuda")
    walls.append((time.perf_counter() - t0) * 1e3)
res["build_index_minimizers_ms"] = walls[1:]
print(json.dumps(res), flush=True)
"""

# name -> (source in csrc/, [(text, replacement)]); seed3's and extend's
# times are taken for each
GROUP = "constexpr int kSeedGroup = 2;"
WARPS = "constexpr int kSeedWarps = 4;"
STAGE = "constexpr int kSeedStageMax = 384;"
LINE_LOAD = "part[i] = __ldg(f.table + 2 * (int64_t)(p < 2 ? ba : bb) + (p & 1));"
PART = "const int p = kSeedParts * gl + i;"
EXT_TESTS = ("        if (pos >= ql || pos >= me) break;\n"
             "        const int c = __ldg(q + (pos < L ? pos : L - 1));\n"
             "        if (c >= 4) break;\n")
EXT_LINES = ("        const Lines t = ext_lines(f, l, s);     "
             "// before the tests: they need no base\n")
VARIANTS = {
    "seed3_group1": ("fmi.cu", [(GROUP, GROUP.replace("2", "1"))]),
    "seed3_group4": ("fmi.cu", [(GROUP, GROUP.replace("2", "4"))]),
    "seed3_warps8": ("fmi.cu", [(WARPS, WARPS.replace("4", "8"))]),
    "seed3_unstaged": ("fmi.cu", [(STAGE, STAGE.replace("384", "0"))]),
    "seed3_lines_l2_only": ("fmi.cu", [(LINE_LOAD, LINE_LOAD.replace("__ldg", "__ldcg"))]),
    # the parts of a pair's lanes interleaved (lane j parts j and j + 2:
    # the counts lane and the planes lane branch apart; a line is one L1
    # request of the pair)
    "seed3_parts_interleaved": ("fmi.cu", [
        (PART + "\n        if (kSeedGroup == 1 && p >= 2 && bb == ba)\n"
                "            part[i] = part[i & 1];",
         "const int p = gl + kSeedGroup * i;\n        if (kSeedGroup < 4 && p >= 2 && bb == ba)\n"
         "            part[i] = part[i - 2 / kSeedGroup];"),
        (PART + "\n            int r[4];",
         "const int p = gl + kSeedGroup * i;\n            int r[4];")]),
    # extend: the tests before the lines, as first written; 16 blocks of
    # 128 an SM (32 registers), every lane resident
    "extend_tests_first": ("fmi.cu", [(EXT_LINES + EXT_TESTS,
                                       EXT_TESTS + EXT_LINES.replace(
                                           "     // before the tests: they need no base", ""))]),
    "extend_16_blocks": ("fmi.cu", [("__launch_bounds__(kThreads)\nfmi_extend_kernel(",
                                     "__launch_bounds__(kThreads, 16)\nfmi_extend_kernel(")]),
}

VARIANT = COMMON + r"""
work, variants = sys.argv[4], json.loads(sys.argv[5])
lib = _kernels.load()
builds = {}
for label, (source, edits) in variants.items():
    text = open(os.path.join(root, "genomicsbench_tpu_torch", "csrc", source)).read()
    for a, b in edits:
        assert text.count(a) == 1, (label, a)
        text = text.replace(a, b)
    src, so = os.path.join(work, label + ".cu"), os.path.join(work, label + ".so")
    open(src, "w").write(text)
    builds[label] = (source, so, subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

def row(label, lib_v, source, log=None):
    r = {"variant": label}
    if source in (None, "kmer.cu"):
        r["sites_device_ms"] = device_ms(sites_launch(lib_v), pre=count.zero_)
        sites_check(label)
    if source in (None, "fmi.cu"):
        r["seed3_device_ms"] = device_ms(seed3_launch(lib_v))
        seed3_check(label)
        r["extend_device_ms"] = device_ms(extend_launch(lib_v))
        extend_check(label)
    if log is not None:
        r["ptxas"] = {k: v for part in ("sites_kernel", "seed3_kernel", "extend_kernel")
                      for k, v in resources(log, part).items()}
    print(json.dumps(r), flush=True)

row("intact", lib, None)
for label, (source, so, proc) in builds.items():
    log = proc.communicate()[0]
    assert proc.returncode == 0, (label, log)
    lib_v = ctypes.CDLL(so)
    for fn in ("gb_kmer_sites", "gb_fmi_seed3", "gb_fmi_extend"):
        if hasattr(lib_v, fn):
            getattr(lib_v, fn).argtypes = getattr(lib, fn).argtypes
            getattr(lib_v, fn).restype = ctypes.c_int
    row(label, lib_v, source, log)
row("intact", lib, None)
"""

PROBE = COMMON + r"""
lib = _kernels.load()
probe = sites_seed3_ab.finish_probe_build(sites_seed3_ab.start_probe_build(cache))
fl = sites_seed3_ab.seed3_floors(probe, tab, q, ql, device_ms)
steps = fmi.fmi_seed3(tab, q, ql, min_intv=20, min_len=20).steps
assert torch.equal(fl.pop("nsteps"), steps), "the recorded walk's steps != seed3's"
fl["seed3_device_ms"] = device_ms(seed3_launch(lib))
fl["sites_device_ms"] = device_ms(sites_launch(lib), pre=count.zero_)
fl["line_bytes_ms"] = 32 * fl["recorded_lines"] / sites_seed3_ab.HBM_BYTES_PER_S * 1e3
fl["empty_kernel_device_ms"] = device_ms(lambda: torch.cuda._sleep(0))
print(json.dumps(fl), flush=True)
"""


def save_inputs(cache):
    """The minimizer index's 5,000 reads and the fmi main path's two indexes
    and batches into `cache`."""
    import numpy as np
    import torch_fmi_cases as fc
    import torch_kmer_cases as kc
    from genomicsbench_tpu_torch.ops.fmi import build_fmd_index

    path = os.path.join(cache, "sites_codes.npy")
    if not os.path.exists(path):
        np.save(path, kc.genome_reads(**kc.MAIN)[0][:kc.INDEX_MINIMIZER_READS])
    for name in ("fmi_main", "fmi_ssr"):
        path = os.path.join(cache, name + ".npz")
        if os.path.exists(path):
            continue
        if name == "fmi_main":
            ref = fc.bench_fmi_reference()
            query, qlen = fc.bench_fmi_reads(ref)
        else:
            ref = fc.ssr_reference()[0]
            query, qlen = fc.bench_fmi_reads(ref, seed=SSR_READ_SEED)
        idx = build_fmd_index(ref)
        del ref
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
        print("sites_seed3_ab: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [here, os.path.join(here, "tests")]
    cache = os.path.join(here, "build", "sites_seed3_ab")
    os.makedirs(cache, exist_ok=True)
    save_inputs(cache)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    me = os.path.abspath(__file__)
    if probe or variants:
        extra = [cache, json.dumps(VARIANTS)] if variants else []
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
