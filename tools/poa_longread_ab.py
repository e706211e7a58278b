"""Time the port's poa and long-read paths of two checkouts on one card, in
turns (A, B, B, A), so that the two versions meet the same card, clocks and
host.

    python3 tools/poa_longread_ab.py A_ROOT B_ROOT

Each root is the top of a checkout of this repository (e.g. a `git archive`
of the parent commit unpacked under build/, and the working tree).  Each
turn is a child process that imports that root's genomicsbench_tpu_torch,
builds its kernels into that root's build directory and measures, on the
main paths of chip_smoke.py:
  - `msa_consensus_batch` over the 1,024 bench_poa windows (seed 19): one
    warm-up, then the wall time of each of 3 calls;
  - one `msa_consensus_batch` under torch.profiler: the device time of the
    fill and backtrack kernels summed over the call's launches;
  - `banded_nw` of the 100,000-base read at W 2,048: one warm-up, then
    the wall time of each of 3 calls.
It prints one JSON line per turn and, last, each measure's best per root.
Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, sys, time
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "tests")]
import torch
from torch.profiler import ProfilerActivity, profile
from genomicsbench_tpu_torch.ops import longread, poa
from torch_longread_cases import main_read
from torch_poa_cases import bench_poa_windows

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

windows = bench_poa_windows(1024)
res = {"root": root, "card": torch.cuda.get_device_name(0)}
res["msa_consensus_batch_ms"] = walls(lambda: poa.msa_consensus_batch(windows, device="cuda"))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    poa.msa_consensus_batch(windows, device="cuda")
    torch.cuda.synchronize()
for name in ("poa_fill_kernel", "poa_backtrack_kernel"):
    evs = [e for e in prof.key_averages() if name in e.key]
    res[name + "_ms_per_call"] = sum(e.self_device_time_total for e in evs) * 1e-3
    res[name + "_launches"] = sum(e.count for e in evs)
q, t, W = main_read()
res["banded_nw_ms"] = walls(lambda: longread.banded_nw(q, t, W, device="cuda"))
print(json.dumps(res), flush=True)
"""


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("poa_longread_ab: no CUDA device is available", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    runs = []
    for label, root in zip("ABBA", (roots[0], roots[1], roots[1], roots[0])):
        out = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True,
                             cwd=root, check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["turn"] = label
        runs.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    summary = {"card": smi}
    for label, root in zip("AB", roots):
        mine = [r for r in runs if r["root"] == root]
        summary[label] = {
            "root": root,
            "msa_consensus_batch_ms": min(min(r["msa_consensus_batch_ms"]) for r in mine),
            "poa_fill_kernel_ms_per_call": min(r["poa_fill_kernel_ms_per_call"] for r in mine),
            "poa_backtrack_kernel_ms_per_call": min(r["poa_backtrack_kernel_ms_per_call"]
                                                    for r in mine),
            "banded_nw_ms": min(min(r["banded_nw_ms"]) for r in mine)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
