"""Time the grm finish kernel (`gb_grm_finish`, csrc/grm.cu) of one or more
checkouts on one card, in the turns given (e.g. A B B A), so that the
versions meet the same card, clocks and host.

    python3 tools/grm_finish_ab.py ROOT [ROOT ...]

Each root is the top of a checkout of this repository (e.g. a `git archive`
of the parent commit unpacked under build/, and the working tree).  Each
root's csrc/grm.cu is built with the package's nvcc flags into
build/grm_finish_ab/ (one nvcc each, started together) and loaded with
ctypes in this one process.  At the main path's shapes (`grm()` on
bench_grm: N 2,504 samples, num and den of (2,560, 2,560) f32, den holding
pair counts 0..100,000 with zeros among them) each turn measures the C
entry by `device_ms` (chip_smoke.py's: best of 20 launches, each timed
alone with the card held busy while the host enqueues), its output held
bit for bit against `grm_finish_reference` on the card; before the turns,
every root's output is also held at N 1-9, 127-131, 255-257 and 2,504
(ld the padded width, a multiple of 128).  Beside them: the launch floor
of `device_ms` (an empty kernel), the card's copy of the same 50.2 MB (one
(2, N (N + 1) / 2) f32 buffer copied into another) by `device_ms`, and the
bytes bound at 3.35 TB/s.  It prints the card's name and power limit, one
JSON line per turn and, last, each root's best.

Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO]

from chip_smoke import HBM_BYTES_PER_S, KERNEL_REPS, device_ms, nvidia_smi  # noqa: E402
from genomicsbench_tpu_torch import _kernels  # noqa: E402
from genomicsbench_tpu_torch.ops.grm import SAMPLE_PAD, grm_finish_reference  # noqa: E402

N_MAIN = 2_504
EDGE_NS = list(range(1, 10)) + list(range(127, 132)) + list(range(255, 258)) + [N_MAIN]
SEED = 22


def build(roots):
    """{root: ctypes entry}, every root's grm.cu built at once."""
    work = os.path.join(REPO, "build", "grm_finish_ab")
    os.makedirs(work, exist_ok=True)
    procs = {}
    for i, root in enumerate(roots):
        so = os.path.join(work, f"grm_{i}.so")
        src = os.path.join(root, "genomicsbench_tpu_torch", "csrc", "grm.cu")
        procs[root] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for root, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {root}:\n{text}")
        print(f"[build] {root}: " + " | ".join(
            ln.strip() for ln in text.splitlines() if "ptxas" in ln and
            ("registers" in ln or "spill" in ln or "Compiling" in ln)), flush=True)
        fn = ctypes.CDLL(so).gb_grm_finish
        fn.argtypes = _kernels.SOURCES["grm"][1]["gb_grm_finish"]
        fn.restype = ctypes.c_int
        out[root] = fn
    return out


def planes(N, gen):
    """num and den at the padded width of N samples, on the card."""
    Nb = -(-N // SAMPLE_PAD) * SAMPLE_PAD
    num = torch.randn(Nb, Nb, generator=gen, device="cuda") * 300.0
    den = torch.randint(0, 100_001, (Nb, Nb), generator=gen, device="cuda").float()
    den[torch.rand(Nb, Nb, generator=gen, device="cuda") < 0.01] = 0.0
    return num, den


def call(fn, num, den, N, out):
    rc = fn(num.data_ptr(), den.data_ptr(), num.shape[1], N, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"gb_grm_finish returned cudaError {rc}")


def held(fn, num, den, N, what):
    out = torch.full((2, N * (N + 1) // 2), float("nan"), device="cuda")
    call(fn, num, den, N, out)
    want = grm_finish_reference(num, den, N)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
        bad = (out.view(torch.int32) != want.view(torch.int32)).nonzero()[:4].tolist()
        raise AssertionError(f"{what}: gb_grm_finish != grm_finish_reference at {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        print("grm_finish_ab: no CUDA device is available", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [REPO]
    turns = roots + roots[::-1] if len(roots) > 1 else roots * 2
    print(f"[device] {nvidia_smi('name,power.limit')}; torch {torch.__version__}", flush=True)
    fns = build(list(dict.fromkeys(roots)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for root, fn in fns.items():
        for N in EDGE_NS:
            num, den = planes(N, gen)
            held(fn, num, den, N, f"{root} at N {N}")
    print(f"[edges] every root == grm_finish_reference bit for bit at N {EDGE_NS}",
          flush=True)
    num, den = planes(N_MAIN, gen)
    tri = N_MAIN * (N_MAIN + 1) // 2
    out = torch.empty(2, tri, device="cuda")
    nbytes = 16 * tri
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    src = torch.randn(2, tri, generator=gen, device="cuda")
    floors = dict(empty_kernel_device_ms=device_ms(lambda: torch.cuda._sleep(0), KERNEL_REPS),
                  copy_same_bytes_device_ms=device_ms(lambda: out.copy_(src), KERNEL_REPS),
                  bound_ms=bound_ms, bytes=nbytes)
    print(json.dumps(floors), flush=True)
    best = {}
    for turn, root in enumerate(turns):
        fn = fns[root]
        ms = device_ms(lambda: call(fn, num, den, N_MAIN, out), KERNEL_REPS)
        held(fn, num, den, N_MAIN, f"{root}, turn {turn}")
        best[root] = min(best.get(root, ms), ms)
        print(json.dumps(dict(turn=turn, root=root, N=N_MAIN, ld=num.shape[1],
                              device_ms=ms, share_of_bound=bound_ms / ms)), flush=True)
    print(json.dumps(dict(best_device_ms=best, **floors)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
