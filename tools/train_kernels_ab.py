"""Time the two training kernels of csrc/basecaller.cu (`gb_bc_depthwise_wgrad`
and `gb_bc_bn_act_bwd`) of one or more checkouts on one card, in the turns
given (e.g. A B B A), so that the versions meet the same card, clocks and
host.

    python3 tools/train_kernels_ab.py ROOT [ROOT ...]
    python3 tools/train_kernels_ab.py --probe ROOT
    python3 tools/train_kernels_ab.py --train-step ROOT [ROOT ...]

Each root is the top of a checkout of this repository (a `git archive` of
the parent unpacked under build/, the working tree, or a directory that
holds only genomicsbench_tpu_torch/csrc/basecaller.cu).  Each root's
basecaller.cu is built with the package's nvcc flags into
build/train_kernels_ab/ (one nvcc each, started together) and loaded with
ctypes in this one process.  At the shapes of one nn-base train step
(the full config, 64 chunks of 6,000 samples: 64 x 2,000 frames; the
weight gradient at each depthwise conv's (k, C), the backward epilogue at
each (C, residual), as many launches of each as the step makes) each turn
measures every C entry by `device_ms` (chip_smoke.py's: best of 20
launches, each timed alone with the card held busy while the host
enqueues) and sums them over the step.  Before the turns every root's
outputs are held as chip_smoke.py's train edges hold them (`wgrad_hold`,
`bn_bwd_hold`: two launches bit for bit, the sums against float64 at the
bound of the root's own order, from its tests/torch_train_cases.py, the
plain versions on the same card tensors), and
the inputs, bytes and FMAs are chip_smoke.py's (`bn_bwd_inputs`,
`wgrad_work`, `bn_bwd_bytes`).  It prints
the card's name and power limit, one JSON line per turn and, last, each
root's best and the bounds (bytes at 3.35 TB/s; FMAs at 128 FP32 lanes an
SM): the step's bytes and FMAs each summed, and each launch's own roofline
(the larger of its two) summed.  A line a root before the summary times
its `gb_bc_bn_act_bwd_sums` and `gb_bc_bn_act_bwd_apply` apart at each
launch shape, beside one PyTorch elementwise pass over the same inputs.
--probe takes the root's k 123 C 456 and k 9 C 440 weight gradients and
its C 440 epilogue (with and without the residual): each kernel's device
time under torch.profiler, both epilogue entries with Swish and without
(act 0: no sigmoid), and the SM clock (`nvidia-smi clocks.sm`, sampled)
while each of the two kernels runs back to back for about two seconds.
--train-step runs chip_smoke.py's nn-base train main phase in each root,
in the turns A B B A, and prints its step times.

Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import collections
import ctypes
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from chip_smoke import (FP32_LANES_PER_SM, HBM_BYTES_PER_S, KERNEL_REPS,  # noqa: E402
                        bn_bwd_bytes, bn_bwd_hold, bn_bwd_inputs, device_ms,
                        device_ms_by_kernel, nvidia_smi,
                        sm_clock_mhz, wgrad_hold, wgrad_work)
from genomicsbench_tpu_torch import _kernels  # noqa: E402
from genomicsbench_tpu_torch.models.basecaller import BasecallerConfig  # noqa: E402
from genomicsbench_tpu_torch.ops import basecaller as ops  # noqa: E402
from torch_train_cases import train_launch_shapes  # noqa: E402

B, T = 64, 2_000
SEED = 23
ENTRIES = ("gb_bc_depthwise_wgrad_scratch", "gb_bc_depthwise_wgrad", "gb_bc_bn_act_bwd",
           "gb_bc_bn_act_bwd_sums", "gb_bc_bn_act_bwd_apply")


def build(roots):
    """{root: {entry: ctypes function}}, every root's basecaller.cu built at
    once."""
    work = os.path.join(REPO, "build", "train_kernels_ab")
    os.makedirs(work, exist_ok=True)
    sources = {root: os.path.join(root, "genomicsbench_tpu_torch", "csrc", "basecaller.cu")
               for root in roots}
    procs = {}
    for i, (root, src) in enumerate(sources.items()):
        so = os.path.join(work, f"basecaller_{i}.so")
        procs[root] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for root, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {root}:\n{text}")
        lines, name = [], None
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                name = ln.split("'")[1]
            elif ("Used" in ln or "spill" in ln) and name and ("wgrad" in name
                                                               or "bn_bwd" in name):
                short = name.split("basecaller_cu_")[-1][:40]
                lines.append(f"{short}: {ln.split(':', 1)[-1].strip()}")
        print(f"[build] {root}: " + " | ".join(lines), flush=True)
        lib = ctypes.CDLL(so)
        fns = {}
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _kernels.SOURCES["basecaller"][1][entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
        out[root] = fns
    return out


def stream():
    return torch.cuda.current_stream().cuda_stream


def order_depths(label):
    """The depth functions of a root's own summation orders, from its
    tests/torch_train_cases.py: (wgrad_depth(B, T, C, k), bn_depth(N, C,
    res))."""
    path = os.path.join(label, "tests", "torch_train_cases.py")
    spec = importlib.util.spec_from_file_location(f"cases_{abs(hash(label))}", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    params = inspect.signature(cases.bn_sums_depth).parameters
    bn = cases.bn_sums_depth if len(params) == 3 else (lambda N, C, res: cases.bn_sums_depth(N))
    return cases.wgrad_depth, bn


class Wgrad:
    """One weight-gradient launch shape: its inputs, scratch and output."""

    def __init__(self, k, C, gen):
        self.k, self.C = k, C
        self.x = torch.randn(B, T, C, device="cuda", generator=gen).to(torch.bfloat16)
        self.gy = torch.randn(B, T, C, device="cuda", generator=gen).to(torch.bfloat16)
        self.out = torch.empty(k, C, device="cuda")
        self.part = None

    def call(self, fns):
        floats = ctypes.c_int64(0)
        fns["gb_bc_depthwise_wgrad_scratch"](B, T, self.C, self.k, ctypes.byref(floats))
        if self.part is None or self.part.numel() < floats.value:
            self.part = torch.empty(floats.value, device="cuda")
        rc = fns["gb_bc_depthwise_wgrad"](self.x.data_ptr(), self.gy.data_ptr(), B, T, self.C,
                                          self.k, self.part.data_ptr(), self.part.numel(),
                                          self.out.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"gb_bc_depthwise_wgrad returned cudaError {rc}")

    def held(self, fns, what, depths):
        wgrad_hold(self.x, self.gy, self.k, what,
                   run=lambda: (self.call(fns), self.out.clone())[1],
                   depth=depths[0](B, T, self.C, self.k))

    def work(self):
        return wgrad_work(B, T, self.C, self.k)


class BnBwd:
    """One backward-epilogue launch shape: its inputs, scratch and outputs."""

    def __init__(self, C, res, gen):
        N = B * T
        self.C, self.res, self.N = C, res, N
        self.x, self.r, self.dout, self.p, self.rp = bn_bwd_inputs(N, C, res, gen)
        nsum = 3 if res else 2
        # enough for this tree's partials and for the older design's (one every 256 rows)
        self.part = torch.empty(max(ops.bn_bwd_scratch_floats(N, C, nsum),
                                    -(-N // 256) * nsum * C), device="cuda")
        self.sums = torch.empty(nsum, C, device="cuda")
        self.dx = torch.empty_like(self.x)
        self.dres = torch.empty_like(self.x) if res else None

    def call(self, fns):
        ptr = lambda t: None if t is None else t.data_ptr()          # noqa: E731
        rc = fns["gb_bc_bn_act_bwd"](ptr(self.x), ptr(self.dout), ptr(self.r), ptr(self.p),
                                     ptr(self.rp), self.N, self.C, 1, ptr(self.part),
                                     self.part.numel(), ptr(self.sums), ptr(self.dx),
                                     ptr(self.dres), stream())
        if rc:
            raise RuntimeError(f"gb_bc_bn_act_bwd returned cudaError {rc}")

    def split(self, fns, act=1):
        """device_ms of the sums entry and the apply entry apart, and of
        torch.add (torch.addcmul with the residual) over the same inputs:
        an elementwise pass of PyTorch's own that reads them once and writes
        one output."""
        ptr = lambda t: None if t is None else t.data_ptr()          # noqa: E731
        ins = (ptr(self.x), ptr(self.dout), ptr(self.r), ptr(self.p), ptr(self.rp), self.N,
               self.C, act)

        def sums():
            rc = fns["gb_bc_bn_act_bwd_sums"](*ins, ptr(self.part), self.part.numel(),
                                              ptr(self.sums), stream())
            if rc:
                raise RuntimeError(f"gb_bc_bn_act_bwd_sums returned cudaError {rc}")

        def apply():
            rc = fns["gb_bc_bn_act_bwd_apply"](*ins, ptr(self.sums), self.N, ptr(self.dx),
                                               ptr(self.dres), stream())
            if rc:
                raise RuntimeError(f"gb_bc_bn_act_bwd_apply returned cudaError {rc}")

        out = torch.empty_like(self.x)
        elementwise = ((lambda: torch.addcmul(self.x, self.dout, self.r, out=out)) if self.res
                       else (lambda: torch.add(self.x, self.dout, out=out)))
        return dict(sums_ms=device_ms(sums, KERNEL_REPS), apply_ms=device_ms(apply, KERNEL_REPS),
                    elementwise_ms=device_ms(elementwise, KERNEL_REPS))

    def held(self, fns, what, depths):
        def run():
            self.call(fns)
            return (self.dx.clone(), None if self.dres is None else self.dres.clone(),
                    self.sums.clone())

        bn_bwd_hold(self.x, self.dout, self.p, self.r, self.rp, what, run=run,
                    depth=depths[1](self.N, self.C, self.res))

    def work(self):
        return bn_bwd_bytes(self.N, self.C, self.res), 0


def probe(fns):
    """The --probe lines: see the module docstring."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {"wgrad_k123_C456": Wgrad(123, 456, gen), "wgrad_k9_C440": Wgrad(9, 440, gen),
             "bn_C440": BnBwd(440, False, gen), "bn_C440_res": BnBwd(440, True, gen)}
    for name, case in cases.items():
        _, kern = device_ms_by_kernel(lambda: case.call(fns),
                                      ["wgrad_partial", "wgrad_final", "bn_bwd_sums",
                                       "bn_bwd_final", "bn_bwd_apply"])
        row = dict(case=name, kernels_ms={k: v[0] for k, v in kern.items() if v[1]},
                   call_device_ms=device_ms(lambda: case.call(fns), KERNEL_REPS))
        if isinstance(case, BnBwd):
            row["entries_ms"] = case.split(fns)
            row["entries_no_swish_ms"] = case.split(fns, act=0)
        print(json.dumps(row), flush=True)
    for name in ("wgrad_k123_C456", "bn_C440"):
        case, clocks, stop = cases[name], [], threading.Event()

        def sample():
            while not stop.is_set():
                clocks.append(nvidia_smi("clocks.sm,power.draw"))
                time.sleep(0.1)

        reps = max(1, int(2.0 / (device_ms(lambda: case.call(fns), 3) * 1e-3)))
        th = threading.Thread(target=sample)
        th.start()
        for _ in range(reps):
            case.call(fns)
        torch.cuda.synchronize()
        stop.set()
        th.join()
        print(json.dumps(dict(clock_while=name, reps=reps, samples=clocks)), flush=True)


STEP_CHILD = r"""
import os, sys
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
import torch
import chip_smoke
chip_smoke.phase_nn_train_main(torch.cuda.get_device_name(0))
"""


def train_steps(turns):
    """The --train-step lines: see the module docstring."""
    for turn, root in enumerate(turns):
        out = subprocess.run([sys.executable, "-c", STEP_CHILD], cwd=root, capture_output=True,
                             text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"{root}'s train step failed:\n{out.stdout[-3000:]}"
                               f"{out.stderr[-3000:]}")
        lines = [ln.split("] ", 1)[1] for ln in out.stdout.splitlines()
                 if "[nn-base train main]" in ln and ("best of 3" in ln or "split" in ln)]
        print(json.dumps(dict(turn=turn, root=root, lines=lines)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_kernels_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--probe"]:
        print(f"[device] {nvidia_smi('name,power.limit')}; torch {torch.__version__}",
              flush=True)
        root = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else REPO
        probe(build([root])[root])
        return 0
    if sys.argv[1:2] == ["--train-step"]:
        roots = [os.path.abspath(r) for r in sys.argv[2:]] or [REPO]
        print(f"[device] {nvidia_smi('name,power.limit')}; torch {torch.__version__}",
              flush=True)
        train_steps(roots + roots[::-1] if len(roots) > 1 else roots * 2)
        return 0
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [REPO]
    turns = roots + roots[::-1] if len(roots) > 1 else roots * 2
    print(f"[device] {nvidia_smi('name,power.limit')}; torch {torch.__version__}", flush=True)
    fns = build(list(dict.fromkeys(roots)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dw, ep = train_launch_shapes(BasecallerConfig())
    shapes = {"bc_depthwise_wgrad": [(Wgrad(k, C, gen), n)
                                     for (k, C), n in collections.Counter(dw).items()],
              "bc_bn_act_bwd": [(BnBwd(C, res, gen), n)
                                for (C, res), n in collections.Counter(ep).items()]}
    for root, f in fns.items():
        depths = order_depths(root)
        for name, cases in shapes.items():
            for case, _ in cases:
                case.held(f, f"{root}, {name} at {vars(case).get('k', '')} C {case.C}", depths)
    print("[held] every root's outputs within the float64 sums' kernel-order bound and the "
          "plain versions' order bound, two launches bit for bit", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz, clock_src = sm_clock_mhz()
    fp32_rate = sms * FP32_LANES_PER_SM * clock_mhz * 1e6
    bounds = {}
    for name, cases in shapes.items():
        nbytes = sum(n * c.work()[0] for c, n in cases)
        nops = sum(n * c.work()[1] for c, n in cases)
        roof = sum(n * max(c.work()[0] / HBM_BYTES_PER_S, c.work()[1] / fp32_rate)
                   for c, n in cases)
        bounds[name] = dict(bytes=nbytes, ops=nops,
                            bound_ms=max(nbytes / HBM_BYTES_PER_S, nops / fp32_rate) * 1e3,
                            launch_roofline_ms=roof * 1e3)
    best = collections.defaultdict(dict)
    for turn, root in enumerate(turns):
        row = dict(turn=turn, root=root)
        for name, cases in shapes.items():
            per = {}
            for case, n in cases:
                key = f"k{getattr(case, 'k', '')}_C{case.C}" + ("_res" if getattr(case, "res", 0)
                                                                else "")
                per[key] = device_ms(lambda: case.call(fns[root]), KERNEL_REPS)
            total = sum(n * per[k] for (c, n), k in zip(cases, per))
            row[name] = dict(step_device_ms=total, share_of_bound=bounds[name]["bound_ms"] / total,
                             share_of_launch_roofline=bounds[name]["launch_roofline_ms"] / total,
                             per_launch_device_ms=per)
            best[root][name] = min(best[root].get(name, total), total)
        print(json.dumps(row), flush=True)
    for root in dict.fromkeys(roots):   # the two entries apart
        split = {f"C{case.C}" + ("_res" if case.res else ""): case.split(fns[root])
                 for case, _ in shapes["bc_bn_act_bwd"]}
        print(json.dumps(dict(split_root=root, bn_bwd_entries_device_ms=split)), flush=True)
    print(json.dumps(dict(best_step_device_ms=best, bounds=bounds,
                          clock=f"{clock_mhz:.0f} MHz [{clock_src}]")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
