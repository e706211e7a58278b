"""Rules of the PyTorch port (genomicsbench_tpu_torch), checked on the CPU.

* The port, chip_smoke.py and the test helper it imports import neither
  JAX nor the JAX package: a source scan of every file, and an import in a
  fresh interpreter.
* Every entry point runs on the card unless asked for the CPU, and raises
  when there is no card; it never falls back to the CPU on its own.
* The wrappers of the kernels check what they are given before any launch.
* The fmi index build refuses an ambiguous base (tests/test_torch_fmi.py);
  the fmi wrappers refuse widths of 2^15 or more, index rows of 2^31 or
  more, qrow outside the query and mismatched shapes with ValueError.
* The configuration, the anchor calls and the phmm batches cross from the
  JAX package as plain dicts.
* The methylation wrapper refuses ranks outside 0..15624, instances of no
  k-mer or more than 256, events and reads outside the uploaded tables, a
  short flank table and unknown flags, with ValueError, before any launch.
* The host library (native/peaks.cpp, native/poa.cpp, native/sais.cpp,
  native/psr9.cpp, native/ctc.cpp, native/bam.cpp, native/pileup.cpp and
  native/dbg.cpp, one library per source) is built
  into a temporary file
  and moved into place, so
  concurrent test workers never load half of it; the kernel build holds a
  lock, so two threads that load at once run one nvcc per source.
* The kernel's launch configuration is a host function of the padded query
  width alone.
* The kmer-cnt entry points raise without a card; its wrappers refuse k
  outside 1..16, a window below 1, lengths outside the batch's width and
  wrong dtypes, before any launch.
* The nn-base entry points (basecall_signals, basecall_with_quals,
  build_model, the CLI) raise without a card unless asked for the CPU; the
  depthwise, epilogue and head wrappers refuse wrong dtypes and shapes, an
  odd channel count and a k whose shared-memory tile a block cannot hold,
  before any launch.
* The grm and long-read entry points (grm, banded_nw, the grm CLI) raise
  without a card unless asked for the CPU; the standardise, finish and
  banded NW wrappers refuse wrong dtypes, shapes, devices and contiguity, a
  band outside 1..8,192 and an end cell outside the band, before any
  launch.
* The device stages of pileup and dbg (`_count_keys`,
  `_build_window_graphs_sorted`, `build_window_graphs` and `dbg_from_bam`
  without as_arrays) raise without a card unless asked for the CPU;
  `_count_keys` refuses keys past the int32 key space and
  `_device_sort_pairs` mismatched lengths, keys past 32 bits and window ids
  outside [0, 2^31).  The pileup and dbg test files mask the JAX package's
  native loader on every test.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from genomicsbench_tpu.config import BswParams as JaxBswParams

import genomicsbench_tpu_torch
from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.config import BswParams, bsw_params_from_dict
from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts, write_anchor_calls
from genomicsbench_tpu_torch.io.pairs import PairBatch, write_pairs
from genomicsbench_tpu_torch.io.phmm_text import PhmmBatch, PhmmRead, write_phmm_testfile
from genomicsbench_tpu_torch.ops import abea, bsw, chain, eventalign, fmi, kmer, pairhmm, poa
from genomicsbench_tpu_torch.ops import methylation as meth

from torch_abea_cases import _model as abea_model
from torch_abea_cases import edge_cases as abea_edge_cases
from torch_abea_cases import eventalign_reads_case
from torch_chain_cases import edge_cases
from torch_fmi_cases import edge_cases as fmi_edge_cases
from torch_meth_cases import edge_instances, ref_mode_case, write_ref_mode_files
from torch_phmm_cases import edge_cases as phmm_edge_cases
from torch_poa_cases import dag_planes, random_dag, small_windows, write_windows_fasta

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them and slow the run many times over
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the port, chip_smoke.py and the test helpers it imports on the card
PORT_FILES = sorted((ROOT / "genomicsbench_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_bsw_cases.py",
    ROOT / "tests" / "torch_chain_cases.py", ROOT / "tests" / "torch_phmm_cases.py",
    ROOT / "tests" / "torch_abea_cases.py", ROOT / "tests" / "torch_poa_cases.py",
    ROOT / "tests" / "torch_fmi_cases.py", ROOT / "tests" / "torch_meth_cases.py",
    ROOT / "tests" / "torch_kmer_cases.py", ROOT / "tests" / "torch_basecaller_cases.py",
    ROOT / "tests" / "torch_grm_cases.py", ROOT / "tests" / "torch_longread_cases.py",
    ROOT / "tests" / "torch_pileup_cases.py", ROOT / "tests" / "torch_dbg_cases.py",
    ROOT / "tools" / "kmer_ab.py", ROOT / "tools" / "sites_seed3_ab.py",
]
FORBIDDEN_ROOTS = ("jax", "jaxlib", "genomicsbench_tpu")


def _imported_modules(source: str):
    """Every absolute module name that `source` imports, by statement or by
    a literal importlib.import_module / __import__ call."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def _forbidden(module: str) -> bool:
    # compare the first dotted component, so the port's own name
    # (genomicsbench_tpu_torch) is not taken for the JAX package's
    return module.split(".")[0] in FORBIDDEN_ROOTS


def test_scanner_tells_the_packages_apart():
    src = ("import genomicsbench_tpu_torch.ops\n"
           "from genomicsbench_tpu_torch import cli\n"
           "from genomicsbench_tpu.ops import bsw\n"
           "import jax.numpy as jnp\n"
           "importlib.import_module('genomicsbench_tpu.config')\n")
    assert [m for m in _imported_modules(src) if _forbidden(m)] == [
        "genomicsbench_tpu.ops", "jax.numpy", "genomicsbench_tpu.config"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imported_modules(path.read_text()) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_loads_no_jax():
    code = ("import sys\n"
            "import genomicsbench_tpu_torch.ops.bsw, genomicsbench_tpu_torch.cli\n"
            "import genomicsbench_tpu_torch.ops.chain, genomicsbench_tpu_torch.io\n"
            "import genomicsbench_tpu_torch.oracle\n"
            "import genomicsbench_tpu_torch.ops.pairhmm, genomicsbench_tpu_torch.io.phmm_text\n"
            "import genomicsbench_tpu_torch.oracle.pairhmm\n"
            "import genomicsbench_tpu_torch.ops.abea, genomicsbench_tpu_torch.ops.eventalign\n"
            "import genomicsbench_tpu_torch.native, genomicsbench_tpu_torch.config\n"
            "import genomicsbench_tpu_torch.ops.poa, genomicsbench_tpu_torch.oracle.poa\n"
            "import genomicsbench_tpu_torch.ops.fmi, genomicsbench_tpu_torch.io.seqio\n"
            "import genomicsbench_tpu_torch.ops.methylation, genomicsbench_tpu_torch.io.bam\n"
            "import genomicsbench_tpu_torch.ops.ref_align\n"
            "import genomicsbench_tpu_torch.ops.kmer, genomicsbench_tpu_torch.oracle.kmer\n"
            "import genomicsbench_tpu_torch.utils, genomicsbench_tpu_torch.io.fast5\n"
            "import genomicsbench_tpu_torch.models.basecaller\n"
            "import genomicsbench_tpu_torch.ops.basecaller\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'genomicsbench_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _tiny_batch():
    rng = np.random.default_rng(0)
    query = rng.integers(0, 4, (4, 16)).astype(np.uint8)
    target = np.concatenate([query, query], axis=1)
    n = np.full(4, 16, np.int32)
    return PairBatch(target=target, query=query, tlen=2 * n, qlen=n,
                     h0=np.full(4, 10, np.int32))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["scorer", "pairs", "batch"])
def test_entry_points_raise_without_card(no_card, entry):
    b = _tiny_batch()
    calls = {
        "scorer": lambda **kw: bsw.BswScorer(b, **kw),
        "pairs": lambda **kw: bsw.banded_sw_pairs(b, **kw),
        "batch": lambda **kw: bsw.banded_sw_batch(
            b.query, b.target, b.qlen, b.tlen, b.h0, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry](device="cuda:0")
    calls[entry](device="cpu")


def test_cli_raises_without_card(no_card, tmp_path):
    b = _tiny_batch()
    path = tmp_path / "pairs.txt"
    write_pairs(str(path), zip(b.query, b.target, b.h0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli_main(["bsw", "-pairs", str(path)])


def _tiny_calls():
    return anchor_calls_from_dicts(edge_cases()["n0_n1"][0])


@pytest.mark.parametrize("entry", ["chain_batch", "cli"])
def test_chain_entry_points_raise_without_card(no_card, entry, tmp_path):
    calls = _tiny_calls()
    path = tmp_path / "anchors.in"
    write_anchor_calls(str(path), calls)
    run = {
        "chain_batch": lambda *dev: chain.chain_batch(calls, device=dev[0])
        if dev else chain.chain_batch(calls),
        "cli": lambda *dev: torch_cli_main(["chain", "-i", str(path)]
                                           + (["--device", dev[0]] if dev else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


def _chain_args():
    t, _, _ = chain.upload_calls(_tiny_calls(), "cpu")
    return [t[k].clone() for k in chain.CHAIN_DP_INPUTS]


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "length", "offs_order",
                                   "offs_end", "window", "order_keyword", "targets_keyword"])
def test_chain_wrapper_checks_inputs(fault, monkeypatch):
    """chain_dp refuses what the kernel does not take, on the host, before
    it would build or launch anything."""
    from genomicsbench_tpu_torch import _kernels

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    args, kw = _chain_args(), {}
    if fault == "dtype":
        args[3], err = args[3].double(), TypeError          # avg_qspan
    elif fault == "contiguity":
        args[1], err = torch.stack([args[1], args[1]], 1)[:, 0], ValueError
    elif fault == "length":
        args[6], err = args[6][:-1], ValueError              # bw
    elif fault == "offs_order":
        args[2][2], err = args[2][3] + 1, ValueError         # offs[2] > offs[3]
    elif fault == "offs_end":
        args[2][-1], err = args[2][-1] - 1, ValueError
    elif fault == "order_keyword":
        # the warps' read order comes from the checked offsets, never the caller
        kw, err = dict(order=torch.zeros(5, dtype=torch.int64)), TypeError
    elif fault == "targets_keyword":
        # the kernel keeps its max_skip marks in shared memory: no scratch
        kw, err = dict(targets=torch.zeros(42, dtype=torch.int32)), TypeError
    else:
        kw, err = dict(window=-1), ValueError
    with pytest.raises(err):
        chain.chain_dp(*args, **kw)
    scores, parents, peak, visited = chain.chain_dp(*_chain_args())
    assert scores.shape == parents.shape == peak.shape == (42,)
    assert visited.dtype == torch.int64 and visited.shape == (5,)


def _tiny_phmm():
    return phmm_edge_cases()["strip_edges"][:2]


@pytest.mark.parametrize("entry", ["pairhmm_batch", "cli"])
def test_phmm_entry_points_raise_without_card(no_card, entry, tmp_path):
    reads, haps = _tiny_phmm()
    path = tmp_path / "phmm.txt"
    write_phmm_testfile(str(path), [PhmmBatch(reads=[PhmmRead(**r) for r in reads],
                                              haps=haps)])
    run = {
        "pairhmm_batch": lambda *dev: pairhmm.pairhmm_batch(reads, haps, device=dev[0])
        if dev else pairhmm.pairhmm_batch(reads, haps),
        "cli": lambda *dev: torch_cli_main(["phmm", "-f", str(path)]
                                           + (["--device", dev[0]] if dev else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


def _phmm_tables():
    reads, haps = _tiny_phmm()
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    t = pairhmm.upload_pairs(reads, haps, pairs, "cpu")
    fields = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    fields = {k: (v.clone() if isinstance(v, torch.Tensor) else
                  {n: a.copy() for n, a in v.items()}) for k, v in fields.items()}
    return pairhmm.PairTables(**fields)


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "offs_order", "offs_end",
                                   "pair_index", "idx_range", "idx_dtype", "host_idx",
                                   "fp16", "order", "classes"])
def test_phmm_wrapper_checks_inputs(fault, monkeypatch):
    """pairhmm_forward refuses what the kernel does not take, on the host,
    before it would build or launch anything."""
    from genomicsbench_tpu_torch import _kernels

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    t, idx, dtype, kw = _phmm_tables(), None, torch.float32, {}
    if fault == "dtype":
        t.q, err = t.q.to(torch.int32), TypeError
    elif fault == "contiguity":
        t.d, err = torch.stack([t.d, t.d], 1)[:, 0], ValueError
    elif fault == "offs_order":
        t.host["r_off"][2], err = t.host["r_off"][3] + 1, ValueError
    elif fault == "offs_end":
        t.host["h_off"][-1], err = t.host["h_off"][-1] - 1, ValueError
    elif fault == "pair_index":
        t.host["pair_h"][4], err = len(t.host["h_off"]) - 1, IndexError
    elif fault == "idx_range":
        idx, err = torch.tensor([0, t.n_pairs], dtype=torch.int64), IndexError
    elif fault == "idx_dtype":
        idx, err = torch.tensor([0, 1], dtype=torch.int32), TypeError
    elif fault == "host_idx":
        idx, err = torch.tensor([0, 1]), ValueError
        kw = dict(host_idx=np.array([0, 1, 2]))
    elif fault == "order":
        t.host["order"][0], err = t.host["order"][1], ValueError
    elif fault == "classes":
        t.host["classes"][2] += 1
        err = ValueError
    else:
        dtype, err = torch.float16, TypeError
    with pytest.raises(err):
        pairhmm.pairhmm_forward(t, idx, dtype, **kw)
    for dtype in (torch.float32, torch.float64):
        out = pairhmm.pairhmm_forward(_phmm_tables(), torch.tensor([9, 0, 3]), dtype)
        assert out.dtype == dtype and out.shape == (3,)


def test_phmm_upload_refuses_bad_pairs():
    reads, haps = _tiny_phmm()
    with pytest.raises(IndexError, match="haplotype"):
        pairhmm.upload_pairs(reads, haps, [(0, 0), (1, len(haps))], "cpu")
    with pytest.raises(IndexError, match="read"):
        pairhmm.upload_pairs(reads, haps, [(-1, 0)], "cpu")


@pytest.mark.parametrize("h_max, itemsize, warps, warp_bytes, scratch", [
    (400, 4, 8, 4816, False),       # top rows of the main path's haplotypes, float32
    (400, 8, 8, 9632, False),       # float64 (the fallback's reads past 128 rows): 77 KB
    (10_000, 4, 1, 120016, False),  # one warp fills most of a block
    (10_000, 8, 8, 240032, True),   # past a block's shared memory
])
def test_phmm_launch_is_a_function_of_h_max(h_max, itemsize, warps, warp_bytes, scratch):
    assert pairhmm.phmm_launch(h_max, itemsize) == (warps, warp_bytes, scratch)
    assert warp_bytes >= 3 * (h_max + 1) * itemsize
    if not scratch:
        assert warps * warp_bytes <= pairhmm.SMEM_MAX_BYTES


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert genomicsbench_tpu_torch.resolve_device is resolve_device


def _wrapper_args():
    b = _tiny_batch()
    w = bsw._compute_w_eff(b.qlen, BswParams())
    args = [torch.from_numpy(a) for a in (b.query, b.target, b.qlen, b.tlen,
                                          b.h0, w)]
    return args + [torch.arange(4)]


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "rows", "ndim"])
def test_wrapper_checks_inputs(fault):
    args = _wrapper_args()
    if fault == "dtype":
        args[2] = args[2].long()
        err = TypeError
    elif fault == "contiguity":
        args[0] = torch.cat([args[0], args[0]], 1)[:, ::2]
        err = ValueError
    elif fault == "rows":
        args[4] = args[4][:3]
        err = ValueError
    else:
        args[6] = args[6][None]
        err = ValueError
    with pytest.raises(err):
        bsw.bsw_extend(*args)
    assert bsw.bsw_extend(*_wrapper_args()).shape == (7, 4)


def test_lengths_beyond_width_are_refused():
    b = _tiny_batch()
    with pytest.raises(ValueError, match="qlen"):
        bsw.banded_sw_batch(b.query, b.target, b.qlen + 1, b.tlen, b.h0,
                            device="cpu")
    with pytest.raises(ValueError, match="tlen"):
        bsw.BswScorer(dataclasses.replace(b, tlen=b.tlen + 1),
                      device="cpu").score()
    args = _wrapper_args()
    with pytest.raises(ValueError, match="idx"):
        bsw.bsw_extend(*args[:6], args[6] + 1)


@pytest.mark.parametrize("fields", [{}, dict(match=2, mismatch=3, ambig=-2,
                                             o_del=4, e_del=2, o_ins=4,
                                             e_ins=2, zdrop=50, w=40)])
def test_params_round_trip(fields):
    jp = JaxBswParams(**fields)
    p = bsw_params_from_dict(dataclasses.asdict(jp))
    assert isinstance(p, BswParams)
    assert JaxBswParams(**dataclasses.asdict(p)) == jp
    assert bsw_params_from_dict(dataclasses.asdict(p)) == p
    np.testing.assert_array_equal(p.score_matrix(), jp.score_matrix())
    with pytest.raises(TypeError):
        bsw_params_from_dict({**dataclasses.asdict(jp), "band": 3})


@pytest.mark.parametrize("q_width, warps, warp_bytes, scratch", [
    (0, 8, 16, False),
    (191, 8, 1728, False),         # the main path's width
    (1100, 8, 9920, False),        # 79 KB: the block opts in past 48 KB
    (8000, 3, 72016, False),       # fewer warps to fit a block's 227 KB
    (30000, 8, 0, True),           # past a block's 227 KB: device scratch
])
def test_launch_is_a_function_of_query_width(q_width, warps, warp_bytes, scratch):
    launch = bsw.bsw_launch(q_width)
    assert launch == bsw.BswLaunch(warps, warp_bytes, scratch)
    assert launch == bsw.bsw_launch(np.int64(q_width))
    if not scratch:
        assert warp_bytes >= 9 * (q_width + 1)      # the kernel's own check
        assert launch.shared_bytes <= bsw.SMEM_MAX_BYTES
        if warps < bsw.WARPS_PER_BLOCK:             # one more would not fit
            assert launch.shared_bytes + warp_bytes > bsw.SMEM_MAX_BYTES


def test_wrapper_launch_reads_only_query_width():
    """bsw_launch takes the padded query width and nothing else, and its
    answer does not depend on what it was asked before."""
    import inspect

    assert list(inspect.signature(bsw.bsw_launch).parameters) == ["q_width"]
    widths = [0, 191, 1100, 8000, 30000]
    first = [bsw.bsw_launch(q) for q in widths]
    assert [bsw.bsw_launch(q) for q in reversed(widths)] == first[::-1]


@pytest.mark.parametrize("entry", ["align_batch", "eventalign_reads", "cli"])
def test_abea_entry_points_raise_without_card(no_card, entry, tmp_path):
    seqs, evs, sc = abea_edge_cases(longest=200)["one_kmer"]
    raws, ea_seqs = eventalign_reads_case(1, seed=0, lo=30, hi=31)
    np.savez(tmp_path / "x.npz", r0=raws[0])
    (tmp_path / "x.fa").write_text(">r0\n" + "".join("ACGT"[c] for c in ea_seqs[0]) + "\n")
    mean, stdv = abea_model()
    run = {
        "align_batch": lambda *dev: abea.align_batch(seqs, evs, mean, stdv, sc, *dev),
        "eventalign_reads": lambda *dev: eventalign.eventalign_reads(
            raws, ea_seqs, mean, stdv, **({"device": dev[0]} if dev else {})),
        "cli": lambda *dev: torch_cli_main(
            ["eventalign", "--signals", str(tmp_path / "x.npz"), "-r", str(tmp_path / "x.fa")]
            + (["--device", dev[0]] if dev else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


def _abea_tables():
    seqs, evs, sc = abea_edge_cases(longest=200)["few_events"]
    t = abea.upload_reads(seqs, evs, *abea_model(), sc, "cpu")
    fields = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    fields = {k: (v.clone() if isinstance(v, torch.Tensor) else
                  {n: a.copy() for n, a in v.items()}) for k, v in fields.items()}
    return abea.ReadTables(**fields)


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "model_shape", "offs_order",
                                   "offs_end", "band_off", "empty_read", "order", "fill_dtype",
                                   "fill_length"])
def test_abea_wrappers_check_inputs(fault, monkeypatch):
    """abea_fill and abea_backtrack refuse what the kernels do not take, on
    the host, before they would build or launch anything."""
    from genomicsbench_tpu_torch import _kernels

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    t = _abea_tables()
    f = abea.abea_fill(_abea_tables())
    if fault == "dtype":
        t.events, err = t.events.double(), TypeError
    elif fault == "contiguity":
        t.ranks, err = torch.stack([t.ranks, t.ranks], 1)[:, 0], ValueError
    elif fault == "model_shape":
        t.model, err = t.model[:, :2048].contiguous(), ValueError
    elif fault == "offs_order":
        t.host["e_off"][1], err = t.host["e_off"][2] + 1, ValueError
    elif fault == "offs_end":
        t.host["k_off"][-1], err = t.host["k_off"][-1] - 1, ValueError
    elif fault == "band_off":
        t.host["band_off"][1], err = t.host["band_off"][1] + 1, ValueError
    elif fault == "empty_read":     # a read of no k-mer
        t.host["k_off"][1], t.host["band_off"][1] = 0, t.host["e_off"][1]
        err = ValueError
    elif fault == "order":          # the kernel's start order, not a permutation
        t.host["order"][0], err = t.host["order"][1], ValueError
    elif fault == "fill_dtype":
        f.best_ev, err = f.best_ev.long(), TypeError
    else:
        f.traces, err = f.traces[:-1], ValueError
    with pytest.raises(err):
        if fault.startswith("fill"):
            abea.abea_backtrack(t, f)
        else:
            abea.abea_fill(t)
    good = _abea_tables()
    out = abea.abea_backtrack(good, abea.abea_fill(good))
    assert out.dtype == torch.int32 and out.shape == (4 * good.n_reads + 2 * good.n_bands,)


def test_abea_marshal_refuses_bad_reads():
    seqs, evs, sc = abea_edge_cases(longest=200)["few_events"]
    mean, stdv = abea_model()
    with pytest.raises(ValueError, match="0..3"):
        abea.upload_reads([np.array([0, 1, 4, 2, 3, 1, 0])] + seqs[1:], evs, mean, stdv, sc,
                          "cpu")
    with pytest.raises(ValueError, match="shorter"):
        abea.upload_reads([seqs[0][:5]] + seqs[1:], evs, mean, stdv, sc, "cpu")
    with pytest.raises(ValueError, match="4096"):
        abea.upload_reads(seqs, evs, mean[:1024], stdv[:1024], sc, "cpu")


def test_native_build_replaces_a_temporary_file(tmp_path, monkeypatch):
    """Each source of the host library is compiled into a temporary name
    beside its final path and moved into place with os.replace."""
    import os

    from genomicsbench_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    calls = []
    real_run, real_replace = subprocess.run, os.replace

    def run(cmd, **kw):
        calls.append(("cc", cmd[cmd.index("-o") + 1], cmd[-1]))
        return real_run(cmd, **kw)

    def replace(src, dst):
        calls.append(("replace", str(src), str(dst)))
        return real_replace(src, dst)

    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native.os, "replace", replace)
    libs = native.build()
    assert sorted(libs) == ["bam", "ctc", "dbg", "peaks", "pileup", "poa", "psr9", "sais"]
    assert [c[0] for c in calls] == ["cc", "replace"] * 8
    for k, (name, lib) in enumerate(libs.items()):
        assert lib == native.library_path(name) and lib.exists()
        cc, rep = calls[2 * k], calls[2 * k + 1]
        tmp = cc[1]
        assert cc[2] == str(native.SOURCES[name][0])
        assert tmp != str(lib) and tmp.endswith(".tmp") and os.path.dirname(tmp) == str(lib.parent)
        assert rep[1:] == (tmp, str(lib)) and not os.path.exists(tmp)
    calls.clear()
    assert native.build() == libs and calls == []        # built once, then reused


def test_kernel_build_runs_once_under_threads(tmp_path, monkeypatch):
    """Two threads that call _kernels.load() at once run one nvcc per source
    (the module lock), each into a temporary name carrying the process and
    the thread, and get the same entry points."""
    import os
    import threading
    import time
    import types

    from genomicsbench_tpu_torch import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    builds = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            builds.append((cmd[-1], self.out))
            self.returncode = 0

        def communicate(self):
            time.sleep(0.2)             # a build takes a while: both threads get here
            pathlib.Path(self.out).write_bytes(b"lib")
            return "ptxas info: 0 bytes spill stores, 0 bytes spill loads\n", None

    def fake_cdll(path):
        name = next(n for n in _kernels.SOURCES if _kernels.library_path(n) == pathlib.Path(path))
        return types.SimpleNamespace(**{fn: (lambda *a: 0)
                                        for fn in _kernels.SOURCES[name][1]})

    monkeypatch.setattr(_kernels.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", fake_cdll)
    start, got = threading.Barrier(2), []

    def worker():
        start.wait()
        got.append(_kernels.load())

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 2 and got[0] is got[1]
    assert sorted(src for src, _ in builds) == sorted(str(s) for s, _ in
                                                      _kernels.SOURCES.values())
    for _, tmp in builds:
        assert tmp.endswith(".tmp") and f".{os.getpid()}." in tmp and not os.path.exists(tmp)
    assert all(_kernels.library_path(n).exists() for n in _kernels.SOURCES)
    assert {"gb_poa_fill", "gb_poa_backtrack", "gb_bsw_extend"} <= set(vars(got[0]))


@pytest.mark.parametrize("entry", ["msa_consensus_batch", "align_batch", "cli"])
def test_poa_entry_points_raise_without_card(no_card, entry, tmp_path):
    windows = small_windows(2, 0)
    path = tmp_path / "w.fa"
    write_windows_fasta(path, windows)

    def align(*dev):
        g = poa.NativePoaGraph(poa.PoaParams(), cap=300)
        g.add_alignment([], windows[0][0])
        return poa.align_batch([g], [windows[0][1]], **({"device": dev[0]} if dev else {}))

    run = {
        "msa_consensus_batch": lambda *dev: poa.msa_consensus_batch(
            windows, **({"device": dev[0]} if dev else {})),
        "align_batch": align,
        "cli": lambda *dev: torch_cli_main(["poa", "-s", str(path)]
                                           + (["--device", dev[0]] if dev else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


def _poa_planes(max_indeg=3, n=20, q=30, n_pad=256, q_pad=128):
    rng = np.random.default_rng(4)
    dags = [random_dag(rng, n, max_indeg, q) for _ in range(2)]
    p_pad = poa._bucket(max(max(len(p) for p in d[1]) for d in dags), 2)
    return list(dag_planes(dags, n_pad, p_pad, q_pad))


@pytest.mark.parametrize("fault", ["q_pad", "p_pad", "n_pad", "mismatched", "dtype", "no_nodes",
                                   "qlen", "pred_rank", "offsets", "codes", "fill_length",
                                   "params"])
def test_poa_wrappers_check_inputs(fault, monkeypatch):
    """poa_fill and poa_backtrack refuse what the kernels do not take, on
    the host, before they would build or launch anything: q_pad or p_pad of
    2^13 or more and n_pad of 65,535 or more with ValueError, where the JAX
    package asserts (ops/poa.py:279,566)."""
    from genomicsbench_tpu_torch import _kernels

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    good = poa.upload_windows(*_poa_planes(), "cpu")
    f = poa.poa_fill(good)
    err, call = ValueError, None
    if fault == "q_pad":
        t = poa.upload_windows(*_poa_planes(q_pad=1 << 13), "cpu")
    elif fault == "p_pad":
        planes = _poa_planes()
        planes[1] = np.full((2, 256, 1 << 13), 0xFFFF, np.uint16)
        planes[1][:, :, 0] = planes[1][:, :, 0] * 0
        t = poa.upload_windows(*planes, "cpu")
    elif fault == "n_pad":
        t = poa.upload_windows(*_poa_planes(n_pad=0xFFFF), "cpu")
    elif fault == "mismatched":
        planes = _poa_planes()
        planes[1] = planes[1][:, :128]
        call = lambda: poa.upload_windows(*planes, "cpu")     # noqa: E731
    elif fault == "dtype":
        t = poa.upload_windows(*_poa_planes(), "cpu")
        t.n, err = t.n.long(), TypeError
    elif fault == "no_nodes":
        planes = _poa_planes()
        planes[2][1] = 0
        t = poa.upload_windows(*planes, "cpu")
    elif fault == "qlen":
        planes = _poa_planes()
        planes[4][0] = 128
        t = poa.upload_windows(*planes, "cpu")
    elif fault == "pred_rank":
        planes = _poa_planes()
        planes[1][0, 3, 0] = 5                  # row 3 is rank 4
        t = poa.upload_windows(*planes, "cpu")
    elif fault == "offsets":
        t = poa.upload_windows(*_poa_planes(), "cpu")
        t.host["trace_off"] = t.host["trace_off"] + 1
    elif fault == "codes":
        t = poa.upload_windows(*_poa_planes(max_indeg=9), "cpu")
        call = lambda: poa.poa_backtrack(t, poa.poa_fill(t), codes=True)   # noqa: E731
    elif fault == "fill_length":
        t = good
        call = lambda: poa.poa_backtrack(                      # noqa: E731
            t, poa.FillResult(f.score, f.best_rank, f.trace[:-1]))
    else:
        t, err = good, TypeError
        call = lambda: poa.poa_fill(t, dict(match=2))           # noqa: E731
    with pytest.raises(err):
        if call is None:
            poa.poa_fill(t)
        else:
            call()
    path, plen = poa.poa_backtrack(good, f, codes=True)
    assert path.dtype == torch.int32 and path.shape == (2, good.path_width(True))
    assert plen.dtype == torch.int32 and (plen > 0).all()


@pytest.mark.parametrize("entry", ["pipeline", "tables", "cli"])
def test_fmi_entry_points_raise_without_card(no_card, entry, tmp_path):
    c = fmi_edge_cases()["short"]
    idx = fmi.build_fmd_index(c["ref"])
    (tmp_path / "ref.fa").write_text(">r\n" + "".join("ACGT"[b] for b in c["ref"]) + "\n")
    (tmp_path / "q.fa").write_text(">q\n" + "".join("ACGT"[b] for b in c["ref"][:60]) + "\n")
    run = {
        "pipeline": lambda *dev: fmi.FmiPipeline(idx, **({"device": dev[0]} if dev else {}))
        .run(c["query"], c["qlen"]),
        "tables": lambda *dev: idx.device(*dev),
        "cli": lambda *dev: torch_cli_main(["fmi", str(tmp_path / "ref.fa"), str(tmp_path / "q.fa")]
                                           + (["--device", dev[0]] if dev else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


@pytest.mark.parametrize("fault", ["width", "rows", "qrow_high", "qrow_low", "qlen_shape",
                                   "item_shape", "dtype", "pivot_alone", "min_len"])
def test_fmi_wrappers_check_inputs(fault, monkeypatch):
    """fmi_smem1, fmi_seed3 and fmi_extend refuse what the kernels do not
    take, on the host, before they would build or launch anything: a width
    of 2^15 or more (JAX asserts, ops/fmi.py:1839,2363), index rows of 2^31
    or more, qrow outside the query, mismatched shapes, wrong dtypes."""
    from genomicsbench_tpu_torch import _kernels

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    c = fmi_edge_cases()["ambiguous"]
    tab = fmi.build_fmd_index(c["ref"]).device("cpu")
    q, ql = torch.from_numpy(c["query"]), torch.from_numpy(c["qlen"])
    B, L = q.shape
    items = [torch.zeros(3, dtype=torch.int32), torch.full((3,), 5, dtype=torch.int32),
             torch.ones(3, dtype=torch.int32)]
    lanes = [torch.zeros(4, dtype=torch.int32), torch.arange(4, dtype=torch.int32),
             torch.ones(4, dtype=torch.int32), torch.full((4,), 99, dtype=torch.int32)]
    err = ValueError
    calls = []
    if fault == "width":
        wide = torch.zeros((2, 1 << 15), dtype=torch.uint8)
        wl = torch.full((2,), 10, dtype=torch.int32)
        calls = [lambda: fmi.fmi_smem1(tab, wide, wl, min_seed_len=19),
                 lambda: fmi.fmi_seed3(tab, wide, wl, min_intv=20, min_len=20),
                 lambda: fmi.fmi_extend(tab, wide, wl, *lanes)]
    elif fault == "rows":
        big = dataclasses.replace(tab, c_host=tab.c_host[:4] + (1 << 31,))
        calls = [lambda: fmi.fmi_smem1(big, q, ql, min_seed_len=19),
                 lambda: fmi.fmi_seed3(big, q, ql, min_intv=20, min_len=20),
                 lambda: fmi.fmi_extend(big, q, ql, *lanes)]
    elif fault in ("qrow_high", "qrow_low"):
        bad = torch.tensor([0, B if fault == "qrow_high" else -1, 1], dtype=torch.int32)
        calls = [lambda: fmi.fmi_smem1(tab, q, ql, bad, *items[1:], min_seed_len=19),
                 lambda: fmi.fmi_extend(tab, q, ql, torch.cat([bad, bad[:1]]), *lanes[1:])]
    elif fault == "qlen_shape":
        calls = [lambda: fmi.fmi_smem1(tab, q, ql[:-1], min_seed_len=19),
                 lambda: fmi.fmi_seed3(tab, q[0], ql, min_intv=20, min_len=20)]
    elif fault == "item_shape":
        calls = [lambda: fmi.fmi_smem1(tab, q, ql, items[0], items[1][:2], items[2],
                                       min_seed_len=19),
                 lambda: fmi.fmi_extend(tab, q, ql, lanes[0], lanes[1][:3], *lanes[2:])]
    elif fault == "dtype":
        err = TypeError
        calls = [lambda: fmi.fmi_smem1(tab, q.long(), ql, min_seed_len=19),
                 lambda: fmi.fmi_seed3(tab, q, ql.long(), min_intv=20, min_len=20),
                 lambda: fmi.fmi_extend(tab, q, ql, lanes[0].long(), *lanes[1:])]
    elif fault == "pivot_alone":
        calls = [lambda: fmi.fmi_smem1(tab, q, ql, pivot=items[1], min_seed_len=19)]
    else:
        calls = [lambda: fmi.fmi_seed3(tab, q, ql, min_intv=20, min_len=0)]
    for call in calls:
        with pytest.raises(err):
            call()
    w = fmi.fmi_smem1(tab, q, ql, *items, min_seed_len=19)
    assert w.slots.shape == (3, fmi.walk_caps(L)[1], 4) and w.buf.dtype == torch.int32


@pytest.mark.parametrize("entry", ["call_methylation_batch", "call_methylation_for_read",
                                   "profile_hmm_score_batch", "upload_reads", "cli",
                                   "eventalign_cli_ref_mode"])
def test_meth_entry_points_raise_without_card(no_card, entry, tmp_path):
    cpg = meth.synthetic_cpg_model()
    inst = edge_instances(cpg[0])["single"]
    rng = np.random.default_rng(0)
    ref = "".join(rng.choice(list("ACT"), 25)) + "CG" + "".join(rng.choice(list("ACT"), 25))
    rd = dict(ref_seq=ref, ref_start_pos=0, aln_ref_pos=np.arange(48),
              aln_event_idx=np.arange(48), event_means=rng.normal(90, 5, 48).astype(np.float32),
              scalings3=(1.0, 0.0, 1.0), events_per_base=1.1, rc=False)
    case = ref_mode_case(2, seed=1, genome_len=3000, lo=200, hi=300)
    paths = write_ref_mode_files(str(tmp_path), case, __import__(
        "genomicsbench_tpu_torch.io.bam", fromlist=["bam"]))
    files = ["--signals", paths["signals"], "-r", paths["reads"]]
    ref_mode = ["-b", paths["bam"], "-g", paths["genome"]]
    dev_kw = lambda dev: {"device": dev[0]} if dev else {}
    dev_arg = lambda dev: ["--device", dev[0]] if dev else []
    run = {
        "call_methylation_batch": lambda *dev: meth.call_methylation_batch([rd], *cpg,
                                                                          **dev_kw(dev)),
        "call_methylation_for_read": lambda *dev: meth.call_methylation_for_read(
            *(rd[k] for k in ("ref_seq", "ref_start_pos", "aln_ref_pos", "aln_event_idx",
                              "event_means", "scalings3")), *cpg, 1.1, **dev_kw(dev)),
        "profile_hmm_score_batch": lambda *dev: meth.profile_hmm_score_batch(inst, *cpg,
                                                                             **dev_kw(dev)),
        "upload_reads": lambda *dev: meth.upload_reads([rd], *cpg, *dev),
        "cli": lambda *dev: torch_cli_main(["call-methylation", *files, *ref_mode]
                                           + dev_arg(dev)),
        "eventalign_cli_ref_mode": lambda *dev: torch_cli_main(["eventalign", *files, *ref_mode]
                                                               + dev_arg(dev)),
    }[entry]
    if entry != "upload_reads":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


def _meth_tables():
    cpg = meth.synthetic_cpg_model()
    insts = edge_instances(cpg[0])["k_range"][:4]
    return meth.upload_profile_instances(insts, *cpg, "cpu")


@pytest.mark.parametrize("fault", ["rank_high", "rank_upload", "no_kmer", "too_many_kmers",
                                   "events", "read", "flank", "flags", "dtype", "model_shape",
                                   "order", "lane_groups"])
def test_meth_wrapper_checks_inputs(fault, monkeypatch):
    """meth_forward refuses what the kernel does not take, on the host,
    before it would build or launch anything."""
    from genomicsbench_tpu_torch import _kernels

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    t = _meth_tables()
    h = t.host
    flags, err = 3, ValueError
    if fault == "rank_high":
        h["rank_range"] = (0, meth.NUM_KMER_METH)
    elif fault == "rank_upload":
        with pytest.raises(ValueError, match="0..15624"):
            meth.upload_instances(np.array([15625]), [0, 1], [0], [0], np.zeros(1, np.int32),
                                  np.ones(1, np.float32), meth.read_params([[1, 0, 1]], [1.5]),
                                  *meth.synthetic_cpg_model(), "cpu")
        return
    elif fault == "no_kmer":
        h["rank_off"] = h["rank_off"].copy()
        h["rank_off"][1] = 0
    elif fault == "too_many_kmers":
        t = meth.upload_instances(np.zeros(257, np.int64), [0, 257], [0], [9],
                                  np.zeros(1, np.int32), np.ones(10, np.float32),
                                  meth.read_params([[1, 0, 1]], [1.5]),
                                  *meth.synthetic_cpg_model(), "cpu")
        with pytest.raises(ValueError, match="at most 256"):
            meth.meth_forward(t)
        return
    elif fault == "events":
        h["ev_last"] = h["ev_last"].copy()
        h["ev_last"][2] = t.events.numel()
    elif fault == "read":
        h["read"] = np.array([0, 1, 4, 0], np.int32)
    elif fault == "flank":
        t.flank = t.flank[:3].clone()
    elif fault == "flags":
        flags = 4
    elif fault == "dtype":
        t.ranks, err = t.ranks.int(), TypeError
    elif fault == "order":          # the kernel's slots, not a permutation
        h["order"] = np.zeros_like(h["order"])
    elif fault == "lane_groups":    # an instance counted in a smaller lane group
        h["class_n"] = np.roll(h["class_n"], -1)
    else:
        t.model = t.model[:, :100].contiguous()
    with pytest.raises(err):
        meth.meth_forward(t, flags)
    good = _meth_tables()
    out = meth.meth_forward(good)
    assert out.dtype == torch.float32 and out.shape == (4,) and torch.isfinite(out).all()


@pytest.mark.parametrize("entry", ["count_kmers", "count_kmers_stats", "per_position_freqs",
                                   "minimizer_mask", "build_index_minimizers",
                                   "build_index_uneven_coverage", "cli_count", "cli_minimizers"])
def test_kmer_entry_points_raise_without_card(no_card, entry, tmp_path):
    seq = np.random.default_rng(0).integers(0, 4, (3, 40)).astype(np.uint8)
    lens = np.array([40, 17, 30], np.int32)
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i}\n{''.join('ACGT'[c] for c in row)}\n"
                          for i, row in enumerate(seq)))
    cfg = tmp_path / "k.cfg"
    cfg.write_text(f"use_minimizers={int(entry == 'cli_minimizers')}\n")
    dev_kw = lambda dev: {"device": dev[0]} if dev else {}          # noqa: E731
    cli = lambda *dev: torch_cli_main(["kmer-cnt", "--reads", str(fa), "--config", str(cfg)]
                                      + (["--device", dev[0]] if dev else []))
    run = {
        "count_kmers": lambda *dev: kmer.count_kmers(seq, lens, 9, **dev_kw(dev)),
        "count_kmers_stats": lambda *dev: kmer.count_kmers_stats(seq, lens, 9, **dev_kw(dev)),
        "per_position_freqs": lambda *dev: kmer._per_position_freqs(seq, lens, k=9,
                                                                    **dev_kw(dev)),
        "minimizer_mask": lambda *dev: kmer.minimizer_mask(seq, lens, k=9, window=3,
                                                           **dev_kw(dev)),
        "build_index_minimizers": lambda *dev: kmer.build_index_minimizers(
            seq, lens, k=9, window=3, **dev_kw(dev)),
        "build_index_uneven_coverage": lambda *dev: kmer.build_index_uneven_coverage(
            seq, lens, k=9, **dev_kw(dev)),
        "cli_count": cli, "cli_minimizers": cli,
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


@pytest.mark.parametrize("fault", ["k_low", "k_high", "window", "length_high", "length_low",
                                   "codes_dtype", "lengths_dtype", "codes_shape", "mode",
                                   "keys_dtype", "order_dtype", "sites_planes"])
def test_kmer_wrappers_check_inputs(fault, monkeypatch):
    """canonical_keys, kmer_runs, kmer_freqs, minimizer_walk and
    minimizer_sites refuse what the kernels do not take, on the host, before
    they would build or launch anything."""
    from genomicsbench_tpu_torch import _kernels

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    codes = torch.from_numpy(np.random.default_rng(1).integers(0, 4, (3, 24)).astype(np.uint8))
    lens = torch.tensor([24, 0, 10], dtype=torch.int32)
    err = ValueError
    if fault in ("k_low", "k_high"):
        k = 0 if fault == "k_low" else 17
        calls = [lambda: kmer.canonical_keys(codes, lens, k),
                 lambda: kmer.minimizer_walk(codes, lens, k, 5),
                 lambda: kmer.count_kmers(codes.numpy(), lens.numpy(), k, device="cpu")]
    elif fault == "window":
        calls = [lambda: kmer.minimizer_walk(codes, lens, 15, 0),
                 lambda: kmer.minimizer_mask(codes.numpy(), lens.numpy(), k=5, window=0,
                                             device="cpu")]
    elif fault in ("length_high", "length_low"):
        bad = lens.clone()
        bad[2] = 25 if fault == "length_high" else -1
        calls = [lambda: kmer.canonical_keys(codes, bad, 5),
                 lambda: kmer.minimizer_walk(codes, bad, 5, 3),
                 lambda: kmer.count_kmers_stats(codes.numpy(), bad.numpy(), 5, device="cpu")]
    elif fault == "codes_dtype":
        err = TypeError
        calls = [lambda: kmer.canonical_keys(codes.int(), lens, 5),
                 lambda: kmer.minimizer_walk(codes.long(), lens, 5, 3)]
    elif fault == "lengths_dtype":
        err = TypeError
        calls = [lambda: kmer.canonical_keys(codes, lens.long(), 5),
                 lambda: kmer.minimizer_walk(codes, lens.long(), 5, 3)]
    elif fault == "codes_shape":
        calls = [lambda: kmer.canonical_keys(codes.reshape(-1), lens, 5),
                 lambda: kmer.canonical_keys(codes.t(), lens, 5),
                 lambda: kmer.minimizer_walk(codes[:, ::2], lens, 5, 3)]
    elif fault == "mode":
        calls = [lambda: kmer.canonical_keys(codes, lens, 5, 2),
                 lambda: kmer.canonical_keys(codes, lens, 5, -1)]
    elif fault == "keys_dtype":
        err = TypeError
        keys = torch.arange(10, dtype=torch.int64)
        calls = [lambda: kmer.kmer_runs(keys),
                 lambda: kmer.kmer_freqs(keys, torch.arange(10, dtype=torch.int64))]
    elif fault == "order_dtype":
        err = TypeError
        keys = torch.arange(10, dtype=torch.int32)
        calls = [lambda: kmer.kmer_freqs(keys, torch.arange(10, dtype=torch.int32)),
                 lambda: kmer.kmer_freqs(keys, torch.arange(9, dtype=torch.int64))]
    else:
        err = TypeError
        raw, mask = kmer.minimizer_walk(codes, lens, 5, 3)
        offs = torch.zeros(3, dtype=torch.int64)
        calls = [lambda: kmer.minimizer_sites(raw.int(), mask, lens, offs, 5),
                 lambda: kmer.minimizer_sites(raw, mask[:, 1:], lens, offs, 5),
                 lambda: kmer.minimizer_sites(raw, mask, lens, offs.int(), 5)]
    for call in calls:
        with pytest.raises(err):
            call()
    keys = kmer.canonical_keys(codes, lens, 5)
    assert keys.dtype == torch.int32 and keys.shape == (72,)


@pytest.mark.parametrize("entry", ["basecall_signals", "basecall_with_quals", "build_model",
                                   "cli"])
def test_nn_base_entry_points_raise_without_card(no_card, entry, tmp_path):
    from genomicsbench_tpu_torch.models import basecaller as bc

    cfg = bc.BasecallerConfig.tiny()
    state = bc.init_params(cfg)
    sigs = [np.random.default_rng(0).normal(size=700).astype(np.float32)]
    np.savez(tmp_path / "s.npz", r0=sigs[0])
    dev_kw = lambda dev: {"device": dev[0]} if dev else {}          # noqa: E731
    run = {
        "basecall_signals": lambda *dev: bc.basecall_signals(state, sigs, cfg, **dev_kw(dev)),
        "basecall_with_quals": lambda *dev: bc.basecall_with_quals(state, sigs, cfg,
                                                                   **dev_kw(dev)),
        "build_model": lambda *dev: bc.build_model(state, cfg, **dev_kw(dev)),
        "cli": lambda *dev: torch_cli_main(["nn-base", "--signals", str(tmp_path / "s.npz"),
                                            "--beamsize", "1"]
                                           + (["--device", dev[0]] if dev else [])),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


@pytest.mark.parametrize("fault", ["x_dtype", "w_dtype", "channels", "odd_channels", "rank",
                                   "contiguity", "k_too_large", "stride", "bn_shape",
                                   "bn_dtype", "res_pairing", "res_shape", "head_labels",
                                   "head_channels", "head_dtype", "device"])
def test_nn_base_wrappers_check_inputs(fault, monkeypatch):
    """depthwise_conv, bn_act and decoder_head refuse what the kernels do
    not take, on the host, before they would build or launch anything."""
    from genomicsbench_tpu_torch import _kernels
    from genomicsbench_tpu_torch.ops import basecaller as ops

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    bf = torch.bfloat16
    x = torch.randn(2, 40, 64).to(bf)
    w = torch.randn(9, 64).to(bf)
    p = ops.bn_params(torch.ones(64), torch.zeros(64), torch.zeros(64), torch.ones(64))
    hw = torch.randn(64, 5).to(bf)
    err = ValueError
    if fault == "x_dtype":
        err, calls = TypeError, [lambda: ops.depthwise_conv(x.float(), w),
                                 lambda: ops.bn_act(x.half(), p),
                                 lambda: ops.decoder_head(x.float(), hw)]
    elif fault == "w_dtype":
        err, calls = TypeError, [lambda: ops.depthwise_conv(x, w.float()),
                                 lambda: ops.decoder_head(x, hw.float())]
    elif fault == "channels":
        calls = [lambda: ops.depthwise_conv(x, w[:, :32].contiguous())]
    elif fault == "odd_channels":
        calls = [lambda: ops.depthwise_conv(x[..., :63].contiguous(), w[:, :63].contiguous()),
                 lambda: ops.bn_act(x[..., :63].contiguous(), p[:, :63].contiguous())]
    elif fault == "rank":
        calls = [lambda: ops.depthwise_conv(x[0], w), lambda: ops.decoder_head(x[0], hw)]
    elif fault == "contiguity":
        calls = [lambda: ops.depthwise_conv(x.transpose(0, 1), w),
                 lambda: ops.bn_act(x[:, ::2], p)]
    elif fault == "k_too_large":
        # the kernel stages taps past DW_TAP_CHUNK in chunks, so no k is too
        # large at a stride whose rows for one tap fit in 227 KB (7 and
        # below; the layout before chunks held k <= 780 at stride 1), and
        # none is small enough past it
        big = torch.zeros(800, 64, dtype=bf)
        for k in (780, 781, 100_000):
            assert ops.depthwise_tap_chunk(k, 1) == ops.DW_TAP_CHUNK
            assert ops.depthwise_shared_bytes(k, 7) <= ops.SHARED_MAX
        assert ops.depthwise_tap_chunk(1, 8) == 0
        assert ops.depthwise_shared_bytes(1, 8) > ops.SHARED_MAX
        assert ops.depthwise_conv(x, big).shape == (2, 41, 64)      # even k: T + 1
        calls = [lambda: ops.depthwise_conv(x, big, stride=8),
                 lambda: ops.depthwise_conv(x, torch.zeros(600, 64, dtype=bf), stride=9)]
    elif fault == "stride":
        calls = [lambda: ops.depthwise_conv(x, w, stride=0)]
    elif fault == "bn_shape":
        calls = [lambda: ops.bn_act(x, p[:2].contiguous()),
                 lambda: ops.bn_act(x, p[:, :32].contiguous())]
    elif fault == "bn_dtype":
        err, calls = TypeError, [lambda: ops.bn_act(x, p.double())]
    elif fault == "res_pairing":
        calls = [lambda: ops.bn_act(x, p, x), lambda: ops.bn_act(x, p, None, p)]
    elif fault == "res_shape":
        calls = [lambda: ops.bn_act(x, p, x[:, :20].contiguous(), p)]
    elif fault == "head_labels":
        calls = [lambda: ops.decoder_head(x, torch.zeros(64, 9, dtype=bf))]
    elif fault == "head_channels":
        calls = [lambda: ops.decoder_head(x, torch.zeros(48, 5, dtype=bf)),
                 lambda: ops.decoder_head(torch.zeros(1, 4, 2048, dtype=bf),
                                          torch.zeros(2048, 8, dtype=bf))]
    elif fault == "head_dtype":
        err, calls = TypeError, [lambda: ops.decoder_head(x, hw, torch.bfloat16)]
    else:
        calls = [lambda: ops.depthwise_conv(x, w.to("meta")), lambda: ops.bn_act(x, p.to("meta"))]
    for call in calls:
        with pytest.raises(err):
            call()
    assert ops.depthwise_conv(x, w).shape == (2, 40, 64)
    assert ops.depthwise_conv(x, w, stride=3).shape == (2, 14, 64)
    assert ops.depthwise_shared_bytes(123, 1) <= ops.SHARED_MAX
    assert ops.bn_act(x, p, x, p).shape == x.shape
    assert ops.decoder_head(x, hw).dtype == torch.float16


def test_grm_and_longread_import_loads_no_jax():
    code = ("import sys\n"
            "import genomicsbench_tpu_torch.ops.grm, genomicsbench_tpu_torch.io.plink\n"
            "import genomicsbench_tpu_torch.ops.longread, genomicsbench_tpu_torch.oracle.grm\n"
            "import genomicsbench_tpu_torch.oracle.longread, genomicsbench_tpu_torch.cli\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'genomicsbench_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("entry", ["grm", "banded_nw", "cli_pgen", "cli_bfile"])
def test_grm_longread_entry_points_raise_without_card(no_card, entry, tmp_path):
    from genomicsbench_tpu_torch.io.plink import write_bed, write_pgen
    from genomicsbench_tpu_torch.ops import grm, longread

    geno = np.random.default_rng(0).integers(0, 4, (30, 9)).astype(np.uint8)
    write_pgen(str(tmp_path / "p"), geno)
    write_bed(str(tmp_path / "b"), geno)
    q = np.random.default_rng(1).integers(0, 4, 50)
    dev_kw = lambda dev: {"device": dev[0]} if dev else {}          # noqa: E731
    cli = {"cli_pgen": ["--pgen", str(tmp_path / "p.pgen")],
           "cli_bfile": ["--bfile", str(tmp_path / "b")]}.get(entry, [])
    run = {
        "grm": lambda *dev: grm.grm(geno, **dev_kw(dev)),
        "banded_nw": lambda *dev: longread.banded_nw(q, q, 16, **dev_kw(dev)),
        "cli_pgen": lambda *dev: torch_cli_main(["grm", *cli, "--out", str(tmp_path / "o")]
                                                + (["--device", dev[0]] if dev else [])),
    }
    run["cli_bfile"] = run["cli_pgen"]
    run = run[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")


@pytest.mark.parametrize("fault", ["packed_dtype", "maf_dtype", "packed_rank", "maf_rank",
                                   "variants", "contiguity", "empty_rows", "device",
                                   "finish_dtype", "finish_shape", "finish_n"])
def test_grm_wrappers_check_inputs(fault, monkeypatch):
    """grm_standardize and grm_finish refuse what the kernels do not take,
    on the host, before they would build or launch anything."""
    from genomicsbench_tpu_torch import _kernels
    from genomicsbench_tpu_torch.ops import grm as ops

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    packed = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (6, 32)).astype(np.uint8))
    ok = torch.ones(6, dtype=torch.bool)
    num = torch.zeros(128, 128)
    err = ValueError
    if fault == "packed_dtype":
        err, calls = TypeError, [lambda: ops.grm_standardize(packed.int(), ok)]
    elif fault == "maf_dtype":
        err, calls = TypeError, [lambda: ops.grm_standardize(packed, ok.to(torch.uint8))]
    elif fault == "packed_rank":
        calls = [lambda: ops.grm_standardize(packed.reshape(-1), ok)]
    elif fault == "maf_rank":
        calls = [lambda: ops.grm_standardize(packed, ok[:, None])]
    elif fault == "variants":
        calls = [lambda: ops.grm_standardize(packed, ok[:5])]
    elif fault == "contiguity":
        calls = [lambda: ops.grm_standardize(packed[:, ::2], ok),
                 lambda: ops.grm_standardize(packed.t(), torch.ones(32, dtype=torch.bool)),
                 lambda: ops.grm_finish(num.t()[:, :64], num[:, :64], 10)]
    elif fault == "empty_rows":
        calls = [lambda: ops.grm_standardize(packed[:, :0], ok)]
    elif fault == "device":
        calls = [lambda: ops.grm_standardize(packed, ok.to("meta")),
                 lambda: ops.grm_finish(num, num.to("meta"), 10),
                 lambda: ops.grm_standardize(packed.to("meta"), ok.to("meta"))]
    elif fault == "finish_dtype":
        err, calls = TypeError, [lambda: ops.grm_finish(num.double(), num, 10),
                                 lambda: ops.grm_finish(num, num.half(), 10)]
    elif fault == "finish_shape":
        calls = [lambda: ops.grm_finish(num[:64].contiguous(), num[:64].contiguous(), 10),
                 lambda: ops.grm_finish(num, num[:64, :64].contiguous(), 10),
                 lambda: ops.grm_finish(num[0], num[0], 1)]
    else:
        calls = [lambda: ops.grm_finish(num, num, 129), lambda: ops.grm_finish(num, num, -1)]
    for call in calls:
        with pytest.raises(err):
            call()
    x, w = ops.grm_standardize(packed, ok)
    assert x.shape == w.shape == (6, 128)
    assert ops.grm_finish(num, num, 10).shape == (2, 55)


@pytest.mark.parametrize("fault", ["dtype", "rank", "contiguity", "devices", "band_low",
                                   "band_type", "end_cell"])
def test_longread_wrapper_checks_inputs(fault, monkeypatch):
    """longread_nw refuses what gb_longread_nw does not take, on the host,
    before it would build or launch anything; banded_nw checks the band and
    the end cell before it uploads."""
    from genomicsbench_tpu_torch import _kernels
    from genomicsbench_tpu_torch.ops import longread as ops

    def no_launch():
        raise AssertionError("reached the kernel")

    monkeypatch.setattr(_kernels, "load", no_launch)
    q = torch.from_numpy(np.random.default_rng(3).integers(0, 4, 60).astype(np.int32))
    err = ValueError
    if fault == "dtype":
        err, calls = TypeError, [lambda: ops.longread_nw(q.long(), q, 16),
                                 lambda: ops.longread_nw(q, q.to(torch.uint8), 16)]
    elif fault == "rank":
        calls = [lambda: ops.longread_nw(q.reshape(6, 10), q, 16),
                 lambda: ops.banded_nw(q.numpy().reshape(6, 10), q.numpy(), 16, device="cpu")]
    elif fault == "contiguity":
        calls = [lambda: ops.longread_nw(q[::2], q[:30].clone(), 16)]
    elif fault == "devices":
        calls = [lambda: ops.longread_nw(q, q.to("meta"), 16),
                 lambda: ops.longread_nw(q.to("meta"), q.to("meta"), 16)]
    elif fault == "band_low":
        calls = [lambda: ops.longread_nw(q, q, 0),
                 lambda: ops.banded_nw(q.numpy(), q.numpy(), -4, device="cpu")]
    elif fault == "band_type":
        calls = [lambda: ops.longread_nw(q, q, 16.0)]
    else:
        calls = [lambda: ops.longread_nw(q, q[:40].clone(), 16),
                 lambda: ops.longread_nw(q[:40].clone(), q, 16),
                 lambda: ops.banded_nw(q.numpy(), q.numpy()[:51], 16, device="cpu")]
    for call in calls:
        with pytest.raises(err):
            call()
    assert int(ops.longread_nw(q, q, 16)) == 60
    assert ops.banded_nw(q.numpy(), q.numpy()[:53], 16, device="cpu") == 53 - 2 * 7


def test_pileup_and_dbg_import_loads_no_jax():
    code = ("import sys\n"
            "import genomicsbench_tpu_torch.ops.pileup, genomicsbench_tpu_torch.ops.dbg\n"
            "import genomicsbench_tpu_torch.oracle.dbg, genomicsbench_tpu_torch.io.bam\n"
            "import genomicsbench_tpu_torch.native, genomicsbench_tpu_torch.cli\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_pileup_cases, torch_dbg_cases\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'genomicsbench_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("entry", ["count_keys", "sort_pairs", "graphs", "sorted", "from_bam"])
def test_pileup_dbg_device_stages_raise_without_card(no_card, entry, tmp_path):
    """The device stages raise without a card, whatever the size of their
    input (the sort-pairs host cutoff included), and run on the CPU when
    asked; the array routes never touch the card."""
    from genomicsbench_tpu_torch.io.bam import IndexedBam
    from genomicsbench_tpu_torch.ops import dbg, pileup
    from torch_dbg_cases import FastaStub, bam_reads, edge_windows
    from torch_pileup_cases import write_indexed

    windows = edge_windows()["test_dbg"]
    ref, recs = bam_reads(n_reads=200, region=6_000)
    path = write_indexed(str(tmp_path / "x.bam"), recs, len(ref))
    big = np.zeros(dbg.HOST_SORT_ABOVE + 1, np.int64)
    dev_kw = lambda dev: {"device": dev[0]} if dev else {}          # noqa: E731
    run = {
        "count_keys": lambda *dev: pileup._count_keys(np.arange(300) % 7, **dev_kw(dev)),
        "sort_pairs": lambda *dev: dbg._device_sort_pairs(big.astype(np.int32), big,
                                                          **dev_kw(dev)),
        "graphs": lambda *dev: dbg.build_window_graphs(windows, **dev_kw(dev)),
        "sorted": lambda *dev: dbg._build_window_graphs_sorted(windows, as_arrays=True,
                                                               **dev_kw(dev)),
        "from_bam": lambda *dev: dbg.dbg_from_bam(IndexedBam(path), FastaStub(ref), "chr1",
                                                  0, 3000, **dev_kw(dev)),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run("cuda:0")
    run("cpu")
    assert len(dbg.build_window_graphs(windows, as_arrays=True)) == 4
    assert len(dbg.dbg_from_bam(IndexedBam(path), FastaStub(ref), "chr1", 0, 3000,
                                as_arrays=True)) == 4


@pytest.mark.parametrize("fault", ["key_space", "lengths", "key_bits", "window_ids", "sorted_k"])
def test_pileup_dbg_stages_check_inputs(fault, monkeypatch):
    """_count_keys and _device_sort_pairs refuse what they cannot sort,
    before any upload."""
    from genomicsbench_tpu_torch.ops import dbg, pileup

    def no_sort(*a, **kw):
        raise AssertionError("reached the sort")

    monkeypatch.setattr(torch, "sort", no_sort)
    keys = np.arange(10)
    call = {
        "key_space": lambda: pileup._count_keys(np.array([1, np.iinfo(np.int32).max]), "cpu"),
        "lengths": lambda: dbg._device_sort_pairs(np.zeros(9, np.int32), keys, "cpu"),
        "key_bits": lambda: dbg._device_sort_pairs(np.zeros(2, np.int32),
                                                   np.array([0, 1 << 32]), "cpu"),
        "window_ids": lambda: dbg._device_sort_pairs(np.array([0, 1 << 31]), keys[:2], "cpu"),
        "sorted_k": lambda: dbg._build_window_graphs_sorted([], k=16, device="cpu"),
    }[fault]
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("name", ["test_torch_pileup.py", "test_torch_dbg.py"])
def test_pileup_dbg_tests_mask_the_jax_native_loader(name):
    """The pileup and dbg test files run every test under an autouse fixture
    that patches genomicsbench_tpu.native._load to return None."""
    source = (ROOT / "tests" / name).read_text()
    if name == "test_torch_pileup.py":
        assert ("@pytest.fixture(autouse=True)\ndef jax_native_masked(monkeypatch):\n"
                "    monkeypatch.setattr(jax_native, \"_load\", lambda: None)") in source
    else:
        assert "from test_torch_pileup import jax_c, jax_native_masked, on_library" in source
