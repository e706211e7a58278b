"""Rules of the PyTorch port (genomicsbench_tpu_torch), checked on the CPU.

* The port, chip_smoke.py and the test helper it imports import neither
  JAX nor the JAX package: a source scan of every file, and an import in a
  fresh interpreter.
* Every entry point runs on the card unless asked for the CPU, and raises
  when there is no card; it never falls back to the CPU on its own.
* The wrappers of the kernels check what they are given before any launch.
* The configuration and the anchor calls cross from the JAX package as
  plain dicts.
* The kernel's launch configuration is a host function of the padded query
  width alone.
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
from genomicsbench_tpu_torch.ops import bsw, chain

from torch_chain_cases import edge_cases

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the port, chip_smoke.py and the test helpers it imports on the card
PORT_FILES = sorted((ROOT / "genomicsbench_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_bsw_cases.py",
    ROOT / "tests" / "torch_chain_cases.py",
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
                                   "offs_end", "window", "order_keyword"])
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
    else:
        kw, err = dict(window=-1), ValueError
    with pytest.raises(err):
        chain.chain_dp(*args, **kw)
    scores, parents, peak, visited = chain.chain_dp(*_chain_args())
    assert scores.shape == parents.shape == peak.shape == (42,)
    assert visited.dtype == torch.int64 and visited.shape == (5,)


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
