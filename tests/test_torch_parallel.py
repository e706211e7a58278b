"""The port's data parallelism (genomicsbench_tpu_torch/parallel/, the mesh
arguments of chain_batch, align_batch and FmiPipeline, predict_sharded and
the data-parallel train step) against the JAX package, on the CPU.

Two gloo worlds, of 2 and 3 CPU processes, start once for the module
(`worlds`): each rank runs tests/torch_parallel_cases.py, joins its world
through `init_multihost` on a FileStore in tmp_path (world 2 with
torchrun's variables, world 3 with JAX's), runs every case on
`make_mesh(device="cpu")` and writes its outputs to npz.  Meanwhile this
process computes the JAX package's sharded results on a 2-device and an
8-device CPU mesh and the port's one-card CPU results; the tests then
compare case by case, every rank's output.  Every batch divides by
neither world size.  Each rank runs torch on one thread and has its own
timeout.

Bounds:
* bsw, chain, abea, fmi, the sharded k-mer counts and the pileup
  histogram: bit for bit against the JAX wrappers and the port's one-card
  path (fmi's SMEMs in the one-card order, pass by pass).
* pairhmm: bit for bit against the one-card path; within 1e-5 in log10 of
  JAX (tests/test_torch_phmm.py's float32 bound).
* predict_sharded: within rtol 2e-5, atol 2e-6 of JAX
  (tests/test_variant_caller.py:43) and of the one-card forward (a rank's
  block is another matrix shape, which the CPU's BLAS may block and sum
  otherwise: one head value in 504 differs by an ulp at world 2).
* The train step, 3 steps at world 2 (lr 1e-4) from the same weights,
  against JAX's `make_train_step` on a data=2 mesh and against the port's
  one-card step on the global batch (tests/test_torch_train.py's bounds):
  the first step's averaged gradients within 3% relative L2 and a cosine
  above 0.999 of the global batch's gradient (the model-level bound);
  every step's loss within 1e-3 relative and after 3 steps every parameter
  within 2 * 3 * lr (the train-steps bounds).  Against the one-card step
  the first loss also within 1e-4 (the same code; only the statistics'
  and the gradients' sums run in other orders).  Against JAX the first
  loss is not held to 1e-4: on these 8-row batches the one-card port is
  itself about 1e-4 from JAX at the same weights (bf16 activations
  rounded by XLA and by torch), and at lr 1e-3 its third loss drifts up to
  5e-3 from JAX's, hence lr 1e-4.  The "scaled" batch gives rank 1's rows
  4 times the signal of rank 0's: statistics taken per rank would
  normalise each half apart and miss these bounds by far.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import genomicsbench_tpu.models.basecaller as JB
import genomicsbench_tpu.models.variant_caller as JV
import genomicsbench_tpu.native as jax_native
from genomicsbench_tpu.io.anchors import AnchorCall as JaxAnchorCall
from genomicsbench_tpu.models.train import make_train_step as jax_make_train_step
from genomicsbench_tpu.models.train import param_spec as jax_param_spec
from genomicsbench_tpu.models.train import place_params as jax_place_params
from genomicsbench_tpu.ops.fmi import build_fmd_index as jax_build_fmd_index
from genomicsbench_tpu.parallel import data_parallel as JDP
from genomicsbench_tpu.parallel.mesh import make_mesh as jax_make_mesh
from genomicsbench_tpu.parallel.mesh import shard_batch as jax_shard_batch
from genomicsbench_tpu.parallel.sharded_count import sharded_count_kmers as jax_count

import genomicsbench_tpu_torch.models.basecaller as TB
import genomicsbench_tpu_torch.models.variant_caller as TV
from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts
from genomicsbench_tpu_torch.models import train as TR
from genomicsbench_tpu_torch.ops import abea, bsw, chain, fmi, kmer, pairhmm, pileup
from genomicsbench_tpu_torch.parallel import mesh as TM
from genomicsbench_tpu_torch.parallel import multihost as TH

import torch_parallel_cases as C
from torch_train_cases import agreement

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240          # seconds; a world runs all its cases in about 15 s
JAX_MESHES = (2, 8)
CASES = [c for c in C.RUNNERS if c != "train"]
PHMM_TOL = 1e-5
VARIANT_TOL = dict(rtol=2e-5, atol=2e-6)
LOSS_REL, GRAD_REL, GRAD_COS = 1e-4, 0.03, 0.999
STEP_LOSS_REL = 1e-3


# ------------------------------------------------------------------ worlds
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started: {world: (out_dir, [Popen per rank])}."""
    started = {}
    env0 = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT")}
    env0["OMP_NUM_THREADS"] = "1"
    for world in C.WORLDS:
        out = tmp_path_factory.mktemp(f"world{world}")
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_parallel_cases.py"),
             str(out / "store"), str(out)], cwd=ROOT, env={**env0, **C.rank_env(world, r)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
        started[world] = (out, procs)
    yield started
    for _, procs in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _wait(out, procs):
    """{case: [rank's outputs]} of one world, after every rank exits 0."""
    logs = []
    for rank, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            raise AssertionError(f"rank {rank} timed out:\n{err[-3000:]}")
        logs.append((rank, p.returncode, err))
    for rank, rc, err in logs:
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
    world = len(procs)
    return {case: [dict(np.load(out / f"{case}-{r}.npz")) for r in range(world)]
            for case in C.world_cases(world)}


# ----------------------------------------------------------- JAX and one card
def _jax_cases(n_dev):
    """The JAX wrappers' outputs on an n_dev CPU mesh, as the rank program
    stores the port's."""
    mesh = jax_make_mesh(jax.devices()[:n_dev])
    out = {}
    res = JDP.banded_sw_sharded(mesh, *C.bsw_inputs())
    out["bsw"] = {f: getattr(res, f) for f in ("score", "qle", "tle", "gtle", "gscore",
                                                 "max_off")}
    out["pairhmm"] = {"lk": JDP.pairhmm_sharded(mesh, *C.phmm_inputs())}
    res = JDP.chain_sharded(mesh, [JaxAnchorCall(**c) for c in C.chain_inputs()])
    out["chain"] = dict(scores=res.scores, parents=res.parents, peak=res.peak_scores, n=res.n)
    seqs, evs, sc, mm, ms = C.abea_inputs()
    out["abea"] = C.abea_arrays(JDP.abea_sharded(mesh, seqs, evs, mm, ms, sc))
    ref, q, qlen = C.fmi_inputs()
    p1, p2, p3, total = JDP.fmi_sharded(mesh, jax_build_fmd_index(ref), q, qlen)
    out["fmi"] = {**C.smem_arrays("p1", p1), **C.smem_arrays("p2", p2),
                  **C.smem_arrays("p3", p3), "total": np.array(total)}
    seq, lens = C.kmer_inputs()
    pad = (-len(seq)) % n_dev           # JAX asserts that the batch divides
    seq = np.concatenate([seq, np.zeros((pad, seq.shape[1]), np.uint8)])
    lens = np.concatenate([lens, np.zeros(pad, np.int32)])
    out["kmer"] = {}
    # each call compiles anew (about 4 s on 2 devices, 11 s on 8), so the
    # 8-device mesh runs the multi-process form alone; JAX returns the same
    # counts either way
    for rep in ((False, True) if n_dev == 2 else (True,)):
        u, c = jax_count(mesh, seq, lens, C.K, replicate_out=rep)
        for key in ((int(rep),) if n_dev == 2 else (0, 1)):
            out["kmer"][f"acgt_{key}_u"], out["kmer"][f"acgt_{key}_c"] = u, c
    out["pileup"] = {"hist": JDP.pileup_hist_sharded(mesh, C.pileup_keys(), C.PILEUP_SIZE)}
    cfg, tree, x = C.variant_inputs()
    jcfg = JV.ClairConfig(lstm_units=cfg.lstm_units, l3_units=cfg.l3_units,
                          l4_units=cfg.l4_units, l5_units=cfg.l5_units)
    heads = JV.predict_sharded(tree, x, jcfg, mesh)
    out["predict"] = {n: np.asarray(heads[n]) for n in TV.HEAD_NAMES}
    return out


def _one_card_cases():
    """The port's one-card CPU path on the whole batches."""
    out = {}
    res = bsw.banded_sw_batch(*C.bsw_inputs(), device="cpu")
    out["bsw"] = {f: getattr(res, f) for f in ("score", "qle", "tle", "gtle", "gscore",
                                                 "max_off")}
    reads, haps, pairs = C.phmm_inputs()
    out["pairhmm"] = {"lk": pairhmm.pairhmm_batch(reads, haps, pairs, device="cpu")}
    res = chain.chain_batch(anchor_calls_from_dicts(C.chain_inputs()), device="cpu")
    out["chain"] = dict(scores=res.scores, parents=res.parents, peak=res.peak_scores, n=res.n)
    seqs, evs, sc, mm, ms = C.abea_inputs()
    out["abea"] = C.abea_arrays(abea.align_batch(seqs, evs, mm, ms, sc, device="cpu"))
    ref, q, qlen = C.fmi_inputs()
    p1, p2, p3, total = fmi.FmiPipeline(fmi.build_fmd_index(ref), device="cpu").run(q, qlen)
    out["fmi"] = {**C.smem_arrays("p1", p1), **C.smem_arrays("p2", p2),
                  **C.smem_arrays("p3", p3), "total": np.array(total)}
    out["kmer"] = {}
    for name, with_n in (("acgt", False), ("n", True)):
        u, c = kmer.count_kmers(*C.kmer_inputs(with_n=with_n), C.K, device="cpu")
        for rep in (0, 1):
            out["kmer"][f"{name}_{rep}_u"], out["kmer"][f"{name}_{rep}_c"] = u, c
    keys = C.pileup_keys()
    u, c = pileup._count_keys(keys, device="cpu")
    hist = np.zeros(C.PILEUP_SIZE, np.int64)
    hist[u] = c
    out["pileup"] = {"hist": hist}
    cfg, tree, x = C.variant_inputs()
    model = TV.build_model(TV.params_from_jax(tree, cfg), cfg, "cpu")
    packed = TV.forward_slabs(model, torch.from_numpy(x))
    out["predict"] = dict(zip(TV.HEAD_NAMES, (h.numpy() for h in torch.split(
        packed, list(cfg.head_sizes), dim=-1))))
    return out


def _jax_train(kind):
    """JAX: 3 steps of make_train_step on a data=2 mesh from train_tree(0),
    with the gradient of the global batch before each step."""
    mesh = jax_make_mesh(jax.devices()[:2])
    jcfg = JB.BasecallerConfig.tiny()
    _, jstep = jax_make_train_step(jcfg, mesh, learning_rate=C.TRAIN_LR)
    params = jax.tree_util.tree_map(jnp.asarray, C.train_tree(0))
    opt = optax.adamw(C.TRAIN_LR).init(params)
    vg = jax.jit(jax.value_and_grad(JB.ctc_loss), static_argnames=("cfg",))
    batch = tuple(jnp.asarray(a) for a in C.train_batch(kind))
    losses, grads = [], []
    with mesh:
        params, opt = jax_place_params(params, opt, mesh)
        sharded = jax_shard_batch(mesh, batch)
        for _ in range(C.TRAIN_STEPS):
            _, g = vg(params, *batch, cfg=jcfg)
            grads.append(C.flat_tree(jax.tree_util.tree_map(np.asarray, g)))
            params, opt, loss = jstep(params, opt, *sharded)
            losses.append(float(loss))
    return dict(losses=np.array(losses), grads=grads,
                params=C.flat_tree(jax.tree_util.tree_map(np.asarray, params)))


@pytest.fixture(scope="module")
def runs(worlds):
    """(port outputs {world: {case: [per rank]}}, JAX {n_dev: {case: ...}},
    one card {case: ...}, JAX train {kind: ...}, one-card train {kind:
    ...}); the JAX package's native library masked, so it takes its Python
    routes and never builds libgbingest.so here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_load", lambda: None)
        jax_out = {n: _jax_cases(n) for n in JAX_MESHES}
        jax_train = {kind: _jax_train(kind) for kind in ("even", "scaled")}
    one = _one_card_cases()
    one_train = {}
    for kind in ("even", "scaled"):
        got, *_ = C.train_run(TR.make_train_step(TB.BasecallerConfig.tiny(), device="cpu",
                                                 learning_rate=C.TRAIN_LR),
                              C.train_batch(kind), C.train_init(0))
        one_train[kind] = got
    port = {world: _wait(*worlds[world]) for world in C.WORLDS}
    return port, jax_out, one, jax_train, one_train


# --------------------------------------------------------------- the cases
def _equal(got, want, keys, what):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("world", C.WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_every_rank_equals_the_one_card_path(runs, case, world):
    port, _, one, _, _ = runs
    want = one[case]
    for rank, got in enumerate(port[world][case]):
        what = f"{case}, world {world}, rank {rank}"
        if case == "predict":
            for n in TV.HEAD_NAMES:
                np.testing.assert_allclose(got[n], want[n], err_msg=f"{what}: {n}",
                                           **VARIANT_TOL)
        else:
            _equal(got, want, want.keys(), what)


@pytest.mark.parametrize("n_dev", JAX_MESHES)
@pytest.mark.parametrize("world", C.WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_every_rank_equals_jax(runs, case, world, n_dev):
    port, jax_out, _, _, _ = runs
    want = jax_out[n_dev][case]
    for rank, got in enumerate(port[world][case]):
        what = f"{case}, world {world}, rank {rank}, JAX on {n_dev} devices"
        if case == "pairhmm":
            np.testing.assert_allclose(got["lk"], want["lk"], rtol=0, atol=PHMM_TOL,
                                       err_msg=what)
        elif case == "predict":
            for n in TV.HEAD_NAMES:
                np.testing.assert_allclose(got[n], want[n], err_msg=f"{what}: {n}",
                                           **VARIANT_TOL)
        elif case == "chain":
            np.testing.assert_array_equal(got["n"], want["n"], err_msg=what)
            for r, n in enumerate(want["n"]):
                for k in ("scores", "parents", "peak"):
                    np.testing.assert_array_equal(got[k][r, :n], want[k][r, :n],
                                                  err_msg=f"{what}: {k} of read {r}")
        else:
            _equal(got, want, want.keys(), what)


def test_cases_reach_what_they_test(runs):
    """The inputs take the paths the comparisons are for: float64 pairs,
    reads that fail QC and reads that pass, SMEMs of all three passes,
    k-mers that carry code 4, and errors where the batch does not divide or
    a bucket overflows."""
    port, _, one, _, _ = runs
    assert (one["pairhmm"]["lk"] < -60).sum() == 2             # the float64 pairs
    assert 0 < one["abea"]["failed"].sum() < len(one["abea"]["failed"])
    for p in (1, 2, 3):
        assert len(one["fmi"][f"p{p}_rid"]) > 0, p
    assert not np.array_equal(one["kmer"]["n_0_u"], one["kmer"]["acgt_0_u"])
    for world in C.WORLDS:
        for got in port[world]["kmer"]:
            assert "raise capacity_factor" in str(got["capacity_error"])
        for got in port[world]["predict"]:
            assert "does not divide" in str(got["uneven_error"])


def test_jax_three_device_count_drops_keys_the_port_keeps(runs):
    """JAX's sharded_count_kmers gives each key the rank `key >> shift`, with
    shift from the bit length of n_dev - 1: on 3 devices the keys whose top
    two bits are 11 go to a fourth bucket that no device receives, and are
    lost.  The port sends them to the last rank (ROADMAP section 3): its
    world-3 counts equal count_kmers, JAX's 3-device ones miss those keys."""
    port, _, one, _, _ = runs
    seq, lens = C.kmer_inputs()
    seq = np.concatenate([seq, np.zeros((2, seq.shape[1]), np.uint8)])   # 15 rows
    lens = np.concatenate([lens, np.zeros(2, np.int32)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_load", lambda: None)
        u, c = jax_count(jax_make_mesh(jax.devices()[:3]), seq, lens, C.K)
    want = one["kmer"]["acgt_0_u"]
    top = want >> np.uint32(2 * C.K - 2)
    assert (top == 3).sum() > 0
    np.testing.assert_array_equal(u, want[top != 3])
    for got in port[3]["kmer"]:
        np.testing.assert_array_equal(got["acgt_0_u"], want)


# ------------------------------------------------------------- train step
def _train_pair(runs, kind, against):
    port, _, _, jax_train, one_train = runs
    ranks = port[C.TRAIN_WORLD]["train"]
    got = {k[len(kind) + 1:]: v for k, v in ranks[0].items() if k.startswith(kind + "/")}
    for other in ranks[1:]:
        for k in got:
            np.testing.assert_array_equal(other[f"{kind}/{k}"], got[k], err_msg=k)
    if against == "jax":
        want = jax_train[kind]
        return got, want["losses"], want["grads"][0], want["params"]
    want = one_train[kind]
    return (got, want["losses"], {k[5:]: v for k, v in want.items() if k.startswith("grad:")},
            {k[6:]: v for k, v in want.items() if k.startswith("param:")})


@pytest.mark.parametrize("against", ["jax", "one_card"])
@pytest.mark.parametrize("kind", ["even", "scaled"])
def test_train_steps_match(runs, kind, against):
    """3 data-parallel steps at world 2 (every rank the same) against JAX's
    data=2 mesh step or the port's one-card step: losses, the first step's
    gradients, the parameters after the last step."""
    got, losses, grads, params = _train_pair(runs, kind, against)
    assert bool(got["start_equal"])            # init broadcast data rank 0's weights
    np.testing.assert_allclose(got["losses"], losses, rtol=STEP_LOSS_REL, atol=0)
    if against == "one_card":       # the same code: only the sums' orders differ
        np.testing.assert_allclose(got["losses"][0], losses[0], rtol=LOSS_REL, atol=0)
    n = 0
    for name, g in grads.items():
        if name.endswith((".mean", ".var")):
            continue
        rel, cos = agreement(torch.from_numpy(got[f"grad:{name}"]), torch.from_numpy(g))
        assert rel < GRAD_REL and cos > GRAD_COS, (name, rel, cos)
        n += 1
    assert n == len([k for k in got if k.startswith("grad:")])
    for name, v in params.items():
        d = np.abs(got[f"param:{name}"].astype(np.float64) - v).max()
        assert d <= 2 * C.TRAIN_STEPS * C.TRAIN_LR, (name, d)


def test_train_checkpoint_and_uneven_batch(runs):
    """Data rank 0 writes the checkpoint, every rank reads it back equal to
    its own state after the barrier; a batch that does not divide by the
    data axis raises ValueError."""
    port = runs[0]
    for got in port[C.TRAIN_WORLD]["train"]:
        assert bool(got["ckpt_equal"])
        assert "does not divide" in str(got["uneven_error"])


def test_scaled_rows_move_the_statistics(runs):
    """The "scaled" batch's rank rows differ enough that per-rank statistics
    would show: the one-card step on rank 1's rows alone, normalised by
    their own statistics, gives another loss than on the whole batch."""
    _, _, _, _, one_train = runs
    sig, labels, lens = C.train_batch("scaled")
    half = C.TRAIN_B // 2
    model = TB.Basecaller(TB.BasecallerConfig.tiny())
    model.load_state_dict(C.train_init(0))
    per_rank = np.mean([float(TB.ctc_loss(model, sig[s], labels[s], lens[s]))
                        for s in (slice(0, half), slice(half, None))])
    whole = one_train["scaled"]["losses"][0]
    assert abs(per_rank - whole) > 100 * LOSS_REL * abs(whole), (per_rank, whole)


# ------------------------------------------------------------------ guards
def test_meshes_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TM.make_mesh(), lambda: TH.global_mesh(),
                 lambda: TM.mesh_device("cuda"),
                 lambda: TH.init_multihost(init_method="file:///nonexistent", device="cuda",
                                           num_processes=1, process_id=0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cpu_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="initialised torch.distributed world"):
        TM.make_mesh(device="cpu")


def test_init_multihost_reads_jax_then_torchrun(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert TH.init_multihost(device="cpu") is False          # nothing set: a no-op
    assert TH.world_from_env() == (None, None, None)
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert TH.world_from_env() == ("node0:29500", 4, 3)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "node1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    assert TH.world_from_env() == ("node1:1234", 2, 1)
    assert TH.world_from_env("node2:1", 8, 5) == ("node2:1", 8, 5)


def test_host_shard_and_bounds_single_process():
    items = list(range(10))
    assert TH.host_shard(items) == items
    assert TH.host_batch_bounds(11) == (0, 11)
    shards = [TH.host_shard(items, process_id=i, num_processes=3) for i in range(3)]
    assert sorted(sum(shards, [])) == items
    spans = [TH.host_batch_bounds(11, process_id=i, num_processes=4) for i in range(4)]
    assert [i for lo, hi in spans for i in range(lo, hi)] == list(range(11))


def _fake_mesh(data, model, rank=0):
    return TM.Mesh(data=data, model=model, data_rank=rank // model, model_rank=rank % model,
                   data_group=None, model_group=None, device=torch.device("cpu"))


def test_shard_batch_blocks_and_refuses_uneven_rows():
    x = np.arange(12).reshape(6, 2)
    got = [TM.shard_batch(_fake_mesh(3, 1, r), {"x": x, "y": (x[:, 0],)}) for r in range(3)]
    assert torch.equal(torch.cat([g["x"] for g in got]), torch.from_numpy(x))
    assert torch.equal(got[1]["y"][0], torch.tensor([4, 6]))
    with pytest.raises(ValueError, match="does not divide"):
        TM.shard_batch(_fake_mesh(4, 1), x)
    assert TM.row_bounds(_fake_mesh(2, 2, 3), 6) == (3, 6)   # rank 3 is data 1, model 1


def test_param_spec_is_jax_rule_on_the_port_layout():
    """JAX's param_spec on JAX's tree and the port's on the same weights:
    the same leaves split over "model" at model sizes 1, 2, 3 and 5."""
    tree = C.train_tree(0)
    state = C.train_init(0)
    for size in (1, 2, 3, 5):
        split = jax.tree_util.tree_map(
            lambda x, s: np.full(np.shape(x), tuple(s) == (None, None, "model")),
            tree, jax_param_spec(tree, size))
        want = {name: bool(v.all()) for name, v in C.flat_tree(split).items()}
        got = TR.param_spec(state, size)
        assert {n: bool(s) for n, s in got.items()} == want, size
        for name, spec in got.items():
            assert spec == () or (len(spec) == state[name].dim() and spec[-1] == "model")


def test_place_params_refuses_the_model_axis():
    init, _ = TR.make_train_step(TB.BasecallerConfig.tiny(), device="cpu")
    model, opt = init(C.train_init(0))
    with pytest.raises(NotImplementedError, match="model and sequence sharding"):
        TR.place_params(model, opt, _fake_mesh(1, 2))


def test_pileup_hist_refuses_keys_out_of_range():
    from genomicsbench_tpu_torch.parallel.data_parallel import pileup_hist_sharded

    for keys in ([0, 5], [-1, 2]):
        with pytest.raises(ValueError, match="pileup keys"):
            pileup_hist_sharded(_fake_mesh(1, 1), keys, 5)
