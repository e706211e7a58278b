"""Inputs of the data-parallel tests, and the rank program that runs every
case in a gloo world of CPU processes.

Plain numpy and torch: both packages take these inputs, and no JAX is
imported here (the rank processes run the port alone).  Every batch is of
a size that divides by neither world size the tests start (2 and 3), so
every wrapper pads.

Run one rank of a world (tests/test_torch_parallel.py starts them), with
`rank_env(world, rank)` in its environment:

    python tests/torch_parallel_cases.py STORE_FILE OUT_DIR

Each rank joins the world by `init_multihost(device="cpu",
init_method="file://STORE_FILE")` (gloo on a FileStore), builds
`make_mesh(device="cpu")`, runs every case of `world_cases(world)` and
writes each case's outputs to OUT_DIR/<case>-<rank>.npz.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORLDS = (2, 3)
TRAIN_WORLD = 2                # the train step runs at world size 2 only
TRAIN_B, TRAIN_LABELS, TRAIN_STEPS, TRAIN_LR = 8, 16, 3, 1e-4
TRAIN_SCALE = 4.0              # the second half's signal scale in the "scaled" batch
K = 15
PILEUP_SIZE = 5000


# ----------------------------------------------------------------- inputs
def bsw_inputs(B=41, Q=128, T=160, seed=0):
    """tests/test_data_parallel.py's pairs: (query, target, qlen, tlen, h0)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Q)).astype(np.uint8)
    t = np.zeros((B, T), np.uint8)
    t[:, :Q] = q
    mut = rng.integers(0, Q, (B, 6))
    t[np.arange(B)[:, None], mut] = rng.integers(0, 4, (B, 6))
    qlen = rng.integers(60, Q + 1, B).astype(np.int32)
    tlen = rng.integers(Q, T + 1, B).astype(np.int32)
    h0 = rng.integers(5, 40, B).astype(np.int32)
    return q, t, qlen, tlen, h0


def phmm_inputs(seed=1):
    """(reads, haps, pairs): 5 random reads, two all-mismatch reads whose
    float32 pass underflows (the float64 pairs) and 3 haplotypes and a hap
    of 1s; 13 pairs."""
    from torch_phmm_cases import _underflow_read

    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(5):
        n = int(rng.integers(10, 30))
        reads.append(dict(bases=rng.integers(0, 4, n).astype(np.uint8),
                          q=rng.integers(10, 40, n), i=rng.integers(30, 45, n),
                          d=rng.integers(30, 45, n), c=rng.integers(5, 15, n)))
    reads += [_underflow_read(120), _underflow_read(64)]
    haps = [rng.integers(0, 4, int(rng.integers(20, 50))).astype(np.uint8) for _ in range(3)]
    haps.append(np.ones(150, np.uint8))
    pairs = [(r, h) for r in range(5) for h in range(2)] + [(5, 3), (6, 3), (4, 2)]
    return reads, haps, pairs


def chain_inputs(n=7, seed=2):
    """tests/test_data_parallel.py's anchor calls, as plain dicts."""
    from torch_chain_cases import call

    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(n):
        m = int(rng.integers(20, 60))
        xs = np.sort(rng.integers(0, 4000, m)).astype(np.uint64)
        ys = np.sort(rng.integers(0, 4000, m)).astype(np.uint64) | (np.uint64(15) << np.uint64(32))
        calls.append(call(xs, ys, 15.0))
    return calls


def abea_inputs(n=5, seed=4):
    """(sequences, event means, scalings, model mean, model stdv):
    bench_abea's generator at 250-299 bases."""
    from torch_abea_cases import _model, bench_abea_reads

    seqs, evs, sc = bench_abea_reads(n_reads=n, seed=seed, lo=250, hi=300)
    mm, ms = _model()
    return seqs, evs, sc, mm, ms


def fmi_inputs(n=13, seed=41):
    """(reference codes, query (n, 101), qlen): reads cut with 3
    substitutions from a 3,000-base reference that holds a random 1,000
    bases three times, each copy with 2% substitutions (so long unique
    SMEMs have shorter repeated ones inside, which pass 2 reseeds), and one
    read of length 0."""
    from torch_fmi_cases import _mutated_slices, pad_batch

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, 1000).astype(np.uint8)
    copies = []
    for _ in range(3):
        c = base.copy()
        at = rng.integers(0, len(c), 20)
        c[at] = rng.integers(0, 4, len(at))
        copies.append(c)
    ref = np.concatenate(copies)
    reads = [r for ln in rng.integers(30, 102, n - 1) for r in _mutated_slices(rng, ref, 1, ln)]
    q, qlen = pad_batch(reads + [np.zeros(0, np.uint8)], 101)
    return ref, q, qlen


def kmer_inputs(n=13, L=96, seed=71, with_n=False):
    """(codes (n, L), lengths): codes 0..3 (with_n: code 4 at 5% of the
    positions, and k-mers that carry), lengths 0..L."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, (n, L)).astype(np.uint8)
    if with_n:
        seq[rng.random((n, L)) < 0.05] = 4
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    lens[:2] = L
    return seq, lens


def pileup_keys(n=1001, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, PILEUP_SIZE, n).astype(np.int64)


def variant_inputs(B=24, seed=3):
    """(tiny ClairConfig, weights in JAX's layout (numpy), x (B, ...) f32)."""
    from genomicsbench_tpu_torch.models import variant_caller as vc
    from torch_variant_cases import jax_tree, normal_inputs

    cfg = vc.ClairConfig.tiny()
    return cfg, jax_tree(cfg, seed), normal_inputs(np.random.default_rng(seed), B, cfg)


def train_batch(kind: str):
    """(signal, labels, label_lens) of the train cases: `ctc_batch(8, 16)`;
    "scaled" multiplies the second half of the rows (rank 1's at world 2)
    by TRAIN_SCALE, so that statistics taken per rank differ from the
    batch's."""
    from torch_train_cases import ctc_batch

    sig, labels, lens = ctc_batch(TRAIN_B, TRAIN_LABELS, 7)
    if kind == "scaled":
        sig[TRAIN_B // 2:] *= np.float32(TRAIN_SCALE)
    return sig, labels, lens


def train_tree(seed: int = 0):
    """The tiny basecaller's start weights in JAX's layout, numpy leaves."""
    from genomicsbench_tpu_torch.models import basecaller as bc
    from torch_basecaller_cases import jax_tree

    return jax_tree(bc.BasecallerConfig.tiny(), seed)


def train_init(seed: int = 0):
    """`train_tree(seed)` as the port's state dict."""
    from genomicsbench_tpu_torch.models import basecaller as bc

    return bc.params_from_jax(train_tree(seed), bc.BasecallerConfig.tiny())


def flat_tree(tree) -> dict:
    """A basecaller pytree in JAX's layout (numpy-convertible leaves) under
    the port's state-dict names and layouts."""
    out = {}
    for i, block in enumerate(tree["blocks"]):
        for r, conv in enumerate(block["convs"]):
            if "depth" in conv:
                out[f"blocks.{i}.depth.{r}"] = np.asarray(conv["depth"])[:, 0, :]
                out[f"blocks.{i}.point.{r}"] = np.asarray(conv["point"])[0]
            else:
                out[f"blocks.{i}.full.{r}"] = np.asarray(conv["full"])
            for n, v in block["bns"][r].items():
                out[f"blocks.{i}.bns.{r}.{n}"] = np.asarray(v)
        if "res_conv" in block:
            out[f"blocks.{i}.res_conv"] = np.asarray(block["res_conv"])[0]
            for n, v in block["res_bn"].items():
                out[f"blocks.{i}.res_bn.{n}"] = np.asarray(v)
    out["decoder"] = np.asarray(tree["decoder"])[0]
    return out


# ------------------------------------------------------------------ cases
def smem_arrays(prefix, r):
    return {f"{prefix}_{f}": getattr(r, f) for f in ("rid", "m", "n", "k", "s")}


def run_bsw(mesh):
    from genomicsbench_tpu_torch.parallel.data_parallel import banded_sw_sharded

    res = banded_sw_sharded(mesh, *bsw_inputs())
    return {f: getattr(res, f) for f in ("score", "qle", "tle", "gtle", "gscore", "max_off")}


def run_pairhmm(mesh):
    from genomicsbench_tpu_torch.parallel.data_parallel import pairhmm_sharded

    return {"lk": pairhmm_sharded(mesh, *phmm_inputs())}


def run_chain(mesh):
    from genomicsbench_tpu_torch.io.anchors import anchor_calls_from_dicts
    from genomicsbench_tpu_torch.parallel.data_parallel import chain_sharded

    res = chain_sharded(mesh, anchor_calls_from_dicts(chain_inputs()))
    return dict(scores=res.scores, parents=res.parents, peak=res.peak_scores, n=res.n)


def abea_arrays(res):
    counts = np.array([len(p) for p in res.pairs], np.int64)
    flat = np.concatenate(res.pairs) if res.pairs else np.zeros((0, 2), np.int32)
    return dict(counts=counts, pairs=flat.astype(np.int32), failed=np.array(res.failed))


def run_abea(mesh):
    from genomicsbench_tpu_torch.parallel.data_parallel import abea_sharded

    seqs, evs, sc, mm, ms = abea_inputs()
    return abea_arrays(abea_sharded(mesh, seqs, evs, mm, ms, sc))


def run_fmi(mesh):
    from genomicsbench_tpu_torch.ops.fmi import build_fmd_index
    from genomicsbench_tpu_torch.parallel.data_parallel import fmi_sharded

    ref, q, qlen = fmi_inputs()
    p1, p2, p3, total = fmi_sharded(mesh, build_fmd_index(ref), q, qlen)
    return {**smem_arrays("p1", p1), **smem_arrays("p2", p2), **smem_arrays("p3", p3),
            "total": np.array(total)}


def run_kmer(mesh):
    from genomicsbench_tpu_torch.parallel.sharded_count import sharded_count_kmers

    out = {}
    for name, with_n in (("acgt", False), ("n", True)):
        seq, lens = kmer_inputs(with_n=with_n)
        for rep in (False, True):
            u, c = sharded_count_kmers(mesh, seq, lens, K, replicate_out=rep)
            out[f"{name}_{int(rep)}_u"], out[f"{name}_{int(rep)}_c"] = u, c
    seq, lens = kmer_inputs()
    try:
        sharded_count_kmers(mesh, seq, lens, K, capacity_factor=0.0)
        out["capacity_error"] = np.array("")
    except ValueError as e:
        out["capacity_error"] = np.array(str(e))
    return out


def run_pileup(mesh):
    from genomicsbench_tpu_torch.parallel.data_parallel import pileup_hist_sharded

    return {"hist": pileup_hist_sharded(mesh, pileup_keys(), PILEUP_SIZE)}


def run_predict(mesh):
    from genomicsbench_tpu_torch.models import variant_caller as vc

    cfg, tree, x = variant_inputs()
    state = vc.params_from_jax(tree, cfg)
    heads = vc.predict_sharded(state, x, cfg, mesh)
    out = {name: heads[name].cpu().numpy() for name in vc.HEAD_NAMES}
    try:
        vc.predict_sharded(state, x[:mesh.data + 1], cfg, mesh)
        out["uneven_error"] = np.array("")
    except ValueError as e:
        out["uneven_error"] = np.array(str(e))
    return out


def train_run(make_step, batch, init_state, steps=TRAIN_STEPS):
    """`steps` steps of (init, step) from init_state on batch: losses,
    the first step's gradients (the averaged ones on a mesh) and the
    trained tensors after the last step, by state-dict name."""
    init, step = make_step
    model, opt = init(init_state)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    losses, grads = [], {}
    for i in range(steps):
        model, opt, loss = step(model, opt, *batch)
        losses.append(float(loss))
        if i == 0:
            grads = {n: t.grad.detach().clone()
                     for n, t in model.state_dict(keep_vars=True).items()
                     if t.grad is not None and not n.endswith((".mean", ".var"))}
    out = {"losses": np.array(losses)}
    out.update({f"grad:{n}": g.cpu().numpy() for n, g in grads.items()})
    out.update({f"param:{n}": v.detach().cpu().numpy() for n, v in model.state_dict().items()})
    return out, model, opt, start


def run_train(mesh):
    from genomicsbench_tpu_torch.models import basecaller as bc
    from genomicsbench_tpu_torch.models import train as tr

    out = {}
    cfg = bc.BasecallerConfig.tiny()
    # each rank starts from its own weights: init broadcasts data rank 0's
    mine = train_init(mesh.data_rank)
    for kind in ("even", "scaled"):
        got, model, opt, start = train_run(
            tr.make_train_step(cfg, learning_rate=TRAIN_LR, mesh=mesh), train_batch(kind), mine)
        same = all(torch.equal(start[k], v) for k, v in train_init(0).items())
        got["start_equal"] = np.array(same)
        out.update({f"{kind}/{k}": v for k, v in got.items()})
    path = os.path.join(os.environ["GB_PARALLEL_OUT"], "ckpt.pt")
    tr.save_checkpoint(path, model, opt, step=TRAIN_STEPS, mesh=mesh)
    back = tr.load_checkpoint(path)
    out["ckpt_equal"] = np.array(back["step"] == TRAIN_STEPS and all(
        torch.equal(back["params"][k], v.cpu()) for k, v in model.state_dict().items()))
    try:
        tr.make_train_step(cfg, mesh=mesh)[1](model, opt, *(a[:mesh.data + 1]
                                                             for a in train_batch("even")))
        out["uneven_error"] = np.array("")
    except ValueError as e:
        out["uneven_error"] = np.array(str(e))
    return out


RUNNERS = dict(bsw=run_bsw, pairhmm=run_pairhmm, chain=run_chain, abea=run_abea,
               fmi=run_fmi, kmer=run_kmer, pileup=run_pileup, predict=run_predict,
               train=run_train)


def world_cases(world: int) -> list:
    return [c for c in RUNNERS if c != "train" or world == TRAIN_WORLD]


def rank_env(world: int, rank: int) -> dict:
    """The variables a launcher sets for one rank: JAX's names at world 3,
    torchrun's at world 2 (init_multihost reads either)."""
    if world == 3:
        return {"NUM_PROCESSES": str(world), "PROCESS_ID": str(rank)}
    return {"WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": str(rank)}


def main(argv) -> int:
    import torch.distributed as dist

    from genomicsbench_tpu_torch.parallel.mesh import make_mesh
    from genomicsbench_tpu_torch.parallel.multihost import init_multihost

    store_path, out_dir = argv[1], argv[2]
    torch.set_num_threads(1)
    os.environ["GB_PARALLEL_OUT"] = out_dir
    # the world joins through a FileStore at store_path (no TCP port)
    if not init_multihost(device="cpu", init_method=f"file://{store_path}"):
        raise SystemExit("init_multihost found no world in the environment")
    try:
        mesh = make_mesh(device="cpu")
        rank = dist.get_rank()
        for case in world_cases(dist.get_world_size()):
            np.savez(os.path.join(out_dir, f"{case}-{rank}.npz"), **RUNNERS[case](mesh))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    sys.exit(main(sys.argv))
