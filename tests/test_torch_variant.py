"""The nn-variant port (genomicsbench_tpu_torch.models.variant_caller,
io/h5_batches.py, io/tf_checkpoint.py and the `nn-variant` CLI) against the
JAX package, on the CPU.

The same weights (tests/torch_variant_cases.py `jax_tree`, numpy drawn
from a seed, handed to the port through `params_from_jax`) and the same
numpy inputs go through both packages.  Both compute in float32, in other
summation orders, so the heads are held within the JAX package's own
tolerance, rtol 2e-5 and atol 2e-6 (tests/test_variant_caller.py:43); the
port's heads and JAX's are each held within it of a float64 forward of the
same weights too.  Per layer, `nn.LSTM` and the step-by-step
`bilstm_reference` are held to JAX's `_bilstm` at that tolerance.  The
checkpoint reader, the Clair converter, the h5 layouts and the narrow
transport's choice are exact.
"""

import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genomicsbench_tpu.io.h5_batches as JH
import genomicsbench_tpu.io.tf_checkpoint as JTF
import genomicsbench_tpu.models.variant_caller as J
from genomicsbench_tpu.cli import build_parser as jax_build_parser

import genomicsbench_tpu_torch.io.h5_batches as TH
import genomicsbench_tpu_torch.io.tf_checkpoint as TTF
import genomicsbench_tpu_torch.models.variant_caller as T
from genomicsbench_tpu_torch.cli import build_parser as torch_build_parser
from genomicsbench_tpu_torch.cli import main as torch_cli_main
from genomicsbench_tpu_torch.ops.grm import full_f32_matmul

from torch_variant_cases import (count_inputs, entry_proto, jax_tree, normal_inputs,
                                 tree_to_tf_bundle, write_bundle, write_table)

# pytest-xdist runs several workers on the CPU's cores; torch's own thread
# pool in each would oversubscribe them
torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-6)        # tests/test_variant_caller.py:43
CFGS = {"tiny": T.ClairConfig.tiny(), "full": T.ClairConfig()}
SEEDS = {"tiny": 3, "full": 4}


def _jcfg(cfg):
    return J.ClairConfig(lstm_units=cfg.lstm_units, l3_units=cfg.l3_units,
                         l4_units=cfg.l4_units, l5_units=cfg.l5_units)


@pytest.fixture(scope="module", params=sorted(CFGS))
def setup(request):
    cfg = CFGS[request.param]
    tree = jax_tree(cfg, SEEDS[request.param])
    return cfg, tree, T.build_model(T.params_from_jax(tree, cfg), cfg, "cpu")


def _heads(d):
    return [np.asarray(d[n]) for n in T.HEAD_NAMES]


def _port_forward(model, x, reference=False):
    with torch.inference_mode(), T.full_f32():
        return _heads({k: v.numpy() for k, v in
                       model(torch.from_numpy(x), reference=reference).items()})


def _float64_forward(cfg, tree, x):
    m = T.build_model(T.params_from_jax(tree, cfg), cfg, "cpu").double()
    with torch.inference_mode():
        return _heads({k: v.numpy() for k, v in
                       m(torch.from_numpy(x).double(), reference=True).items()})


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("route", ["nn_lstm", "reference"])
def test_bilstm_layers_match_jax(setup, route):
    """Both LSTM layers, each fed JAX's own input to it: nn.LSTM with the
    converted weights and the step-by-step plain version against JAX's
    `_bilstm`."""
    cfg, tree, model = setup
    x = normal_inputs(np.random.default_rng(5), 4, cfg).reshape(4, cfg.seq_len, -1)
    h = jnp.asarray(x)
    bilstm = jax.jit(J._bilstm, static_argnums=3)
    for li, lstm in ((1, model.lstm1), (2, model.lstm2)):
        want = bilstm(tree[f"lstm{li}_fw"], tree[f"lstm{li}_bw"], h, cfg.lstm_units)
        with torch.inference_mode(), T.full_f32():
            xt = torch.from_numpy(np.array(h))
            got = (lstm(xt)[0] if route == "nn_lstm" else T.bilstm_reference(lstm, xt)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), err_msg=f"layer {li}", **TOL)
        h = want


@pytest.mark.parametrize("inputs", ["normal", "counts"])
def test_forward_heads_match_jax(setup, inputs):
    """The four softmax heads against JAX's `predict`, and both packages
    against a float64 forward of the same weights."""
    cfg, tree, model = setup
    rng = np.random.default_rng(7)
    x = normal_inputs(rng, 6, cfg) if inputs == "normal" else count_inputs(rng, 6, cfg)
    want = _heads(J.predict(tree, jnp.asarray(x), _jcfg(cfg)))
    got = _port_forward(model, x)
    f64 = _float64_forward(cfg, tree, x)
    for name, g, w, d in zip(T.HEAD_NAMES, got, want, f64):
        assert g.shape == (6, cfg.head_sizes[T.HEAD_NAMES.index(name)])
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        np.testing.assert_allclose(g, d, err_msg=f"{name}: port vs float64", **TOL)
        np.testing.assert_allclose(w, d, err_msg=f"{name}: JAX vs float64", **TOL)
        np.testing.assert_allclose(g.sum(-1), 1.0, rtol=1e-5)


def test_reference_forward_matches_lstm_forward(setup):
    cfg, _, model = setup
    x = normal_inputs(np.random.default_rng(8), 5, cfg)
    for a, b in zip(_port_forward(model, x), _port_forward(model, x, reference=True)):
        np.testing.assert_allclose(a, b, **TOL)


# -------------------------------------------------------------- prediction
@pytest.mark.parametrize("transport", ["int8", "int16", "float32"])
def test_predict_batches_matches_jax(transport):
    """Uneven batches (3, 1, 7, 2) through both packages' predict_batches."""
    cfg = CFGS["tiny"]
    tree = jax_tree(cfg, 9)
    rng = np.random.default_rng(11)
    sizes = (3, 1, 7, 2)
    if transport == "float32":
        batches = [normal_inputs(rng, b, cfg) for b in sizes]
    else:
        batches = [count_inputs(rng, b, cfg, wide=transport == "int16") for b in sizes]
    assert T._narrow_transport(np.concatenate(batches)).dtype == np.dtype(transport)
    want = J.predict_batches(tree, batches, _jcfg(cfg))
    got = T.predict_batches(T.params_from_jax(tree, cfg), batches, cfg, device="cpu")
    assert len(got) == len(want) == len(sizes)
    for b, (gb, wb) in enumerate(zip(got, want)):
        for name, g, w in zip(T.HEAD_NAMES, gb, wb):
            assert g.shape == w.shape and g.shape[0] == sizes[b]
            np.testing.assert_allclose(g, w, err_msg=f"batch {b} {name}", **TOL)


def test_predict_batches_across_slabs(monkeypatch):
    """Slabs of 4 samples over 13: the same heads as one slab; no batch is
    empty and the split follows the batch sizes."""
    cfg = CFGS["tiny"]
    state = T.init_params(cfg)
    batches = [count_inputs(np.random.default_rng(12), b, cfg) for b in (5, 8)]
    whole = T.predict_batches(state, batches, cfg, device="cpu")
    monkeypatch.setattr(T, "SLAB", 4)
    stats = {}
    split = T.predict_batches(state, batches, cfg, device="cpu", stats=stats)
    assert set(stats) == {"concat_narrow", "upload", "forward", "fetch_split"}
    for a, b in zip(whole, split):
        for ha, hb in zip(a, b):
            np.testing.assert_allclose(ha, hb, **TOL)
    assert T.predict_batches(state, [], cfg, device="cpu") == []


def _narrow_case(name):
    rng = np.random.default_rng(5)
    x = count_inputs(rng, 7, CFGS["tiny"])
    if name == "int16":
        x[0, 0, 0, 0] = 300.0
    elif name == "int16_low":
        x[0, 0, 0, 1] = -129.0
    elif name == "fraction":
        x[0, 0, 0, 0] = 0.5
    elif name == "too_wide":
        x[0, 0, 0, 0] = 40_000.0
    elif name == "inf":
        x[0, 0, 0, 0] = np.inf
    elif name == "nan":
        x[0, 0, 0, 0] = np.nan
    elif name == "empty":
        x = x[:0]
    elif name == "integer_array":
        x = x.astype(np.int32)
    return x


@pytest.mark.parametrize("name", ["int8", "int16", "int16_low", "fraction", "too_wide", "inf",
                                  "nan", "empty", "integer_array"])
def test_narrow_transport_choice_matches_jax(name):
    x = _narrow_case(name)
    got, want = T._narrow_transport(x), J._narrow_transport(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_narrow_transport_is_exact(monkeypatch):
    """Counts shipped as int8 give the heads float32 transport gives, bit
    for bit (the widening on the device is exact)."""
    cfg = CFGS["tiny"]
    state = T.init_params(cfg)
    x = count_inputs(np.random.default_rng(6), 7, cfg)
    narrow = T.predict_batches(state, [x[:4], x[4:]], cfg, device="cpu")
    monkeypatch.setattr(T, "_narrow_transport", lambda a: a)
    wide = T.predict_batches(state, [x[:4], x[4:]], cfg, device="cpu")
    for a, b in zip(narrow, wide):
        for ha, hb in zip(a, b):
            np.testing.assert_array_equal(ha, hb)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CFGS["tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.predict_batches(T.init_params(cfg), [count_inputs(np.random.default_rng(0), 2, cfg)],
                          cfg)


# ----------------------------------------------------------------- weights
@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_param_count_and_init_match_jax(cfg_name):
    cfg = CFGS[cfg_name]
    tree = jax_tree(cfg, 1)
    state = T.init_params(cfg)
    assert T.param_count(state) == J.param_count(tree) == T.param_count(
        T.build_model(state, cfg, "cpu"))
    again = T.init_params(cfg)
    assert all(torch.equal(state[k], again[k]) for k in state)
    # JAX's std per tensor (variant_caller.py:85-121): the recurrent kernels
    # at sqrt(1 / units), biases 0
    wh = state["lstm1.weight_hh_l0"]
    assert abs(float(wh.std()) - (1.0 / cfg.lstm_units) ** 0.5) < 0.1 * (1.0 / cfg.lstm_units) ** 0.5
    assert not state["l4.bias"].any() and not state["lstm2.bias_hh_l0_reverse"].any()


def test_import_weights_is_the_tree_layout():
    cfg = CFGS["tiny"]
    tree = jax_tree(cfg, 2)
    state = T.params_from_jax(tree, cfg)
    np.testing.assert_array_equal(state["lstm1.weight_ih_l0"].numpy(), tree["lstm1_fw"]["wx"].T)
    np.testing.assert_array_equal(state["lstm2.weight_hh_l0_reverse"].numpy(),
                                  tree["lstm2_bw"]["wh"].T)
    np.testing.assert_array_equal(state["l3_w"].numpy(), tree["l3"]["w"])
    np.testing.assert_array_equal(state["heads.genotype.weight"].numpy(),
                                  tree["head_genotype"]["w"].T)
    jp = J.import_weights({"l4/w": tree["l4"]["w"]}, _jcfg(cfg))
    np.testing.assert_array_equal(np.asarray(jp["l4"]["w"]), state["l4.weight"].numpy().T)


@pytest.mark.parametrize("fault", ["missing", "shape", "unknown"])
def test_import_weights_refuses(fault):
    cfg = CFGS["tiny"]
    flat = {f"{k}/{n}": v for k, sub in jax_tree(cfg, 2).items() for n, v in sub.items()}
    if fault == "missing":
        del flat["l5_genotype/b"]
        match = "l5_genotype/b"
    elif fault == "shape":
        flat["lstm2_bw/wh"] = np.ones((3, 3), np.float32)
        match = "lstm2_bw/wh"
    else:
        flat["l6/w"] = np.ones(3, np.float32)
        match = "l6/w"
    with pytest.raises(ValueError, match=match):
        T.import_weights(flat, cfg)


# ------------------------------------------------------- TF checkpoints
@pytest.mark.parametrize("compress", [False, True])
def test_tensor_bundle_reader_matches_jax(tmp_path, compress):
    rng = np.random.default_rng(7)
    tensors = {f"scope/sub/var_{i:03d}": rng.standard_normal((i + 1,)).astype(np.float32)
               for i in range(23)}
    tensors.update({"layer2/kernel": rng.standard_normal((3, 4, 2)),
                    "step": np.array(1234, np.int64),
                    "counts": rng.integers(0, 100, (7,)).astype(np.int32)})
    prefix = str(tmp_path / "m.ckpt")
    write_bundle(prefix, tensors, compress=compress, block_size=5)
    got, want = TTF.read_tensor_bundle(prefix), JTF.read_tensor_bundle(prefix)
    assert set(got) == set(want) == set(tensors)
    for k in tensors:
        assert got[k].dtype == want[k].dtype == tensors[k].dtype
        np.testing.assert_array_equal(got[k], tensors[k])
    assert TTF.list_tensors(prefix) == JTF.list_tensors(prefix)
    assert TTF.list_tensors(prefix)["step"] == (np.dtype("<i8"), ())


def test_tensor_bundle_skips_and_refuses(tmp_path):
    """A sliced entry and a DT_STRING variable are skipped; a big-endian
    bundle is refused, as the JAX reader does."""
    prefix = str(tmp_path / "m.ckpt")
    arr = np.zeros((2, 2), np.float32)
    good = np.arange(6, dtype=np.float32)
    entries = [(b"", b"\x08\x01"), (b"a_good", entry_proto(good, 0, arr.nbytes)),
               (b"sliced_t", entry_proto(arr, 0, 0) + b"\x3a\x02\x08\x00"),
               (b"str_var", b"\x08\x07\x12\x00\x28\x00")]
    write_table(prefix + ".index", entries)
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(arr.tobytes() + good.tobytes())
    assert set(TTF.read_tensor_bundle(prefix)) == set(JTF.read_tensor_bundle(prefix)) == {
        "a_good"}
    big = str(tmp_path / "b.ckpt")
    write_table(big + ".index", [(b"", b"\x08\x01\x10\x01"), (b"t", entry_proto(good, 0, 0))])
    with open(big + ".data-00000-of-00001", "wb") as f:
        f.write(good.tobytes())
    with pytest.raises(NotImplementedError):
        TTF.read_tensor_bundle(big)
    with pytest.raises(FileNotFoundError):
        TTF.read_tensor_bundle(str(tmp_path / "none"))


def test_clair_checkpoint_matches_jax(tmp_path):
    """clair_flat_from_tf and load_tf_checkpoint on a written bundle: the
    port's flat dict equals JAX's array for array, its state equals
    params_from_jax of the tree, and JAX restores the same tree."""
    cfg = CFGS["tiny"]
    tree = jax_tree(cfg, 13)
    bundle = tree_to_tf_bundle(tree, cfg)
    got, want = T.clair_flat_from_tf(bundle, cfg), J.clair_flat_from_tf(bundle, _jcfg(cfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    prefix = str(tmp_path / "clair.ckpt")
    write_bundle(prefix, bundle, block_size=7)
    state = T.load_tf_checkpoint(prefix, cfg)
    direct = T.params_from_jax(tree, cfg)
    assert set(state) == set(direct)
    for k in direct:
        assert torch.equal(state[k], direct[k]), k
    restored = J.load_tf_checkpoint(prefix, _jcfg(cfg))
    for layer, sub in tree.items():
        for name, v in sub.items():
            np.testing.assert_array_equal(np.asarray(restored[layer][name]), v)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_clair_checkpoint_refuses(fault):
    cfg = CFGS["tiny"]
    bundle = tree_to_tf_bundle(jax_tree(cfg, 13), cfg)
    name = ("LSTM2/stack_bidirectional_rnn/cell_0/bidirectional_rnn/bw/"
            "cudnn_compatible_lstm_cell/kernel")
    if fault == "missing":
        del bundle["L3/Unit_5/bias"]
        name = "L3/Unit_5/bias"
    else:
        bundle[name] = bundle[name][:-1]
    with pytest.raises(ValueError, match=name):
        T.clair_flat_from_tf(bundle, cfg)


# -------------------------------------------------------------- h5 batches
def test_h5_plain_layout_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    cfg = CFGS["tiny"]
    batches = [normal_inputs(rng, 3, cfg), (count_inputs(rng, 5, cfg), np.arange(5))]
    TH.write_batches(str(tmp_path / "t.h5"), batches)
    JH.write_batches(str(tmp_path / "j.h5"), batches)
    for path in ("t.h5", "j.h5"):
        got, want = TH.read_batches(str(tmp_path / path)), JH.read_batches(str(tmp_path / path))
        assert len(got) == len(want) == 2
        for (gx, ga), (wx, wa) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            assert (ga is None) == (wa is None)
            if ga is not None:
                np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(got[0][0], batches[0])
    np.testing.assert_array_equal(got[1][1], np.arange(5))


def test_h5_deepdish_layout_matches_jax(tmp_path):
    """deepdish's list layout: data/i0/{i0, i1} tuples and a bare data/i1."""
    import h5py

    rng = np.random.default_rng(2)
    cfg = CFGS["tiny"]
    x0, x1, pos = normal_inputs(rng, 4, cfg), normal_inputs(rng, 2, cfg), np.arange(4)
    path = str(tmp_path / "dd.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data/i0/i0", data=x0)
        f.create_dataset("data/i0/i1", data=pos)
        f.create_dataset("data/i1", data=x1)
    got, want = TH.read_batches(path), JH.read_batches(path)
    assert [a is None for _, a in got] == [a is None for _, a in want] == [False, True]
    for (gx, _), (wx, _) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(got[0][1], pos)


def test_h5_without_h5py_raises_import_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        TH.read_batches(str(tmp_path / "x.h5"))
    with pytest.raises(ImportError, match="h5py"):
        TH.write_batches(str(tmp_path / "x.h5"), [np.zeros((1, 33, 8, 4), np.float32)])


# --------------------------------------------------------------- precision
def test_full_f32_sets_and_restores_the_flags():
    """Inside: matmul "highest", cuDNN off, the RNN flag "ieee"; outside:
    the caller's settings as they were, the legacy cuDNN flag readable
    again, and grm's helper still working."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.rnn.fp32_precision, torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        cudnn.rnn.fp32_precision = "tf32"
        before = (mm.fp32_precision, T.precision_state())
        assert before[1] == dict(rnn="tf32", matmul="high", cudnn=True)
        with T.full_f32():
            assert T.precision_state() == T.IEEE == dict(rnn="ieee", matmul="highest",
                                                         cudnn=False)
            assert mm.fp32_precision == "ieee" and not mm.allow_tf32
        assert (mm.fp32_precision, T.precision_state()) == before
        assert cudnn.allow_tf32 and mm.allow_tf32
        with full_f32_matmul():
            assert not mm.allow_tf32
        with pytest.raises(ZeroDivisionError), T.full_f32():
            1 / 0
        assert T.precision_state() == before[1]
    finally:
        cudnn.rnn.fp32_precision = saved[0]
        torch.set_float32_matmul_precision(saved[1])


# --------------------------------------------------------------------- CLI
def _run(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        main(argv)
    return err.getvalue()


def test_cli_matches_jax(tmp_path):
    """`nn-variant --input_fn --output_fn --chkpnt_fn --device cpu` against
    the JAX CLI on the same checkpoint of the full ClairConfig(): the output
    h5's packed heads within the tolerance, the same timing line."""
    from genomicsbench_tpu.cli import cmd_nn_variant as jax_cmd

    cfg = CFGS["full"]
    prefix = str(tmp_path / "clair.ckpt")
    write_bundle(prefix, tree_to_tf_bundle(jax_tree(cfg, 21), cfg), block_size=64)
    rng = np.random.default_rng(22)
    TH.write_batches(str(tmp_path / "in.h5"), [count_inputs(rng, 3, cfg),
                                               count_inputs(rng, 5, cfg, wide=True)])
    args = ["nn-variant", "--input_fn", str(tmp_path / "in.h5"), "--chkpnt_fn", prefix,
            "--sampleName", "NA12878", "--threads", "4", "--qual", "50"]
    t_err = _run(torch_cli_main, args + ["--output_fn", str(tmp_path / "t.h5"),
                                         "--device", "cpu"])
    j_args = jax_build_parser().parse_args(args + ["--output_fn", str(tmp_path / "j.h5")])
    j_err = _run(jax_cmd, j_args)
    for e in (t_err, j_err):
        assert len(e.splitlines()) == 1
        head, _, tail = e.strip().rpartition(" ")
        assert tail == "s" and head.startswith("Time taken: ")
        assert len(head.split()[-1].split(".")[1]) == 4
    got, want = TH.read_batches(str(tmp_path / "t.h5")), JH.read_batches(str(tmp_path / "j.h5"))
    assert [x.shape for x, _ in got] == [x.shape for x, _ in want] == [(3, 90), (5, 90)]
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_cli_random_init_and_arguments(tmp_path):
    """Without --chkpnt_fn the CLI runs `init_params` (the port's random
    model); the parity flags parse as JAX's parser parses them."""
    cfg = CFGS["full"]
    x = count_inputs(np.random.default_rng(3), 2, cfg)
    TH.write_batches(str(tmp_path / "in.h5"), [x])
    _run(torch_cli_main, ["nn-variant", "--input_fn", str(tmp_path / "in.h5"), "--output_fn",
                          str(tmp_path / "o.h5"), "--device", "cpu"])
    (got, _), = TH.read_batches(str(tmp_path / "o.h5"))
    want = T.predict_batches(T.init_params(cfg), [x], cfg, device="cpu")[0]
    np.testing.assert_array_equal(got, np.concatenate(want, axis=1))
    argv = ["nn-variant", "--input_fn", "a.h5"]
    t, j = torch_build_parser().parse_args(argv), jax_build_parser().parse_args(argv)
    for name in ("input_fn", "output_fn", "chkpnt_fn", "sampleName", "threads", "qual"):
        assert getattr(t, name) == getattr(j, name)
    assert (t.device, t.sampleName, t.threads, t.qual) == ("cuda", "SAMPLE", 1, 100)
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        torch_build_parser().parse_args(["nn-variant"])
