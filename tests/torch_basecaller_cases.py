"""Inputs of the basecaller port's tests and of chip_smoke.py's nn-base phases.

Plain numpy (and torch for the state dicts): either package takes these.

* `jax_tree`: weights in the JAX package's params pytree layout (conv
  weights (k, Cin/groups, Cout), BatchNorms as dicts), every leaf a numpy
  array, drawn from a seed with the JAX init's std and BatchNorm statistics
  away from identity (so that every BatchNorm vector matters).  The JAX
  package takes it as it is; the port through `params_from_jax`.
* `calibrated_tree`: those weights with small BatchNorm scales,
  near-identity residual branches, a confident decoder and each
  BatchNorm's statistics taken from its input on a calibration batch, as a
  trained model's are: the whole-network comparisons run on these.
* `float_forward`: a tree's network in float32 or float64 without bf16
  rounding (calibrated_tree's calibration pass, tools/basecaller_drift.py's
  float64 reference).
* `bonito_state`: the same weights as bonito's ordered torch state dict
  (Conv1d weights (Cout, Cin/groups, k), BatchNorm1d weight, bias,
  running_mean, running_var and num_batches_tracked, in the reference
  model's registration order), as a weights_*.tar holds it.
* `depthwise_shapes`: the (k, C) of every depthwise conv of a config.
* `bench_signals`: tools/scale_bench.py:1111-1130 `bench_nn_base`'s reads
  (2,000 reads of 20,000 standard-normal samples, seed 31), copied.
* `mixed_signals`: reads of many lengths around the chunk size (a
  multi-chunk read, reads shorter than a chunk, lengths not a multiple of
  the stride 3, two reads of one short length, one of 1 sample).
* `peaked_posteriors`: blank-dominated (T, 5) posteriors with runs of
  active frames, repeats and sub-threshold symbols, for the beam search.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

BENCH = dict(n_signals=2_000, sig_len=20_000, seed=31)
CHUNKSIZE, OVERLAP, BEAMSIZE = 6_000, 300, 5
# calibrated_tree's scales: every BatchNorm's, each residual branch's on
# top, the decoder's
RESIDUAL_GAIN, BN_GAIN, DECODER_GAIN = 0.2, 0.3, 6.0


def _conv(rng, k, cin, cout):
    return (rng.standard_normal((k, cin, cout)) * (2.0 / (k * cin)) ** 0.5).astype(np.float32)


def _bn(rng, c):
    return dict(scale=rng.normal(1.0, 0.2, c).astype(np.float32),
                bias=rng.normal(0.0, 0.2, c).astype(np.float32),
                mean=rng.normal(0.0, 0.5, c).astype(np.float32),
                var=rng.uniform(0.5, 2.0, c).astype(np.float32))


def jax_tree(cfg, seed: int = 0) -> dict:
    """Random weights of `cfg` (either package's config) in the JAX params
    pytree layout, numpy leaves."""
    rng = np.random.default_rng(seed)
    tree = {"blocks": []}
    cin = cfg.features_in
    for b in cfg.blocks:
        block = {"convs": [], "bns": []}
        c = cin
        for _ in range(b.repeat):
            if b.separable:
                block["convs"].append(dict(depth=_conv(rng, b.kernel, 1, c),
                                           point=_conv(rng, 1, c, b.filters)))
            else:
                block["convs"].append(dict(full=_conv(rng, b.kernel, c, b.filters)))
            block["bns"].append(_bn(rng, b.filters))
            c = b.filters
        if b.residual:
            block["res_conv"] = _conv(rng, 1, cin, b.filters)
            block["res_bn"] = _bn(rng, b.filters)
        tree["blocks"].append(block)
        cin = b.filters
    tree["decoder"] = _conv(rng, 1, cin, cfg.num_labels)
    return tree


def calibrated_tree(cfg, seed: int = 0, residual_gain: float = RESIDUAL_GAIN,
                    bn_gain: float = BN_GAIN, decoder_gain: float = DECODER_GAIN) -> dict:
    """`jax_tree`'s weights shaped as a trained model's, then calibrated.

    Every BatchNorm scale is multiplied by `bn_gain` and the one that
    closes each residual block's branch also by `residual_gain` (a
    near-identity branch, as trained residual networks' are and as a
    zero-gamma initialisation makes them); the decoder by `decoder_gain`
    (posteriors about as confident as a caller's: a mean largest posterior
    near 0.55 instead of 0.4).  Then every BatchNorm's mean and var are set
    to the channel statistics of its input over 2 standard-normal signals
    of 3,000 samples (the normalised signal's scale), as training leaves a
    model's running statistics.  The calibration forward is `float_forward`
    in float32.

    At the full config's depth a random network with gains of 1 is
    chaotic: bf16 rounding differences grow from layer to layer until
    frames flip, and the JAX package's own bf16 forward then misses the
    0.05 / 0.98 bound against the same network in float64 as the port's
    does against JAX's.  With these gains the Swish inputs stay small,
    where the rounding noise is not amplified, and both meet it
    (tools/basecaller_drift.py measures both settings)."""
    tree = jax_tree(cfg, seed)
    for b, block in zip(cfg.blocks, tree["blocks"]):
        bns = block["bns"] + ([block["res_bn"]] if b.residual else [])
        for p in bns:
            p["scale"] = p["scale"] * np.float32(bn_gain)
        if b.residual:
            block["bns"][-1]["scale"] = block["bns"][-1]["scale"] * np.float32(residual_gain)
    tree["decoder"] = tree["decoder"] * np.float32(decoder_gain)
    rng = np.random.default_rng(seed + 1)

    def calibrate(y, p):
        p["mean"] = y.mean((0, 1)).numpy().astype(np.float32)
        p["var"] = y.var((0, 1), unbiased=False).numpy().astype(np.float32)

    float_forward(tree, cfg, rng.standard_normal((2, 3_000)).astype(np.float32),
                  bn_hook=calibrate)
    return tree


def float_forward(tree: dict, cfg, x, dtype=torch.float32, bn_hook=None) -> torch.Tensor:
    """The log-probs of `tree`'s network on x (B, T) in `dtype` throughout,
    no rounding to bf16: every op as the JAX package's `forward` orders it.
    `bn_hook(y, p)`, where given, sees each BatchNorm's input y and its dict
    p before the BatchNorm reads p."""
    F = torch.nn.functional

    def vec(a):
        return torch.from_numpy(np.asarray(a)).to(dtype)

    def conv(x, w, stride=1, groups=1):       # (k, Cin/groups, Cout) weights
        wt = vec(np.ascontiguousarray(np.asarray(w).transpose(2, 1, 0)))
        return F.conv1d(x.transpose(1, 2), wt, stride=stride, padding=wt.shape[2] // 2,
                        groups=groups).transpose(1, 2)

    def bn(y, p):
        if bn_hook is not None:
            bn_hook(y, p)
        return (y - vec(p["mean"])) * (torch.rsqrt(vec(p["var"]) + 1e-5) * vec(p["scale"])) \
            + vec(p["bias"])

    x = torch.from_numpy(np.asarray(x)).to(dtype)[:, :, None]
    with torch.no_grad():
        for b, block in zip(cfg.blocks, tree["blocks"]):
            inp = x
            for r in range(b.repeat):
                cv, stride = block["convs"][r], b.stride if r == 0 else 1
                if b.separable:
                    y = conv(conv(x, cv["depth"], stride, groups=x.shape[2]), cv["point"])
                else:
                    y = conv(x, cv["full"], stride)
                x = bn(y, block["bns"][r])
                if not (b.residual and r == b.repeat - 1):
                    x = x * torch.sigmoid(x)
            if b.residual:
                x = x + bn(conv(inp, block["res_conv"]), block["res_bn"])
                x = x * torch.sigmoid(x)
        return torch.log_softmax(conv(x, tree["decoder"]), -1)


def bonito_state(tree: dict, cfg) -> collections.OrderedDict:
    """`tree` as bonito's ordered state dict of torch tensors."""
    state = collections.OrderedDict()

    def conv(name, w):          # (k, Cin/groups, Cout) -> (Cout, Cin/groups, k)
        state[name] = torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(2, 1, 0)))

    def bn(prefix, p):
        for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            state[f"{prefix}.{dst}"] = torch.from_numpy(np.asarray(p[src]).copy())
        state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    for i, (b, block) in enumerate(zip(cfg.blocks, tree["blocks"])):
        for r, (cv, p) in enumerate(zip(block["convs"], block["bns"])):
            unit = f"encoder.{i}.conv.{r}"
            if b.separable:
                conv(f"{unit}.depthwise.weight", cv["depth"])
                conv(f"{unit}.pointwise.weight", cv["point"])
            else:
                conv(f"{unit}.conv.weight", cv["full"])
            bn(f"{unit}.bn", p)
        if b.residual:
            conv(f"encoder.{i}.residual.0.weight", block["res_conv"])
            bn(f"encoder.{i}.residual.1", block["res_bn"])
    conv("decoder.layers.0.weight", tree["decoder"])
    return state


def depthwise_shapes(cfg):
    """Sorted (k, C) of every depthwise conv of `cfg`."""
    shapes, cin = set(), cfg.features_in
    for b in cfg.blocks:
        if b.separable:
            shapes.update((b.kernel, c) for c in [cin] + [b.filters] * (b.repeat - 1))
        cin = b.filters
    return sorted(shapes)


def bench_signals(n_signals: int = BENCH["n_signals"], sig_len: int = BENCH["sig_len"],
                  seed: int = BENCH["seed"]):
    """bench_nn_base's reads: standard-normal float32 signals."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sig_len).astype(np.float32) for _ in range(n_signals)]


def mixed_signals(seed: int = 5, chunksize: int = 3_000):
    """{name: float32 signal}: a piecewise-level nanopore-like read of
    several chunks and reads around and below the chunk size."""
    rng = np.random.default_rng(seed)
    lengths = [4 * chunksize + 777, chunksize, chunksize + 1, chunksize - 1, 1_001, 1_001,
               1_000, 400, 2, 1]
    out = {}
    for i, n in enumerate(lengths):
        levels = rng.normal(90.0, 15.0, n // 8 + 1)
        sig = np.repeat(levels, 8)[:n] + rng.normal(0.0, 3.0, n)
        out[f"read_{i}"] = sig.astype(np.float32)
    return out


def peaked_posteriors(T: int = 4_000, seed: int = 7, L: int = 5):
    """(T, L) float32 posteriors, rows summing to 1: mostly blank, with
    bursts of one or two active symbols, repeated symbols across a blank,
    near ties and symbols just under the 1e-3 threshold."""
    rng = np.random.default_rng(seed)
    p = np.zeros((T, L), np.float64)
    p[:, 0] = 1.0
    p[:, 1:] = rng.uniform(0, 9e-4, (T, L - 1))
    t = 0
    while t < T:
        t += int(rng.integers(1, 12))
        run = int(rng.integers(1, 5))
        sym = int(rng.integers(1, L))
        for u in range(t, min(t + run, T)):
            p[u, sym] = rng.uniform(0.3, 0.95)
            if rng.random() < 0.3:
                p[u, 1 + (sym % (L - 1))] = rng.uniform(0.01, 0.4)
        t += run
    p[:, 0] = np.maximum(p[:, 0] - p[:, 1:].sum(1), 0.01)
    return (p / p.sum(1, keepdims=True)).astype(np.float32)
