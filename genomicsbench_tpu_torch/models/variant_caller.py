"""Clair-style neural variant caller (the nn-variant workload) in PyTorch.

The port of genomicsbench_tpu/models/variant_caller.py.  The architecture
is Clair's "2BiLSTM" (benchmarks/nn-variant/clair/model.py:400-620):

  input  X (B, 33, 8, 4)   33 = 2 * flankingBaseNum + 1 positions, 8 count
                           rows (ACGTacgt), 4 channels (shared/param.py:9-11)
  flatten -> (B, 33, 32)
  BiLSTM1 128 units a direction -> (B, 33, 256)
  BiLSTM2 128 units a direction -> (B, 33, 256)
  L3  slice-dense along the channel axis: 256 independent 33 -> 30 dense
      layers with SELU, stacked -> (B, 30, 256), flattened row-major to
      (B, 7,680)
  L4  dense 7,680 -> 192, SELU
  L5  one dense 192 -> 96 with SELU per head
  heads: dense 96 -> {21, 3, 33, 33} with SELU on the logits (a reference
      quirk, kept) and then softmax.

Device part.  Each bidirectional LSTM layer is one `nn.LSTM(bidirectional=
True, batch_first=True)` with the JAX package's weights: `weight_ih =
wx.T`, `weight_hh = wh.T`, `bias_ih = b`, `bias_hh = 0`, gate order (i, f,
g, o) in both and no forget-bias offset; its output is [forward, backward]
concatenated, as JAX's `_bilstm` (:134-157) gives.  L3 is one batched
product (`einsum("btc,ctu->buc")`), L4, L5 and the heads `nn.Linear`
(cuBLAS); SELU and softmax are plain PyTorch ops.  The JAX package has no
Pallas kernel on this path, and none is written here: the LSTM's
`lax.scan` maps onto a library's recurrence.  `bilstm_reference` is the
plain step-by-step version of one layer, in JAX's operations and order
(the projection of every step, then per step `xp + h @ wh`, the split, c,
h); the tests and the card's checks use it, the main path never.

Precision.  The JAX package computes in float32 (`ClairConfig.dtype`).
PyTorch runs a float32 cuDNN RNN in TF32 by default
(`torch.backends.cudnn.rnn.fp32_precision` is "tf32"), and the global
matmul setting does not reach it; with the flag at "ieee", cuDNN's LSTM
(cuDNN 9.2 on an H100) still lands 23 times further from float64 than
IEEE float32 does, and takes twice as long as PyTorch's own CUDA LSTM
(tools/variant_precision_probe.py).  So every forward runs inside
`full_f32()`: the matmul precision "highest" (cuBLAS without TF32), cuDNN
switched off, so that `nn.LSTM` takes PyTorch's CUDA LSTM (cuBLAS products
and ATen's fused LSTM cell), and cuDNN's RNN flag at "ieee" all the same;
it asserts all three and restores the caller's settings on the way out.
It never reads the legacy `allow_tf32` flags: torch refuses to read
`torch.backends.cudnn.allow_tf32` while the conv and RNN flags differ.

Weights: `init_params` (JAX's shapes and std, drawn from a torch.Generator
seeded 0: it cannot reproduce jax.random's threefry stream, so the two
packages' random models differ), `import_weights` (the flat {path: array}
dict of the JAX package's `import_weights`), `params_from_jax` (the JAX
params tree as numpy leaves) and `load_tf_checkpoint` (a Clair TF V2
checkpoint through io/tf_checkpoint.py) each give the module's state dict.

`predict_batches` is the reference prediction loop (prediction.py:11-45)
as the JAX package runs it: the batches concatenated, integral counts
shipped narrow (`_narrow_transport`: int8 or int16, widened on the card),
slabs of 65,536 samples, one fetch, split per batch and head.  The slabs
are not padded to a power of two as JAX pads them for its compile cache:
rows are independent.

Training (:377-442): `focal_loss`, `clair_loss` (the four heads' focal
losses on the SELU'd logits of `ClairNet.logits`, task weights 1, plus
0.005 times the sum of squares of every JAX leaf) and `make_train_step`
(`torch.optim.Adam(1e-3)`, optax's `adam`), the gradients through
`nn.LSTM` inside `full_f32()`.  The LSTMs' `bias_hh` stays frozen at zero,
outside the optimizer and the L2 sum: JAX has one bias per LSTM, and a
trained second one would move the effective bias twice as fast.

`predict_sharded` (:256) shards the samples over a mesh's "data" axis and
gathers the four heads on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch import nn

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.models import StepTimer
from genomicsbench_tpu_torch.parallel.mesh import gather_rows, shard_batch

# Label counts: clair/task/gt21.py (21), genotype.py (3),
# variant_length.py (2 * 16 + 1 = 33 each).
GT21_CLASSES = 21
GENOTYPE_CLASSES = 3
VARIANT_LENGTH_CLASSES = 33
HEAD_NAMES = ("gt21", "genotype", "indel_length_1", "indel_length_2")
# Samples a forward takes at once (the JAX package's slab, variant_caller.py:233)
SLAB = 65_536
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ClairConfig:
    seq_len: int = 33  # 2 * flankingBaseNum + 1 (param.py:9)
    rows: int = 8  # matrixRow (param.py:10)
    channels: int = 4  # matrixNum (param.py:11)
    lstm_units: int = 128  # LSTM{1,2}_num_units (model.py:92-93)
    l3_units: int = 30  # L2_num_units, reused for slice-dense (model.py:81,466)
    l4_units: int = 192  # model.py:82
    l5_units: int = 96  # model.py:84-90
    head_sizes: tuple = (GT21_CLASSES, GENOTYPE_CLASSES, VARIANT_LENGTH_CLASSES,
                         VARIANT_LENGTH_CLASSES)
    dtype: str = "float32"

    @property
    def input_feats(self) -> int:
        return self.rows * self.channels

    @classmethod
    def tiny(cls):
        return cls(lstm_units=16, l3_units=8, l4_units=32, l5_units=16)


# ---------------------------------------------------------------- precision
IEEE = dict(rnn="ieee", matmul="highest", cudnn=False)    # the state inside full_f32


@contextlib.contextmanager
def full_f32():
    """float32 products and LSTMs in IEEE float32 inside the block: the
    matmul precision "highest", cuDNN off (nn.LSTM then runs PyTorch's own
    CUDA LSTM over cuBLAS) and cuDNN's RNN flag at "ieee", all asserted; the
    caller's settings restored on the way out.  The matmul setting goes
    through the one global setter, which keeps the cuBLAS and oneDNN flags
    in step (torch refuses to read a mix).  Reads no legacy `allow_tf32`
    flag (torch refuses a read of `torch.backends.cudnn.allow_tf32` while
    the RNN and conv flags differ)."""
    cudnn = torch.backends.cudnn
    saved = cudnn.rnn.fp32_precision, torch.get_float32_matmul_precision(), cudnn.enabled
    torch.set_float32_matmul_precision("highest")
    cudnn.rnn.fp32_precision = "ieee"
    cudnn.enabled = False
    try:
        state = precision_state()
        if state != IEEE:
            raise RuntimeError(f"float32 is not IEEE inside full_f32: {state}")
        yield
    finally:
        cudnn.rnn.fp32_precision = saved[0]
        torch.set_float32_matmul_precision(saved[1])
        cudnn.enabled = saved[2]


def precision_state() -> dict:
    """The settings `full_f32` makes: cuDNN's RNN float32 precision, the
    float32 matmul precision and whether cuDNN is on."""
    cudnn = torch.backends.cudnn
    return dict(rnn=cudnn.rnn.fp32_precision, matmul=torch.get_float32_matmul_precision(),
                cudnn=cudnn.enabled)


# ---------------------------------------------------------------- the network
def _frozen(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class ClairNet(nn.Module):
    """The 2BiLSTM network.  `forward(x)`: x (B, seq_len, rows, channels) of
    any real or integer dtype -> {head name: (B, classes) softmax}; `packed`
    gives the four heads concatenated, (B, sum(head_sizes))."""

    def __init__(self, cfg: ClairConfig = ClairConfig()):
        super().__init__()
        self.cfg = cfg
        H, h2 = cfg.lstm_units, 2 * cfg.lstm_units
        self.lstm1 = nn.LSTM(cfg.input_feats, H, batch_first=True, bidirectional=True)
        self.lstm2 = nn.LSTM(h2, H, batch_first=True, bidirectional=True)
        self.l3_w = _frozen(h2, cfg.seq_len, cfg.l3_units)
        self.l3_b = _frozen(h2, cfg.l3_units)
        self.l4 = nn.Linear(cfg.l3_units * h2, cfg.l4_units)
        self.l5 = nn.ModuleDict({n: nn.Linear(cfg.l4_units, cfg.l5_units) for n in HEAD_NAMES})
        self.heads = nn.ModuleDict({n: nn.Linear(cfg.l5_units, s)
                                    for n, s in zip(HEAD_NAMES, cfg.head_sizes)})
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, reference: bool = False) -> dict:
        """reference=True runs each LSTM layer step by step
        (`bilstm_reference`) instead of nn.LSTM; float64 weights and inputs
        give a float64 forward."""
        # SELU on the logits, then softmax: model.py:581-620
        return {name: torch.softmax(v, dim=-1) for name, v in self.logits(x, reference).items()}

    def logits(self, x: torch.Tensor, reference: bool = False) -> dict:
        """{head name: (B, classes)} SELU'd logits before the softmax (JAX's
        `_forward_logits`, :392-407)."""
        cfg = self.cfg
        dt = self.l3_w.dtype
        b = x.shape[0]
        h = x.to(dt).reshape(b, cfg.seq_len, cfg.input_feats)
        for lstm in (self.lstm1, self.lstm2):
            h = bilstm_reference(lstm, h) if reference else lstm(h)[0]
        # L3 slice-dense over channels: out[b, u, c] = selu(sum_t h[b, t, c] W[c, t, u])
        l3 = torch.selu(torch.einsum("btc,ctu->buc", h, self.l3_w) + self.l3_b.T[None])
        l4 = torch.selu(self.l4(l3.reshape(b, -1)))   # row-major (u, c), as the reference
        return {name: torch.selu(self.heads[name](torch.selu(self.l5[name](l4))))
                for name in HEAD_NAMES}

    def packed(self, x: torch.Tensor, reference: bool = False) -> torch.Tensor:
        y = self.forward(x, reference)
        return torch.cat([y[n] for n in HEAD_NAMES], dim=-1)


def bilstm_reference(lstm: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """The plain version of one bidirectional layer, (B, T, I) -> (B, T, 2H),
    in the JAX package's operations and order (`_bilstm`, :134-157): the
    input projection of every step at once plus b, then per step
    gates = xp + h @ wh, the split (i, f, g, o), c = sigmoid(f) c +
    sigmoid(i) tanh(g), h = sigmoid(o) tanh(c); the backward direction on
    the reversed sequence, flipped back.  `lstm`'s bias_hh is added to the
    projection (zero for weights from the JAX layout)."""
    def run(sfx, xs):
        wx = getattr(lstm, f"weight_ih_l0{sfx}").T
        wh = getattr(lstm, f"weight_hh_l0{sfx}").T
        bias = getattr(lstm, f"bias_ih_l0{sfx}") + getattr(lstm, f"bias_hh_l0{sfx}")
        xproj = torch.einsum("bti,ig->btg", xs, wx) + bias
        h = c = xs.new_zeros(xs.shape[0], lstm.hidden_size)
        hs = []
        for t in range(xs.shape[1]):
            gates = xproj[:, t] + h @ wh
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1)

    fw = run("", x)
    bw = torch.flip(run("_reverse", torch.flip(x, dims=[1])), dims=[1])
    return torch.cat([fw, bw], dim=-1)


# ------------------------------------------------------------------ weights
def flat_shapes(cfg: ClairConfig = ClairConfig()) -> dict:
    """{path: shape} of the JAX package's parameter tree, its paths joined
    by '/' as `import_weights` takes them, in its init's order."""
    H, h2, T = cfg.lstm_units, 2 * cfg.lstm_units, cfg.seq_len
    shapes = {}
    for li, in_dim in ((1, cfg.input_feats), (2, h2)):
        for d in ("fw", "bw"):
            shapes.update({f"lstm{li}_{d}/wx": (in_dim, 4 * H),
                           f"lstm{li}_{d}/wh": (H, 4 * H), f"lstm{li}_{d}/b": (4 * H,)})
    shapes.update({"l3/w": (h2, T, cfg.l3_units), "l3/b": (h2, cfg.l3_units),
                   "l4/w": (cfg.l3_units * h2, cfg.l4_units), "l4/b": (cfg.l4_units,)})
    for name, hs in zip(HEAD_NAMES, cfg.head_sizes):
        shapes.update({f"l5_{name}/w": (cfg.l4_units, cfg.l5_units),
                       f"l5_{name}/b": (cfg.l5_units,),
                       f"head_{name}/w": (cfg.l5_units, hs), f"head_{name}/b": (hs,)})
    return shapes


def import_weights(flat: dict, cfg: ClairConfig = ClairConfig()) -> dict:
    """The state dict of a flat {path: array} dict in the JAX package's
    layout (its `import_weights`, :271): LSTM kernels (in, 4H) and (H, 4H)
    in gate order (i, f, g, o), dense kernels (in, out), L3 stacked (2H, T,
    U).  Every path of `flat_shapes(cfg)` is required: a missing, unknown
    or ill-shaped tensor raises ValueError naming it (the JAX package keeps
    its random init for a missing one)."""
    want = flat_shapes(cfg)
    unknown = sorted(set(flat) - set(want))
    if unknown:
        raise ValueError(f"unknown tensors {unknown[:4]}")
    t = {}
    for path, shape in want.items():
        if path not in flat:
            raise ValueError(f"{path}: missing (expected shape {shape})")
        v = torch.tensor(np.asarray(flat[path], np.float32))
        if tuple(v.shape) != shape:
            raise ValueError(f"{path}: shape {tuple(v.shape)} != expected {shape}")
        t[path] = v
    state = {}
    for li in (1, 2):
        for d, sfx in (("fw", ""), ("bw", "_reverse")):
            p = f"lstm{li}_{d}"
            state[f"lstm{li}.weight_ih_l0{sfx}"] = t[f"{p}/wx"].T
            state[f"lstm{li}.weight_hh_l0{sfx}"] = t[f"{p}/wh"].T
            state[f"lstm{li}.bias_ih_l0{sfx}"] = t[f"{p}/b"]
            state[f"lstm{li}.bias_hh_l0{sfx}"] = torch.zeros_like(t[f"{p}/b"])
    state["l3_w"], state["l3_b"] = t["l3/w"], t["l3/b"]
    state["l4.weight"], state["l4.bias"] = t["l4/w"].T, t["l4/b"]
    for name in HEAD_NAMES:
        state[f"l5.{name}.weight"], state[f"l5.{name}.bias"] = t[f"l5_{name}/w"].T, \
            t[f"l5_{name}/b"]
        state[f"heads.{name}.weight"], state[f"heads.{name}.bias"] = \
            t[f"head_{name}/w"].T, t[f"head_{name}/b"]
    return {k: v.contiguous() for k, v in state.items()}


def params_from_jax(tree: dict, cfg: ClairConfig = ClairConfig()) -> dict:
    """The state dict of the JAX params tree `tree` ({layer: {name:
    array}}, numpy leaves)."""
    return import_weights({f"{layer}/{name}": v for layer, sub in tree.items()
                           for name, v in sub.items()}, cfg)


def init_params(cfg: ClairConfig = ClairConfig(),
                generator: torch.Generator | None = None) -> dict:
    """A deterministic random state with the JAX package's shapes and std
    (`_init_params_impl`, :99-121: LSTM input kernels normal * sqrt(1 /
    in), recurrent ones * sqrt(1 / units), L3 * sqrt(2 / seq_len), dense
    layers * sqrt(2 / fan_in), biases 0), drawn in its order from
    `generator` (seeded 0 when None).  The values differ from JAX
    `init_params(key(0))`'s."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    flat = {}
    for path, shape in flat_shapes(cfg).items():
        layer, name = path.split("/")
        if name == "b":
            flat[path] = torch.zeros(shape)
            continue
        if layer.startswith("lstm"):
            std = (1.0 / (shape[0] if name == "wx" else cfg.lstm_units)) ** 0.5
        elif layer == "l3":
            std = (2.0 / cfg.seq_len) ** 0.5
        else:
            std = (2.0 / shape[0]) ** 0.5
        flat[path] = torch.randn(shape, generator=generator, dtype=_F32) * std
    return import_weights({k: v.numpy() for k, v in flat.items()}, cfg)


def param_count(params) -> int:
    """The JAX model's parameter count: every tensor of a state dict (or a
    ClairNet's) but the LSTMs' bias_hh, which the JAX layout does not have
    (held at zero)."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    return sum(v.numel() for k, v in state.items() if ".bias_hh_" not in k)


def build_model(params, cfg: ClairConfig | None = None, device="cuda") -> ClairNet:
    """A ClairNet on `device` from a state dict (or a ClairNet, moved)."""
    dev = resolve_device(device)
    if isinstance(params, ClairNet):
        return params.to(dev)
    model = ClairNet(cfg or ClairConfig())
    model.load_state_dict(params)
    return model.to(dev).eval()


# ------------------------------------------------- TF checkpoint restore
# The reference loads Clair weights with tf.train.Saver.restore
# (clair/model.py:1030, prediction.py:66); its CPU graph builds
# CudnnCompatibleLSTMCells under stack_bidirectional_dynamic_rnn
# (model.py:300-312), so the checkpoint carries fused (I + H, 4H) kernels
# in TF's (i, j, f, o) gate order.
_TF_LSTM_VAR = ("{scope}/stack_bidirectional_rnn/cell_0/bidirectional_rnn/"
                "{direction}/cudnn_compatible_lstm_cell/{var}")
_TF_HEAD_VARS = (  # model.py:581-620, scope "Prediction"
    "Y_base_change_logits",
    "Y_genotype_logits",
    "Y_indel_length_logits_1",
    "Y_indel_length_logits_2",
)


def clair_flat_from_tf(bundle: dict, cfg: ClairConfig = ClairConfig()) -> dict:
    """A Clair TF tensor bundle ({tf variable name: array}) in the flat
    layout `import_weights` takes (the JAX package's `clair_flat_from_tf`,
    :312).  LSTM kernels: TF's fused (I + H, 4H) kernel split into wx and
    wh and its gate blocks (i, j, f, o) permuted to (i, f, g, o), g = TF's
    j (CudnnCompatibleLSTMCell has forget_bias 0).  L3: the 2H per-channel
    "Unit_i" (T, U) kernels stacked.  Dense kernels are (in, out) already.
    A missing or ill-shaped LSTM tensor raises ValueError naming it (JAX:
    KeyError or AssertionError)."""
    H = cfg.lstm_units
    perm = np.concatenate([
        np.arange(0, H),           # i
        np.arange(2 * H, 3 * H),   # f  (TF block 2)
        np.arange(H, 2 * H),       # g = TF j (block 1)
        np.arange(3 * H, 4 * H),   # o
    ])

    def take(name):
        if name not in bundle:
            raise ValueError(f"{name}: missing from the checkpoint")
        return np.asarray(bundle[name])

    flat = {}
    for li, scope in ((1, "LSTM1"), (2, "LSTM2")):
        in_dim = cfg.input_feats if li == 1 else 2 * H
        for d in ("fw", "bw"):
            kname = _TF_LSTM_VAR.format(scope=scope, direction=d, var="kernel")
            k = take(kname)
            b = take(_TF_LSTM_VAR.format(scope=scope, direction=d, var="bias"))
            if k.shape != (in_dim + H, 4 * H):
                raise ValueError(f"{kname}: shape {k.shape} != expected {(in_dim + H, 4 * H)}")
            k = k[:, perm]
            flat[f"lstm{li}_{d}/wx"] = k[:in_dim]
            flat[f"lstm{li}_{d}/wh"] = k[in_dim:]
            flat[f"lstm{li}_{d}/b"] = b[perm]
    h2 = 2 * H
    flat["l3/w"] = np.stack([take(f"L3/Unit_{i}/kernel") for i in range(h2)])
    flat["l3/b"] = np.stack([take(f"L3/Unit_{i}/bias") for i in range(h2)])
    flat["l4/w"] = take("L4/kernel")
    flat["l4/b"] = take("L4/bias")
    for i, name in enumerate(HEAD_NAMES):
        flat[f"l5_{name}/w"] = take(f"L5_{i + 1}/kernel")
        flat[f"l5_{name}/b"] = take(f"L5_{i + 1}/bias")
        tf_head = f"Prediction/{_TF_HEAD_VARS[i]}"
        flat[f"head_{name}/w"] = take(f"{tf_head}/kernel")
        flat[f"head_{name}/b"] = take(f"{tf_head}/bias")
    return flat


def load_tf_checkpoint(prefix: str, cfg: ClairConfig = ClairConfig()) -> dict:
    """The state dict of a Clair TF V2 checkpoint prefix (the `{prefix}.index`
    and `{prefix}.data-*` pair the reference's `restore_parameters(chkpnt_fn)`
    takes)."""
    from genomicsbench_tpu_torch.io.tf_checkpoint import read_tensor_bundle

    return import_weights(clair_flat_from_tf(read_tensor_bundle(prefix), cfg), cfg)


# ------------------------------------------------------------ prediction
def _narrow_transport(xs: np.ndarray) -> np.ndarray:
    """Clair input tensors are integer-valued pileup counts (reference
    clair/plot_tensor.py:65-68: channel 0 base counts, channels 1-3 count
    deltas), shipped by the reference as float32.  When every value is
    integral and in int8 or int16 range, ship the narrow integer instead:
    widening to f32 on the card is exact, and the upload shrinks 4x or 2x
    (the JAX package's `_narrow_transport`, :197)."""
    if xs.dtype.kind == "f" and xs.size:
        lo, hi = xs.min(), xs.max()
        if np.isfinite(lo) and np.isfinite(hi) and np.all(xs == np.floor(xs)):
            if -128 <= lo and hi <= 127:
                return xs.astype(np.int8)
            if -32768 <= lo and hi <= 32767:
                return xs.astype(np.int16)
    return xs


def forward_slabs(model: ClairNet, xd: torch.Tensor) -> torch.Tensor:
    """The packed heads, (N, sum(head_sizes)) f32 on xd's device, of every
    sample of xd (N, seq_len, rows, channels), SLAB samples a forward, in
    IEEE float32 (`full_f32`)."""
    with torch.inference_mode(), full_f32():
        packed = torch.empty(len(xd), sum(model.cfg.head_sizes), dtype=_F32, device=xd.device)
        for off in range(0, len(xd), SLAB):
            packed[off:off + SLAB] = model.packed(xd[off:off + SLAB])
    return packed


def predict_batches(params, batches, cfg: ClairConfig | None = None, device="cuda",
                    stats=None):
    """The reference prediction loop (prediction.py:11-45): run the h5
    mini-batches and return [gt21, genotype, il1, il2] numpy arrays per
    batch.  params: a state dict or a ClairNet.

    All batches are concatenated and narrowed (`_narrow_transport`),
    uploaded at once, run in slabs of SLAB samples inside `full_f32()`
    into one device buffer of packed heads, fetched once and split on the
    host.  With `stats`, a dict, each stage is waited for and its seconds
    added under concat_narrow, upload, forward and fetch_split."""
    model = build_model(params, cfg, device)
    cfg = model.cfg
    dev = next(model.parameters()).device
    batches = [np.asarray(x) for x in batches]
    if not batches:
        return []
    cuda = dev.type == "cuda"
    stamp = [time.perf_counter()]

    def lap(name):
        if stats is not None:
            if cuda:
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            stats[name] = stats.get(name, 0.0) + now - stamp[0]
            stamp[0] = now

    sizes = [len(x) for x in batches]
    total = sum(sizes)
    xs = _narrow_transport(np.concatenate(batches, axis=0))
    lap("concat_narrow")
    xd = torch.from_numpy(np.ascontiguousarray(xs)).to(dev)
    lap("upload")
    packed = forward_slabs(model, xd)
    lap("forward")
    if cuda:
        host = torch.empty(packed.shape, dtype=_F32, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        torch.cuda.synchronize(dev)
        packed = host
    heads = np.split(packed.numpy(), np.cumsum(cfg.head_sizes)[:-1], axis=-1)
    outs, off = [], 0
    for s in sizes:
        outs.append([h[off:off + s] for h in heads])
        off += s
    lap("fetch_split")
    return outs


def predict_sharded(params, x, cfg: ClairConfig, mesh) -> dict:
    """Data-parallel inference over the mesh's "data" axis (JAX's
    `predict_sharded`, :256): x (B, seq_len, rows, channels) with B a
    multiple of the axis (ValueError, as NamedSharding), each rank's block
    through `forward_slabs` on the mesh's device, the packed heads gathered
    in rank order.  Returns {head name: (B, classes) f32 softmax} on the
    mesh's device, on every rank."""
    model = build_model(params, cfg, mesh.device)
    xd = shard_batch(mesh, x if torch.is_tensor(x) else np.asarray(x))
    packed = gather_rows(mesh, forward_slabs(model, xd))
    return dict(zip(HEAD_NAMES, torch.split(packed, list(model.cfg.head_sizes), dim=-1)))


# ---------------------------------------------------------------- training
# (reference: clair/model.py: default_loss_function "FocalLoss" param.py:29,
# focal_loss model.py:783-805, task weights model.py:64-70, Adam at 1e-3
# param.py:17-28, L2 lambda 0.005 param.py:23; JAX :377-442)
def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """The reference's formula (model.py:783-805), summed over every entry:
    -((z - p)^g log(clip(p)) where z > 0, p^g log(clip(1 - p)) where z = 0),
    p the softmax of the logits, clipped to [1e-8, 1]."""
    p = torch.softmax(logits, dim=-1)
    pos = torch.where(target > 0, target - p, torch.zeros_like(p))
    neg = torch.where(target > 0, torch.zeros_like(p), p)
    ent = -(pos ** gamma * torch.log(torch.clamp(p, 1e-8, 1.0))
            + neg ** gamma * torch.log(torch.clamp(1.0 - p, 1e-8, 1.0)))
    return ent.sum()


def trained_tensors(model: ClairNet) -> list:
    """The tensors training moves, in state-dict order: every one of the
    JAX layout, so every one but the LSTMs' bias_hh (held at zero)."""
    return [v for k, v in model.state_dict(keep_vars=True).items() if ".bias_hh_" not in k]


def clair_loss(model: ClairNet, x: torch.Tensor, labels: torch.Tensor,
               task_weights=(1.0, 1.0, 1.0, 1.0), l2_lambda: float = 0.005,
               reference: bool = False) -> torch.Tensor:
    """JAX's `clair_loss` (:410-421): each head's focal loss against its
    slice of the one-hot labels (B, sum(head_sizes)), weighted and summed,
    plus l2_lambda times the sum of squares of every trained tensor.  Run it
    inside `full_f32()` on the card."""
    logits = model.logits(x, reference)
    parts = torch.split(labels, list(model.cfg.head_sizes), dim=1)
    loss = 0.0
    for w, name, tgt in zip(task_weights, HEAD_NAMES, parts):
        loss = loss + w * focal_loss(logits[name], tgt)
    l2 = sum((t ** 2).sum() for t in trained_tensors(model))
    return loss + l2_lambda * l2


def make_train_step(cfg: ClairConfig = ClairConfig(), device="cuda",
                    learning_rate: float = 1e-3):
    """(init, train_step) for Clair on one device ("cuda" unless the caller
    asks for "cpu"; raises without a card), as JAX's `make_train_step`
    (:424-442): optax's `adam` is `torch.optim.Adam` (b1 0.9, b2 0.999, eps
    1e-8, no decay).

    `init(params=None, opt_state=None)` -> (model, optimizer): a ClairNet on
    the device from a state dict (`init_params(cfg)` when None), every
    tensor of the JAX layout trained (bias_hh stays frozen at zero), and its
    Adam, restored from `opt_state` where given.
    `train_step(model, optimizer, x, labels, stats=None)` -> (model,
    optimizer, loss): one step in place inside `full_f32()`, the loss a
    detached scalar; with `stats`, a dict, each stage's seconds (waited
    for) added under forward, backward and optimizer."""
    dev = resolve_device(device)

    def init(params=None, opt_state=None):
        model = ClairNet(cfg)
        model.load_state_dict(init_params(cfg) if params is None else params)
        model = model.to(dev)
        for t in trained_tensors(model):
            t.requires_grad_(True)
        opt = torch.optim.Adam(trained_tensors(model), lr=learning_rate)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        return model, opt

    def train_step(model, opt, x, labels, stats=None):
        timer = StepTimer(stats, dev)
        opt.zero_grad(set_to_none=True)
        x = torch.as_tensor(x).to(dev)
        labels = torch.as_tensor(labels, dtype=_F32).to(dev)
        with full_f32():
            loss = clair_loss(model, x, labels)
            timer.lap("forward")
            loss.backward()
            timer.lap("backward")
            opt.step()
        timer.lap("optimizer")
        return model, opt, loss.detach()

    return init, train_step
