"""QuartzNet-style CTC basecaller (the nn-base workload) in PyTorch.

The port of genomicsbench_tpu/models/basecaller.py.  The architecture is
the reference bonito model's (benchmarks/nn-base/bonito/basecall.py:74-255
and models/bonito_dna_r941/config.toml): a stride-3 entry conv,
time-channel-separable conv blocks with BatchNorm, Swish and residual
connections, a wide final conv pair and a 1x1 decoder over the 5 CTC labels
"NACGT".

`Basecaller` computes the JAX package's `forward(..., train=False)`
(:158-186) in channels-last (B, T, C) layout with JAX's rounding points:
every conv input is bf16, every conv output bf16 accumulated in f32,
BatchNorm and Swish in f32 from the bf16 conv output.  The depthwise convs,
the BatchNorm/Swish/residual epilogues and the decoder head are the
kernels of ops/basecaller.py; the 1x1 pointwise and residual convs are
bf16 matrix products (cuBLAS with f32 reduction on the card) and the two
dense convs cuDNN convolutions, as the JAX package leaves them to XLA.  On
the CPU the products run in f32 on the bf16 values and round to bf16.

Weights: `init_params` (a deterministic init with JAX's std, drawn from a
torch.Generator: it cannot reproduce jax.random's threefry stream, so the
two packages' random models differ), `params_from_jax` (the JAX params
pytree as numpy leaves) and `import_torch_state_dict` (bonito's state dict)
each give the module's state dict.

Host pipeline, copied: `norm_by_noisiest_section`, `chunk_signal`,
`stitch_posteriors`, `decode_with_quals`, and the CTC beam search, whose
C++ (native/ctc.cpp) is the decoder and whose Python loop is the plain
version `beam_search_reference`.  `basecall_signals` and
`basecall_with_quals` batch full-size chunks across reads.

Training: `run_network(..., train=True)` is JAX's `forward(train=True)`:
every BatchNorm, the residual branch's included, on its batch statistics
(no running statistics are kept or updated, as JAX reads none back), the
weights under autograd, the depthwise convs and the epilogues through
`ops.depthwise_conv_train` and `ops.bn_act_train` (their backwards are
kernels too), the 1x1 and dense convs bf16 `torch.matmul` and cuDNN
`conv1d` under autograd, the decoder's bf16 logits cast to f32 and
`log_softmax`ed (:184-185; the head kernel writes float16 and stays the
inference path).  `ctc_loss` is JAX's (:188-199) on `F.ctc_loss`;
models/train.py has the trainer and the checkpoints.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch import nn

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.ops import basecaller as ops

CTC_LABELS = "NACGT"  # blank = 0 (basecall.py Decoder log_softmax over 5)
_BF16, _F32, _F16 = torch.bfloat16, torch.float32, torch.float16


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    repeat: int
    filters: int
    kernel: int
    stride: int = 1
    separable: bool = True
    residual: bool = True


@dataclasses.dataclass(frozen=True)
class BasecallerConfig:
    """Defaults mirror models/bonito_dna_r941/config.toml."""

    features_in: int = 1
    blocks: tuple = (
        BlockCfg(1, 344, 9, stride=3, separable=False, residual=False),  # C1
        BlockCfg(2, 424, 115),
        BlockCfg(7, 464, 5),
        BlockCfg(4, 456, 123),
        BlockCfg(9, 440, 9),
        BlockCfg(6, 280, 31),
        BlockCfg(1, 384, 67, separable=True, residual=False),            # C2
        BlockCfg(1, 48, 15, separable=False, residual=False),            # C3
    )
    num_labels: int = len(CTC_LABELS)

    @staticmethod
    def tiny():
        """Small config for tests/dry-runs."""
        return BasecallerConfig(
            blocks=(
                BlockCfg(1, 64, 9, stride=3, separable=False, residual=False),
                BlockCfg(2, 64, 11),
                BlockCfg(2, 128, 13),
                BlockCfg(1, 128, 15, separable=True, residual=False),
                BlockCfg(1, 64, 7, separable=False, residual=False),
            )
        )


def model_stride(cfg: BasecallerConfig) -> int:
    s = 1
    for b in cfg.blocks:
        s *= b.stride
    return s


# ---------------------------------------------------------------- the network
class BatchNorm(nn.Module):
    """A BatchNorm's four vectors, named as the JAX package's dict: scale and
    bias parameters (trained), mean and var buffers (eval mode's running
    statistics, which training leaves to the optimizer's decay alone)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def rows(self) -> torch.Tensor:
        return ops.bn_params(self.scale, self.bias, self.mean, self.var)


def _weights(shapes):
    return nn.ParameterList([nn.Parameter(torch.zeros(s), requires_grad=False) for s in shapes])


class Block(nn.Module):
    """One config block: per repeat a depthwise (k, C) and a pointwise
    (C, F) weight, or a dense (k, C, F) one, and a BatchNorm; a residual
    block also has its 1x1 conv (Cin, F) and BatchNorm."""

    def __init__(self, cin: int, b: BlockCfg):
        super().__init__()
        self.cfg = b
        chans = [cin] + [b.filters] * (b.repeat - 1)
        if b.separable:
            self.depth = _weights([(b.kernel, c) for c in chans])
            self.point = _weights([(c, b.filters) for c in chans])
        else:
            self.full = _weights([(b.kernel, c, b.filters) for c in chans])
        self.bns = nn.ModuleList([BatchNorm(b.filters) for _ in chans])
        if b.residual:
            self.res_conv = nn.Parameter(torch.zeros(cin, b.filters), requires_grad=False)
            self.res_bn = BatchNorm(b.filters)


class Basecaller(nn.Module):
    """The basecaller's inference network.  `forward(x)`: x (B, T) raw
    signal or (B, T, C) -> (B, T', num_labels) log-probs in `out_dtype`,
    through the kernels on CUDA tensors (float16 log-probs only) and their
    plain versions on CPU tensors (float32, as the JAX package's `forward`,
    or float16)."""

    def __init__(self, cfg: BasecallerConfig = BasecallerConfig()):
        super().__init__()
        self.cfg = cfg
        blocks, cin = [], cfg.features_in
        for b in cfg.blocks:
            blocks.append(Block(cin, b))
            cin = b.filters
        self.blocks = nn.ModuleList(blocks)
        self.decoder = nn.Parameter(torch.zeros(cin, cfg.num_labels), requires_grad=False)

    def prepare(self, train: bool = False) -> dict:
        """The weights as the passes take them: bf16 conv weights (JAX's
        `w.astype(x.dtype)`), dense ones in conv1d's (F, C, k) layout, each
        BatchNorm's (3, C) rows.  One set serves every batch of a call.
        With `train`, casts under autograd of the parameters themselves: the
        depthwise taps stay f32 (`ops.depthwise_conv_train` casts them) and
        each BatchNorm is its (scale, bias) parameters, its statistics the
        batch's."""
        with torch.set_grad_enabled(train):
            return self._prepare(train)

    def _prepare(self, train: bool) -> dict:
        blocks = []
        for blk in self.blocks:
            b = blk.cfg
            units = []
            for r in range(b.repeat):
                bn = blk.bns[r]
                u = dict(bn=(bn.scale, bn.bias) if train else bn.rows())
                if b.separable:
                    u["depth"] = blk.depth[r] if train else blk.depth[r].to(_BF16).contiguous()
                    u["point"] = blk.point[r].to(_BF16).contiguous()
                else:
                    u["full"] = blk.full[r].permute(2, 1, 0).to(_BF16).contiguous()
                units.append(u)
            res = None
            if b.residual:
                rbn = blk.res_bn
                res = (blk.res_conv.to(_BF16).contiguous(),
                       (rbn.scale, rbn.bias) if train else rbn.rows())
            blocks.append((b, units, res))
        return dict(blocks=blocks, decoder=self.decoder.to(_BF16).contiguous(), train=train)

    def forward(self, x: torch.Tensor, out_dtype=_F32) -> torch.Tensor:
        return run_network(self.prepare(), x, out_dtype)


@contextlib.contextmanager
def f32_reduction(dev: torch.device):
    """cuBLAS reduces bf16 products in f32, as XLA does, while inside: the
    forward, and a train step's forward and backward, run in it."""
    if dev.type != "cuda":
        yield
        return
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved


def _pointwise(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv: (B, T, C) bf16 by (C, F) bf16, f32 sums, bf16 out."""
    if x.device.type == "cuda":
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(_BF16)


def _dense(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """A dense conv with padding k // 2: (B, T, C) bf16 by (F, C, k) bf16,
    f32 sums, (B, T', F) bf16 out."""
    k = w.shape[2]
    xt = x.transpose(1, 2)
    if x.device.type == "cuda":
        y = torch.nn.functional.conv1d(xt, w, stride=stride, padding=k // 2)
    else:
        y = torch.nn.functional.conv1d(xt.float(), w.float(), stride=stride,
                                       padding=k // 2).to(_BF16)
    return y.transpose(1, 2).contiguous()


def _train_passes(reference: bool, group=None):
    """The depthwise conv and the epilogue in train mode: the autograd
    Functions, on the kernels or (reference) the plain versions; the
    epilogue's statistics over `group`'s ranks where given."""
    def depthwise(x, w, stride):
        return ops.depthwise_conv_train(x, w, stride, reference)

    def epilogue(y, bn, res=None, res_bn=(None, None)):
        return ops.bn_act_train(y, *bn, res, *res_bn, reference=reference, group=group)

    return depthwise, epilogue


def run_block(entry, x: torch.Tensor, reference: bool = False,
              train: bool = False, group=None) -> torch.Tensor:
    """One config block of `prepare(train)["blocks"]` on x (B, T, C) bf16:
    the JAX package's `forward` loop body (:166-183), its output bf16 (every
    consumer casts the f32 activation to bf16 first).  `train` takes the
    batch statistics (over `group`'s ranks, an `ops.BatchGroup`, where
    given) and keeps the graph for autograd."""
    if train:
        depthwise, epilogue = _train_passes(reference, group)
    elif reference:
        depthwise, epilogue = ops.depthwise_conv_reference, ops.bn_act_reference
    else:
        depthwise, epilogue = ops.depthwise_conv, ops.bn_act
    b, units, res = entry
    inp = x
    for r, u in enumerate(units):
        stride = b.stride if r == 0 else 1
        if b.separable:
            y = _pointwise(depthwise(x, u["depth"], stride), u["point"])
        else:
            y = _dense(x, u["full"], stride)
        if res is not None and r == b.repeat - 1:
            x = epilogue(y, u["bn"], _pointwise(inp, res[0]), res[1])
        else:
            x = epilogue(y, u["bn"])
    return x


def run_network(prep: dict, x: torch.Tensor, out_dtype=_F32, reference: bool = False,
                train: bool = False, group=None):
    """The forward pass over `prepare(train)`'s weights: x (B, T) or (B, T,
    C) -> (B, T', L) log-probs in out_dtype.  reference=True takes the plain
    versions of the kernels on any device (the card's check of the kernels).
    train=True is JAX's `forward(train=True)` under autograd: batch
    statistics, and the decoder's bf16 logits cast to f32 and
    `log_softmax`ed by torch (float32 log-probs; out_dtype is not read).  Its
    backward runs outside this call: `f32_reduction` keeps cuBLAS's bf16
    sums in f32 there too.  `group`, an `ops.BatchGroup`: train mode's
    statistics over every rank's rows (the data-parallel step)."""
    if train and not prep.get("train"):
        raise ValueError("train mode needs prepare(train=True)'s weights")
    if x.dim() == 2:
        x = x[:, :, None]
    x = x.to(_BF16).contiguous()
    with f32_reduction(x.device):
        for entry in prep["blocks"]:
            x = run_block(entry, x, reference, train, group)
        if train:
            return torch.log_softmax(_pointwise(x, prep["decoder"]).float(), dim=-1)
        head = ops.decoder_head_reference if reference else ops.decoder_head
        return head(x, prep["decoder"], out_dtype)


def ctc_loss_from_logp(logp: torch.Tensor, labels: torch.Tensor,
                       label_lens: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of the per-sequence CTC loss of (B, T', L)
    f32 log-probs: blank 0, every frame used, labels (B, S) with 0 padding
    past `label_lens`.  JAX takes the mean of optax's per-sequence losses
    (:198-199); `reduction="mean"` would divide by the label lengths first.
    An impossible alignment (more labels, with their repeats' blanks, than
    frames) gives inf, where optax floors it at log_epsilon and returns a
    large finite loss."""
    B, T, _ = logp.shape
    lens = torch.as_tensor(label_lens, device=logp.device).long()
    frames = torch.full((B,), T, dtype=torch.long, device=logp.device)
    per_seq = torch.nn.functional.ctc_loss(
        logp.transpose(0, 1), torch.as_tensor(labels, device=logp.device).long(), frames, lens,
        blank=0, reduction="none", zero_infinity=False)
    return per_seq.mean()


def ctc_loss(model: "Basecaller", signal, labels, label_lens, reference: bool = False,
             group=None):
    """JAX's `ctc_loss(params, signal, labels, label_lens, cfg, train=True)`
    (:188-199): the train-mode forward of `model` on signal (B, T) or (B,
    T, C), then `ctc_loss_from_logp`.  A scalar tensor under autograd.
    `group`, an `ops.BatchGroup`: the BatchNorm statistics over its ranks'
    rows (the loss stays the mean over this rank's rows)."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(signal, dtype=_F32).to(dev)
    logp = run_network(model.prepare(train=True), x, train=True, reference=reference,
                       group=group)
    return ctc_loss_from_logp(logp, labels, label_lens)


# ------------------------------------------------------------------ weights
def _state_template(cfg: BasecallerConfig) -> dict:
    return Basecaller(cfg).state_dict()


def init_params(cfg: BasecallerConfig = BasecallerConfig(),
                generator: torch.Generator | None = None) -> dict:
    """A deterministic random state: every conv weight normal with JAX's
    std sqrt(2 / (k * cin)) (`_conv_init`, :72-76), drawn in the JAX
    package's order from `generator` (seeded 0 when None), BatchNorm at
    identity.  The values differ from JAX `init_params(key(0))`'s."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def draw(k, cin, shape):
        return torch.randn(shape, generator=generator, dtype=_F32) * (2.0 / (k * cin)) ** 0.5

    state = _state_template(cfg)
    cin = cfg.features_in
    for i, b in enumerate(cfg.blocks):
        c = cin
        for r in range(b.repeat):
            if b.separable:
                state[f"blocks.{i}.depth.{r}"] = draw(b.kernel, 1, (b.kernel, c))
                state[f"blocks.{i}.point.{r}"] = draw(1, c, (c, b.filters))
            else:
                state[f"blocks.{i}.full.{r}"] = draw(b.kernel, c, (b.kernel, c, b.filters))
            c = b.filters
        if b.residual:
            state[f"blocks.{i}.res_conv"] = draw(1, cin, (cin, b.filters))
        cin = b.filters
    state["decoder"] = draw(1, cin, (cin, cfg.num_labels))
    return state


def _bn_state(prefix, bn: dict) -> dict:
    return {f"{prefix}.{name}": torch.as_tensor(np.asarray(bn[name], np.float32))
            for name in ("scale", "bias", "mean", "var")}


def params_from_jax(tree: dict, cfg: BasecallerConfig = BasecallerConfig()) -> dict:
    """The state dict of the JAX params pytree `tree`, every leaf a numpy
    array: conv weights in JAX's (k, Cin/groups, Cout) layout, BatchNorms
    as dicts of scale, bias, mean, var.  Shapes are checked against cfg."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    state = {}
    for i, block in enumerate(tree["blocks"]):
        for r, conv in enumerate(block["convs"]):
            if "depth" in conv:
                state[f"blocks.{i}.depth.{r}"] = t(conv["depth"])[:, 0, :]
                state[f"blocks.{i}.point.{r}"] = t(conv["point"])[0]
            else:
                state[f"blocks.{i}.full.{r}"] = t(conv["full"])
            state.update(_bn_state(f"blocks.{i}.bns.{r}", block["bns"][r]))
        if "res_conv" in block:
            state[f"blocks.{i}.res_conv"] = t(block["res_conv"])[0]
            state.update(_bn_state(f"blocks.{i}.res_bn", block["res_bn"]))
    state["decoder"] = t(tree["decoder"])[0]
    _check_state(state, cfg)
    return state


def _check_state(state: dict, cfg: BasecallerConfig) -> None:
    want = _state_template(cfg)
    if set(state) != set(want):
        raise ValueError(f"state keys differ from the config's: missing "
                         f"{sorted(set(want) - set(state))[:4]}, extra "
                         f"{sorted(set(state) - set(want))[:4]}")
    for name, w in want.items():
        if tuple(state[name].shape) != tuple(w.shape):
            raise ValueError(f"{name}: shape {tuple(state[name].shape)} != expected "
                             f"{tuple(w.shape)}")


def import_torch_state_dict(state, cfg: BasecallerConfig = BasecallerConfig()) -> dict:
    """The state dict of an ordered torch-style (bonito) state dict.

    Expected tensor order (registration order of the reference model,
    basecall.py:74-255): per block, per repeat -> conv weight(s)
    (depthwise then pointwise for separable convs), then BN
    weight/bias/running_mean/running_var; residual 1x1 conv + BN after a
    block's repeats; decoder conv last.  'num_batches_tracked' entries
    are ignored.  Shapes are validated against the config: a wrong shape
    or leftover tensors raise ValueError, as in the JAX package; so does a
    state dict that runs short (JAX lets StopIteration escape there), naming
    the missing tensor."""
    tensors = [(k, v) for k, v in state.items() if "num_batches_tracked" not in k]
    it = iter(tensors)
    out = {}

    def take(what, shape):
        try:
            _, v = next(it)
        except StopIteration:
            raise ValueError(f"state dict ends before {what} {tuple(shape)}") from None
        v = v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"shape {tuple(v.shape)} != expected {tuple(shape)}")
        return v.to(_F32)

    def take_bn(prefix, c):
        for name in ("scale", "bias", "mean", "var"):
            out[f"{prefix}.{name}"] = take(f"{prefix}.{name}", (c,))

    cin = cfg.features_in
    for i, b in enumerate(cfg.blocks):
        c = cin
        for r in range(b.repeat):
            if b.separable:
                out[f"blocks.{i}.depth.{r}"] = take(
                    f"block {i} repeat {r} depthwise conv", (c, 1, b.kernel))[:, 0, :].T
                out[f"blocks.{i}.point.{r}"] = take(
                    f"block {i} repeat {r} pointwise conv", (b.filters, c, 1))[:, :, 0].T
            else:
                out[f"blocks.{i}.full.{r}"] = take(
                    f"block {i} repeat {r} conv", (b.filters, c, b.kernel)).permute(2, 1, 0)
            take_bn(f"blocks.{i}.bns.{r}", b.filters)
            c = b.filters
        if b.residual:
            out[f"blocks.{i}.res_conv"] = take(f"block {i} residual conv",
                                               (b.filters, cin, 1))[:, :, 0].T
            take_bn(f"blocks.{i}.res_bn", b.filters)
        cin = b.filters
    out["decoder"] = take("decoder conv", (cfg.num_labels, cin, 1))[:, :, 0].T
    leftover = sum(1 for _ in it)
    if leftover:
        raise ValueError(f"{leftover} unconsumed tensors in state dict")
    return {k: v.contiguous() for k, v in out.items()}


def build_model(params, cfg: BasecallerConfig | None = None, device="cuda") -> Basecaller:
    """A Basecaller on `device` from a state dict (or a Basecaller, moved)."""
    dev = resolve_device(device)
    if isinstance(params, Basecaller):
        return params.to(dev)
    cfg = cfg or BasecallerConfig()
    _check_state(params, cfg)
    model = Basecaller(cfg)
    model.load_state_dict(params)
    return model.to(dev).eval()


# ------------------------------------------------------------------ decoders
def greedy_decode(logp: torch.Tensor):
    """CTC greedy decode: argmax, collapse repeats, drop blanks.  logp
    (B, T, L).  Returns (B, T) int32 label codes with -1 padding and (B,)
    int32 lengths."""
    ids = logp.argmax(-1)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != 0) & (ids != prev)
    pos = torch.cumsum(keep.long(), 1) - 1
    out = torch.full(ids.shape, -1, dtype=torch.int32, device=ids.device)
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    out[rows[keep], pos[keep]] = ids[keep].int()
    return out, keep.sum(1).int()


def beam_search_reference(probs, beamsize=5, threshold=1e-3):
    """The plain version of the CTC prefix beam search: the JAX package's
    Python loop (models/basecaller.py:305-343), in float64 as the C++
    decoder sums (numpy 2 would keep the JAX loop's products of float32
    frames in float32).  Returns the decoded string."""
    probs = np.asarray(probs, np.float64)
    T, L = probs.shape
    active = np.nonzero(probs[:, 1:].max(axis=1, initial=0.0) >= threshold)[0]
    beams = {(): (1.0, 0.0)}  # prefix -> (p_blank, p_nonblank)
    prev_t = 0
    for t in active:
        if t > prev_t:  # collapse the blank-only run [prev_t, t)
            beams = {p: (pb + pnb, 0.0) for p, (pb, pnb) in beams.items()}
        frame = [float(v) for v in probs[t]]
        nxt: dict = {}

        def add(prefix, pb, pnb):
            b, nb = nxt.get(prefix, (0.0, 0.0))
            nxt[prefix] = (b + pb, nb + pnb)

        for prefix, (pb, pnb) in beams.items():
            p_tot = pb + pnb
            add(prefix, frame[0] * p_tot, 0.0)  # blank
            for s in range(1, L):
                p = frame[s]
                if p < threshold:
                    continue
                if prefix and prefix[-1] == s:
                    add(prefix, 0.0, p * pnb)  # repeat absorbed (collapse)
                    add(prefix + (s,), 0.0, p * pb)  # new copy needs a blank gap
                else:
                    add(prefix + (s,), 0.0, p * p_tot)
        top = sorted(nxt.items(), key=lambda kv: kv[1][0] + kv[1][1],
                     reverse=True)[:beamsize]
        norm = 1.0 / max(top[0][1][0] + top[0][1][1], 1e-300)
        beams = {p: (pb * norm, pnb * norm) for p, (pb, pnb) in top}
        prev_t = t + 1
    best = max(beams.items(), key=lambda kv: kv[1][0] + kv[1][1])[0]
    return "".join(CTC_LABELS[s] for s in best)


def beam_search_decode(probs, beamsize=5, threshold=1e-3):
    """CTC prefix beam search over (T, L) posteriors by the host library's
    C++ decoder (native/ctc.cpp): the decoded string."""
    from genomicsbench_tpu_torch import native

    ids = native.ctc_beam_search(probs, beamsize, threshold)
    return "".join(CTC_LABELS[int(s)] for s in ids)


def decode_with_quals(probs, qscale: float = 1.0, qbias: float = 0.0):
    """Viterbi-style greedy decode with per-base phred qualities
    (basecall.py:100-106 viterbi_search(qscores=True) semantics: emitted
    base quality = phred of its posterior at the emitting frame, scaled
    by qscale/qbias).  probs: (T, L) posteriors.  Returns (seq, qstring)."""
    ids = np.argmax(probs, axis=-1)
    prev = np.concatenate([[-1], ids[:-1]])
    keep = (ids != 0) & (ids != prev)
    frames = np.nonzero(keep)[0]
    seq = "".join(CTC_LABELS[i] for i in ids[frames])
    p = probs[frames, ids[frames]]
    q = -10.0 * np.log10(np.clip(1.0 - p, 1e-5, 1.0)) * qscale + qbias
    q = np.clip(q, 0, 60).astype(np.int32)
    qstring = "".join(chr(33 + int(v)) for v in q)
    return seq, qstring


# ------------------------------------------------------- host signal pipeline
def med_mad(x, factor=1.4826):
    """Median and scaled median absolute deviation (basecall.py:391-397).
    A constant signal has MAD 0, and the normalised signal is then NaN or
    infinite, as in the JAX package."""
    med = np.median(x)
    mad = np.median(np.abs(x - med)) * factor
    return med, mad


def norm_by_noisiest_section(signal, samples=100, threshold=6.0):
    """Normalise by med/MAD of the longest continuous high-noise region
    (basecall.py:367-388: the longest run of 1s of the windows' noise
    mask, first of the longest on ties)."""
    signal = np.asarray(signal, np.float32)
    thr = signal.std() / threshold
    n_win = signal.shape[0] // samples
    noise = np.ones(signal.shape, np.int8)
    if n_win:
        wstd = signal[: n_win * samples].reshape(n_win, samples).std(axis=1)
        noise[: n_win * samples] = np.repeat((wstd > thr).astype(np.int8), samples)
    noise[0] = 0
    noise[-1] = 0
    d = np.diff(noise)
    starts = np.nonzero(d == 1)[0] + 1   # noise[0] == 0: every run has a start
    ends = np.nonzero(d == -1)[0] + 1    # noise[-1] == 0: ... and an end
    if len(starts):
        i = int(np.argmax(ends - starts))
        best_len, best_l = int(ends[i] - starts[i]), int(starts[i])
    else:
        best_len, best_l = 0, 0
    if best_len:
        med, mad = med_mad(signal[best_l - 1 : best_l + best_len + 1])
    else:
        med, mad = med_mad(signal)
    return (signal - med) / mad


def chunk_signal(raw, chunksize, overlap):
    """Overlapping chunks (basecall.py:295-304): stride = chunksize -
    overlap, zero-padded tail.  Returns (num_chunks, chunksize); a read of
    at most chunksize samples is one chunk of its own length.  As in the
    JAX package, the windows are the first (len(tmp) - chunksize) // stride
    + 1 of the padded signal, so a read's last samples can fall outside
    every chunk."""
    raw = np.asarray(raw, np.float32)
    if chunksize <= 0 or raw.shape[0] <= chunksize:
        return raw[None, :]
    stride = chunksize - overlap
    num_chunks = raw.shape[0] // stride + 1
    tmp = np.zeros(num_chunks * stride, np.float32)
    tmp[: raw.shape[0]] = raw
    n = (len(tmp) - chunksize) // stride + 1
    return np.lib.stride_tricks.sliding_window_view(tmp, chunksize)[::stride][:n]


def stitch_posteriors(preds, overlap):
    """basecall.py:307-316: trim `overlap` frames from interior chunk
    boundaries and concatenate.  preds: (n_chunks, T', L)."""
    if preds.shape[0] == 1:
        return preds[0]
    parts = [preds[0, :-overlap]]
    parts += [p[overlap:-overlap] for p in preds[1:-1]]
    parts.append(preds[-1][overlap:])
    return np.concatenate(parts)


def _batched_posteriors(model, signals, chunksize, overlap, batch_size, normalize,
                        stats=None):
    """Normalise and chunk every read, run the forward over the flat chunk
    stream, return per-read (posteriors, signal length).

    Full-size chunks batch across reads, `batch_size` to a batch; reads
    shorter than a chunk run at their natural length, grouped by length.
    On the card every batch is uploaded from a page-locked buffer and
    launched before any is fetched; each batch's float16 log-probs come
    back through one page-locked buffer behind an event, and `exp` runs on
    the host.  With `stats`, a dict, each stage is waited for and its
    seconds added under normalize, upload, forward and fetch (a slower
    run, for the split)."""
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"

    def mark(name, t0):
        if stats is not None:
            if cuda:
                torch.cuda.synchronize(dev)
            stats[name] = stats.get(name, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    sigs, all_chunks = [], []
    for raw in signals:
        sig = norm_by_noisiest_section(raw) if normalize else np.asarray(raw, np.float32)
        sigs.append(sig)
        all_chunks.append(chunk_signal(sig, chunksize, overlap))
    t0 = mark("normalize", t0)
    if not sigs:
        return []
    prep = model.prepare()
    futs = []  # (read indices, log-probs on the host, event, page-locked input)

    def dispatch(rows, ridxs):
        nonlocal t0
        host = torch.from_numpy(np.stack(rows))
        if cuda:
            staged = torch.empty(host.shape, dtype=_BF16, pin_memory=True)
            staged.copy_(host)      # the first conv's bf16 cast, on the host
            x = staged.to(dev, non_blocking=True)
        else:
            staged, x = None, host.to(_BF16)
        t0 = mark("upload", t0)
        lp = run_network(prep, x, _F16)
        t0 = mark("forward", t0)
        if cuda:
            out = torch.empty(lp.shape, dtype=_F16, pin_memory=True)
            out.copy_(lp, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out, done = lp, None
        t0 = mark("fetch", t0)
        futs.append((ridxs, out, done, staged))

    pend_rows, pend_ridx = [], []
    short_groups: dict = {}
    for i, chunks in enumerate(all_chunks):
        if chunks.shape[1] < chunksize:
            short_groups.setdefault(chunks.shape[1], []).append(i)
            continue
        for c in chunks:
            pend_rows.append(c)
            pend_ridx.append(i)
            if len(pend_rows) == batch_size:
                dispatch(pend_rows, pend_ridx)
                pend_rows, pend_ridx = [], []
    if pend_rows:
        dispatch(pend_rows, pend_ridx)
    for _, idxs in sorted(short_groups.items()):
        for s in range(0, len(idxs), batch_size):
            part = idxs[s : s + batch_size]
            dispatch([all_chunks[i][0] for i in part], part)

    per_read: dict = collections.defaultdict(list)
    t0 = time.perf_counter()
    for ridxs, out, done, _ in futs:  # all launched above; fetch here
        if done is not None:
            done.synchronize()
        lp = np.exp(out.numpy().astype(np.float32))
        for j, i in enumerate(ridxs):
            per_read[i].append(lp[j])
    mark("fetch", t0)
    return [(np.stack(per_read[i]), len(sigs[i])) for i in range(len(sigs))]


def basecall_signals(params, signals, cfg: BasecallerConfig | None = None, chunksize=6000,
                     overlap=300, beamsize=5, batch_size=64, normalize=True, device="cuda",
                     stats=None):
    """Full nn-base loop (basecall.py:580-627): per read normalise, chunk,
    batched forward, stitch (overlap // stride // 2 frames), decode by beam
    search (beamsize > 1) or greedily.  params: a state dict or a
    Basecaller.  Returns the base strings.  With `stats`, a dict, the split
    of `_batched_posteriors` plus the host's stitch and decode seconds."""
    model = build_model(params, cfg, device)
    stride = model_stride(model.cfg)
    out = []
    posts = _batched_posteriors(model, signals, chunksize, overlap, batch_size, normalize,
                                stats)
    t_stitch = t_decode = 0.0
    for p, sig_len in posts:
        t0 = time.perf_counter()
        stitched = stitch_posteriors(p, overlap // stride // 2)[: sig_len // stride]
        t1 = time.perf_counter()
        if beamsize > 1:
            out.append(beam_search_decode(stitched, beamsize))
        else:
            ids, n = greedy_decode(torch.log(torch.from_numpy(stitched + 1e-9))[None])
            out.append("".join(CTC_LABELS[i] for i in ids[0, : int(n[0])].tolist()))
        t_stitch += t1 - t0
        t_decode += time.perf_counter() - t1
    if stats is not None:
        stats["stitch"] = stats.get("stitch", 0.0) + t_stitch
        stats["decode"] = stats.get("decode", 0.0) + t_decode
    return out


def basecall_with_quals(params, signals, cfg: BasecallerConfig | None = None,
                        chunksize=6000, overlap=300, batch_size=64, normalize=True,
                        device="cuda"):
    """Greedy basecalls + phred qstrings per read (the reference's
    beamsize==1 / qscores path)."""
    model = build_model(params, cfg, device)
    stride = model_stride(model.cfg)
    out = []
    for posts, sig_len in _batched_posteriors(model, signals, chunksize, overlap,
                                              batch_size, normalize):
        stitched = stitch_posteriors(posts, overlap // stride // 2)
        out.append(decode_with_quals(stitched[: sig_len // stride]))
    return out
