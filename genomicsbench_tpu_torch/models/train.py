"""The basecaller's CTC train step and the checkpoints, on one card or
data-parallel over a mesh.

The port of genomicsbench_tpu/models/train.py: `make_train_step` (:33-56),
`param_spec` (:21-30), `place_params` (:59-74) and `save_checkpoint` /
`load_checkpoint` (:86-111).  The mesh's "data" axis is ported: each rank
trains on its block of the batch, the BatchNorm statistics are over the
whole batch (`ops.BatchGroup`), and the gradients are averaged over the
ranks in one flat all_reduce before AdamW, as GSPMD's psum does for JAX.
The "model" axis (conv channels split across ranks) is not: `param_spec`
says what it would split, and `place_params` raises NotImplementedError
for a mesh with model > 1 (ROADMAP queue 1: model and sequence sharding).

The step is JAX's `value_and_grad(ctc_loss)` and `optax.adamw(1e-3)`:
the train-mode forward (models/basecaller.py `run_network(train=True)`,
its depthwise convs and epilogues on hand-written kernels forward and
backward on the card), `F.ctc_loss`, autograd, then `torch.optim.AdamW`
with optax's settings, b1 0.9, b2 0.999, eps 1e-8 and weight decay 1e-4
(torch's default decay is 1e-2).  optax decays every leaf of the tree,
the BatchNorm `mean` and `var` among them: they get zero gradients in
train mode, so each step leaves them only the decoupled decay, a factor
1 - lr * 1e-4.  The port copies that: the optimizer holds the BatchNorm
buffers too, each step with a zero gradient.

Checkpoints are `torch.save` files of {"params": state dict, "step": int,
"opt_state": the optimizer's state dict}, read back by `torch.load(...,
weights_only=True)`.  Orbax's format needs orbax, so the two packages'
checkpoint files are not interchangeable; weights cross between them
through `params_from_jax`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch import nn

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.models import StepTimer
from genomicsbench_tpu_torch.models import basecaller as bc
from genomicsbench_tpu_torch.ops.basecaller import BatchGroup
from genomicsbench_tpu_torch.parallel.mesh import row_bounds

ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)   # optax.adamw's defaults


def optimized_tensors(model: nn.Module) -> list:
    """The basecaller's tensors the optimizer holds, in state-dict order:
    every parameter and the BatchNorm buffers, as JAX's tree has them all
    as leaves."""
    return list(model.state_dict(keep_vars=True).values())


def param_spec(state: dict, model_size: int = 1) -> dict:
    """JAX's sharding rule (:21-30) on the port's state-dict names and
    layouts: {name: spec}, a spec a tuple of one axis name or None per
    dimension, () for a replicated tensor.  Conv weights (depth (k, C),
    point and res_conv (C, F), full (k, C, F), decoder (C, L); JAX's
    (k, Cin, Cout) leaves) split their output channel, the last dimension,
    over "model" where it divides by model_size; the BatchNorm vectors
    replicate."""
    def spec(t):
        if t.dim() >= 2 and t.shape[-1] % model_size == 0:
            return (None,) * (t.dim() - 1) + ("model",)
        return ()
    return {name: spec(t) for name, t in state.items()}


def place_params(model: nn.Module, optimizer, mesh):
    """Every rank's model and optimizer state made equal to data rank 0's,
    by broadcasts over the mesh's "data" axis.  Returns (model, optimizer).
    A mesh with model > 1 raises NotImplementedError: splitting the conv
    channels over "model" is ROADMAP queue 1's next slice."""
    if mesh.model > 1:
        raise NotImplementedError("the 'model' axis (conv channels split over ranks, "
                                  "param_spec) is not ported: ROADMAP queue 1, model and "
                                  "sequence sharding")
    src = dist.get_global_rank(mesh.data_group, 0)
    tensors = [t.data for t in model.state_dict(keep_vars=True).values()]
    for st in optimizer.state.values():
        tensors += [v for v in st.values() if torch.is_tensor(v)]
    for t in tensors:
        moved = t.to(mesh.device)
        dist.broadcast(moved, src=src, group=mesh.data_group)
        if moved is not t:
            t.copy_(moved)
    return model, optimizer


def make_train_step(cfg: bc.BasecallerConfig = bc.BasecallerConfig(), device="cuda",
                    learning_rate: float = 1e-3, mesh=None):
    """(init, train_step) for the basecaller on one device ("cuda" unless
    the caller asks for "cpu"; raises without a card), or data-parallel
    over `mesh`'s "data" axis on the mesh's device (`device` is then not
    read).

    `init(params=None, opt_state=None)` -> (model, optimizer): a Basecaller
    on the device from a state dict (`init_params(cfg)` when None), its
    weights trained, and its AdamW, restored from `opt_state` (an optimizer
    state dict, as `load_checkpoint` gives it) where given.
    `train_step(model, optimizer, signal, labels, label_lens, stats=None)`
    -> (model, optimizer, loss): one step in place, the loss a detached
    scalar tensor; signal (B, T) f32, labels (B, S) with 0 padding,
    label_lens (B,).  With `stats`, a dict, each stage is waited for and its
    seconds added under forward, loss, backward and optimizer.

    With `mesh`: every rank calls train_step with the same global batch, B
    a multiple of the "data" axis (ValueError); each rank trains on its
    block of rows, the BatchNorm statistics over every rank's rows; the
    gradients and the loss are averaged over the ranks in one flat
    all_reduce before AdamW, so every rank takes the same step and returns
    the global batch's mean loss.  `init` broadcasts data rank 0's state
    (`place_params`).  With `stats` the collectives' seconds are added too,
    under "bn forward all_reduce", "bn backward all_reduce" (inside the
    forward's and the backward's) and "gradient all_reduce"."""
    dev = mesh.device if mesh is not None else resolve_device(device)

    def init(params=None, opt_state=None):
        state = bc.init_params(cfg) if params is None else params
        bc._check_state(state, cfg)
        model = bc.Basecaller(cfg)
        model.load_state_dict(state)
        model = model.to(dev).train().requires_grad_(True)
        opt = torch.optim.AdamW(optimized_tensors(model), lr=learning_rate, **ADAMW)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        if mesh is not None:
            place_params(model, opt, mesh)
        return model, opt

    def train_step(model, opt, signal, labels, label_lens, stats=None):
        timer = StepTimer(stats, dev)
        opt.zero_grad(set_to_none=True)
        group = None
        if mesh is not None:
            lo, hi = row_bounds(mesh, len(signal))
            signal, labels, label_lens = signal[lo:hi], labels[lo:hi], label_lens[lo:hi]
            group = BatchGroup(mesh.data_group, stats)
        x = torch.as_tensor(signal, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        label_lens = torch.as_tensor(label_lens).to(dev)
        with bc.f32_reduction(dev):
            logp = bc.run_network(model.prepare(train=True), x, train=True, group=group)
            timer.lap("forward")
            loss = bc.ctc_loss_from_logp(logp, labels, label_lens)
            timer.lap("loss")
            loss.backward()
        timer.lap("backward")
        loss = loss.detach()
        if mesh is not None:
            loss = _average_grads(model, loss, mesh)
            timer.lap("gradient all_reduce")
        for t in optimized_tensors(model):
            if t.grad is None:          # the BatchNorm statistics: decay alone
                t.grad = torch.zeros_like(t)
        opt.step()
        timer.lap("optimizer")
        return model, opt, loss

    return init, train_step


def _average_grads(model: nn.Module, loss: torch.Tensor, mesh) -> torch.Tensor:
    """Every trained tensor's gradient, and the loss, averaged over the
    mesh's "data" axis in one all_reduce of one flat f32 buffer; returns the
    averaged loss."""
    grads = [t.grad for t in optimized_tensors(model) if t.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).float()])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.data
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[off].to(loss.dtype)


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------
def _state(obj) -> dict:
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def save_checkpoint(path, params, opt_state=None, step: int = 0, mesh=None) -> None:
    """Write (params[, opt_state], step) to the file `path` with torch.save:
    params a module or a state dict (copied to the CPU), opt_state an
    optimizer or its state dict.  Written to a temporary file and moved
    into place, so a reader never sees half a checkpoint.  With `mesh`
    (every rank calls it), data rank 0 writes and every rank of the "data"
    axis waits at a barrier until the file is in place."""
    if mesh is not None:
        if mesh.data_rank == 0:
            save_checkpoint(path, params, opt_state, step)
        dist.barrier(group=mesh.data_group)
        return
    payload = {"params": {k: v.detach().cpu() for k, v in _state(params).items()},
               "step": int(step)}
    if opt_state is not None:
        payload["opt_state"] = _state(opt_state)
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path) -> dict:
    """The saved dict: "params" (a state dict on the CPU), "step" and, where
    saved, "opt_state"; read with weights_only=True."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
