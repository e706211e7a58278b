"""The basecaller's CTC train step and the checkpoints, one card.

The port of genomicsbench_tpu/models/train.py without the mesh:
`make_train_step` (:33-56) and `save_checkpoint` / `load_checkpoint`
(:86-111).  `param_spec`, `place_params` and the mesh arguments belong to
the parallel slice, which is not ported yet.

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
from torch import nn

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch.models import StepTimer
from genomicsbench_tpu_torch.models import basecaller as bc

ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)   # optax.adamw's defaults


def optimized_tensors(model: nn.Module) -> list:
    """The basecaller's tensors the optimizer holds, in state-dict order:
    every parameter and the BatchNorm buffers, as JAX's tree has them all
    as leaves."""
    return list(model.state_dict(keep_vars=True).values())


def make_train_step(cfg: bc.BasecallerConfig = bc.BasecallerConfig(), device="cuda",
                    learning_rate: float = 1e-3):
    """(init, train_step) for the basecaller on one device ("cuda" unless
    the caller asks for "cpu"; raises without a card).

    `init(params=None, opt_state=None)` -> (model, optimizer): a Basecaller
    on the device from a state dict (`init_params(cfg)` when None), its
    weights trained, and its AdamW, restored from `opt_state` (an optimizer
    state dict, as `load_checkpoint` gives it) where given.
    `train_step(model, optimizer, signal, labels, label_lens, stats=None)`
    -> (model, optimizer, loss): one step in place, the loss a detached
    scalar tensor; signal (B, T) f32, labels (B, S) with 0 padding,
    label_lens (B,).  With `stats`, a dict, each stage is waited for and its
    seconds added under forward, loss, backward and optimizer."""
    dev = resolve_device(device)

    def init(params=None, opt_state=None):
        state = bc.init_params(cfg) if params is None else params
        bc._check_state(state, cfg)
        model = bc.Basecaller(cfg)
        model.load_state_dict(state)
        model = model.to(dev).train().requires_grad_(True)
        opt = torch.optim.AdamW(optimized_tensors(model), lr=learning_rate, **ADAMW)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        return model, opt

    def train_step(model, opt, signal, labels, label_lens, stats=None):
        timer = StepTimer(stats, dev)
        opt.zero_grad(set_to_none=True)
        x = torch.as_tensor(signal, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        label_lens = torch.as_tensor(label_lens).to(dev)
        with bc.f32_reduction(dev):
            logp = bc.run_network(model.prepare(train=True), x, train=True)
            timer.lap("forward")
            loss = bc.ctc_loss_from_logp(logp, labels, label_lens)
            timer.lap("loss")
            loss.backward()
        timer.lap("backward")
        for t in optimized_tensors(model):
            if t.grad is None:          # the BatchNorm statistics: decay alone
                t.grad = torch.zeros_like(t)
        opt.step()
        timer.lap("optimizer")
        return model, opt, loss.detach()

    return init, train_step


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------
def _state(obj) -> dict:
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def save_checkpoint(path, params, opt_state=None, step: int = 0) -> None:
    """Write (params[, opt_state], step) to the file `path` with torch.save:
    params a module or a state dict (copied to the CPU), opt_state an
    optimizer or its state dict.  Written to a temporary file and moved
    into place, so a reader never sees half a checkpoint."""
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
