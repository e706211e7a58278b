"""The ("data", "model") mesh over a torch.distributed world, and the
sharding helpers (the port of genomicsbench_tpu/parallel/mesh.py).

JAX runs one controller over a device mesh; torch runs one process per
card.  So here every rank calls a wrapper with the same full input, takes
its own contiguous block of rows (`row_bounds`, `shard_batch`), runs the
one-card entry point on them, and a collective merges the results
(`gather_rows`), so every rank returns the full result.

Rank r sits at (r // model, r % model), as JAX's `reshape(data, model)`
places the devices (mesh.py:19-28).  A "cuda" mesh runs its collectives on
NCCL and a "cpu" mesh on gloo: the mesh makes its own process groups with
that backend, whatever the world's default, so a cuda mesh never runs on
gloo, and nothing here moves a cuda mesh's work to the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh: the two axes' sizes, its
    coordinate on each, each axis's process group (the ranks that differ
    from this one only on that axis) and its torch.device."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def _axis(self, axis: str) -> str:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}: use 'data' or 'model'")
        return axis

    def size(self, axis: str = "data") -> int:
        return getattr(self, self._axis(axis))

    def rank(self, axis: str = "data") -> int:
        return getattr(self, self._axis(axis) + "_rank")

    def group(self, axis: str = "data"):
        return getattr(self, self._axis(axis) + "_group")


def mesh_device(device="cuda") -> torch.device:
    """The torch.device a mesh of `device`'s type runs on in this process:
    "cpu", or the card LOCAL_RANK names (else rank modulo the cards); raises
    without a card unless asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a mesh of "
                           "CPU ranks on gloo")
    if dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                      rank % torch.cuda.device_count())))
    return dev


def make_mesh(data: int | None = None, model: int = 1, device="cuda") -> Mesh:
    """A ("data", "model") mesh over the initialised world (init_multihost
    or torch.distributed.init_process_group first): data * model must equal
    the world size, data defaulting to world // model.  Every rank must call
    it, in the same order as its other group creations.  device "cuda"
    (raises without a card) gives NCCL groups, "cpu" gloo ones."""
    dev = mesh_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world: call "
                           "init_multihost() or torch.distributed.init_process_group first")
    n, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = n // model
    if model < 1 or data < 1 or data * model != n:
        raise ValueError(f"{n} ranks != {data} x {model}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    # every rank creates every group, in the same order
    data_groups = [dist.new_group([d * model + m for d in range(data)], backend=backend)
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)], backend=backend)
                    for d in range(data)]
    d, m = divmod(rank, model)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(data=data, model=model, data_rank=d, model_rank=m,
                data_group=data_groups[m], model_group=model_groups[d], device=dev)


def row_bounds(mesh: Mesh, n: int, axis: str = "data") -> tuple[int, int]:
    """This rank's contiguous [lo, hi) block of n rows sharded over `axis`;
    ValueError where n does not divide by the axis, as NamedSharding."""
    size = mesh.size(axis)
    if n % size:
        raise ValueError(f"the leading dimension {n} does not divide by the mesh's "
                         f"{axis!r} axis of {size}: pad it first")
    per = n // size
    r = mesh.rank(axis)
    return r * per, (r + 1) * per


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """This rank's rows of every array leaf of `tree` (dicts, lists and
    tuples of numpy arrays or tensors), on the mesh's device; ValueError
    where a leaf's leading dimension does not divide by the axis."""
    def take(x):
        lo, hi = row_bounds(mesh, len(x), axis)
        return torch.as_tensor(x[lo:hi]).to(mesh.device)
    return _tree_map(take, tree)


def replicate(mesh: Mesh, tree):
    """Every leaf of `tree` whole on the mesh's device."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), tree)


def gather_rows(mesh: Mesh, t, axis: str = "data") -> torch.Tensor:
    """Every rank's rows of t (n_r, ...) concatenated in rank order, on the
    mesh's device, on every rank.  Ragged: the ranks' row counts go first,
    then each rank's rows padded to the largest, so that results of any
    length travel as device tensors.  Trailing shapes and dtypes must
    agree across the ranks."""
    t = torch.as_tensor(t).to(mesh.device)
    if t.dtype == torch.bool:
        return gather_rows(mesh, t.to(torch.uint8), axis).bool()
    group, size = mesh.group(axis), mesh.size(axis)
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=mesh.device)
    counts = [torch.empty_like(n) for _ in range(size)]
    dist.all_gather(counts, n, group=group)
    counts = [int(c) for c in counts]
    top = max(counts)
    if top == 0:
        return t
    if t.shape[0] < top:
        t = torch.cat([t, t.new_zeros((top - t.shape[0],) + tuple(t.shape[1:]))])
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])
