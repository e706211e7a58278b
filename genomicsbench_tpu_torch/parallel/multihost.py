"""Multi-process start-up and per-process input sharding (the port of
genomicsbench_tpu/parallel/multihost.py).

`init_multihost` starts torch.distributed from its arguments or the
environment: JAX's variables first (JAX_COORDINATOR_ADDRESS host:port,
NUM_PROCESSES, PROCESS_ID), torchrun's second (MASTER_ADDR and MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK).  With neither set it does nothing and
returns False, as JAX does (:26-45), so one process runs unchanged.
`global_mesh` is the (data, model) mesh over every rank; `host_shard` and
`host_batch_bounds` take this process's rank and the world size from
torch.distributed where it is initialised, else 0 and 1.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from genomicsbench_tpu_torch.parallel.mesh import make_mesh, mesh_device


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def world_from_env(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None):
    """(coordinator host:port or None, world size, rank) from the arguments,
    then JAX's variables, then torchrun's."""
    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS") or None
    if coordinator is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    return coordinator, num_processes, process_id


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, *, device="cuda",
                   init_method: str | None = None) -> bool:
    """Initialise torch.distributed from the arguments or the environment
    (see the module docstring): NCCL for device "cuda" (raises without a
    card; the process's card is LOCAL_RANK, else rank modulo the cards),
    gloo for "cpu".  `init_method` (a "file://" or "tcp://" URL) replaces
    the coordinator's tcp://host:port.  Returns True if a world was
    initialised (or already was), False where nothing names one."""
    if dist.is_initialized():
        return True
    coordinator, n, pid = world_from_env(coordinator, num_processes, process_id)
    if init_method is None:
        if not coordinator:
            return False        # one process: nothing to do
        init_method = f"tcp://{coordinator}"
    if n is None or pid is None:
        raise ValueError("init_multihost needs the world size and this process's rank "
                         "(NUM_PROCESSES / PROCESS_ID or WORLD_SIZE / RANK)")
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for gloo")
        os.environ.setdefault("LOCAL_RANK", str(pid % torch.cuda.device_count()))
        torch.cuda.set_device(mesh_device(device))
        backend = "nccl"
    else:
        mesh_device(device)             # "cpu", or ValueError
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=pid)
    return True


def global_mesh(model: int = 1, device="cuda"):
    """The ("data", "model") mesh over every rank of the job."""
    return make_mesh(model=model, device=device)


def _world(process_id, num_processes):
    on = dist.is_available() and dist.is_initialized()
    pid = (dist.get_rank() if on else 0) if process_id is None else process_id
    n = (dist.get_world_size() if on else 1) if num_processes is None else num_processes
    return pid, n


def host_shard(items, process_id: int | None = None, num_processes: int | None = None):
    """This process's slice of a work list (files, read batches): process i
    of n takes items[i::n]."""
    pid, n = _world(process_id, num_processes)
    return list(items)[pid::n]


def host_batch_bounds(total: int, process_id: int | None = None,
                      num_processes: int | None = None):
    """This process's contiguous [lo, hi) slice of `total` items (for
    index-addressable inputs: BAM regions, h5 batch files)."""
    pid, n = _world(process_id, num_processes)
    per = -(-total // n)
    lo = min(pid * per, total)
    return lo, min(lo + per, total)
