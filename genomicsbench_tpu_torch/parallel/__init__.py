"""The (data, model) mesh over a torch.distributed world, its sharding
helpers and the data-parallel wrappers (the port of
genomicsbench_tpu/parallel/)."""

from genomicsbench_tpu_torch.parallel.mesh import (Mesh, gather_rows, make_mesh, replicate,
                                                   row_bounds, shard_batch)

__all__ = ["Mesh", "gather_rows", "make_mesh", "replicate", "row_bounds", "shard_batch"]
