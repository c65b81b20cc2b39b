"""Data-parallel and spatially sharded runs over `torch.distributed`,
counterpart of `uformer_tpu/parallel/`: `mesh` (the data ranks),
`multihost` (process groups, per-rank batch rows, local ranks for tests
and checks), `sharding_rules` (tensor-parallel placements, consumed by
nothing yet) and `spatial` (the H-sharded forward and sharded tiling).
JAX's `batch_sharding` and `replicated_sharding` are sharding objects of
its mesh; here a rank's rows come from `shard_batch`."""

from uformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
