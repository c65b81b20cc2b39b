"""The data mesh, counterpart of `uformer_tpu/parallel/mesh.py`.

JAX builds one ('data', 'model') device mesh: batches split over 'data',
parameters replicated, XLA's all-reduce of the gradients. Here a `Mesh`
is a process group over the data ranks, one process per card: this
rank's rows of each batch (`shard_batch`), parameters broadcast from rank
0 (`replicate`; `DistributedDataParallel` does the same when the train
step wraps the model) and DDP's all-reduce of the gradients. A 'model'
axis is not built: JAX's trainer never shards over it either, and
`make_mesh(model > 1)` raises (ROADMAP.md).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from uformer_tpu_torch.parallel.multihost import (
    comm_device,
    group_rank,
    group_size,
    local_batch_range,
)

MODEL_AXIS_NOT_PORTED = (
    "a 'model' axis (tensor parallel over sharding_rules.param_placements) "
    "is not built: ROADMAP.md, port queue 1 item 4; JAX's trainer "
    "replicates its parameters too")


@dataclass(frozen=True)
class Mesh:
    """The data ranks: their process group (None: one process without a
    group), this rank, their count, and this rank's device."""
    group: Any
    rank: int
    size: int
    device: torch.device


def make_mesh(data: Optional[int] = None, model: int = 1,
              device: Optional[torch.device] = None, group=None) -> Mesh:
    """The mesh over `group`'s ranks (the default group when None; one
    process where no group is up). `data`, where given, must equal their
    count."""
    if model > 1:
        raise NotImplementedError(f"model axis {model}: "
                                  f"{MODEL_AXIS_NOT_PORTED}")
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    n = group_size(group)
    if data is not None and data != n:
        raise ValueError(f"a data mesh of {data} needs a process group of "
                         f"{data} ranks; {n} are up (launch with torchrun "
                         f"--nproc_per_node {data})")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(group, group_rank(group), n, torch.device(device))


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch: a tensor, an array, or a dict
    of them, split along the leading axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    start, size = local_batch_range(batch.shape[0], mesh.group)
    return batch[start:start + size]


def weights_crc32(model: nn.Module) -> int:
    """crc32 of every parameter's and buffer's bytes, in state_dict order."""
    crc = 0
    for t in model.state_dict().values():
        crc = zlib.crc32(t.detach().cpu().contiguous().reshape(-1)
                         .view(torch.uint8).numpy().tobytes(), crc)
    return crc


def verify_replicated(model: nn.Module, mesh: Mesh) -> int:
    """The weights' crc32 (`weights_crc32`), gathered from every rank;
    ValueError where two ranks differ."""
    crc = weights_crc32(model)
    if mesh.size == 1:
        return crc
    mine = torch.tensor([crc], dtype=torch.int64,
                        device=comm_device(mesh.group))
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine, group=mesh.group)
    crcs = [int(t) for t in every]
    if len(set(crcs)) != 1:
        raise ValueError(f"weights differ across ranks: crc32 {crcs}")
    return crc


@torch.no_grad()
def replicate(model: nn.Module, mesh: Mesh, verify: bool = False
              ) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place.
    With `verify`, first check JAX's caller contract (every rank passes
    equal bits: same-seed weights or one checkpoint read by all) and raise
    ValueError where it fails: JAX's UFORMER_TPU_VERIFY_REPLICATE check,
    as an argument."""
    if verify:
        verify_replicated(model, mesh)
    if mesh.size > 1:
        src = (0 if mesh.group is None
               else dist.get_global_rank(mesh.group, 0))
        for t in model.state_dict().values():
            dist.broadcast(t, src, group=mesh.group)
    return model
