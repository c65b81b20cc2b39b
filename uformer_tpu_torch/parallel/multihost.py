"""Process groups, counterpart of `uformer_tpu/parallel/multihost.py`.

One process per card. `init_multihost` starts the default process group
from `torchrun`'s environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) or from a store the caller gives, NCCL on cards and gloo on
the CPU. Data loading stays per rank: `local_batch_range` gives each rank
its rows of the global batch, and `all_gather_rows` assembles the global
batch where a step really needs it (MixUp pairs rows across ranks).

gloo moves CUDA tensors only in `broadcast` and `all_reduce`; for its
point-to-point and gather calls a CUDA tensor is copied to pinned host
memory and back (`host_staged`). That is the transport of several ranks
that share one card, where NCCL refuses two ranks on one GPU.

`spawn_ranks` runs a function on N local ranks (one process each, a
`FileStore` rendezvous, a deadline on the whole run): the CPU tests and
the one-card checks launch their ranks with it.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0


def rank_device(device: Optional[str] = None) -> torch.device:
    """The card of this rank: `device` when it names an index or the CPU,
    else cuda:LOCAL_RANK, which must exist."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    if local >= count:
        raise ValueError(f"LOCAL_RANK {local} needs a card cuda:{local}, "
                         f"but torch.cuda.device_count() is {count}; name "
                         f"the device to share one card")
    return torch.device("cuda", local)


def init_multihost(backend: Optional[str] = None,
                   device: Optional[str] = None, *,
                   store: Optional[dist.Store] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   timeout_s: float = 1800.0) -> torch.device:
    """Start the default process group and return this rank's device.

    Without a store, RANK and WORLD_SIZE come from the environment
    (torchrun's, with MASTER_ADDR and MASTER_PORT); at one process this
    starts nothing, as JAX's does. With a store, `rank` and `world_size`
    are the caller's, and a group of one is started too. The device is
    `device` where it names one, else cuda:LOCAL_RANK (`rank_device`); the
    backend NCCL on a card and gloo on the CPU unless named. A group that
    is already up is kept when its size agrees."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if device is None and torch.cuda.is_available():
        device = "cuda"
    dev = rank_device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is up; asked for {world_size}")
        return dev
    if store is None and world_size <= 1:
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = dict(backend=backend, world_size=world_size,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        if rank is None:
            raise ValueError("a store needs this process's rank")
        dist.init_process_group(store=store, rank=rank, **kw)
    else:
        dist.init_process_group(init_method="env://",
                                rank=int(os.environ["RANK"]), **kw)
    return dev


def group_size(group=None) -> int:
    """Ranks in `group` (the default group when None); 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def local_batch_slice(global_batch: int, group=None) -> Tuple[int, int]:
    """(start, size) of this rank's slice of the global batch (JAX's
    `local_batch_slice`: an equal share, rounded down)."""
    n, i = group_size(group), group_rank(group)
    per = global_batch // n
    return i * per, per


def local_batch_range(global_batch: int, group=None) -> Tuple[int, int]:
    """(start, size) of the global batch rows this rank owns: rank i of n
    owns rows [i B/n, (i + 1) B/n), one contiguous range by construction
    (JAX derives its rows from the sharding's device map and asserts
    that they are contiguous). The batch must split evenly."""
    n = group_size(group)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} ranks")
    return local_batch_slice(global_batch, group)


def host_staged(x: torch.Tensor, group=None) -> bool:
    """True where `group`'s backend cannot move `x` point to point or in a
    gather: a CUDA tensor on gloo goes through host memory."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def comm_device(group=None) -> torch.device:
    """Where a tensor made for a collective lives: this rank's card under
    NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def to_host(x: torch.Tensor) -> torch.Tensor:
    """x in pinned host memory, copied once the current stream gets there."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return out


def all_gather_rows(x: torch.Tensor, group=None, dim: int = 0
                    ) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in rank order (each rank's x
    of one shape): the counterpart of JAX's `make_global_batch` where the
    global batch is really needed. x itself without a group of two or
    more."""
    n = group_size(group)
    if n == 1:
        return x
    staged = host_staged(x, group)
    src = to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device, non_blocking=True) if staged else out


def _rank_main(fn, rank: int, world_size: int, store_path: str,
               backend: str, device: Optional[str], timeout_s: float,
               num_threads: Optional[int], args: tuple, results) -> None:
    if num_threads is not None:
        torch.set_num_threads(num_threads)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        store = dist.FileStore(store_path, world_size)
        init_multihost(backend, device, store=store, rank=rank,
                       world_size=world_size, timeout_s=timeout_s)
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args: Any,
                backend: str = "gloo", device: Optional[str] = "cpu",
                timeout_s: float = DEFAULT_TIMEOUT_S,
                num_threads: Optional[int] = 1) -> List[Any]:
    """Run fn(rank, world_size, *args) on `world_size` spawned processes
    joined in one default process group (`backend`; every rank on
    `device`, or on cuda:rank when None) and return their results in rank
    order. fn and its results must pickle. If a rank raises, dies or the
    run passes `timeout_s`, every rank is killed and RuntimeError (with the
    rank's traceback) or TimeoutError is raised here."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    done: dict = {}
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, world_size, os.path.join(tmp, "store"), backend,
                  device, timeout_s, num_threads, args, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(done) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world_size} ranks: no result from ranks "
                        f"{sorted(set(range(world_size)) - set(done))} "
                        f"after {timeout_s:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code "
                            f"{procs[dead[0]].exitcode}) without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{payload}")
                done[rank] = payload
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
            results.close()
    return [done[r] for r in range(world_size)]
