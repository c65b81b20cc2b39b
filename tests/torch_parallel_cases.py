"""Rank functions of the port's parallel tests (test_torch_port_spatial.py,
test_torch_port_parallel.py in tests/). Each runs on one rank spawned by
`uformer_tpu_torch.parallel.multihost.spawn_ranks` over gloo on the CPU,
imports torch and the port only (a spawned rank imports this module, not
the test file and its JAX), and returns numpy results to the test."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from uformer_tpu_torch.convert import load_numpy_state_dict
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.layers import LeWinBlock
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.parallel import spatial as S
from uformer_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
    weights_crc32,
)
from uformer_tpu_torch.parallel.multihost import (
    all_gather_rows,
    local_batch_range,
    local_batch_slice,
)

PRIMITIVE_SHIFT = 3


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _rows(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    rows = x.shape[1] // world
    return torch.from_numpy(np.ascontiguousarray(
        x[:, rank * rows:(rank + 1) * rows]))


def primitives(rank: int, world: int, p: dict) -> dict:
    """This rank's outputs of the exchanges and the sharded convs on its
    rows of p["x"] (B, H, W, C)."""
    g = dist.group.WORLD
    x = _rows(p["x"], rank, world)
    w = {k: torch.from_numpy(v) for k, v in p.items() if k != "x"}
    return {
        "shift": _np(S.cyclic_shift_sharded(x, PRIMITIVE_SHIFT, g)),
        "unshift": _np(S.cyclic_unshift_sharded(x, PRIMITIVE_SHIFT, g)),
        "halo1": _np(S.halo_exchange(x, 1, g)),
        "halo12": _np(S.halo_exchange(x, (1, 2), g)),
        "halo1_periodic": _np(S.halo_exchange(x, 1, g, periodic=True)),
        "dwconv": _np(S.dwconv_sharded(x, w["wd"], w["bd"], g)),
        "conv3x3": _np(S.conv3x3_sharded(x, w["wc"], w["bc"], g)),
        "downsample": _np(S.downsample_sharded(x, w["wdown"], w["bdown"],
                                               g)),
        "upsample": _np(S.upsample_local(x, w["wup"], w["bup"])),
    }


def _block(case: dict) -> LeWinBlock:
    blk = LeWinBlock(case["C"], case["heads"], case["win"], case["shift"],
                     modulator=case["modulator"])
    return load_numpy_state_dict(blk, case["sd"]).eval()


def _model(cfg: dict, sd: dict) -> Uformer:
    return load_numpy_state_dict(Uformer(**cfg), sd).eval()


def spatial(rank: int, world: int, prims: dict, blocks: dict,
            models: dict) -> dict:
    """Every spatial case on this rank: the primitives, each LeWin block
    (whole result), each Uformer (whole result, and the plain calls of
    kernels 5 and 2 it made here)."""
    g = dist.group.WORLD
    out = {"primitives": primitives(rank, world, prims), "blocks": {},
           "models": {}}
    for name, case in blocks.items():
        out["blocks"][name] = _np(S.run_lewin_block_spatially_sharded(
            _block(case), torch.from_numpy(case["img"]), g))
    for name, (cfg, sd, x) in models.items():
        model = _model(cfg, sd)
        K.reset_counts()
        y = S.run_uformer_spatially_sharded(model, torch.from_numpy(x), g)
        out["models"][name] = (_np(y), K.plain_counts(),
                               S.exchange_stats())
    img = np.random.default_rng(0).uniform(0, 1, (1, 100, 180, 3)) \
        .astype(np.float32)
    out["tiled_identity"] = (img, S.tiled_inference_sharded(
        lambda t: t, img, g, tile=64, overlap=16, factor=32, tile_batch=3))
    out["slab_rows"] = leff_slab_rows(rank, world)
    return out


def data_parallel_step(rank: int, world: int, cfg: dict, sd: dict,
                       batch: dict, seed: int, lr: float) -> dict:
    """One fp32 train step (MixUp on, the model's drop path) of this rank's
    rows of `batch` over the data mesh; then the mesh's utilities."""
    from uformer_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    mesh = make_mesh(world)
    model = load_numpy_state_dict(Uformer(**cfg), sd)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: lr), step=5)
    step = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=1,
                           mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    full = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = step(state, shard_batch(mesh, full), gen)
    out = {"loss": float(loss), "gen": gen.get_state().numpy(),
           "grads": {n: _np(p.grad) for n, p in model.named_parameters()
                     if p.grad is not None},
           "params": {n: _np(p) for n, p in model.named_parameters()},
           "rows": (local_batch_range(8), local_batch_slice(8)),
           "gathered": _np(all_gather_rows(shard_batch(mesh, full["input"]),
                                           mesh.group))}
    # replicate: a rank that differs is caught with verify, then overwritten
    other = load_numpy_state_dict(Uformer(**cfg), sd)
    with torch.no_grad():
        next(other.parameters()).add_(float(rank))
    out["crc_before"] = weights_crc32(other)
    try:
        replicate(other, mesh, verify=True)
        out["verify"] = "passed"
    except ValueError as e:
        out["verify"] = str(e)
    replicate(other, mesh)
    out["crc_after"] = weights_crc32(other)
    return out


def train_cli(rank: int, world: int, argv: list, eval_argv: list,
              gopro_argv: list, image: np.ndarray) -> dict:
    """The train CLI for an epoch over the ranks, then the eval CLI's
    sharded tiled restorer on `image` and its GoPro harness."""
    from uformer_tpu_torch.eval import cli as ecli
    from uformer_tpu_torch.train import cli

    trainer, state, best = cli.main(argv)
    restore = ecli.build_restorer(ecli.eval_argparser().parse_args(
        eval_argv))
    return {"params": {n: _np(p) for n, p in
                       trainer.model.named_parameters()},
            "step": state.step, "best": best, "is_main": trainer.is_main,
            "restored": restore(image), "gopro": ecli.main(gopro_argv)}


def leff_slab_rows(rank: int, world: int) -> list:
    """The rows of the slab this rank hands kernel 2 (interior halos only)
    in a block on 4 rows a rank."""
    x = np.zeros((1, 4 * world, 4, 8), np.float32)
    seen = []
    fused_leff = S.fused_leff

    def spy(slab, *a, **kw):
        seen.append(slab.shape[1])
        return fused_leff(slab, *a, **kw)

    S.fused_leff = spy
    try:
        blk = LeWinBlock(8, 1, 2, 0).eval()
        S.lewin_block_sharded(blk, _rows(x, rank, world),
                              H=x.shape[1], group=dist.group.WORLD)
    finally:
        S.fused_leff = fused_leff
    return seen


def unsharded_conv(x: np.ndarray, p: dict) -> dict:
    """The torch references of `primitives` on the whole batch."""
    t = torch.from_numpy(x)
    w = {k: torch.from_numpy(v) for k, v in p.items() if k != "x"}
    from uformer_tpu_torch.ops.dwconv import depthwise_conv2d

    def nhwc(y):
        return y.permute(0, 2, 3, 1)

    nchw = t.permute(0, 3, 1, 2)
    return {
        "dwconv": _np(depthwise_conv2d(t, w["wd"], w["bd"])),
        "conv3x3": _np(nhwc(F.conv2d(nchw, w["wc"], w["bc"], padding=1))),
        "downsample": _np(nhwc(F.conv2d(nchw, w["wdown"], w["bdown"],
                                        stride=2, padding=1))),
        "upsample": _np(nhwc(F.conv_transpose2d(nchw, w["wup"], w["bup"],
                                                stride=2))),
    }


def fails(rank: int, world: int) -> int:
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def hangs(rank: int, world: int) -> int:
    if rank == 1:
        import time

        time.sleep(600)
    return rank
