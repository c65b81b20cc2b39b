"""The train and eval steps, counterparts of
`uformer_tpu/train/train_step.py`.

One step: the forward at the model's working dtype (`model.dtype`, bf16 for
the reference recipe) over float32 master parameters, with no loss scaler;
Charbonnier loss; backward (through the backward kernels on the card);
AdamW with weight decay on every parameter (the reference trainers never
use the model's no-decay sets); optional global-norm clipping. MixUp runs
once the epoch passes `mixup_after_epoch`. On the card the kernel path
trains every linear-projection model at window 8 and head dim 16 or 32
(Uformer_B, Uformer_T and the rest of the registry; LeFF or Mlp, with or
without a cross-modulator, with or without `use_checkpoint`): the
attention-image, attention-block and LeFF kernels and their backward
kernels; UNet trains on cuDNN alone. It refuses any other model (conv
projection, other windows or head dims) before the step runs; no plain
version stands in on the card. Over a data mesh the step runs under
DistributedDataParallel (`make_train_step(mesh=...)`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from uformer_tpu_torch.data.augment import mixup_batch
from uformer_tpu_torch.models.layers import BatchRows, LeWinBlock
from uformer_tpu_torch.train.losses import charbonnier_loss
from uformer_tpu_torch.train.schedules import Schedule


class AdamW(torch.optim.AdamW):
    """torch AdamW (its fused single-kernel update) whose lr follows a
    step -> lr schedule, optionally after clipping the gradients' global
    norm, as optax's `chain(clip_by_global_norm, adamw(schedule))` does."""

    def __init__(self, params: Iterable[torch.Tensor], lr_schedule: Schedule,
                 weight_decay: float, betas, eps: float,
                 grad_clip: Optional[float]):
        super().__init__(params, lr=lr_schedule(0), betas=betas, eps=eps,
                         weight_decay=weight_decay, fused=True)
        self.lr_schedule, self.grad_clip = lr_schedule, grad_clip

    @torch.no_grad()
    def step_at(self, step: int) -> None:
        """One update with the schedule's lr for `step` (0-based)."""
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if self.grad_clip is not None and grads:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            factor = torch.where(norm > self.grad_clip,
                                 self.grad_clip / norm, torch.ones_like(norm))
            for g in grads:
                g.mul_(factor.to(g.dtype))
        for group in self.param_groups:
            group["lr"] = self.lr_schedule(step)
        self.step()


def make_optimizer(params: Iterable[torch.Tensor], lr_schedule: Schedule,
                   weight_decay: float = 0.02, betas=(0.9, 0.999),
                   eps: float = 1e-8,
                   grad_clip: Optional[float] = None) -> AdamW:
    """AdamW of the reference recipe (lr from the schedule, betas
    (0.9, 0.999), eps 1e-8, weight decay 0.02 on all parameters) over the
    trainable ones: a parameter frozen by `utils.freeze.freeze`
    (requires_grad False) gets no update and no weight decay."""
    return AdamW([p for p in params if p.requires_grad], lr_schedule,
                 weight_decay, betas, eps, grad_clip)


def blocks_without_backward_kernel(model: nn.Module) -> List[str]:
    """Names of the blocks the backward kernels do not cover (conv
    projection, a window other than 8 or a head dim other than 16 or 32;
    the block's `backward_gap` says why)."""
    return [name for name, m in model.named_modules()
            if isinstance(m, LeWinBlock) and m.backward_gap is not None]


@dataclass
class TrainState:
    model: nn.Module
    optimizer: AdamW
    step: int = 0


def data_parallel(model: nn.Module, mesh) -> nn.Module:
    """`model` wrapped in DistributedDataParallel over the mesh's group:
    its constructor broadcasts rank 0's weights (JAX's `replicate`), its
    backward averages the gradients. Frozen parameters (requires_grad
    False) stay out of its buckets. A cross-modulator block's
    `norm_cross`, built and never applied (JAX layers.py:729-732), gets no
    gradient: such a model is wrapped with find_unused_parameters."""
    from torch.nn.parallel import DistributedDataParallel

    unused = any(isinstance(m, LeWinBlock) and m.norm_cross is not None
                 for m in model.modules())
    return DistributedDataParallel(
        model, process_group=mesh.group, broadcast_buffers=False,
        gradient_as_bucket_view=True, find_unused_parameters=unused)


def make_train_step(model: nn.Module, loss_fn: Callable = charbonnier_loss,
                    mixup_after_epoch: Optional[int] = None,
                    steps_per_epoch: int = 1, plain: bool = False,
                    mesh=None):
    """Build train_step(state, batch, generator) -> loss (float32 scalar).

    batch: {"input": (B, H, W, C), "target": (B, H, W, 3)} on the model's
    device. `generator` draws the MixUp and DropPath randomness. plain=True
    runs the kernels' plain versions under torch autograd (the comparison
    path). After the step each parameter's `.grad` holds its gradient.
    On the card the kernel path runs every attention and LeFF sub-block
    forward and backward through the kernels, and raises
    NotImplementedError before the step for a model with blocks in
    `blocks_without_backward_kernel`.

    With a `parallel.Mesh` that has a process group, the batch is this
    rank's rows of the global batch (an even share), the model runs under
    `data_parallel`, and MixUp and DropPath draw for the global batch
    from a generator that every rank holds in one state (`BatchRows`):
    loss, gradients, parameters and the generator's state follow the
    one-process step on the global batch. The loss returned is this
    rank's; gradients are averaged over the ranks."""
    net = model
    group = None
    if mesh is not None and mesh.group is not None:
        net, group = data_parallel(model, mesh), mesh.group

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> torch.Tensor:
        inp, tgt = batch["input"], batch["target"]
        if not plain and inp.device.type == "cuda":
            uncovered = blocks_without_backward_kernel(model)
            if uncovered:
                first = model.get_submodule(uncovered[0])
                raise NotImplementedError(
                    f"{first.backward_gap}: {len(uncovered)} blocks, "
                    f"{uncovered[0]} first")
        if inp.shape[0] != tgt.shape[0]:
            raise ValueError(f"input/target batch mismatch: "
                             f"{tuple(inp.shape)} vs {tuple(tgt.shape)}")
        if mixup_after_epoch is not None \
                and state.step // steps_per_epoch + 1 > mixup_after_epoch:
            tgt, inp = mixup_batch(generator, tgt, inp, group=group)
        rows = generator
        if group is not None:
            local = inp.shape[0]
            rows = BatchRows(generator, mesh.rank * local, mesh.size * local)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(net(inp, plain=plain, generator=rows), tgt)
        loss.backward()
        state.optimizer.step_at(state.step)
        state.step += 1
        return loss.detach()

    return train_step


def make_eval_step(model: nn.Module, plain: bool = False):
    """Forward in eval mode at the model's dtype, clamped to [0, 1]
    (reference train_denoise.py:196-199); plain=True runs the kernels'
    plain versions."""

    @torch.no_grad()
    def eval_step(inp: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(inp, plain=plain).clamp(0.0, 1.0)

    return eval_step
