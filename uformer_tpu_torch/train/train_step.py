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
without a cross-modulator): the attention-image, attention-block and
LeFF kernels and their backward kernels. It refuses any other model
(conv projection, other windows or head dims) before the step runs; no
plain version stands in on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from uformer_tpu_torch.data.augment import mixup_batch
from uformer_tpu_torch.models.layers import LeWinBlock
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
    (0.9, 0.999), eps 1e-8, weight decay 0.02 on all parameters)."""
    return AdamW(params, lr_schedule, weight_decay, betas, eps, grad_clip)


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


def make_train_step(model: nn.Module, loss_fn: Callable = charbonnier_loss,
                    mixup_after_epoch: Optional[int] = None,
                    steps_per_epoch: int = 1, plain: bool = False):
    """Build train_step(state, batch, generator) -> loss (float32 scalar).

    batch: {"input": (B, H, W, C), "target": (B, H, W, 3)} on the model's
    device. `generator` draws the MixUp and DropPath randomness. plain=True
    runs the kernels' plain versions under torch autograd (the comparison
    path). After the step each parameter's `.grad` holds its gradient.
    On the card the kernel path runs every attention and LeFF sub-block
    forward and backward through the kernels, and raises
    NotImplementedError before the step for a model with blocks in
    `blocks_without_backward_kernel`."""

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
            tgt, inp = mixup_batch(generator, tgt, inp)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(inp, plain=plain, generator=generator), tgt)
        loss.backward()
        state.optimizer.step_at(state.step)
        state.step += 1
        return loss.detach()

    return train_step


def make_eval_step(model: nn.Module):
    """Forward in eval mode, clamped to [0, 1] (reference
    train_denoise.py:196-199)."""

    @torch.no_grad()
    def eval_step(inp: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(inp).clamp(0.0, 1.0)

    return eval_step
