"""Training losses, counterparts of `uformer_tpu/train/losses.py`.

Charbonnier is the only loss the reference trainers use; the TV loss is
kept for parity with the JAX package.
"""

from __future__ import annotations

import torch


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-3) -> torch.Tensor:
    """mean(sqrt(diff^2 + eps^2)) in float32, eps 1e-3."""
    diff = pred.float() - target.float()
    return torch.sqrt(diff * diff + eps * eps).mean()


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Anisotropic total variation of x (B, H, W, C): squared neighbour
    differences, each direction normalised by its count, times 2, averaged
    over the batch."""
    B, H, W, C = x.shape
    x = x.float()
    h_tv = (x[:, 1:] - x[:, :-1]).square().sum()
    w_tv = (x[:, :, 1:] - x[:, :, :-1]).square().sum()
    return weight * 2.0 * (h_tv / ((H - 1) * W * C)
                           + w_tv / (H * (W - 1) * C)) / B
