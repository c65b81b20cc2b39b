"""Eval entry: a restorer that answers batched NHWC requests."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from uformer_tpu_torch.device import to_device_async
from uformer_tpu_torch.utils.params import prepare_serving


class Restorer:
    """Moves `model` to `device`, prepares its weights once for `dtype`
    (`prepare_serving`), and answers requests: NHWC images in [0, 1] in,
    `clip(model(x), 0, 1)` float32 out."""

    def __init__(self, model: nn.Module, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.dtype = dtype
        self.model = prepare_serving(model.to(self.device).eval(), dtype)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) -> (B, H, W, 3) float32 in [0, 1]."""
        return self.model(to_device_async(x, self.device)).clamp_(0.0, 1.0)

    def numpy(self, x: np.ndarray) -> np.ndarray:
        """The restorer on host arrays, as the eval harnesses call it: x
        (B, H, W, 3) float32 in, the (B, H, W, 3) float32 result out. The
        input goes to the card through pinned memory without a wait; the
        host waits once, for the copy back."""
        y = self(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
        if y.device.type == "cpu":
            return y.numpy()
        out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        out.copy_(y, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return out.numpy()
