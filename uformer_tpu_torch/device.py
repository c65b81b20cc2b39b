"""Moving small host-drawn tensors onto the card without a stream sync."""

from __future__ import annotations

import torch


def to_device_async(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t on `device`. A host tensor bound for the card goes through pinned
    memory and a non-blocking copy: a copy from pageable memory would make
    the host wait until the stream has drained, so it could not queue the
    next kernels ahead of the card."""
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
