"""Argument checks and raw pointers for the ctypes kernel entries."""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from uformer_tpu_torch.ops.kernels._build import load

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def expect(t: Optional[torch.Tensor], name: str, shape: Sequence[int],
           dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless t is a contiguous, 32-byte aligned tensor of this shape,
    dtype and device (the kernels' fragment loads need the alignment)."""
    if t is None:
        raise ValueError(f"{name} is required")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 32:
        raise ValueError(f"{name} must be 32-byte aligned")


def check_input(x: torch.Tensor, layout: str = "(B, H, W, C)") -> None:
    """Raise unless x is a contiguous float32 or bfloat16 CUDA tensor with
    one dimension per name of `layout`."""
    if x.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, got {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != layout.count(",") + 1 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {layout} tensor")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error."""
    if err != 0:
        name = load().uf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")


def scratch_regions(lib, is_bf16: int, C: int, D: int) -> int:
    """The 64 x C scratch tiles a window of the one-window attention body
    needs at (dtype, C, head dim D), 0-2 (`uf_attention_needs_scratch`);
    raises for a head dim no body takes."""
    n = lib.uf_attention_needs_scratch(is_bf16, C, D)
    if n < 0:
        check(-n, f"uf_attention_needs_scratch(C={C}, D={D})")
    return n


@functools.lru_cache(maxsize=None)
def resident_blocks(entry: str, device_index: int, *args: int) -> int:
    """Blocks of a persistent kernel resident on the card at once
    (occupancy x SMs), as the C entry `entry(*args)` reports it: 0 where
    those arguments take no persistent kernel. Asked once per device and
    arguments; it also sets the kernel's shared-memory limit."""
    with torch.cuda.device(device_index):
        n = getattr(load(), entry)(*args)
    if n < 0:
        check(-n, entry)
    return n


def persistent_grid(items: int, slots: int) -> int:
    """Blocks of a persistent launch: one per work item, at most as many
    as are resident at once (`slots`), each then walking items
    blockIdx.x + i * gridDim.x."""
    return max(1, min(items, slots))
