"""Attention masks: the static SW-MSA shift mask and the input-mask bias.

Copies of `uformer_tpu/ops/masks.py:20-69` (not imported, because
importing the JAX package imports jax). Additive bias: 0.0 where attention
is allowed, NEG_BIAS where two tokens come from different pre-shift
regions or are both masked.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NEG_BIAS = -100.0


@functools.lru_cache(maxsize=256)
def shift_window_mask(H: int, W: int, win: int, shift: int) -> np.ndarray:
    """Additive SW-MSA mask, shape (nW, win*win, win*win), float32: the
    9-region construction of the reference, partitioned into windows."""
    r = shift_window_regions(H, W, win, shift)
    diff = r[:, None, :] - r[:, :, None]
    return np.where(diff != 0, np.float32(NEG_BIAS), np.float32(0.0))


def shift_window_regions(H: int, W: int, win: int,
                         shift: int) -> np.ndarray:
    """The pre-shift region of each token of each window, (nW, win*win)
    int32: two tokens may attend to each other where theirs are equal."""
    if not 0 < shift < win:
        raise ValueError(f"shift={shift} must lie in (0, {win})")
    region = np.zeros((H, W), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, H - win), slice(H - win, H - shift),
               slice(H - shift, H)):
        for ws in (slice(0, W - win), slice(W - win, W - shift),
                   slice(W - shift, W)):
            region[hs, ws] = cnt
            cnt += 1
    r = region.reshape(H // win, win, W // win, win)
    return r.transpose(0, 2, 1, 3).reshape(-1, win * win)  # nW, win*win


@functools.lru_cache(maxsize=64)
def shift_mask_on(H: int, W: int, win: int, shift: int,
                  device: torch.device) -> torch.Tensor:
    """`shift_window_mask` as a float32 tensor on `device`, copied there
    once per geometry and device and kept (the JAX package has it as a
    compile-time constant). Read-only: callers must not write to it."""
    return torch.from_numpy(shift_window_mask(H, W, win, shift)).to(device)


def input_mask_bias(mask: torch.Tensor, H: int, W: int,
                    win: int) -> torch.Tensor:
    """Additive attention bias from a user input mask (reference
    model.py:913-919): the mask resized to (H, W) by nearest neighbour,
    partitioned into windows, each window's token mask multiplied by
    itself, and every nonzero product NEG_BIAS. `mask` is (B, 1, Hm, Wm)
    or (B, Hm, Wm, 1). Returns (B * nW, win², win²) float32."""
    if mask.dim() != 4:
        raise ValueError("mask must be 4-D")
    if mask.shape[1] == 1 and mask.shape[-1] != 1:  # NCHW -> NHWC
        mask = mask.permute(0, 2, 3, 1)
    B, Hm, Wm, _ = mask.shape
    if (Hm, Wm) != (H, W):
        # F.interpolate's default nearest: an integer index map
        rows = torch.arange(H, device=mask.device) * Hm // H
        cols = torch.arange(W, device=mask.device) * Wm // W
        mask = mask[:, rows][:, :, cols]
    m = mask.reshape(B, H // win, win, W // win, win)
    m = m.permute(0, 1, 3, 2, 4).reshape(-1, win * win)  # B*nW, N
    prod = m[:, :, None] * m[:, None, :]
    return torch.where(prod != 0, NEG_BIAS, 0.0).float()
