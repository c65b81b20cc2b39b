"""Arbitrary-resolution inference: padding and overlapping-crop stitching.

`expand2square` reproduces the reference's pad-to-square protocol
(duplicated across all four test scripts, e.g. `test/test_sidd.py:79-92`):
zero-pad to a centered square of side ceil(max(h,w)/factor)*factor and
return a binary mask for exact unpadding.

`pad_to_multiple` pads each side only to a multiple of `factor` (the NHWC
core has no square requirement), so it wastes fewer FLOPs on wide images
like GoPro 1280x720.

`tiled_inference` is the north-star extra (BASELINE.json): overlapping
crops with smooth blending, for images too large to run whole.

A copy of `uformer_tpu/eval/padding.py`: the pad functions take numpy
arrays or torch tensors (where the JAX package's take jnp arrays);
`tiled_inference` takes a numpy image and a callable that answers numpy
(`Restorer.numpy`).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def expand2square(img, factor: int = 128):
    """img: (B, H, W, C) -> (padded (B, S, S, C), mask (B, S, S, 1)).

    The image sits centered; mask is 1 on image pixels.
    """
    B, H, W, C = img.shape
    S = int(math.ceil(max(H, W) / float(factor)) * factor)
    top = (S - H) // 2
    left = (S - W) // 2
    if isinstance(img, torch.Tensor):
        out = img.new_zeros((B, S, S, C))
        mask = img.new_zeros((B, S, S, 1))
    else:
        out = np.zeros((B, S, S, C), img.dtype)
        mask = np.zeros((B, S, S, 1), img.dtype)
    out[:, top:top + H, left:left + W] = img
    mask[:, top:top + H, left:left + W] = 1
    return out, mask


def unexpand(img, orig_hw: Tuple[int, int], factor: int = 128):
    """Exact inverse crop of expand2square for known original size."""
    H, W = orig_hw
    S = img.shape[1]
    top = (S - H) // 2
    left = (S - W) // 2
    return img[:, top:top + H, left:left + W]


def pad_to_multiple(img, factor: int = 128):
    """Zero-pad bottom/right to the next multiple of factor per side."""
    B, H, W, C = img.shape
    Hp = int(math.ceil(H / factor) * factor)
    Wp = int(math.ceil(W / factor) * factor)
    if (Hp, Wp) == (H, W):
        return img, (H, W)
    if isinstance(img, torch.Tensor):
        return F.pad(img, (0, 0, 0, Wp - W, 0, Hp - H)), (H, W)
    out = np.pad(img, ((0, 0), (0, Hp - H), (0, Wp - W), (0, 0)))
    return out, (H, W)


def unpad(img, orig_hw: Tuple[int, int]):
    H, W = orig_hw
    return img[:, :H, :W]


def _blend_window(length: int, ramp: int, lo_interior: bool,
                  hi_interior: bool) -> np.ndarray:
    """1-D raised-cosine ramp on interior edges, flat elsewhere."""
    w = np.ones(length, np.float32)
    if ramp > 0:
        r = 0.5 * (1 - np.cos(np.pi * (np.arange(ramp) + 0.5) / ramp))
        if lo_interior:
            w[:ramp] = r
        if hi_interior:
            w[-ramp:] = np.minimum(w[-ramp:], r[::-1])
    return w


def tile_weights(y: int, x: int, th: int, tw: int, H: int, W: int,
                 margin: int, ramp: int):
    """The part of a th x tw tile at (y, x) of an H x W image that counts,
    `margin` cropped on interior edges only, and its blend weights:
    (y0, y1, x0, x1, (y1 - y0, x1 - x0) weights)."""
    y0 = margin if y > 0 else 0
    y1 = th - margin if y + th < H else th
    x0 = margin if x > 0 else 0
    x1 = tw - margin if x + tw < W else tw
    wy = _blend_window(y1 - y0, ramp, y > 0, y + th < H)
    wx = _blend_window(x1 - x0, ramp, x > 0, x + tw < W)
    return y0, y1, x0, x1, wy[:, None] * wx[None, :]


def tiled_inference(fn: Callable, img: np.ndarray, tile: int = 256,
                    overlap: int = 32, factor: int = 128,
                    margin: int | None = None,
                    tile_batch: int = 8) -> np.ndarray:
    """Run `fn` (NHWC->NHWC restorer) over overlapping tiles and blend.

    img: (B, H, W, C) numpy. Tiles are `tile`x`tile` (a multiple of
    `factor`), stepped by tile - overlap, edge-clamped. Each tile's
    outermost `margin` pixels (default overlap//4) are discarded on
    interior edges — tile-boundary-contaminated outputs never contribute —
    and the remaining overlap is blended with a raised-cosine window. For
    a local model whose receptive-field halo <= margin, the stitched
    output equals whole-image inference on the interior exactly.

    Edge-clamping makes every tile the same shape, so tile positions are
    BATCHED through `fn` in groups of `tile_batch` (the last group is
    padded by repetition to keep a single compiled shape) — a 720p image
    at tile=256 is 2 batched dispatches instead of 24 single-tile calls.
    The model is batch-equivariant (no cross-image ops), so outputs are
    identical to the tile-at-a-time loop.
    """
    if tile % factor:
        raise ValueError(f"tile {tile} is no multiple of factor {factor}")
    if margin is None:
        margin = overlap // 4
    if overlap and 2 * margin >= overlap:
        raise ValueError(f"margin {margin} leaves no blend in overlap "
                         f"{overlap}")
    B, H, W, C = img.shape
    if H <= tile and W <= tile:
        padded, orig = pad_to_multiple(img, factor)
        return np.asarray(fn(padded))[:, :H, :W]

    step = tile - overlap
    ys = sorted({min(y, max(H - tile, 0)) for y in range(0, max(H - overlap, 1), step)})
    xs = sorted({min(x, max(W - tile, 0)) for x in range(0, max(W - overlap, 1), step)})
    acc = np.zeros((B, H, W, C), np.float32)
    wsum = np.zeros((1, H, W, 1), np.float32)
    ramp = overlap - 2 * margin

    # all tiles share one clamped shape -> batch positions through fn,
    # streaming one tile_batch chunk at a time (a 4K frame has ~170
    # positions; materializing them all at once would cost several
    # hundred MB of host RAM)
    pos = [(y, x) for y in ys for x in xs]
    th = min(tile, H)
    tw = min(tile, W)
    nflat = len(pos) * B
    cb = max(1, min(nflat, int(tile_batch)))
    for i in range(0, nflat, cb):
        sel = [(pos[j // B], j % B) for j in range(i, min(i + cb, nflat))]
        chunk = np.stack([img[b, y:y + th, x:x + tw] for (y, x), b in sel])
        chunk, _ = pad_to_multiple(chunk, factor)
        if len(chunk) < cb:  # repeat-pad: keep one compiled batch shape
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], cb - len(chunk), axis=0)])
        outs = np.asarray(fn(chunk))[:len(sel), :th, :tw]
        for ((y, x), b), out in zip(sel, outs):
            y0, y1, x0, x1, w = tile_weights(y, x, th, tw, H, W, margin,
                                             ramp)
            acc[b, y + y0:y + y1, x + x0:x + x1] += \
                out[y0:y1, x0:x1] * w[:, :, None]
            if b == 0:
                wsum[0, y + y0:y + y1, x + x0:x + x1] += w[:, :, None]
    assert float(wsum.min()) > 0, "tiling left uncovered pixels"
    return acc / wsum
