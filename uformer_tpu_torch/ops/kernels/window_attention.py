"""Window-attention core: Hopper kernel and plain version.

Port of `uformer_tpu/ops/pallas/window_attention.py:fused_window_attention`
(kernel source `csrc/window_attention.cu`). On the H100 the core is
memory-bound (q, k, v read and the output written once against 64
multiply-adds per value). In bf16 persistent blocks of four warps walk
contiguous ranges of the (head, window) pairs head-major
(`window_attention_plan`), the head's bias in shared memory, the next
window's q, k and v in flight by `cp.async` while each warp runs the core
on its 16 rows in registers (`csrc/window_core_mma.cuh`, the core of
kernels 1 and 5's narrow body); fp32 runs one block per head and group of
windows on `csrc/window_core.cuh`. No model path calls it, in the JAX
package either: it is the standalone form of the core the other kernels
run. `window_attention_reference` is the plain PyTorch version.

Unlike the block kernels, which fold the softmax scale into q before
rounding it, this kernel scales the float32 logits (the TPU kernel's
`window_attention.py:55`): in bf16 the two round differently.
"""

from __future__ import annotations

import numpy as np
import torch

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load
from uformer_tpu_torch.ops.masks import shift_window_mask

HEAD_DIMS = (16, 32)  # the kernels' head widths (WMMA is 16 wide)


def window_attention_plan(nH: int, Bw: int, slots: int):
    """(chunk, grid) of the bf16 body: the nH * Bw (head, window) pairs,
    head-major, in contiguous ranges of `chunk` windows, one per block,
    over at most `slots` blocks."""
    items = nH * Bw
    chunk = -(-items // _launch.persistent_grid(items, slots))
    return chunk, -(-items // chunk)


def check_window(win: int, shift: int, H: int, W: int) -> None:
    """Raise unless the kernels take this window geometry: win 8 (their
    region ids are those of an 8-wide window), H and W multiples of 8."""
    if win != 8 or H % 8 or W % 8 or not 0 <= shift < 8:
        raise ValueError(f"kernel needs win 8, H, W multiples of 8 and "
                         f"0 <= shift < 8: win={win} H={H} W={W} "
                         f"shift={shift}")


def check_head_dim(C: int, num_heads: int) -> None:
    if C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"kernel needs head dim in {HEAD_DIMS}: C={C}, "
                         f"num_heads={num_heads}")


def window_mask(H: int, W: int, win: int, shift: int, n: int, w_off: int,
                device) -> torch.Tensor:
    """The SW-MSA mask of n windows whose first lies at place w_off of the
    H x W image's nW windows (row-major, wrapping): the image's (nW, win²,
    win²) mask when the n windows are whole images from place 0, which
    `ops.attention.window_attention` tiles, else one per window."""
    mask = shift_window_mask(H, W, win, shift)
    nW = mask.shape[0]
    if n % nW or w_off % nW:
        mask = mask[(w_off + np.arange(n)) % nW]
    return torch.from_numpy(mask).to(device)


def window_attention_reference(q, k, v, bias, *, win, shift, H, W, scale):
    """q, k, v: (nH, Bw, N, D), window w at place w mod nW of its image;
    bias (nH, N, N). softmax(q kᵀ · scale + bias + mask) v with the
    products accumulated in float32, the logits scaled in float32, the
    softmax in float32 and the probabilities rounded to q's dtype."""
    nH, Bw, N, D = q.shape
    dt = q.dtype
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale \
        + bias.float()[:, None]
    if shift > 0:
        mask = window_mask(H, W, win, shift, Bw, 0, q.device)
        m = mask.shape[0]
        logits = (logits.reshape(nH, Bw // m, m, N, N) + mask) \
            .reshape(nH, Bw, N, N)
    probs = torch.softmax(logits, dim=-1).to(dt)
    return (probs.float() @ v.float()).to(dt)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, *, win: int, shift: int,
                           H: int, W: int, scale: float) -> torch.Tensor:
    """q, k, v: (nH, Bw, 64, D), D in HEAD_DIMS, float32 or bfloat16;
    bias (nH, 64, 64) float32. Returns (nH, Bw, 64, D). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (win 8)
    or raises."""
    if q.device.type == "cpu":
        fused_window_attention.plain_calls += 1
        return window_attention_reference(q, k, v, bias, win=win,
                                          shift=shift, H=H, W=W, scale=scale)
    _launch.check_input(q, "(nH, Bw, N, D)")
    nH, Bw, N, D = q.shape
    check_window(win, shift, H, W)
    if N != 64 or D not in HEAD_DIMS:
        raise ValueError(f"kernel needs N = 64 and D in {HEAD_DIMS}: "
                         f"N={N} D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _launch.expect(t, name, q.shape, q.dtype, q.device)
    _launch.expect(bias, "bias", (nH, 64, 64), torch.float32, q.device)
    lib = load()
    is_bf16 = int(q.dtype == torch.bfloat16)
    chunk = grid = 0
    if is_bf16:
        slots = _launch.resident_blocks("uf_window_attention_slots",
                                        q.device.index, is_bf16, D)
        chunk, grid = window_attention_plan(nH, Bw, slots)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.uf_window_attention(
            is_bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), nH, Bw, D, H, W, shift,
            float(scale), chunk, grid, _launch.stream(q))
    _launch.check(err, "window_attention kernel")
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0
fused_window_attention.plain_calls = 0
