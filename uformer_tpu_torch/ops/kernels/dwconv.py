"""Depthwise 3x3 convolution: Hopper kernel and plain version.

Port of `uformer_tpu/ops/pallas/dwconv.py:dwconv3x3` (kernel source
`csrc/dwconv.cu`): a 3x3 depthwise SAME convolution, stride 1, on NHWC,
with x and w widened to float32, the nine products and the bias summed
in float32 and one rounding to x's dtype. Its model caller is
`SepConv2d` (the conv token projection), on (Bw, 8, 8, C) windows, each
padded with zeros as its own image. On the H100 it is bound by bytes;
the kernel stages a tile and its halo in shared memory and writes each
pixel's channels with 16-byte stores. `dwconv3x3_reference` is the plain
PyTorch version. The plain op of `leff_reference`,
`uformer_tpu_torch.ops.dwconv.depthwise_conv2d`, rounds w to x's dtype
first, as the JAX package's jnp path does; it is not this function.

There is no backward kernel, in the JAX package either (no custom_vjp on
`dwconv3x3`): on the card the wrapper refuses inputs that need a
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load

DWCONV_BACKWARD_NOT_PORTED = (
    "kernel 8 (dwconv3x3) has no backward kernel, in the JAX package either "
    "(no custom_vjp on uformer_tpu/ops/pallas/dwconv.py:dwconv3x3): "
    "conv-projection blocks train on the plain path only (ROADMAP.md, port "
    "queue 2, kernel 8 follow-ups)")


def dwconv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, C); w (3, 3, C); b (C,) or None. The convolution of the
    float32 copies of x and w plus the float32 bias, rounded once to x's
    dtype."""
    C = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.float().permute(2, 0, 1).unsqueeze(1),
                 None if b is None else b.float(), padding=1, groups=C)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def dwconv3x3(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, H, W, C) float32 or bfloat16, any B, H, W, C >= 1; w (3, 3, C)
    float32 or x's dtype; b (C,) or None. Returns (B, H, W, C) in x's
    dtype. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if x.device.type == "cpu":
        dwconv3x3.plain_calls += 1
        return dwconv3x3_reference(x, w, b)
    _launch.check_input(x)
    B, H, W, C = x.shape
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        raise NotImplementedError(DWCONV_BACKWARD_NOT_PORTED)
    if w.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"w: dtype {w.dtype}, expected float32 or {x.dtype}")
    dev = x.device
    _launch.expect(w, "w", (3, 3, C), w.dtype, dev)
    if b is not None:
        b = b.float()
        _launch.expect(b, "b", (C,), torch.float32, dev)
    y = torch.empty_like(x)
    vec = int(C % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        err = load().uf_dwconv3x3(
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            x.data_ptr(), w.data_ptr(), _launch.ptr(b), y.data_ptr(), B, H,
            W, C, vec, _launch.stream(x))
    _launch.check(err, "dwconv3x3 kernel")
    dwconv3x3.launches += 1
    return y


dwconv3x3.launches = 0
dwconv3x3.plain_calls = 0
