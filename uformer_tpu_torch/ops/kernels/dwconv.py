"""Depthwise 3x3 convolution: Hopper kernel and plain versions.

Port of `uformer_tpu/ops/pallas/dwconv.py:dwconv3x3` (kernel source
`csrc/dwconv.cu`): a 3x3 depthwise SAME convolution, stride 1, on NHWC,
with x and w widened to float32, the nine products and the bias summed
in float32 and one rounding to x's dtype. Its model caller is the conv
token projection on (Bw, 8, 8, C) windows, each padded with zeros as its
own image: `ConvProjection` runs the q, k and v convolutions of one input
in one launch (`dwconv3x3_qkv`, with the ReLU that follows each, exact
before the rounding), `SepConv2d` alone `dwconv3x3`. On the H100 its
work is bound by bytes (nine multiply-adds a value), and the kernel runs
at 2-3x that bound, held by instruction issue and latency: persistent
blocks walk the tiles of `dwconv_plan` through a ring of shared-memory
slots, the next tiles' loads in flight while one is computed, and write
each pixel's channels with 16-byte stores.
`dwconv3x3_reference` and `dwconv3x3_qkv_reference` are the plain PyTorch
versions. The plain op of `leff_reference`,
`uformer_tpu_torch.ops.dwconv.depthwise_conv2d`, rounds w to x's dtype
first, as the JAX package's jnp path does; it is not this function.

There is no backward kernel, in the JAX package either (no custom_vjp on
`dwconv3x3`): on the card the wrappers refuse inputs that need a
gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def dwconv3x3_qkv_reference(x: torch.Tensor, w3: torch.Tensor,
                            b3: Optional[torch.Tensor] = None,
                            relu: bool = True) -> Tuple[torch.Tensor, ...]:
    """x (B, H, W, C); w3 (3, 3, 3, C): the q, k and v weight sets; b3
    (3, C) or None. Three `dwconv3x3_reference` results, each through
    F.relu when relu."""
    ys = (dwconv3x3_reference(x, w3[i], None if b3 is None else b3[i])
          for i in range(3))
    return tuple(F.relu(y) if relu else y for y in ys)


DW_THREADS, DW_CHUNK, DW_ITEMS, DW_STAGES = 256, 64, 1024, 3
DW_SMEM = 112 * 1024  # a block's ring and weights: two blocks per SM


class DwPlan(NamedTuple):
    nb: int     # images per tile
    Th: int     # rows per tile
    Tw: int     # columns per tile
    Cc: int     # channels per tile
    tiles: int
    smem: int   # bytes of shared memory a block takes


def dwconv_plan(B: int, H: int, W: int, C: int, esize: int, vec: bool,
                nq: int = 1) -> DwPlan:
    """The tiles of `csrc/dwconv.cu`: a channel chunk of at most DW_CHUNK,
    up to 32 columns, rows (or, when one image fits, whole images) up to
    about DW_ITEMS outputs of one 16-byte vector (one value when not
    `vec`), halved until DW_STAGES ring slots of the tile and its halo
    (each pixel's channels padded by 16 bytes) and nq sets of nine fp32
    weight rows and a bias fit in DW_SMEM."""
    V = 16 // esize if vec else 1
    Cc, Tw = min(C, DW_CHUNK), min(W, 32)
    cv = Cc // V
    Th = max(1, min(H, DW_ITEMS // (Tw * cv)))
    nb = max(1, min(B, DW_ITEMS // (H * W * cv))) \
        if (Th, Tw) == (H, W) else 1

    def smem():
        slot = -(-nb * (Th + 2) * (Tw + 2) * (Cc * esize + 16) // 128) * 128
        return DW_STAGES * slot + nq * 10 * Cc * 4

    while smem() > DW_SMEM:
        if nb > 1:
            nb = -(-nb // 2)
        elif Th > 1:
            Th = -(-Th // 2)
        elif Tw > 1:
            Tw = -(-Tw // 2)
        else:
            break
    tiles = -(-C // Cc) * -(-B // nb) * -(-H // Th) * -(-W // Tw)
    return DwPlan(nb, Th, Tw, Cc, tiles, smem())


def _launch_dw(x, w, b, nq: int, relu: bool, what: str):
    """One launch of the kernel on checked CUDA inputs: y (B, H, W, C), or
    (3, B, H, W, C) for nq = 3."""
    B, H, W, C = x.shape
    dev = x.device
    x_bf16, w_bf16 = int(x.dtype == torch.bfloat16), \
        int(w.dtype == torch.bfloat16)
    vec = int(C % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    plan = dwconv_plan(B, H, W, C, x.element_size(), bool(vec), nq)
    slots = _launch.resident_blocks("uf_dwconv3x3_slots", dev.index, x_bf16,
                                    w_bf16, vec, nq, plan.smem)
    y = torch.empty(((nq,) if nq > 1 else ()) + tuple(x.shape),
                    dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = load().uf_dwconv3x3(
            x_bf16, w_bf16, x.data_ptr(), w.data_ptr(), _launch.ptr(b),
            y.data_ptr(), B, H, W, C, vec, nq, int(relu), plan.nb, plan.Th,
            plan.Tw, plan.Cc, _launch.persistent_grid(plan.tiles, slots),
            _launch.stream(x))
    _launch.check(err, what)
    return y


def _check_dw(x, ws, w_shape, b, b_shape):
    """Raise unless x, the weights and the bias are what the kernel takes
    (and need no gradient); returns b as float32 or None."""
    _launch.check_input(x)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, ws, b)):
        raise NotImplementedError(DWCONV_BACKWARD_NOT_PORTED)
    if ws.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"w: dtype {ws.dtype}, expected float32 or "
                        f"{x.dtype}")
    _launch.expect(ws, "w", w_shape, ws.dtype, x.device)
    if b is not None:
        b = b.float()
        _launch.expect(b, "b", b_shape, torch.float32, x.device)
    return b


def dwconv3x3(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, H, W, C) float32 or bfloat16, any B, H, W, C >= 1; w (3, 3, C)
    float32 or x's dtype; b (C,) or None. Returns (B, H, W, C) in x's
    dtype. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if x.device.type == "cpu":
        dwconv3x3.plain_calls += 1
        return dwconv3x3_reference(x, w, b)
    C = x.shape[-1] if x.dim() else 0
    b = _check_dw(x, w, (3, 3, C), b, (C,))
    y = _launch_dw(x, w, b, 1, False, "dwconv3x3 kernel")
    dwconv3x3.launches += 1
    return y


dwconv3x3.launches = 0
dwconv3x3.plain_calls = 0


def dwconv3x3_qkv(x: torch.Tensor, w3: torch.Tensor,
                  b3: Optional[torch.Tensor] = None,
                  relu: bool = True) -> Tuple[torch.Tensor, ...]:
    """The q, k and v depthwise convolutions of one input in one launch:
    x (B, H, W, C) as `dwconv3x3` takes it; w3 (3, 3, 3, C) float32 or
    x's dtype, the three weight sets; b3 (3, C) or None. Returns three
    (B, H, W, C) tensors in x's dtype, each through ReLU when relu: the
    values of three `dwconv3x3` launches and F.relu. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        dwconv3x3_qkv.plain_calls += 1
        return dwconv3x3_qkv_reference(x, w3, b3, relu)
    C = x.shape[-1] if x.dim() else 0
    b3 = _check_dw(x, w3, (3, 3, 3, C), b3, (3, C))
    y = _launch_dw(x, w3, b3, 3, relu, "dwconv3x3_qkv kernel")
    dwconv3x3_qkv.launches += 1
    return y[0], y[1], y[2]


dwconv3x3_qkv.launches = 0
dwconv3x3_qkv.plain_calls = 0
