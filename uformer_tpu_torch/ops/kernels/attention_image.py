"""Image-layout LeWin attention sub-block: Hopper kernel and plain version.

Port of `uformer_tpu/ops/pallas/attention_image.py:fused_attention_image`
(kernel source `csrc/attention_image.cu`), window 8 (as the JAX
kernel, `attention_image.py:665`), head dim 8-128, a multiple of 8. On the
H100 a window is little work at every width, so latency between small
products sets the pace. In bf16 two persistent bodies on `mma.sync` read
and write the NHWC image once: at C 16-64 (`csrc/attention_narrow_mma.cuh`)
the weights stay in shared memory, four warps take a window with its
softmax core in registers and the next window's gather in flight; at C
128-512 the stage kernel's attention half (`csrc/attention_mma.cuh`)
takes 1-4 windows per work item with the weights streamed through a
`cp.async` ring. `attention_image_plan` picks the body and the windows per
work item. Head dim 8 runs the narrow body at C 32 and 64 (its QKᵀ and
O wo of depth 8 on mma.sync.m16n8k8) and the wide body at C 128 (16-wide
products over zeroed pad columns; training reaches it, as the stage
kernel runs only in eval). Head dim 64 (`--embed_dim 64`) runs the
narrow body at C 64 (one head) and the wide one at C 128-512 (two
windows a work item at most). fp32, and bf16 at C 1024 and at head dims
24, 40, 48 and 56 (`--embed_dim` 24-56, C 384-896 on the image route)
and 72-128 (`--embed_dim` 72-128 in training: every block with C % 128
== 0, C 128-2048), run one window per block (`csrc/attention_window.cuh`;
those head dims on kernel 5's instantiations,
`csrc/attention_block_heads.cu` and `csrc/attention_block_big_heads.cu`).
`attention_image_reference` is the plain PyTorch version with the JAX
reference's signature (`attention_image.py:432`). Its backward,
`fused_attention_image_bwd` (kernel source `csrc/attention_bwd.cu`),
takes every head dim the forward does (head dim 64 at C 512 and 1024
with g streamed and dxm through device memory,
`csrc/attention_bwd_mma.cuh`'s kBig; 24-56 one window a block,
`csrc/attention_bwd_heads.cu`; 72-128 one window a block on the body of
the next multiple of 16, `csrc/attention_bwd_big_heads.cu`).
"""

from __future__ import annotations

from typing import Optional

import torch

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load
from uformer_tpu_torch.ops.kernels.attention_block import (
    attention_block_reference,
    attention_bwd_parts,
    run_parts,
    vjp_reference,
)
from uformer_tpu_torch.ops.kernels.wgrad import sm_count
from uformer_tpu_torch.ops.kernels.window_attention import (
    FORWARD_HEAD_DIMS,
    check_head_dim,
    check_window,
)
from uformer_tpu_torch.ops.norm import layer_norm
from uformer_tpu_torch.ops.window import (
    cyclic_shift,
    cyclic_unshift,
    window_partition,
    window_reverse,
)


def attention_image_reference(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo,
                              bias, *, win, shift, scale, num_heads,
                              has_ln=True, residual=True):
    """LN -> shift -> partition -> attention block -> reverse -> unshift
    [-> + x], on the (B, H, W, C) image."""
    _, H, W, _ = x.shape
    y = layer_norm(x, ln_s, ln_b) if has_ln else x
    wnd = window_partition(cyclic_shift(y, shift), win)
    out = attention_block_reference(
        wnd, mod, None, None, wq, bq, wkv, bkv, wo, bo, bias, win=win,
        shift=shift, H=H, W=W, scale=scale, num_heads=num_heads,
        has_ln=False)
    out = cyclic_unshift(window_reverse(out, win, H, W), shift)
    return x + out if residual else out


NARROW_WIDTHS = (8, 16, 32, 64)  # C 8: head dim 8, kernel 5 only
WIDE_WIDTHS = (128, 256, 512)


def wide_windows(windows: int, sms: int, C: int, D: int = 32) -> int:
    """Windows per work item of the wide body (`csrc/stage.cu:wide_windows`):
    the most, up to 512 / C (and 2 at head dim 64: four windows' q, k, v
    and O tiles, 64 rows each, would not fit beside the weight ring,
    `csrc/attention_mma.cuh:attn_wide_wn_fits`), that do not add a round
    of items over one block per SM."""
    best, best_cost, wn = 1, None, 1
    while wn * C <= 512 and (D < 64 or wn <= 2):
        items = -(-windows // wn)
        cost = -(-items // sms) * wn  # rounds of items, each WN windows
        if best_cost is None or cost <= best_cost:
            best, best_cost = wn, cost
        wn *= 2
    return best


def attention_image_plan(windows: int, C: int, D: int, bf16: bool,
                         sms: int):
    """(body, windows per work item) of kernel 1 on `windows` 8x8 windows
    of width C, head dim D: in bf16 the narrow body at C 16-64 with the
    most of 4, 2, 1 windows (one per group of four warps) that still
    leaves a work item per SM, the wide body at C 128-512 (head dim 8 at
    C 128) with `wide_windows`; else ("window", 1), one window per
    block (fp32, and bf16 at C 1024 and at head dims 24-56 and 72-128)."""
    if D > 64:
        return "window", 1
    if bf16 and C in NARROW_WIDTHS and C >= D:
        for wn in (4, 2):
            if -(-windows // wn) >= sms:
                return "narrow", wn
        return "narrow", 1
    if bf16 and C in WIDE_WIDTHS and (D != 8 or C == 128):
        return "wide", wide_windows(windows, sms, C, D)
    return "window", 1


def _check_geometry(x, win, shift, num_heads):
    """Kernels 1 and 6's image-layout geometry: window 8; head dim in
    FORWARD_HEAD_DIMS (in bf16 head dim 8 from C = 32, where JAX's image
    route starts)."""
    _, H, W, C = x.shape
    check_window(win, shift, H, W, windows=(8,))
    check_head_dim(C, num_heads, FORWARD_HEAD_DIMS)
    if x.dtype == torch.bfloat16 and C // num_heads == 8 and C < 32:
        raise ValueError(f"bf16 kernel takes head dim 8 from C = 32: C={C}")


def fused_attention_image(x: torch.Tensor, mod: Optional[torch.Tensor],
                          ln_s: Optional[torch.Tensor],
                          ln_b: Optional[torch.Tensor], wq, bq, wkv, bkv, wo,
                          bo, bias, *, win: int, shift: int, scale: float,
                          num_heads: int, has_ln: bool = True,
                          residual: bool = True) -> torch.Tensor:
    """x: (B, H, W, C) block input -> (B, H, W, C).

    Weight layouts are the kernels' (in, out): wq, wo (C, C) and
    wkv (C, 2C) = [k | v] in x's dtype; mod (64, C) in x's dtype or None;
    bq, bkv, bo, ln_s, ln_b float32; bias (nH, 64, 64) float32.
    A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (win 8, head dim in FORWARD_HEAD_DIMS; its body and
    windows per work item from `attention_image_plan`) or raises."""
    if x.device.type == "cpu":
        fused_attention_image.plain_calls += 1
        return attention_image_reference(
            x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias, win=win,
            shift=shift, scale=scale, num_heads=num_heads, has_ln=has_ln,
            residual=residual)
    _launch.check_input(x)
    B, H, W, C = x.shape
    _check_geometry(x, win, shift, num_heads)
    dt, dev, f32 = x.dtype, x.device, torch.float32
    if has_ln:
        _launch.expect(ln_s, "ln_s", (C,), f32, dev)
        _launch.expect(ln_b, "ln_b", (C,), f32, dev)
    if mod is not None:
        _launch.expect(mod, "mod", (64, C), dt, dev)
    for name, t, shape, tdt in (
            ("wq", wq, (C, C), dt), ("bq", bq, (C,), f32),
            ("wkv", wkv, (C, 2 * C), dt), ("bkv", bkv, (2 * C,), f32),
            ("wo", wo, (C, C), dt), ("bo", bo, (C,), f32),
            ("bias", bias, (num_heads, 64, 64), f32)):
        _launch.expect(t, name, shape, tdt, dev)
    lib = load()
    is_bf16 = int(dt == torch.bfloat16)
    D, windows = C // num_heads, B * (H // 8) * (W // 8)
    body, wn = attention_image_plan(windows, C, D, bool(is_bf16),
                                    sm_count(dev))
    grid, scratch = windows, None
    if body != "window":
        slots = _launch.resident_blocks("uf_attention_image_slots",
                                        dev.index, is_bf16, C, D, wn)
        grid = _launch.persistent_grid(-(-windows // wn), slots)
    else:
        regions = _launch.scratch_regions(lib, is_bf16, C, D)
        scratch = (torch.empty((regions,) + x.shape, dtype=dt, device=dev)
                   if regions else None)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.uf_attention_image(
            is_bf16, x.data_ptr(), y.data_ptr(), _launch.ptr(mod),
            _launch.ptr(ln_s) if has_ln else None,
            _launch.ptr(ln_b) if has_ln else None, wq.data_ptr(),
            bq.data_ptr(), wkv.data_ptr(), bkv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), bias.data_ptr(), _launch.ptr(scratch), B, H, W, C,
            num_heads, shift, float(scale), int(has_ln), int(residual), wn,
            grid, _launch.stream(x))
    _launch.check(err, "attention_image kernel")
    fused_attention_image.launches += 1
    return y


fused_attention_image.launches = 0
fused_attention_image.plain_calls = 0


def attention_image_vjp_reference(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv,
                                  wo, bo, bias, *, win, shift, scale,
                                  num_heads, has_ln=True, residual=True):
    """The VJP of `attention_image_reference` by torch autograd, as the
    tuple of `uformer_tpu` `attention_block.py:fused_attention_block_bwd`:
    (dx, dmod, dln_s, dln_b, dwq, dbq, dwkv, dbkv, dwo, dbo, dbias), dx in
    x's dtype and the rest float32 (None for an absent mod or LN)."""
    return vjp_reference(attention_image_reference, x, g,
                         (mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias),
                         has_ln, win=win, shift=shift, scale=scale,
                         num_heads=num_heads, residual=residual)


def fused_attention_image_bwd(x: torch.Tensor, g: torch.Tensor,
                              mod: Optional[torch.Tensor],
                              ln_s: Optional[torch.Tensor],
                              ln_b: Optional[torch.Tensor], wq, bq, wkv, bkv,
                              wo, bo, bias, *, win: int, shift: int,
                              scale: float, num_heads: int,
                              has_ln: bool = True, residual: bool = True):
    """VJP of the image-layout attention sub-block: (dx, dmod, dln_s,
    dln_b, dwq, dbq, dwkv, dbkv, dwo, dbo, dbias), weight grads float32
    (`uformer_tpu` `attention_block.py:877`, as `attention_image.py:482`
    calls it).

    Kernel source `csrc/attention_bwd.cu`: one block per shifted window
    gathers x and g from the image, recomputes the forward and walks the
    VJP; the weight gradients are then reduced over every token by
    `csrc/wgrad.cu` (`attention_image_bwd_parts` lists the launches). Inputs as
    `fused_attention_image` takes them. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels (win 8, head dim in
    FORWARD_HEAD_DIMS; in bf16 head dim 8 from C = 32) or raises."""
    kw = dict(win=win, shift=shift, scale=scale, num_heads=num_heads,
              has_ln=has_ln, residual=residual)
    if x.device.type == "cpu":
        fused_attention_image_bwd.plain_calls += 1
        return attention_image_vjp_reference(x, g, mod, ln_s, ln_b, wq, bq,
                                             wkv, bkv, wo, bo, bias, **kw)
    parts, result = attention_image_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq,
                                              wkv, bkv, wo, bo, bias, **kw)
    run_parts(parts, x.device)
    fused_attention_image_bwd.launches += 1
    return result()


def attention_image_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo,
                              bo, bias, *, win, shift, scale, num_heads,
                              has_ln=True, residual=True):
    """`fused_attention_image_bwd`'s launches on CUDA tensors, unrun, as
    `attention_block.attention_bwd_parts` returns them."""
    _launch.check_input(x)
    _launch.check_input(g)
    B, H, W, C = x.shape
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    _check_geometry(x, win, shift, num_heads)

    def launch(lib, is_bf16, wn, hpb, *ptrs):
        return lib.uf_attention_bwd(
            is_bf16, *ptrs, B, H, W, C, num_heads, shift, float(scale),
            int(has_ln), int(residual), wn, hpb, _launch.stream(x))

    return attention_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo,
                               bias, num_heads=num_heads, has_ln=has_ln,
                               windows=B * (H // 8) * (W // 8), launch=launch,
                               what="attention_bwd kernel")


fused_attention_image_bwd.launches = 0
fused_attention_image_bwd.plain_calls = 0


class _AttentionImage(torch.autograd.Function):
    """fused_attention_image forward; fused_attention_image_bwd backward.
    Saves only the inputs and weights (`uformer_tpu`
    `attention_image.py:479-480`); grads are cast to each input's dtype
    (`attention_image.py:521-525`)."""

    @staticmethod
    def forward(ctx, x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias, kw):
        ctx.kw = kw
        ctx.save_for_backward(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo,
                              bias)
        return fused_attention_image(x, mod, ln_s, ln_b, wq, bq, wkv, bkv,
                                     wo, bo, bias, **kw)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = fused_attention_image_bwd(saved[0], g.contiguous(),
                                          *saved[1:], **ctx.kw)
        return tuple(None if d is None or t is None else d.to(t.dtype)
                     for d, t in zip(grads, saved)) + (None,)


def attention_image_ad(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias,
                       *, win: int, shift: int, scale: float, num_heads: int,
                       has_ln: bool = True,
                       residual: bool = True) -> torch.Tensor:
    """Differentiable `fused_attention_image`: its backward is
    `fused_attention_image_bwd`."""
    kw = dict(win=win, shift=shift, scale=scale, num_heads=num_heads,
              has_ln=has_ln, residual=residual)
    return _AttentionImage.apply(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo,
                                 bo, bias, kw)
