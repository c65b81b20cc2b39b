"""Windowed LeWin attention block: Hopper kernel and plain version.

Port of `uformer_tpu/ops/pallas/attention_block.py:fused_attention_block`
(kernel source `csrc/attention_block.cu`). It takes (Bw, 64, C) windows
already shifted and partitioned and returns the attention branch only:
[LN1] + modulator, q/kv projection, the window core, output projection.
The model runs it for the blocks that the image kernel does not take
(C = 16 in Uformer_T's outer stages). On the H100 a window is little
work, so latency between its steps sets the pace: in bf16 at C 16-64 the
kernel runs kernel 1's narrow body (`csrc/attention_block_narrow.cu` on
`csrc/attention_narrow_mma.cuh` with the identity token map): persistent
blocks, weights resident, the window core in registers, windows per work
item and grid planned as kernel 1's (`attention_image_plan`). fp32 and
bf16 at other widths run one window per block (`csrc/attention_window.cuh`).
`attention_block_reference` is the plain PyTorch version with the JAX
reference's signature (`attention_block.py:345`), plus the spatial
path's `w_off`.

Windows of N = win² < 64 tokens (a stage built below the window, or
`--win_size` below 8: JAX sends every block whose window is not 8 here,
`layers.py:773-775`) run in 64-row tiles of 64 // N whole windows
(`packed_operands`: the modulator's and the bias's tiles, the bias -inf
between two windows), on the same bodies: bf16 at C 8-64 the narrow body
on packed tiles (`csrc/attention_block_packed.cu`), else a tile per block.
Head dim 8 runs at every C (bf16: the narrow body at C 8-64, a tile per
block at C % 128 == 0). Head dims 24, 40, 48 and 56 (`--embed_dim`
24-56: C 24-896, none a power of two) run a window (tile) per block at
windows 1-8, both ways, and `attention_wide` above. Head dims 72-128 in
steps of 8 (`--embed_dim` 72-128: C 72-2048) run both ways at windows
1-8 (`FORWARD_HEAD_DIMS`), a window (tile) per block on the body of the
next multiple of 16, which projects q, k and v in turn
(`csrc/attention_block_big_heads.cu`) and in the backward makes dq, dk
and dv in turn (`csrc/attention_bwd_big_heads.cu`); above window 8 they
are refused before any launch (ROADMAP.md, port queue 2 item 9).
Windows above 8 (N
= win² > 64 tokens, any size) run `csrc/attention_wide.cu` through
`attention_wide`: the projections over 64-row tiles of tokens, the core
with a key-chunked online softmax, both ways, at every head dim of
`HEAD_DIMS`; the backward holds dS for a bounded group of windows at a
time (`DS_BUDGET`), its bf16 core on the tensor cores
(`csrc/wide_core_bwd_mma.cuh`), its fp32 core on the CUDA cores.

Its backward, `fused_attention_block_bwd`, is the port of
`attention_block.py:fused_attention_block_bwd` in its own layout (kernel
source `csrc/attention_block_bwd.cu`: in bf16 the tensor-core body
`csrc/attention_bwd_mma.cuh`, in fp32 `csrc/attention_window_bwd.cuh`,
with the identity token map; head dims 24-56 and 72-128 in both dtypes on
the one-window body, `csrc/attention_bwd_heads.cu` and
`csrc/attention_bwd_big_heads.cu`), windows 1-8: at
N < 64 on the forward's packed tiles (`csrc/attention_block_bwd_packed.cu`,
the operands' tiles from `packed_operands`, the tile gradients of the bias
and the modulator folded back by `fold_tile_bias`, `fold_tile_tokens`);
`attention_bwd_parts` allocates, launches and reduces for it and for the
image layout's backward (`attention_image.fused_attention_image_bwd`).
"""

from __future__ import annotations

from typing import Optional

import torch

from uformer_tpu_torch.ops.attention import window_attention
from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load
from uformer_tpu_torch.ops.kernels.attention_wide import (
    wide_attention_block,
    wide_block_bwd_parts,
)
from uformer_tpu_torch.ops.kernels.wgrad import colsum, sm_count, wgrad
from uformer_tpu_torch.ops.kernels.window_attention import (
    FORWARD_HEAD_DIMS,
    HEAD_DIMS,
    TILE,
    check_head_dim,
    check_window,
    fold_tile_bias,
    fold_tile_tokens,
    packed_tiles,
    tile_bias,
    tile_tokens,
    window_mask,
)
from uformer_tpu_torch.ops.norm import layer_norm


def attention_block_reference(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo,
                              bias, *, win, shift, H, W, scale, num_heads,
                              has_ln=True, w_off=0):
    """Plain windowed block on (Bw, N, C) windows after shift and
    partition; window i lies at place (w_off + i) mod nW of its H x W
    image. mod (N, C) or None."""
    Bw, N, C = x.shape
    D = C // num_heads
    dt = x.dtype
    if has_ln:
        x = layer_norm(x, ln_s, ln_b)
    xm = x + mod[None].to(dt) if mod is not None else x
    q = xm @ wq.to(dt) + bq.to(dt)
    kv = xm @ wkv.to(dt) + bkv.to(dt)
    q = q.reshape(Bw, N, num_heads, D).transpose(1, 2)
    k = kv[..., :C].reshape(Bw, N, num_heads, D).transpose(1, 2)
    v = kv[..., C:].reshape(Bw, N, num_heads, D).transpose(1, 2)
    mask = (window_mask(H, W, win, shift, Bw, w_off, x.device)
            if shift > 0 else None)
    out = window_attention(q, k, v, bias, mask, scale=scale)
    return out @ wo.to(dt) + bo.to(dt)


def fused_attention_block(x: torch.Tensor, mod: Optional[torch.Tensor],
                          ln_s: Optional[torch.Tensor],
                          ln_b: Optional[torch.Tensor], wq, bq, wkv, bkv, wo,
                          bo, bias, *, win: int, shift: int, H: int, W: int,
                          scale: float, num_heads: int, has_ln: bool = True,
                          w_off: int = 0) -> torch.Tensor:
    """x: (Bw, N, C) windows, N = win² (any win) -> (Bw, N, C), the
    attention branch.

    Weight layouts are the kernels' (in, out), as `fused_attention_image`
    takes them; mod (N, C) in x's dtype or None; bias (nH, N, N); ln_s,
    ln_b read only with has_ln. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (head dim in FORWARD_HEAD_DIMS at
    windows 1-8, in HEAD_DIMS above) or raises."""
    kw = dict(win=win, shift=shift, H=H, W=W, scale=scale,
              num_heads=num_heads, has_ln=has_ln, w_off=w_off)
    if x.device.type == "cpu":
        fused_attention_block.plain_calls += 1
        return attention_block_reference(x, mod, ln_s, ln_b, wq, bq, wkv,
                                          bkv, wo, bo, bias, **kw)
    _launch.check_input(x, "(Bw, N, C)")
    Bw, N, C = x.shape
    check_window(win, shift, H, W)
    # head dims 72-128 at windows 1-8 only (above: ROADMAP.md item 9)
    check_head_dim(C, num_heads,
                   HEAD_DIMS if N > TILE else FORWARD_HEAD_DIMS)
    if N != win * win or w_off < 0:
        raise ValueError(f"kernel needs N = win² and w_off >= 0: N={N} "
                         f"win={win} w_off={w_off}")
    dt, dev, f32 = x.dtype, x.device, torch.float32
    D = C // num_heads
    if has_ln:
        _launch.expect(ln_s, "ln_s", (C,), f32, dev)
        _launch.expect(ln_b, "ln_b", (C,), f32, dev)
    if mod is not None:
        _launch.expect(mod, "mod", (N, C), dt, dev)
    for name, t, shape, tdt in (
            ("x", x, (Bw, N, C), dt),
            ("wq", wq, (C, C), dt), ("bq", bq, (C,), f32),
            ("wkv", wkv, (C, 2 * C), dt), ("bkv", bkv, (2 * C,), f32),
            ("wo", wo, (C, C), dt), ("bo", bo, (C,), f32),
            ("bias", bias, (num_heads, N, N), f32)):
        _launch.expect(t, name, shape, tdt, dev)
    if N > TILE:
        y = wide_attention_block(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo,
                                 bo, bias, **kw, count=fused_attention_block)
        fused_attention_block.launches += 1
        return y
    is_bf16 = int(dt == torch.bfloat16)
    if is_bf16 and D == 8 and C > 64 and C % 128:
        raise ValueError(f"bf16 kernel takes head dim 8 at C 8-64 or "
                         f"C % 128 == 0: C={C}")
    mod, bias = packed_operands(mod, bias, N)
    lib = load()
    wn, grid, regions = block_plan(lib, Bw, C, D, is_bf16, dev, N)
    scratch = (torch.empty(regions * packed_tiles(Bw, N) * TILE, C,
                           dtype=dt, device=dev) if regions else None)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.uf_attention_block(
            is_bf16, x.data_ptr(), y.data_ptr(), _launch.ptr(mod),
            _launch.ptr(ln_s) if has_ln else None,
            _launch.ptr(ln_b) if has_ln else None, wq.data_ptr(),
            bq.data_ptr(), wkv.data_ptr(), bkv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), bias.data_ptr(), _launch.ptr(scratch), Bw, H, W,
            C, num_heads, win, shift, w_off, float(scale), int(has_ln), wn,
            grid, _launch.stream(x))
    _launch.check(err, "attention_block kernel")
    fused_attention_block.launches += 1
    return y


fused_attention_block.launches = 0
fused_attention_block.plain_calls = 0
# launches above window 8 by the core's body (`attention_wide._core`)
fused_attention_block.core_mma_launches = 0
fused_attention_block.core_fma_launches = 0


def packed_operands(mod: Optional[torch.Tensor], bias: torch.Tensor,
                    N: int):
    """The kernel's (64, C) modulator and (nH, 64, 64) bias for windows of
    N tokens: themselves at N = 64, else their tiles (`tile_tokens`,
    `tile_bias`) for 64-row tiles of 64 // N whole windows."""
    return (None if mod is None else tile_tokens(mod, N)), tile_bias(bias, N)


def block_plan(lib, Bw: int, C: int, D: int, is_bf16: int, dev,
               N: int = TILE):
    """(windows per work item, grid, scratch tiles a window) of kernel 5 on
    Bw windows of N tokens (at N < 64, its packed tiles stand for
    windows): kernel 1's plan (`attention_image_plan`); its narrow body
    persistent over `persistent_grid` blocks, else a block per window
    (tile), with `uf_attention_needs_scratch` 64 x C scratch tiles each."""
    from uformer_tpu_torch.ops.kernels.attention_image import (
        attention_image_plan,
    )

    items = packed_tiles(Bw, N)
    body, wn = attention_image_plan(items, C, D, bool(is_bf16),
                                    sm_count(dev))
    if body == "narrow":
        slots = _launch.resident_blocks("uf_attention_block_slots",
                                        dev.index, is_bf16, C, D, wn,
                                        int(N < TILE))
        return wn, _launch.persistent_grid(-(-items // wn), slots), 0
    return 1, items, _launch.scratch_regions(lib, is_bf16, C, D)


def vjp_reference(fn, x, g, args, has_ln, **kw):
    """The VJP at g of fn(x, *args, has_ln=has_ln, **kw) by torch autograd,
    args = (mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias), as the tuple
    of `uformer_tpu` `attention_block.py:fused_attention_block_bwd`:
    (dx, dmod, dln_s, dln_b, dwq, dbq, dwkv, dbkv, dwo, dbo, dbias), dx in
    x's dtype and the rest float32 (None for an absent mod or LN)."""
    args = [x, *args]
    if not has_ln:
        args[2] = args[3] = None
    with torch.enable_grad():
        args = [None if t is None else t.detach().requires_grad_(True)
                for t in args]
        y = fn(*args, has_ln=has_ln, **kw)
        live = [t for t in args if t is not None]
        grads = iter(torch.autograd.grad(y, live, g.to(y.dtype)))
    out = [None if t is None else next(grads) for t in args]
    return (out[0],) + tuple(None if d is None else d.float()
                             for d in out[1:])


def attention_block_vjp_reference(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv,
                                  wo, bo, bias, *, has_ln=True, **kw):
    """The VJP of `attention_block_reference` by torch autograd."""
    return vjp_reference(attention_block_reference, x, g,
                         (mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias),
                         has_ln, **kw)


MMA_WIDTHS = (8, 16, 32, 64, 128, 256, 512, 1024)  # C of the bf16 tiles
# D of the bf16 tiles; the other head dims take a window a block
MMA_HEAD_DIMS = (8, 16, 32, 64)


def windows_per_item(windows: int, C: int, sms: int) -> int:
    """Windows (packed tiles at N < 64: `packed_tiles`) one block of the
    bf16 attention backward takes, one after another, summing their dbias,
    dmod and dln shares before writing them: at C <= 128 the most of 4, 2
    and 1 that still leaves two work items per SM; 1 at wider C, where the
    windows are few."""
    if C > 128:
        return 1
    for wn in (4, 2):
        if -(-windows // wn) >= 2 * sms:
            return wn
    return 1


def attention_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias,
                        *, num_heads, has_ln, windows, launch, what,
                        N=TILE):
    """The attention backward on the card, unrun: checks the weights,
    allocates the per-token buffers of `windows` 64-row tiles (8x8
    windows, or at N < 64 packed tiles of 64 // N windows of N tokens,
    whose mod and bias come as their (64, C) and (nH, 64, 64) tiles) and
    the partial sums of their work items (bf16 at MMA_HEAD_DIMS:
    `windows_per_item` tiles each, or `heads_per_block` heads of one tile,
    C 8-1024 in powers of 2, at most 16 heads; fp32, and bf16 at head dims
    24-56 and 72-128: one tile; head dim 64 at C 512 and 1024 writes every
    tile's fp32 dxm to part_dxm and ends it in a second launch, and bf16
    at head dims 24-56 and 72-128 writes it there where it misses shared
    memory; the xm and dO tiles go to their scratches where they miss it,
    `uf_attention_bwd_scratch`), and
    returns ([(name, run)],
    result): the body, launch(lib, is_bf16, wn, hpb, *pointers) (a C
    entry taking x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bias, dx,
    xm_w, dqkv_w, o_img, dbias_part, dmod_part, dln_part, x_scratch,
    do_scratch, part_dxm in that order, then its own geometry, wn and
    hpb), then the weight gradients reduced over every token
    (`csrc/wgrad.cu`, the bias gradients of dqkv and g from the same
    passes; dWo over x's rows, the tiles' over their 64 rows, pad rows
    adding exact zeros), then the tile sums (colsum, dbias and dmod folded
    back to N tokens), each run() one of them in order on these buffers;
    result() gives the tuple of `fused_attention_block_bwd`, weight grads
    float32."""
    C = x.shape[-1]
    dt, dev, f32 = x.dtype, x.device, torch.float32
    if has_ln:
        _launch.expect(ln_s, "ln_s", (C,), f32, dev)
        _launch.expect(ln_b, "ln_b", (C,), f32, dev)
    if mod is not None:
        _launch.expect(mod, "mod", (64, C), dt, dev)
    for name, t, shape, tdt in (
            ("wq", wq, (C, C), dt), ("bq", bq, (C,), f32),
            ("wkv", wkv, (C, 2 * C), dt), ("bkv", bkv, (2 * C,), f32),
            ("wo", wo, (C, C), dt), ("bias", bias, (num_heads, 64, 64), f32)):
        _launch.expect(t, name, shape, tdt, dev)
    lib = load()
    is_bf16 = int(dt == torch.bfloat16)
    tiled = is_bf16 and C // num_heads in MMA_HEAD_DIMS
    if tiled and (C not in MMA_WIDTHS or num_heads > 16):
        raise ValueError(f"bf16 backward kernel needs C in {MMA_WIDTHS} "
                         f"and at most 16 heads: C={C} heads={num_heads}")
    M = windows * 64
    hpb = (heads_per_block(windows, C, num_heads, sm_count(dev))
           if tiled else num_heads)
    wn = (windows_per_item(windows, C, sm_count(dev))
          if tiled and hpb == num_heads else 1)
    items = -(-windows // wn)

    def empty(*shape, dtype=dt):
        return torch.empty(*shape, dtype=dtype, device=dev)

    need = lib.uf_attention_bwd_scratch(is_bf16, C, num_heads)
    if need < 0:
        _launch.check(-need, f"uf_attention_bwd_scratch(C={C}, "
                      f"heads={num_heads})")
    x_scr = empty(M, C) if need & 1 else None
    do_scr = empty(M, C) if need & 2 else None
    dx, o_tok = torch.empty_like(x), torch.empty_like(x)
    xm_w, dqkv_w = empty(M, C), empty(M, 3 * C)
    dbias_p = empty(items, num_heads * 4096, dtype=f32)
    dmod_p = empty(items, 64 * C, dtype=f32) if mod is not None else None
    dln_p = empty(items, 2 * C, dtype=f32) if has_ln else None
    # a window's heads split over blocks, or every window of a tile whose
    # fp32 dxm misses shared memory (need & 4): their fp32 shares of dxm
    part_dxm = (empty(num_heads // hpb, windows, 64, C, dtype=f32)
                if hpb < num_heads or need & 4 else None)
    ptrs = (x.data_ptr(), g.data_ptr(), _launch.ptr(mod),
            _launch.ptr(ln_s) if has_ln else None,
            _launch.ptr(ln_b) if has_ln else None, wq.data_ptr(),
            bq.data_ptr(), wkv.data_ptr(), bkv.data_ptr(), wo.data_ptr(),
            bias.data_ptr(), dx.data_ptr(), xm_w.data_ptr(),
            dqkv_w.data_ptr(), o_tok.data_ptr(), dbias_p.data_ptr(),
            _launch.ptr(dmod_p), _launch.ptr(dln_p), _launch.ptr(x_scr),
            _launch.ptr(do_scr), _launch.ptr(part_dxm))
    out = {}
    # the launch holds raw pointers: keep every buffer alive with it
    buffers = (x_scr, do_scr, dx, o_tok, xm_w, dqkv_w, dbias_p, dmod_p,
               dln_p, part_dxm)

    def body():
        _launch.check(launch(lib, is_bf16, wn, hpb, *ptrs), what)

    body.buffers = buffers

    def reduce(key, fn, *args, **kw):
        def run():
            out[key] = fn(*args, **kw)
        run.operands = args  # a wgrad's (a, b), for its yardstick
        return run

    parts = [("body", body),
             # (C, 3C) = [dwq | dwk | dwv], and [dbq | dbk | dbv]
             ("wgrad dWqkv", reduce("dw", wgrad, xm_w, dqkv_w,
                                    colsum_b=True)),
             ("wgrad dWo", reduce("dwo", wgrad, o_tok.view(-1, C),
                                  g.view(-1, C), colsum_b=True)),
             ("colsum", reduce("sums", lambda: (
                 fold_tile_bias(colsum(dbias_p).view(num_heads, 64, 64), N),
                 fold_tile_tokens(colsum(dmod_p).view(64, C), N)
                 if mod is not None else None,
                 colsum(dln_p) if has_ln else None)))]

    def result():
        dw, db = out["dw"]
        dwo, dbo = out["dwo"]
        dbias, dmod, dln = out["sums"]
        return (dx, dmod, dln[:C] if has_ln else None,
                dln[C:] if has_ln else None, dw[:, :C].contiguous(), db[:C],
                dw[:, C:].contiguous(), db[C:], dwo, dbo, dbias)

    return parts, result


def heads_per_block(windows: int, C: int, num_heads: int, sms: int) -> int:
    """Heads of one window that a block of the bf16 attention backward
    takes: all of them, unless C >= 256 and the windows are no more than
    half the SMs; then the fewest groups (2, 4, 8) that give two blocks
    per SM, each group's dq, dk and dv columns a whole number of the dxm
    product's K tiles (16 at C 512 and 1024, 32 at C = 256). (On an H100 the split
    paid at 32 windows and lost at 128: PERF.md, PR 7.)"""
    if C < 256 or 2 * windows > sms:
        return num_heads
    D, kx = C // num_heads, 16 if C >= 512 else 32
    best = num_heads
    for groups in (2, 4, 8):
        hpb = num_heads // groups
        if num_heads % groups or hpb * D % kx:
            break
        best = hpb
        if windows * groups >= 2 * sms:
            break
    return best


def run_parts(parts, device):
    with torch.cuda.device(device):
        for _, run in parts:
            run()


def fused_attention_block_bwd(x: torch.Tensor, g: torch.Tensor,
                              mod: Optional[torch.Tensor],
                              ln_s: Optional[torch.Tensor],
                              ln_b: Optional[torch.Tensor], wq, bq, wkv, bkv,
                              wo, bo, bias, *, win: int, shift: int, H: int,
                              W: int, scale: float, num_heads: int,
                              has_ln: bool = True, w_off: int = 0):
    """VJP of the windowed attention block at g: (dx, dmod, dln_s, dln_b,
    dwq, dbq, dwkv, dbkv, dwo, dbo, dbias), dx (Bw, N, C) in x's dtype,
    weight grads float32, None for an absent mod or LN (`uformer_tpu`
    `attention_block.py:877`).

    Kernel source `csrc/attention_block_bwd.cu` (and, at N < 64, on the
    forward's packed tiles, `csrc/attention_block_bwd_packed.cu`): one
    block per window (tile) recomputes the forward and walks the VJP; the
    weight gradients are then reduced over every token by
    `csrc/wgrad.cu`. Inputs as `fused_attention_block` takes them. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernels
    (any win, w_off 0: the JAX kernel has no
    offset; above window 8 `csrc/attention_wide.cu`) or raises. Head
    dim in FORWARD_HEAD_DIMS at windows 1-8 (24-56 on
    `csrc/attention_bwd_heads.cu`, 72-128 on
    `csrc/attention_bwd_big_heads.cu`), in HEAD_DIMS above."""
    kw = dict(win=win, shift=shift, H=H, W=W, scale=scale,
              num_heads=num_heads, has_ln=has_ln, w_off=w_off)
    if x.device.type == "cpu":
        fused_attention_block_bwd.plain_calls += 1
        return attention_block_vjp_reference(x, g, mod, ln_s, ln_b, wq, bq,
                                             wkv, bkv, wo, bo, bias, **kw)
    parts, result = attention_block_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq,
                                              wkv, bkv, wo, bo, bias, **kw)
    run_parts(parts, x.device)
    fused_attention_block_bwd.launches += 1
    return result()


def attention_block_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo,
                              bo, bias, *, win, shift, H, W, scale,
                              num_heads, has_ln=True, w_off=0):
    """`fused_attention_block_bwd`'s launches on CUDA tensors, unrun, as
    `attention_bwd_parts` returns them."""
    _launch.check_input(x, "(Bw, N, C)")
    _launch.check_input(g, "(Bw, N, C)")
    Bw, N, C = x.shape
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    check_window(win, shift, H, W)
    # head dims 72-128 at windows 1-8 only (above: ROADMAP.md item 9)
    check_head_dim(C, num_heads,
                   HEAD_DIMS if N > TILE else FORWARD_HEAD_DIMS)
    if N != win * win or w_off != 0:
        raise ValueError(f"backward kernel needs N = win² and w_off = 0: "
                         f"N={N} win={win} w_off={w_off}")
    if mod is not None:
        _launch.expect(mod, "mod", (N, C), x.dtype, x.device)
    _launch.expect(bias, "bias", (num_heads, N, N), torch.float32, x.device)
    if N > TILE:
        for name, t, shape, tdt in (
                ("wq", wq, (C, C), x.dtype), ("bq", bq, (C,), torch.float32),
                ("wkv", wkv, (C, 2 * C), x.dtype),
                ("bkv", bkv, (2 * C,), torch.float32),
                ("wo", wo, (C, C), x.dtype)):
            _launch.expect(t, name, shape, tdt, x.device)
        if has_ln:
            _launch.expect(ln_s, "ln_s", (C,), torch.float32, x.device)
            _launch.expect(ln_b, "ln_b", (C,), torch.float32, x.device)
        return wide_block_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv,
                                    wo, bias, win=win, shift=shift, H=H, W=W,
                                    scale=scale, num_heads=num_heads,
                                    has_ln=has_ln,
                                    count=fused_attention_block_bwd)
    mod, bias = packed_operands(mod, bias, N)

    def launch(lib, is_bf16, wn, hpb, *ptrs):
        return lib.uf_attention_block_bwd(
            is_bf16, *ptrs, Bw, H, W, C, num_heads, win, shift, float(scale),
            int(has_ln), wn, hpb, _launch.stream(x))

    return attention_bwd_parts(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo,
                               bias, num_heads=num_heads, has_ln=has_ln,
                               windows=packed_tiles(Bw, N), launch=launch,
                               what="attention_block_bwd kernel", N=N)


fused_attention_block_bwd.launches = 0
fused_attention_block_bwd.plain_calls = 0
# launches above window 8 by the core's body (`attention_wide`'s
# `wide_block_bwd_parts`)
fused_attention_block_bwd.core_mma_launches = 0
fused_attention_block_bwd.core_fma_launches = 0


class _AttentionBlock(torch.autograd.Function):
    """fused_attention_block forward; fused_attention_block_bwd backward.
    Saves only the inputs and weights (`uformer_tpu`
    `attention_block.py:1014-1015`); grads are cast to each input's dtype
    (`attention_block.py:1024-1028`)."""

    @staticmethod
    def forward(ctx, x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias, kw):
        ctx.kw = kw
        ctx.save_for_backward(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo,
                              bias)
        return fused_attention_block(x, mod, ln_s, ln_b, wq, bq, wkv, bkv,
                                     wo, bo, bias, **kw)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = fused_attention_block_bwd(saved[0], g.contiguous(),
                                          *saved[1:], **ctx.kw)
        return tuple(None if d is None or t is None else d.to(t.dtype)
                     for d, t in zip(grads, saved)) + (None,)


def attention_block_ad(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias,
                       *, win: int, shift: int, H: int, W: int, scale: float,
                       num_heads: int, has_ln: bool = True,
                       w_off: int = 0) -> torch.Tensor:
    """Differentiable `fused_attention_block`: its backward is
    `fused_attention_block_bwd`."""
    kw = dict(win=win, shift=shift, H=H, W=W, scale=scale,
              num_heads=num_heads, has_ln=has_ln, w_off=w_off)
    return _AttentionBlock.apply(x, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo,
                                 bo, bias, kw)
