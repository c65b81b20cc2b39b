"""LeFF sub-block: Hopper kernel and plain version.

Port of `uformer_tpu/ops/pallas/leff.py:fused_leff` (kernel source
`csrc/leff.cu`, tiles in `csrc/leff_mma.cuh` and `csrc/leff_tile.cuh`).
On the H100 the bound is the products at C >= 128 and the bytes of x and
y below; the 4C-wide hidden never touches device memory. In bf16 the
tensor-core tiles keep the second product's accumulator in registers:
8 x 8 or 16 x 8 output tiles with the weights streamed through a
cp.async ring at C 128-512, and persistent blocks over 8 x 16 tiles with
the weights resident at C 16-64; they mask partial tiles, so any H and W
run. fp32 (the exact-check path) keeps TH x 8 tiles, H a multiple of TH
and W of 8.
`leff_reference` is the plain PyTorch version with the JAX reference's
signature (`leff.py:504`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uformer_tpu_torch.ops.dwconv import depthwise_conv2d
from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load
from uformer_tpu_torch.ops.kernels.wgrad import colsum, sm_count, wgrad
from uformer_tpu_torch.ops.norm import layer_norm

HIDDEN_CHUNK = 64  # the kernel walks the hidden in chunks of this width


def leff_reference(x, w1, b1, wd, bd, w2, b2, ln_s=None, ln_b=None,
                   residual=False):
    """[x +] W2 . GELU(dw3x3(GELU(W1 . LN(x) + b1)) + bd) + b2, in x's
    dtype; erf GELU; SAME padding zeroes the hidden outside the image."""
    x0 = x
    if ln_s is not None:
        x = layer_norm(x, ln_s, ln_b)
    dt = x.dtype
    y = F.gelu(x @ w1.to(dt) + b1.to(dt))
    y = F.gelu(depthwise_conv2d(y, wd, bd))
    y = y @ w2.to(dt) + b2.to(dt)
    return x0 + y if residual else y


def fused_leff(x: torch.Tensor, w1, b1, wd, bd, w2, b2, ln_s=None, ln_b=None,
               *, residual: bool = False) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H, W, C).

    w1 (C, Ch), wd (3, 3, Ch), w2 (Ch, C) in x's dtype; b1, bd, b2, ln_s,
    ln_b float32. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if x.device.type == "cpu":
        fused_leff.plain_calls += 1
        return leff_reference(x, w1, b1, wd, bd, w2, b2, ln_s=ln_s,
                              ln_b=ln_b, residual=residual)
    _launch.check_input(x)
    B, H, W, C = x.shape
    Ch = w1.shape[-1]
    lib = load()
    is_bf16 = int(x.dtype == torch.bfloat16)
    th = tile_rows(x, Ch)
    tw = 8 if th > 1 else 1
    if C % 16 or Ch % HIDDEN_CHUNK or H % th or W % tw:
        raise ValueError(f"kernel needs C % 16 == 0, Ch % {HIDDEN_CHUNK} "
                         f"== 0, H % {th} == 0 and W % {tw} == 0: "
                         f"C={C} Ch={Ch} H={H} W={W}")
    dt, dev, f32 = x.dtype, x.device, torch.float32
    has_ln = ln_s is not None
    if has_ln:
        _launch.expect(ln_s, "ln_s", (C,), f32, dev)
        _launch.expect(ln_b, "ln_b", (C,), f32, dev)
    for name, t, shape, tdt in (
            ("w1", w1, (C, Ch), dt), ("b1", b1, (Ch,), f32),
            ("wd", wd, (3, 3, Ch), dt), ("bd", bd, (Ch,), f32),
            ("w2", w2, (Ch, C), dt), ("b2", b2, (C,), f32)):
        _launch.expect(t, name, shape, tdt, dev)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.uf_leff(
            is_bf16, x.data_ptr(), y.data_ptr(), _launch.ptr(ln_s),
            _launch.ptr(ln_b), w1.data_ptr(), b1.data_ptr(), wd.data_ptr(),
            bd.data_ptr(), w2.data_ptr(), b2.data_ptr(), B, H, W, C, Ch,
            int(has_ln), int(residual), _launch.stream(x))
    _launch.check(err, "leff kernel")
    fused_leff.launches += 1
    return y


fused_leff.launches = 0
fused_leff.plain_calls = 0


def tile_rows(x: torch.Tensor, Ch: int) -> int:
    """The multiple of rows `fused_leff` takes for x's dtype and width at
    hidden width Ch: its fp32 tile's height on a card tensor (the bf16
    tiles mask partial tiles: 1), and 1 for the plain version."""
    if x.device.type == "cpu":
        return 1
    return load().uf_leff_tile_rows(int(x.dtype == torch.bfloat16),
                                    x.shape[-1], Ch)


def _f32(t):
    return None if t is None else t.float()


def leff_vjp_reference(x, dy, w1, b1, wd, bd, w2, ln_s=None, ln_b=None, *,
                       has_ln=True, residual=False):
    """The VJP of `leff_reference` by torch autograd, as the tuple of
    `uformer_tpu` `leff.py:fused_leff_bwd`: (dx, dw1, db1, dwd, dbd, dw2,
    db2, dln_s, dln_b), dx in x's dtype and the rest float32 (dln_s, dln_b
    None without LN). b2 does not enter the VJP."""
    b2 = torch.zeros(w2.shape[-1], dtype=torch.float32, device=x.device)
    prm = [x, w1, b1, wd, bd, w2, b2] + ([ln_s, ln_b] if has_ln else [])
    with torch.enable_grad():
        prm = [t.detach().requires_grad_(True) for t in prm]
        y = leff_reference(*prm[:7], ln_s=prm[7] if has_ln else None,
                           ln_b=prm[8] if has_ln else None,
                           residual=residual)
        grads = torch.autograd.grad(y, prm, dy.to(y.dtype))
    if not has_ln:
        grads = grads + (None, None)
    return (grads[0],) + tuple(_f32(d) for d in grads[1:])


def chunks_per_block(tiles: int, chunks: int, C: int, sms: int) -> int:
    """Hidden chunks (of HIDDEN_CHUNK channels) that one block of a LeFF
    backward kernel takes from a tile: all of them, unless C >= 256 and
    the image has no more tiles than half the SMs; then the tile's chunks
    are split into groups of at least two, enough groups that the blocks
    make about two waves of the SMs. (On an H100 the split paid at 32
    tiles and lost at 128: PERF.md, PR 7.)"""
    if C < 256 or 2 * tiles > sms:
        return chunks
    groups = -(-2 * sms // tiles)
    return max(2, -(-chunks // groups))


def fused_leff_bwd(x: torch.Tensor, dy: torch.Tensor, w1, b1, wd, bd, w2,
                   ln_s=None, ln_b=None, *, has_ln: bool = True,
                   residual: bool = False):
    """VJP of the LeFF sub-block: (dx, dw1, db1, dwd, dbd, dw2, db2, dln_s,
    dln_b), weight grads float32 (`uformer_tpu` `leff.py:880`).

    Kernel source `csrc/leff_bwd.cu` (two tile kernels that recompute the
    hidden from x; in bf16 the tensor-core tiles of `csrc/leff_bwd_mma.cuh`,
    at C 16-512, their hidden chunks split over blocks where tiles are few,
    `chunks_per_block`), then the weight gradients reduced over every pixel
    by `csrc/wgrad.cu` (`leff_bwd_parts` lists the launches). Any H and W.
    Weights as `fused_leff` takes them. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels or raises."""
    if x.device.type == "cpu":
        fused_leff_bwd.plain_calls += 1
        return leff_vjp_reference(x, dy, w1, b1, wd, bd, w2, ln_s, ln_b,
                                  has_ln=has_ln, residual=residual)
    parts, result = leff_bwd_parts(x, dy, w1, b1, wd, bd, w2, ln_s, ln_b,
                                   has_ln=has_ln, residual=residual)
    with torch.cuda.device(x.device):
        for _, run in parts:
            run()
    fused_leff_bwd.launches += 1
    return result()


def leff_bwd_parts(x, dy, w1, b1, wd, bd, w2, ln_s=None, ln_b=None, *,
                   has_ln=True, residual=False):
    """The launches of `fused_leff_bwd` on CUDA tensors, unrun: ([(name,
    run)], result), each run() one launch (or a weight-gradient reduction)
    on buffers allocated here, in order; result() gives the VJP tuple once
    all have run. Run alone, each can be timed on the same buffers."""
    _launch.check_input(x)
    _launch.check_input(dy)
    B, H, W, C = x.shape
    Ch = w1.shape[-1]
    dt, dev, f32 = x.dtype, x.device, torch.float32
    if dy.shape != x.shape or dy.dtype != dt:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {dt}")
    lib = load()
    is_bf16 = int(dt == torch.bfloat16)
    tha = lib.uf_leff_bwd_tile_rows(0, is_bf16, C)
    thb = lib.uf_leff_bwd_tile_rows(1, is_bf16, C)
    if C % 16 or Ch % HIDDEN_CHUNK or not tha:
        raise ValueError(f"kernel needs C % 16 == 0 (bf16: C 16, 32, ..., "
                         f"512) and Ch % {HIDDEN_CHUNK} == 0: C={C} Ch={Ch}")
    if has_ln:
        _launch.expect(ln_s, "ln_s", (C,), f32, dev)
        _launch.expect(ln_b, "ln_b", (C,), f32, dev)
    for name, t, shape, tdt in (
            ("w1", w1, (C, Ch), dt), ("b1", b1, (Ch,), f32),
            ("wd", wd, (3, 3, Ch), dt), ("bd", bd, (Ch,), f32),
            ("w2", w2, (Ch, C), dt)):
        _launch.expect(t, name, shape, tdt, dev)
    ln_p = (_launch.ptr(ln_s), _launch.ptr(ln_b)) if has_ln else (None, None)
    tail = (B, H, W, C, Ch, int(has_ln), int(residual), _launch.stream(x))
    M, chunks = B * H * W, Ch // HIDDEN_CHUNK

    def tiles(th):
        return B * -(-H // th) * -(-W // 8)

    def split(th):
        return (chunks_per_block(tiles(th), chunks, C, sm_count(dev))
                if is_bf16 else chunks)

    def empty(*shape, dtype=dt):
        return torch.empty(*shape, dtype=dtype, device=dev)

    cpg_a, cpg_b = split(tha), split(thb)
    groups = -(-chunks // cpg_b)
    g, dpre2, dpre1 = empty(M, Ch), empty(M, Ch), empty(M, Ch)
    dx, ln = torch.empty_like(x), empty(M, C)
    part_a = empty(tiles(tha), 10 * Ch, dtype=f32)
    # per tile: dln_s, dln_b (with LN only), then db1, summed from the fp32
    # hidden gradient before its rounding (`leff.py:682`)
    part_b = empty(tiles(thb), 2 * C + Ch, dtype=f32)
    part_dln = (empty(groups, tiles(thb), thb * 8, C, dtype=f32)
                if groups > 1 else None)
    common = (x.data_ptr(), dy.data_ptr(), *ln_p, w1.data_ptr(),
              b1.data_ptr(), wd.data_ptr(), bd.data_ptr())
    a_ptrs = (*common, w2.data_ptr(), g.data_ptr(), dpre2.data_ptr(),
              part_a.data_ptr(), None, None, None, None, None, cpg_a)
    b_ptrs = (*common, None, None, dpre2.data_ptr(), None, dx.data_ptr(),
              ln.data_ptr(), dpre1.data_ptr(), part_b.data_ptr(),
              _launch.ptr(part_dln), cpg_b)
    out = {}
    # the launches hold raw pointers: keep every buffer alive with them
    buffers = (g, dpre2, dpre1, dx, ln, part_a, part_b, part_dln)

    def kernel(which, ptrs, what):
        def run():
            _launch.check(lib.uf_leff_bwd(which, is_bf16, *ptrs, *tail), what)
        run.buffers = buffers
        return run

    def reduce(key, fn, *args, **kw):
        def run():
            out[key] = fn(*args, **kw)
        run.operands = args  # a wgrad's (a, b), for its yardstick
        return run

    parts = [("A", kernel(0, a_ptrs, "leff_bwd kernel A")),
             ("wgrad dW2", reduce("dw2", wgrad, g, dy.view(M, C),
                                  colsum_b=True)),
             ("B", kernel(1, b_ptrs, "leff_bwd kernel B"))]
    if groups > 1:
        parts.append(("B finish", kernel(2, b_ptrs, "leff_bwd finish")))
    parts += [("wgrad dW1", reduce("dw1", wgrad, ln, dpre1)),
              ("colsum", reduce("sums", lambda: (
                  colsum(part_b if has_ln else part_b[:, 2 * C:]),
                  colsum(part_a))))]

    def result():
        dw2, db2 = out["dw2"]
        pb, pa = out["sums"]
        dln, db1 = (pb[:2 * C], pb[2 * C:]) if has_ln else (None, pb)
        return (dx, out["dw1"], db1, pa[:9 * Ch].view(3, 3, Ch),
                pa[9 * Ch:], dw2, db2, dln[:C] if has_ln else None,
                dln[C:] if has_ln else None)

    return parts, result


fused_leff_bwd.launches = 0
fused_leff_bwd.plain_calls = 0


class _LeFF(torch.autograd.Function):
    """fused_leff forward; fused_leff_bwd backward. Saves only the inputs
    and weights (`uformer_tpu` `leff.py:1086-1087`); grads are cast to each
    input's dtype (`leff.py:1099-1103`)."""

    @staticmethod
    def forward(ctx, x, w1, b1, wd, bd, w2, b2, ln_s, ln_b, residual):
        ctx.residual = residual
        ctx.save_for_backward(x, w1, b1, wd, bd, w2, b2, ln_s, ln_b)
        return fused_leff(x, w1, b1, wd, bd, w2, b2, ln_s=ln_s, ln_b=ln_b,
                          residual=residual)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        x, w1, b1, wd, bd, w2, _, ln_s, ln_b = saved
        grads = fused_leff_bwd(x, dy.contiguous(), w1, b1, wd, bd, w2, ln_s,
                               ln_b, has_ln=ln_s is not None,
                               residual=ctx.residual)
        return tuple(None if d is None else d.to(t.dtype)
                     for d, t in zip(grads, saved)) + (None,)


def leff_ad(x, w1, b1, wd, bd, w2, b2, ln_s=None, ln_b=None, *,
            residual: bool = False) -> torch.Tensor:
    """Differentiable `fused_leff`: its backward is `fused_leff_bwd`."""
    return _LeFF.apply(x, w1, b1, wd, bd, w2, b2, ln_s, ln_b, residual)
