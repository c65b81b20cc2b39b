"""LeFF sub-block: Hopper kernel and plain version.

Port of `uformer_tpu/ops/pallas/leff.py:fused_leff` (kernel source
`csrc/leff.cu`, tiles in `csrc/leff_mma.cuh` and `csrc/leff_tile.cuh`).
On the H100 the bound is the products at C >= 128 and the bytes of x and
y below; the 4C-wide hidden never touches device memory. In bf16 the
tensor-core tiles keep the second product's accumulator in registers:
8 x 8 or 16 x 8 output tiles with the weights streamed through a
cp.async ring at C 128-512 (4 x 8 at C = 1024, an `--embed_dim 64`
model's bottleneck and dec0, hidden 4096), and persistent blocks over
8 x 16 tiles with the weights resident at C 16-64; they mask partial
tiles, so any H and W run. fp32 at C 16-512 (every fp32 LeFF of
Uformer_T, _S and _B: the eval CLI's default dtype) runs the three-pass
TF32 tile of `csrc/leff_f32.cuh` (8 x 8 outputs, 4 x 8 at C 512, weights
through a cp.async ring); fp32 at the other widths keeps `leff_tile`'s
TH x 8 FMA tiles, also masking partial ones (an embed-8 model's 4 x 4
bottleneck; 1 x 8 at C = 1024). `fused_leff` counts its fp32 launches
by body: `f32_mma_launches` (three-pass TF32) and `f32_fma_launches`
(`leff_tile`). The widths of an `--embed_dim` 24-56 model that are no
power of two (C 24-896; C 24, 40, 56 are 8 mod 16, hidden 96-3584) run
`leff_tile` in both dtypes, its bf16 products 16 wider where C is 8 mod
16 and, at C 768 and 896, its weight chunk staged in pieces. The
backward takes C 8-1024 too (at C = 1024 2 x 8 and 4 x 8 tiles in bf16,
1 x 8 and 2 x 8 in fp32; at C that is no power of two, bf16 on the WMMA
tiles of `csrc/leff_bwd_heads.cu`, a tile a block, and fp32 on the FMA
loops, which take any C). C = 8 (an embed-8 model's outer stages) runs the
narrow tile too, on its 32-wide hidden zero-padded to one 64-wide chunk
(`pad_hidden`: exact, as GELU(0) = 0; the model pads once, in
`LeFF.kernel_params`), and so does its backward, `fused_leff_bwd` (its products of depth 8 on
mma.sync.m16n8k8). `leff_reference` is the plain PyTorch version with
the JAX reference's signature (`leff.py:504`).
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
# fp32 widths of the three-pass TF32 tile (csrc/leff_f32.cuh)
F32_WIDTHS = (16, 32, 64, 128, 256, 512)


def f32_tile(C: int, Ch: int) -> bool:
    """Whether fp32 LeFF at width C and hidden Ch (padded to whole
    chunks) runs the three-pass TF32 tile (`csrc/leff.cu:f32_tile`)."""
    return C in F32_WIDTHS and Ch % HIDDEN_CHUNK == 0


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


def pad_hidden(w1, b1, wd, bd, w2):
    """The hidden zero-padded to a whole number of HIDDEN_CHUNK channels:
    w1 (C, Ch') and w2 (Ch', C) with zero columns and rows, b1, bd and the
    depthwise taps with zeros. Exact: a padded channel's hidden is GELU(0)
    = 0 before and after the depthwise conv, and its w2 row is zero.
    Unchanged when Ch is already a multiple."""
    pad = -w1.shape[-1] % HIDDEN_CHUNK
    if not pad:
        return w1, b1, wd, bd, w2
    return (F.pad(w1, (0, pad)).contiguous(), F.pad(b1, (0, pad)),
            F.pad(wd, (0, pad)).contiguous(), F.pad(bd, (0, pad)),
            F.pad(w2, (0, 0, 0, pad)).contiguous())


def check_width(C: int) -> None:
    """Raise unless the kernel takes width C: a multiple of 8 (every C of
    the family: 8-1024, the powers of two on the tensor-core tiles, the
    rest on `leff_tile`)."""
    if C <= 0 or C % 8:
        raise ValueError(f"kernel needs C % 8 == 0: C={C}")


def fused_leff(x: torch.Tensor, w1, b1, wd, bd, w2, b2, ln_s=None, ln_b=None,
               *, residual: bool = False) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H, W, C).

    w1 (C, Ch), wd (3, 3, Ch), w2 (Ch, C) in x's dtype; b1, bd, b2, ln_s,
    ln_b float32; C a multiple of 8. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises (a hidden that is
    no multiple of HIDDEN_CHUNK is padded here, `pad_hidden`, unless the
    caller padded it)."""
    if x.device.type == "cpu":
        fused_leff.plain_calls += 1
        return leff_reference(x, w1, b1, wd, bd, w2, b2, ln_s=ln_s,
                              ln_b=ln_b, residual=residual)
    _launch.check_input(x)
    B, H, W, C = x.shape
    check_width(C)
    w1, b1, wd, bd, w2 = pad_hidden(w1, b1, wd, bd, w2)
    Ch = w1.shape[-1]
    lib = load()
    is_bf16 = int(x.dtype == torch.bfloat16)
    # fp32: the three-pass TF32 tile where it has one, else leff_tile
    tf32x3 = not is_bf16 and f32_tile(C, Ch)
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
    if tf32x3:
        fused_leff.f32_mma_launches += 1
    elif not is_bf16:
        fused_leff.f32_fma_launches += 1
    return y


fused_leff.launches = 0
fused_leff.plain_calls = 0
fused_leff.f32_mma_launches = 0
fused_leff.f32_fma_launches = 0


def tile_rows(x: torch.Tensor, Ch: int) -> int:
    """The rows of `fused_leff`'s tile for x's dtype and width at hidden
    width Ch: its fp32 tile's height on a card tensor (the bf16 tiles: 1),
    and 1 for the plain version. Every tile masks partial tiles; the
    spatial path keeps its slabs a multiple of it."""
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


# C of the bf16 backward's tensor-core tiles, which may split a tile's
# hidden chunks over blocks; every other C takes a tile a block
BWD_MMA_WIDTHS = (8, 16, 32, 64, 128, 256, 512, 1024)


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
    at C 8-1024 in powers of two, their hidden chunks split over blocks
    where tiles are few, `chunks_per_block`; at the other multiples of 8,
    `csrc/leff_bwd_heads.cu`), then the weight gradients reduced over
    every pixel by `csrc/wgrad.cu` (`leff_bwd_parts` lists the launches).
    Any H and W. Weights as `fused_leff` takes them: a hidden that is no
    multiple of HIDDEN_CHUNK (C = 8: 32; C 24, 40, 56: 96, 160, 224) is
    padded here (`pad_hidden`) and dw1, db1, dwd, dbd and dw2 come back
    sliced to it, unless the caller padded it (the model does, once, in
    `LeFF.kernel_params`; autograd then slices). The padded channels'
    gradients are exactly 0: their hidden is GELU(0) = 0 and their w2 rows
    are 0, so dpre2, dh and dpre1 vanish there. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels or raises."""
    if x.device.type == "cpu":
        fused_leff_bwd.plain_calls += 1
        return leff_vjp_reference(x, dy, w1, b1, wd, bd, w2, ln_s, ln_b,
                                  has_ln=has_ln, residual=residual)
    Ch = w1.shape[-1]
    w1, b1, wd, bd, w2 = pad_hidden(w1, b1, wd, bd, w2)
    parts, result = leff_bwd_parts(x, dy, w1, b1, wd, bd, w2, ln_s, ln_b,
                                   has_ln=has_ln, residual=residual)
    with torch.cuda.device(x.device):
        for _, run in parts:
            run()
    fused_leff_bwd.launches += 1
    dx, dw1, db1, dwd, dbd, dw2, db2, dln_s, dln_b = result()
    if w1.shape[-1] != Ch:
        dw1, db1, dwd, dbd, dw2 = (dw1[:, :Ch], db1[:Ch], dwd[..., :Ch],
                                   dbd[:Ch], dw2[:Ch])
    return dx, dw1, db1, dwd, dbd, dw2, db2, dln_s, dln_b


def dln_b_of(lib, w1, out) -> torch.Tensor:
    """dln_b = W1 db1 (`csrc/leff_bwd.cu`: uf_leff_dln_b): the sum of the
    LN output's gradient over pixels through the fp32 db1, which sums the
    hidden gradient before its bf16 rounding, where a sum of dLN would
    carry every pixel's rounding of it."""
    db1 = out["sums"][0][w1.shape[0]:]
    dln_b = torch.empty(w1.shape[0], dtype=torch.float32, device=w1.device)
    _launch.check(lib.uf_leff_dln_b(int(w1.dtype == torch.bfloat16),
                                    w1.data_ptr(), db1.data_ptr(),
                                    dln_b.data_ptr(), w1.shape[0],
                                    w1.shape[1], _launch.stream(w1)),
                  "leff_bwd dln_b kernel")
    return dln_b


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
    check_width(C)
    tha = lib.uf_leff_bwd_tile_rows(0, is_bf16, C)
    thb = lib.uf_leff_bwd_tile_rows(1, is_bf16, C)
    if Ch % HIDDEN_CHUNK or not tha or not thb:
        raise ValueError(f"kernel needs a tile for C (C % 8 == 0) and Ch % "
                         f"{HIDDEN_CHUNK} == 0: C={C} Ch={Ch}")
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
                if is_bf16 and C in BWD_MMA_WIDTHS else chunks)

    def empty(*shape, dtype=dt):
        return torch.empty(*shape, dtype=dtype, device=dev)

    cpg_a, cpg_b = split(tha), split(thb)
    groups = -(-chunks // cpg_b)
    g, dpre2, dpre1 = empty(M, Ch), empty(M, Ch), empty(M, Ch)
    dx, ln = torch.empty_like(x), empty(M, C)
    part_a = empty(tiles(tha), 10 * Ch, dtype=f32)
    # per tile: dln_s (with LN only), then db1, summed from the fp32 hidden
    # gradient before its rounding (`leff.py:682`); dln_b = W1 db1 after
    part_b = empty(tiles(thb), C + Ch, dtype=f32)
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
                  colsum(part_b if has_ln else part_b[:, C:]),
                  colsum(part_a))))]
    if has_ln:
        parts.append(("dln_b", reduce("dln_b", dln_b_of, lib, w1, out)))

    def result():
        dw2, db2 = out["dw2"]
        pb, pa = out["sums"]
        dln_s, db1 = (pb[:C], pb[C:]) if has_ln else (None, pb)
        return (dx, out["dw1"], db1, pa[:9 * Ch].view(3, 3, Ch),
                pa[9 * Ch:], dw2, db2, dln_s, out.get("dln_b"))

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
