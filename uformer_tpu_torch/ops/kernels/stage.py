"""Whole-stage LeWin kernel: Hopper kernel and plain version.

Port of `uformer_tpu/ops/pallas/stage.py:fused_stage` (kernel source
`csrc/stage.cu`). At the 16^2..128^2 stages each sub-block is small, so
launches and tails weigh as much as the products; the kernel is one
cooperative persistent launch per stage that runs every block's
attention and LeFF sub-blocks with a grid barrier between them, the
stage image ping-ponging between two buffers that largely stay in L2.
In bf16 at C 128-512 both halves run on tensor-core tiles with register
accumulators: the attention of `csrc/attention_mma.cuh` (1-4 windows per
work item) and the wide LeFF tile of `csrc/leff_mma.cuh` (as `fused_leff`).
In fp32 at C 64-512, head dim 16 or 32 (every fp32 stage of Uformer_T,
_S and _B: the eval CLI's default dtype) both halves run on the
three-pass TF32 tiles (`csrc/stage_f32.cu`): the attention of
`csrc/attention_f32.cuh` (1 or 2 windows per work item, picked by
`csrc/stage.cu` as for bf16) and the LeFF tile of `csrc/leff_f32.cuh`. Other widths and head dims, and
bf16 where no tensor-core body exists, run the one-window attention body
and LeFF's `leff_tile`: among them the stages of an `--embed_dim` 24-56
model (C 384-896, head dims 24-56, `csrc/stage_heads.cu`) and of an
`--embed_dim` 72-128 model (C 128-2048, head dims 72-128 in steps of 8,
`csrc/stage_big_heads.cu`: the attention body of the next multiple of 16
projecting q, k and v in turn; from C 1408 the LeFF tile's halo in the
attention's scratch). `fused_stage`
counts its fp32 launches by body: `f32_mma_launches` (three-pass TF32)
and `f32_fma_launches` (the generic bodies). `stage_reference` is the
plain PyTorch version with the JAX reference's signature
(`stage.py:389`).
"""

from __future__ import annotations

from typing import Dict

import torch

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load
from uformer_tpu_torch.ops.kernels.attention_image import (
    attention_image_reference,
)
from uformer_tpu_torch.ops.kernels.leff import HIDDEN_CHUNK, leff_reference
from uformer_tpu_torch.ops.kernels.window_attention import (
    FORWARD_HEAD_DIMS,
    check_head_dim,
)

# keys of the depth-stacked parameter dict (uformer_tpu stage.py:421-425)
STAGE_KEYS = ("ln1_s", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo",
              "bo", "bias", "mod", "ln2_s", "ln2_b", "w1", "b1", "wd", "bd",
              "w2", "b2")


# fp32 stages on the three-pass TF32 bodies (csrc/stage_f32.cu)
F32_WIDTHS = (64, 128, 256, 512)
F32_HEAD_DIMS = (16, 32)


def f32_stage(C: int, D: int) -> bool:
    """Whether an fp32 stage of width C at head dim D runs the three-pass
    TF32 bodies (`csrc/stage.cuh:stage_f32_fits`)."""
    return C in F32_WIDTHS and D in F32_HEAD_DIMS


def stage_reference(x, p, *, scale, num_heads, use_shift, has_mod):
    """The per-block composition: attention sub-block, then LeFF
    sub-block, for each of the n stacked blocks; shift 4 on odd blocks
    when use_shift."""
    for j in range(p["wq"].shape[0]):
        shift = 4 if (use_shift and j % 2 == 1) else 0
        wkv = torch.cat([p["wk"][j], p["wv"][j]], dim=1)
        bkv = torch.cat([p["bk"][j], p["bv"][j]])
        x = attention_image_reference(
            x, p["mod"][j] if has_mod else None, p["ln1_s"][j],
            p["ln1_b"][j], p["wq"][j], p["bq"][j], wkv, bkv, p["wo"][j],
            p["bo"][j], p["bias"][j], win=8, shift=shift, scale=scale,
            num_heads=num_heads, has_ln=True, residual=True)
        x = leff_reference(
            x, p["w1"][j], p["b1"][j], p["wd"][j], p["bd"][j], p["w2"][j],
            p["b2"][j], ln_s=p["ln2_s"][j], ln_b=p["ln2_b"][j],
            residual=True)
    return x


def fused_stage(x: torch.Tensor, p: Dict[str, torch.Tensor], *, scale: float,
                num_heads: int, use_shift: bool,
                has_mod: bool) -> torch.Tensor:
    """x: (B, H, W, C); p: the STAGE_KEYS arrays stacked along depth n:
    ln1_s/ln1_b/bq/bk/bv/bo/ln2_s/ln2_b/b2 (n, C), wq/wk/wv/wo (n, C, C),
    bias (n, nH, 64, 64), mod (n, 64, C), w1 (n, C, Ch), b1/bd (n, Ch),
    wd (n, 3, 3, Ch), w2 (n, Ch, C). Matrices and mod in x's dtype, the
    rest float32. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if x.device.type == "cpu":
        fused_stage.plain_calls += 1
        return stage_reference(x, p, scale=scale, num_heads=num_heads,
                               use_shift=use_shift, has_mod=has_mod)
    _launch.check_input(x)
    B, H, W, C = x.shape
    n, Ch = p["w1"].shape[0], p["w1"].shape[-1]
    check_head_dim(C, num_heads, FORWARD_HEAD_DIMS)
    lib = load()
    is_bf16 = int(x.dtype == torch.bfloat16)
    if H % 8 or W % 8 or Ch % HIDDEN_CHUNK:
        raise ValueError(f"kernel needs H and W multiples of 8 and "
                         f"Ch % {HIDDEN_CHUNK} == 0: C={C} H={H} W={W} "
                         f"Ch={Ch}")
    dt, dev, f32 = x.dtype, x.device, torch.float32
    shapes = {
        "ln1_s": ((n, C), f32), "ln1_b": ((n, C), f32),
        "wq": ((n, C, C), dt), "bq": ((n, C), f32),
        "wk": ((n, C, C), dt), "bk": ((n, C), f32),
        "wv": ((n, C, C), dt), "bv": ((n, C), f32),
        "wo": ((n, C, C), dt), "bo": ((n, C), f32),
        "bias": ((n, num_heads, 64, 64), f32), "mod": ((n, 64, C), dt),
        "ln2_s": ((n, C), f32), "ln2_b": ((n, C), f32),
        "w1": ((n, C, Ch), dt), "b1": ((n, Ch), f32),
        "wd": ((n, 3, 3, Ch), dt), "bd": ((n, Ch), f32),
        "w2": ((n, Ch, C), dt), "b2": ((n, C), f32),
    }
    for name in STAGE_KEYS:
        if name == "mod" and not has_mod:
            continue
        shape, tdt = shapes[name]
        _launch.expect(p.get(name), name, shape, tdt, dev)
    out = torch.empty_like(x)
    buf = torch.empty_like(x)
    # fp32 on the three-pass TF32 bodies, which need no scratch
    tf32x3 = not is_bf16 and f32_stage(C, C // num_heads)
    regions = 0 if tf32x3 else _launch.scratch_regions(
        lib, is_bf16, C, C // num_heads)
    scratch = (torch.empty((regions,) + x.shape, dtype=dt, device=dev)
               if regions else None)
    ptrs = [p[k].data_ptr() if (k != "mod" or has_mod) else None
            for k in STAGE_KEYS]
    with torch.cuda.device(dev):
        err = lib.uf_stage(
            is_bf16, x.data_ptr(), buf.data_ptr(), out.data_ptr(),
            _launch.ptr(scratch), *ptrs, n, B, H, W, C, num_heads, Ch,
            int(use_shift), float(scale), _launch.stream(x))
    _launch.check(err, "stage kernel (cooperative launch)")
    fused_stage.launches += 1
    if tf32x3:
        fused_stage.f32_mma_launches += 1
    elif not is_bf16:
        fused_stage.f32_fma_launches += 1
    return out


fused_stage.launches = 0
fused_stage.plain_calls = 0
fused_stage.f32_mma_launches = 0
fused_stage.f32_fma_launches = 0
