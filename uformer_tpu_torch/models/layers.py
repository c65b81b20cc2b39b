"""Building blocks of the Uformer eval and train paths (NHWC),
counterparts of `uformer_tpu/models/layers.py`.

Modules keep the reference state_dict key names (`attn.qkv.to_q.weight`,
`attn.qkv.to_q.depthwise.weight`, `mlp.linear1.0.weight`, `mlp.fc1.weight`,
`modulator.weight`, `cross_attn.proj.weight`, ...), so released `.pth`
files and the recorded goldens load with `load_state_dict(strict=True)`.
Torch stores Linear weights as (out, in); the kernels take (in, out).
`kernel_params(dtype)` builds that layout (>= 2-D weights cast to the
working dtype; biases, LayerNorm parameters and the gathered
relative-position bias stay float32) without detaching, so autograd
reaches the float32 parameters through the casts, transposes and the
gather. `prepare(dtype)` keeps a copy built under no_grad, so a serving
model pays the casts and transposes once
(`uformer_tpu_torch.utils.params.prepare_serving`); `params_for` hands
that copy out only while grad is disabled, and builds the weights afresh
otherwise.

Routing (`BasicLayer`): in eval, the whole-stage kernel for win 8 stages
of linear-projection LeFF blocks without a cross-modulator whose
configured resolution is at least the window, with C % 128 == 0, H, W
multiples of 8 and no input mask; otherwise, and always in training
(`uformer_tpu` layers.py:979-986), per block. A block's attention takes
the attention-image kernel where the JAX package takes its image kernel
(`layers.py:757-775`: linear projection, no input mask, win 8 and
C % 128 == 0, or 128 % C == 0, C >= 32 and a shift the pixel packing
takes); else, with linear projection and no mask, the windowed branch
(`layers.py:796-848`): LN1, shift and partition in PyTorch, the
attention-block kernel, reverse and unshift, the residual outside; else
(conv projection, or an input mask) the unfused route of the same lines
with `fused=False`: the q/k/v projection (the conv one's three depthwise
convs in one launch of the depthwise kernel, `dwconv3x3_qkv`, then the
pointwise products; or the linear one) and the plain window attention with
the shift mask and the input-mask bias. A cross-modulator block first
adds its cross-attention over all H*W tokens (`layers.py:722-738`). Then
one LeFF kernel, or the plain `Mlp`. The attention-image, attention-block
and LeFF kernels are differentiated by their backward kernels (window 8,
head dim 16 or 32); `Mlp` and the cross-modulator's attention are plain
PyTorch under autograd, as in JAX. The depthwise kernel has no backward,
in JAX either (`train.train_step` refuses a conv-projection model on the
card). In training a block with a drop-path rate above 0 runs its
kernels without the residual and adds x + DropPath(y) outside
(`layers.py:780-794`, `:860-871`). With `use_checkpoint`, in training,
each block runs under `torch.utils.checkpoint` and its forward kernels
run again in the backward (`BasicLayer`). `LeFF` takes the optional
`Eca1d` gate after its kernel (no shipped arch sets it). The convs around
the stages stay cuDNN (`F.conv2d`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from uformer_tpu_torch.device import to_device_async
from uformer_tpu_torch.ops.attention import window_attention
from uformer_tpu_torch.ops.kernels import (
    DWCONV_BACKWARD_NOT_PORTED,
    STAGE_KEYS,
    attention_block_ad,
    attention_block_reference,
    attention_image_ad,
    attention_image_reference,
    dwconv3x3,
    dwconv3x3_qkv,
    dwconv3x3_reference,
    fused_stage,
    leff_ad,
    leff_reference,
    stage_reference,
)
from uformer_tpu_torch.ops.kernels.window_attention import HEAD_DIMS
from uformer_tpu_torch.ops.masks import input_mask_bias, shift_mask_on
from uformer_tpu_torch.ops.norm import layer_norm
from uformer_tpu_torch.ops.relpos import relative_position_index
from uformer_tpu_torch.ops.window import (
    cyclic_shift,
    cyclic_unshift,
    window_partition,
    window_reverse,
)

Params = Dict[str, torch.Tensor]
LEFF_MLPS = ("leff", "fastleff")  # fastleff: the same function and keys
GEOMETRY_NOT_ON_KERNEL_PATH = (
    f"the attention kernels take window 8 and head dim in {HEAD_DIMS}; "
    f"other windows and head dims train on the plain path only (ROADMAP.md, "
    f"port queue 2 items 2-3: win != 8, head dims other than 16 and 32)")


class _Prepared:
    """Keeps kernel_params(dtype) for one (dtype, device) once prepared."""

    _kp = None

    def kernel_params(self, dtype: torch.dtype) -> Params:
        raise NotImplementedError

    @torch.no_grad()
    def prepare(self, dtype: torch.dtype) -> None:
        p = self.kernel_params(dtype)
        self._kp = (dtype, next(iter(p.values())).device, p)

    def params_for(self, dtype: torch.dtype, device: torch.device) -> Params:
        """The prepared copy while grad is disabled; otherwise weights built
        afresh, in the autograd graph of the parameters."""
        if self._kp is not None and self._kp[:2] == (dtype, device) \
                and not torch.is_grad_enabled():
            return self._kp[2]
        return self.kernel_params(dtype)


def _conv_params(conv: nn.Module, dtype: torch.dtype) -> Params:
    return {"w": conv.weight.to(dtype), "b": conv.bias.to(dtype)}


@dataclass(frozen=True)
class BatchRows:
    """A rank's rows [start, start + size) of a global batch of `total`,
    with the generator every rank holds in the same state: a draw is made
    for the global batch and each rank keeps its rows, so the generator
    ends a data-parallel step where the one-process step leaves it."""
    generator: torch.Generator
    start: int
    total: int


class DropPath(nn.Module):
    """Per-sample stochastic depth (`uformer_tpu` layers.py:60-77): in
    training, each sample's branch is kept with probability 1 - rate and
    then divided by it. The mask is drawn from the generator passed in,
    never from the global RNG; a generator on the CPU serves tensors on any
    device, its masks copied without a stream sync. Given `BatchRows`, the
    mask is drawn for the global batch and this rank keeps its rows (JAX
    draws it for the global batch of its one program). Identity in eval
    and at rate 0. `draw` draws a mask alone, for a caller that hands it in
    later (`keep`): a checkpointed block's recompute must see the masks of
    its first forward (`BasicLayer`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def draw(self, batch: int, device: torch.device,
             generator) -> Optional[torch.Tensor]:
        """The (batch,) keep mask on `device`, or None where inactive.
        generator: a torch.Generator, or `BatchRows` of a global batch."""
        if not self.training or self.rate == 0.0:
            return None
        if generator is None:
            raise ValueError("DropPath in training needs a torch.Generator")
        start, total = 0, batch
        if isinstance(generator, BatchRows):
            start, total = generator.start, generator.total
            generator = generator.generator
            if start + batch > total:
                raise ValueError(f"rows [{start}, {start + batch}) outside "
                                 f"a global batch of {total}")
        u = torch.rand(total, generator=generator, device=generator.device)
        return to_device_async(u[start:start + batch] < 1.0 - self.rate,
                               device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if keep is None:
            keep = self.draw(x.shape[0], x.device, generator)
        mask = keep.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class Eca1d(nn.Module):
    """Efficient channel attention over NHWC maps (reference eca_layer_1d,
    model.py:306-342; JAX layers.py:108-127): the mean over the spatial
    axes, a k-tap 1-D conv across channels in float32 without bias, a
    sigmoid gate cast to x's dtype. `conv.weight` is the reference's
    Conv1d weight, (1, 1, k)."""

    def __init__(self, k_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, k_size, padding=(k_size - 1) // 2,
                              bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        y = x.mean(dim=tuple(range(1, x.dim() - 1)))  # (B, C), x's dtype
        y = F.conv1d(y.float()[:, None], self.conv.weight.float(),
                     padding=self.conv.padding)[:, 0]
        gate = torch.sigmoid(y).to(x.dtype)
        return x * gate.reshape((-1,) + (1,) * (x.dim() - 2) + (C,))


class LeFF(nn.Module):
    """Locally-enhanced FFN (reference model.py:654-699; JAX
    layers.py:130-217): Linear-GELU -> 3x3 depthwise conv-GELU -> Linear
    through the LeFF kernel (`leff_ad`, differentiated by the LeFF
    backward kernel) or its plain version, then the optional `Eca1d`
    gate. With the gate the kernel runs without its residual and the
    residual is added after the gate (JAX's `k_res`, layers.py:175); the
    gate is differentiated by autograd. LeWinBlock builds it without the
    gate, as JAX's does."""

    def __init__(self, dim: int, hidden_dim: int, use_eca: bool = False):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU())
        self.dwconv = nn.Sequential(
            nn.Conv2d(hidden_dim, hidden_dim, 3, 1, 1, groups=hidden_dim),
            nn.GELU())
        self.linear2 = nn.Sequential(nn.Linear(hidden_dim, dim))
        self.eca = Eca1d() if use_eca else None

    def kernel_params(self, dtype: torch.dtype) -> Params:
        l1, dw, l2 = self.linear1[0], self.dwconv[0], self.linear2[0]
        return {
            "w1": l1.weight.t().to(dtype).contiguous(),
            "b1": l1.bias.float(),
            # (Ch, 1, 3, 3) -> (3, 3, Ch)
            "wd": dw.weight[:, 0].permute(1, 2, 0).to(dtype)
            .contiguous(),
            "bd": dw.bias.float(),
            "w2": l2.weight.t().to(dtype).contiguous(),
            "b2": l2.bias.float(),
        }

    def forward(self, x: torch.Tensor, p: Optional[Params] = None,
                ln_s: Optional[torch.Tensor] = None,
                ln_b: Optional[torch.Tensor] = None, residual: bool = False,
                plain: bool = False) -> torch.Tensor:
        """x (B, H, W, C) -> [x +] LeFF(LN?(x)) [gated], in x's dtype; `p`
        the kernel weights (`kernel_params(x.dtype)` when None)."""
        if p is None:
            p = self.kernel_params(x.dtype)
        leff = leff_reference if plain else leff_ad
        k_res = residual and self.eca is None
        y = leff(x, p["w1"], p["b1"], p["wd"], p["bd"], p["w2"], p["b2"],
                 ln_s=ln_s, ln_b=ln_b, residual=k_res)
        if self.eca is None:
            return y
        y = self.eca(y)
        return x + y if residual else y


class Mlp(nn.Module):
    """Plain FFN, fc1 - erf GELU - fc2 (reference model.py:623-651; JAX
    layers.py:87-105), for token_mlp "mlp" or "ffn". Its products are plain
    matmuls in the working dtype, as in JAX."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def kernel_params(self, dtype: torch.dtype) -> Params:
        return {"w1": self.fc1.weight.t().to(dtype),
                "b1": self.fc1.bias.float(),
                "w2": self.fc2.weight.t().to(dtype),
                "b2": self.fc2.bias.float()}

    def forward(self, x: torch.Tensor, p: Params) -> torch.Tensor:
        dt = x.dtype
        y = F.gelu(x @ p["w1"] + p["b1"].to(dt))
        return y @ p["w2"] + p["b2"].to(dt)


class SepConv2d(nn.Module):
    """Depthwise k x k conv, ReLU, pointwise 1x1 conv (reference
    model.py:344-378; JAX layers.py:220-251), NHWC; the conv biases are
    always on. The 3x3 stride-1 depthwise conv runs the depthwise kernel
    (`dwconv3x3`); any other size or stride a grouped `F.conv2d` with the
    weights in the working dtype, as the JAX package's jnp path does. The
    pointwise conv is a matmul in the working dtype (JAX's `nn.Conv`)."""

    def __init__(self, dim: int, out_dim: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.depthwise = nn.Conv2d(dim, dim, kernel_size, stride,
                                   (kernel_size - stride) // 2, groups=dim)
        self.pointwise = nn.Conv2d(dim, out_dim, 1)

    def kernel_params(self, dtype: torch.dtype) -> Params:
        return {
            # (C, 1, k, k) -> (k, k, C); (out, C, 1, 1) -> (C, out)
            "wd": self.depthwise.weight[:, 0].permute(1, 2, 0).to(dtype)
            .contiguous(),
            "bd": self.depthwise.bias.float(),
            "wp": self.pointwise.weight[:, :, 0, 0].t().to(dtype),
            "bp": self.pointwise.bias.float(),
        }

    def forward(self, x: torch.Tensor, p: Params,
                plain: bool = False) -> torch.Tensor:
        dt = x.dtype
        k, s = self.kernel_size, self.stride
        if k == 3 and s == 1:
            y = (dwconv3x3_reference if plain else dwconv3x3)(
                x, p["wd"], p["bd"])
        else:
            y = _nhwc(F.conv2d(
                _nchw(x), p["wd"].permute(2, 0, 1).unsqueeze(1).to(dt),
                p["bd"].to(dt), stride=s, padding=(k - s) // 2,
                groups=x.shape[-1]))
        return F.relu(y) @ p["wp"] + p["bp"].to(dt)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(Bw, N, nH * D) -> (Bw, nH, N, D)."""
    Bw, N, C = t.shape
    return t.reshape(Bw, N, num_heads, C // num_heads).transpose(1, 2)


class LinearProjection(nn.Module):
    """q from Linear(dim, inner), [k | v] from Linear(dim, 2 * inner)."""

    def __init__(self, dim: int, inner: int, bias: bool = True):
        super().__init__()
        self.to_q = nn.Linear(dim, inner, bias=bias)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=bias)

    def kernel_params(self, dtype: torch.dtype) -> Params:
        def bias_of(lin):
            return (lin.bias.float() if lin.bias is not None
                    else torch.zeros(lin.out_features,
                                     device=lin.weight.device))

        return {"wq": self.to_q.weight.t().to(dtype).contiguous(),
                "bq": bias_of(self.to_q),
                "wkv": self.to_kv.weight.t().to(dtype).contiguous(),
                "bkv": bias_of(self.to_kv)}

    def forward(self, x: torch.Tensor, p: Params, num_heads: int,
                plain: bool = False, kv: Optional[torch.Tensor] = None):
        """x (Bw, N, C) -> q, k, v (Bw, nH, N, D); k and v from kv (Bk,
        M, C) when given, else from x."""
        dt, C = x.dtype, x.shape[-1]
        q = x @ p["wq"] + p["bq"].to(dt)
        kv = (x if kv is None else kv) @ p["wkv"] + p["bkv"].to(dt)
        return (_heads(q, num_heads), _heads(kv[..., :C], num_heads),
                _heads(kv[..., C:], num_heads))


class ConvProjection(nn.Module):
    """q, k and v from three SepConv2d on the 2-D window layout (reference
    model.py:381-418; JAX layers.py:284-310): token_projection "conv".
    Each window is a zero-padded side x side image."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.to_q = SepConv2d(dim, inner)
        self.to_k = SepConv2d(dim, inner)
        self.to_v = SepConv2d(dim, inner)

    def kernel_params(self, dtype: torch.dtype) -> Params:
        p = {name: getattr(self, name).kernel_params(dtype)
             for name in ("to_q", "to_k", "to_v")}
        # the three depthwise weight sets and biases, stacked for one launch
        p["wd3"] = torch.stack([p[n]["wd"] for n in ("to_q", "to_k",
                                                     "to_v")])
        p["bd3"] = torch.stack([p[n]["bd"] for n in ("to_q", "to_k",
                                                     "to_v")])
        return p

    def forward(self, x: torch.Tensor, p: Params, num_heads: int,
                plain: bool = False):
        """x (Bw, N, C) windows -> q, k, v (Bw, nH, N, D): the three
        depthwise convs and their ReLUs in one `dwconv3x3_qkv` call, then
        each pointwise product; with plain, three `SepConv2d` on their
        plain versions."""
        Bw, N, C = x.shape
        side = int(round(N ** 0.5))
        xs = x.reshape(Bw, side, side, C)
        names = ("to_q", "to_k", "to_v")
        if plain:
            ys = (getattr(self, n)(xs, p[n], plain) for n in names)
        else:
            ys = (y @ p[n]["wp"] + p[n]["bp"].to(x.dtype) for n, y in zip(
                names, dwconv3x3_qkv(xs, p["wd3"], p["bd3"], relu=True)))
        return tuple(_heads(y.reshape(Bw, N, -1), num_heads) for y in ys)


class WindowAttention(nn.Module):
    """Window MHSA parameters with relative position bias and a linear or
    conv q/k/v projection (reference model.py:452-546).
    `relative_position_index` is a persistent buffer, as in the reference
    state_dict."""

    def __init__(self, dim: int, win_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 token_projection: str = "linear"):
        super().__init__()
        self.dim, self.win_size, self.num_heads = dim, win_size, num_heads
        self.token_projection = token_projection
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * win_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(win_size, win_size).astype(np.int64)))
        if token_projection == "linear":
            self.qkv = LinearProjection(dim, dim, qkv_bias)
        elif token_projection == "conv":  # conv biases always on
            self.qkv = ConvProjection(dim, dim)
        else:
            raise ValueError(f"unknown token_projection {token_projection}")
        self.proj = nn.Linear(dim, dim)

    def kernel_params(self, dtype: torch.dtype) -> Params:
        N = self.win_size ** 2
        table = self.relative_position_bias_table.float()
        bias = table[self.relative_position_index.reshape(-1)]
        p = self.qkv.kernel_params(dtype)
        p.update({
            "wo": self.proj.weight.t().to(dtype).contiguous(),
            "bo": self.proj.bias.float(),
            "bias": bias.reshape(N, N, -1).permute(2, 0, 1).contiguous(),
        })
        return p


class Attention(nn.Module):
    """Plain MHSA without relative bias, the cross-modulator's attention
    (reference model.py:549-618; JAX layers.py:628-658): queries from the
    tokens, keys and values from a shared (M, C) table; float32 logits and
    softmax."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = LinearProjection(dim, dim, qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def kernel_params(self, dtype: torch.dtype) -> Params:
        p = self.qkv.kernel_params(dtype)
        p.update({"wo": self.proj.weight.t().to(dtype),
                  "bo": self.proj.bias.float()})
        return p

    def forward(self, x: torch.Tensor, kv: torch.Tensor,
                p: Params) -> torch.Tensor:
        """x (B, N, C), kv (M, C) -> (B, N, C) in x's dtype."""
        q, k, v = self.qkv(x, p, self.num_heads, kv=kv[None])
        attn = torch.softmax((q.float() * self.scale)
                             @ k.float().transpose(-1, -2), dim=-1)
        out = (attn @ v.float()).transpose(1, 2).reshape(x.shape).to(x.dtype)
        return out @ p["wo"] + p["bo"].to(x.dtype)


class LeWinBlock(_Prepared, nn.Module):
    """LeWin block (reference model.py:850-1008), NHWC in and out:
    [x + CrossAttn(x, cross-modulator)], x + Attn(LN1(x)) [shifted
    windows, + modulator] through the attention-image kernel, the windowed
    branch or the unfused route (module note), then x + LeFF(LN2(x))
    through the LeFF kernel or x + Mlp(LN2(x)); in training each branch
    under DropPath(drop_path)."""

    def __init__(self, dim: int, num_heads: int, win_size: int = 8,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 modulator: bool = False, drop_path: float = 0.0,
                 token_projection: str = "linear", token_mlp: str = "leff",
                 cross_modulator: bool = False):
        super().__init__()
        if not 0 <= shift_size < win_size:
            raise ValueError(f"shift {shift_size} outside [0, {win_size})")
        self.dim, self.num_heads = dim, num_heads
        self.win_size, self.shift_size = win_size, shift_size
        self.token_mlp = token_mlp
        self.cross_modulator = self.cross_attn = self.norm_cross = None
        if cross_modulator:
            self.cross_modulator = nn.Embedding(win_size * win_size, dim)
            self.cross_attn = Attention(dim, num_heads, qkv_bias, qk_scale)
            # reference quirk (JAX layers.py:729-732): built, never applied
            self.norm_cross = nn.LayerNorm(dim)
        self.modulator = (nn.Embedding(win_size * win_size, dim)
                          if modulator else None)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, win_size, num_heads, qkv_bias,
                                    qk_scale, token_projection)
        self.norm2 = nn.LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        if token_mlp in LEFF_MLPS:
            self.mlp = LeFF(dim, hidden)
        elif token_mlp in ("mlp", "ffn"):  # "mlp" is the reference's alias
            self.mlp = Mlp(dim, hidden)
        else:
            raise ValueError(f"unknown token_mlp {token_mlp}")
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        # the JAX package's image-kernel condition (layers.py:699-702,
        # :757-775); an input mask also declines it, at run time
        self.image_route = token_projection == "linear" and win_size == 8 \
            and (dim % 128 == 0 or (128 % dim == 0 and dim >= 32
                                    and shift_size % (128 // dim) == 0))

    @property
    def backward_gap(self) -> Optional[str]:
        """Why the train step's kernel path cannot differentiate this
        block, or None. The attention backward kernels cover the image
        route and the windowed branch at window 8 and head dim 16 or 32;
        Mlp and the cross-modulator's attention are plain PyTorch. Conv
        projection runs the depthwise kernel, which has no backward."""
        if self.attn.token_projection == "conv":
            return DWCONV_BACKWARD_NOT_PORTED
        if self.win_size != 8 or self.dim % self.num_heads \
                or self.dim // self.num_heads not in HEAD_DIMS:
            return GEOMETRY_NOT_ON_KERNEL_PATH
        return None

    def kernel_params(self, dtype: torch.dtype) -> Params:
        p = {"ln1_s": self.norm1.weight.float(),
             "ln1_b": self.norm1.bias.float(),
             "ln2_s": self.norm2.weight.float(),
             "ln2_b": self.norm2.bias.float(),
             "mod": (self.modulator.weight.to(dtype).contiguous()
                     if self.modulator is not None else None)}
        p.update(self.attn.kernel_params(dtype))
        p.update(self.mlp.kernel_params(dtype))
        if self.cross_attn is not None:
            p["cross"] = dict(self.cross_attn.kernel_params(dtype),
                              table=self.cross_modulator.weight.to(dtype))
        return p

    def draw_drop_path(self, x: torch.Tensor,
                       generator: Optional[torch.Generator]) -> tuple:
        """The keep masks of both DropPaths for input x, drawn in the order
        the forward draws them (None where inactive)."""
        return tuple(dp.draw(x.shape[0], x.device, generator)
                     for dp in (self.drop_path1, self.drop_path2))

    def forward(self, x: torch.Tensor, plain: bool = False,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None,
                keep: Optional[tuple] = None) -> torch.Tensor:
        """plain=True runs the kernels' plain versions under torch autograd
        (the comparison path); otherwise the kernels, whose backward is a
        kernel too. `generator` feeds DropPath in training, or `keep` hands
        in both DropPath masks (`draw_drop_path`). `mask`: the input mask,
        (B, 1, Hm, Wm) or (B, Hm, Wm, 1), on x's device."""
        keep1, keep2 = keep if keep is not None else (None, None)
        # active DropPath scales the branch: the residual stays outside
        res = not (self.training and self.drop_path1.rate > 0.0)
        p = self.params_for(x.dtype, x.device)
        if self.cross_attn is not None:
            # x feeds the cross-attention un-normalised (JAX
            # layers.py:729-732); no DropPath on this branch
            B, H, W, C = x.shape
            c = p["cross"]
            x = x + self.cross_attn(x.reshape(B, H * W, C), c["table"],
                                    c).reshape(x.shape)
        if mask is None and self.image_route:
            attention = attention_image_reference if plain else \
                attention_image_ad
            y = attention(
                x, p["mod"], p["ln1_s"], p["ln1_b"], p["wq"], p["bq"],
                p["wkv"], p["bkv"], p["wo"], p["bo"], p["bias"],
                win=self.win_size, shift=self.shift_size,
                scale=self.attn.scale, num_heads=self.num_heads,
                residual=res)
            x = y if res else x + self.drop_path1(y, generator, keep1)
        elif mask is None and self.attn.token_projection == "linear":
            x = x + self.drop_path1(self.windowed_attention(x, p, plain),
                                    generator, keep1)
        else:
            x = x + self.drop_path1(
                self.unfused_attention(x, p, plain, mask), generator, keep1)
        if self.token_mlp not in LEFF_MLPS:
            y = self.mlp(layer_norm(x, p["ln2_s"], p["ln2_b"]), p)
            return x + self.drop_path2(y, generator, keep2)
        y = self.mlp(x, p, p["ln2_s"], p["ln2_b"], residual=res, plain=plain)
        return y if res else x + self.drop_path2(y, generator, keep2)

    def windowed_attention(self, x: torch.Tensor, p: Params,
                           plain: bool = False) -> torch.Tensor:
        """The attention branch off the image route, in the JAX package's
        order and rounding points (`layers.py:796-848`): LN1 in the
        working dtype, cyclic shift, partition, the attention-block kernel
        without LN, reverse, unshift."""
        _, H, W, _ = x.shape
        win, shift = self.win_size, self.shift_size
        wnd = window_partition(
            cyclic_shift(layer_norm(x, p["ln1_s"], p["ln1_b"]), shift), win)
        attention = attention_block_reference if plain else \
            attention_block_ad
        y = attention(wnd, p["mod"], None, None, p["wq"], p["bq"], p["wkv"],
                      p["bkv"], p["wo"], p["bo"], p["bias"], win=win,
                      shift=shift, H=H, W=W, scale=self.attn.scale,
                      num_heads=self.num_heads, has_ln=False)
        return cyclic_unshift(window_reverse(y, win, H, W), shift)

    def unfused_attention(self, x: torch.Tensor, p: Params,
                          plain: bool = False,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """The attention branch of the JAX package's route with
        `fused=False` (`layers.py:796-848`, `:576-607`), for conv
        projection or an input mask: LN1 in the working dtype, cyclic
        shift, partition, + modulator, the q/k/v projection (the conv one
        runs the depthwise kernel once for q, k and v), the plain window
        attention with the relative-position bias, the shift mask and the
        input-mask bias, proj, reverse, unshift."""
        B, H, W, _ = x.shape
        win, shift = self.win_size, self.shift_size
        wnd = window_partition(
            cyclic_shift(layer_norm(x, p["ln1_s"], p["ln1_b"]), shift), win)
        if p["mod"] is not None:
            wnd = wnd + p["mod"]
        q, k, v = self.attn.qkv(wnd, p, self.num_heads, plain)
        out = window_attention(q, k, v, p["bias"],
                               self.attention_mask(B, H, W, x.device, mask),
                               scale=self.attn.scale)
        out = out @ p["wo"] + p["bo"].to(x.dtype)
        return cyclic_unshift(window_reverse(out, win, H, W), shift)

    def attention_mask(self, B: int, H: int, W: int, device,
                       mask: Optional[torch.Tensor] = None
                       ) -> Optional[torch.Tensor]:
        """The unfused route's additive mask (JAX layers.py:708-720): the
        shift mask (nW, N, N), kept on the device, the input-mask bias
        (B * nW, N, N), their sum, or None."""
        win, shift = self.win_size, self.shift_size
        smask = shift_mask_on(H, W, win, shift, device) if shift else None
        if mask is None:
            return smask
        bias = input_mask_bias(mask, H, W, win)
        if smask is None:
            return bias
        N = win * win
        return (bias.reshape(B, -1, N, N) + smask).reshape(-1, N, N)


class BasicLayer(_Prepared, nn.Module):
    """Stage of `depth` LeWin blocks with alternating shift (reference
    BasicUformerLayer, model.py:1013-1066). Window and shift come from the
    configured resolution (`uformer_tpu` layers.py:1019-1024): at or below
    the window the stage runs one window, unshifted.

    use_checkpoint (`uformer_tpu` layers.py:1014-1017, policy
    nothing_saveable, per block): in training with grad enabled each block
    runs under `torch.utils.checkpoint.checkpoint(use_reentrant=False)`,
    keeping only its input; the backward recomputes the block's forward,
    kernels included (their autograd Functions save through
    save_for_backward, which the checkpoint frees and recomputes). The
    checkpoint restores only the global RNGs, not a torch.Generator, so
    each block's DropPath masks are drawn before its checkpoint, in the
    order an unchecked block draws them, and handed in: the recompute
    sees the first forward's masks, and the generator ends the step where
    an unchecked step leaves it. Eval runs as without it."""

    def __init__(self, dim: int, depth: int, num_heads: int, win_size: int,
                 resolution: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 shift_flag: bool = True, modulator: bool = False,
                 drop_path: Sequence[float] = (),
                 token_projection: str = "linear", token_mlp: str = "leff",
                 cross_modulator: bool = False, use_checkpoint: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.win_size = dim, num_heads, win_size
        self.resolution, self.use_checkpoint = resolution, use_checkpoint
        self.has_mod = modulator
        self.use_shift = shift_flag and resolution > win_size
        win = min(resolution, win_size)
        self.blocks = nn.ModuleList([
            LeWinBlock(dim, num_heads, win,
                       win // 2 if (self.use_shift and i % 2) else 0,
                       mlp_ratio, qkv_bias, qk_scale, modulator,
                       drop_path[i] if len(drop_path) else 0.0,
                       token_projection, token_mlp, cross_modulator)
            for i in range(depth)])
        # the stage kernel's static conditions (uformer_tpu layers.py:979)
        self.stage_ok = (win_size == 8 and resolution >= win_size
                         and dim % 128 == 0 and token_projection == "linear"
                         and token_mlp in LEFF_MLPS and not cross_modulator)

    def uses_stage(self, x: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> bool:
        """The stage kernel runs in eval only (it has no backward kernel)
        and without an input mask."""
        return (mask is None and not self.training and self.stage_ok
                and x.shape[1] % 8 == 0 and x.shape[2] % 8 == 0)

    def kernel_params(self, dtype: torch.dtype) -> Params:
        C = self.dim
        per = [b.kernel_params(dtype) for b in self.blocks]
        for q in per:
            q["wk"], q["wv"] = q["wkv"][:, :C], q["wkv"][:, C:]
            q["bk"], q["bv"] = q["bkv"][:C], q["bkv"][C:]
            if q["mod"] is None:
                q["mod"] = torch.zeros(64, C, dtype=dtype,
                                       device=q["wq"].device)
        return {k: torch.stack([q[k] for q in per]).contiguous()
                for k in STAGE_KEYS}

    @torch.no_grad()
    def prepare(self, dtype: torch.dtype) -> None:
        if self.stage_ok:
            super().prepare(dtype)
        else:
            for b in self.blocks:
                b.prepare(dtype)

    def forward(self, x: torch.Tensor, plain: bool = False,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.uses_stage(x, mask):
            stage = stage_reference if plain else fused_stage
            p = self.params_for(x.dtype, x.device)
            return stage(x, p, scale=self.blocks[0].attn.scale,
                         num_heads=self.num_heads, use_shift=self.use_shift,
                         has_mod=self.has_mod)
        checkpointed = (self.use_checkpoint and self.training
                        and torch.is_grad_enabled())
        for blk in self.blocks:
            if checkpointed:
                keep = blk.draw_drop_path(x, generator)
                # no generator inside: the recompute cannot draw
                x = checkpoint(blk, x, plain, None, mask, keep,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(x, plain, generator, mask)
        return x


class _Conv(_Prepared, nn.Module):
    """A conv held, under its reference name, as item 0 of a Sequential."""

    def kernel_params(self, dtype: torch.dtype) -> Params:
        conv = next(m for m in self.modules()
                    if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)))
        return _conv_params(conv, dtype)


class InputProj(_Conv):
    """3x3 conv + LeakyReLU(0.01) (reference model.py:781-810)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, 1, 1),
                                  nn.LeakyReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params_for(x.dtype, x.device)
        return _nhwc(F.leaky_relu(F.conv2d(_nchw(x), p["w"], p["b"],
                                           padding=1), 0.01))


class OutputProj(_Conv):
    """3x3 conv to image channels (reference model.py:813-846)."""

    def __init__(self, in_ch: int, out_ch: int = 3):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params_for(x.dtype, x.device)
        return _nhwc(F.conv2d(_nchw(x), p["w"], p["b"], padding=1))


class Downsample(_Conv):
    """4x4 stride-2 conv (reference model.py:730-753)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(in_ch, out_ch, 4, 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params_for(x.dtype, x.device)
        return _nhwc(F.conv2d(_nchw(x), p["w"], p["b"], stride=2, padding=1))


class Upsample(_Conv):
    """2x2 stride-2 transposed conv (reference model.py:756-778)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.deconv = nn.Sequential(nn.ConvTranspose2d(in_ch, out_ch, 2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params_for(x.dtype, x.device)
        return _nhwc(F.conv_transpose2d(_nchw(x), p["w"], p["b"], stride=2))
