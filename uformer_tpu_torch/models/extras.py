"""The auxiliary blocks the reference defines and its shipped archs never
call, counterpart of `uformer_tpu/models/extras.py`: SAM, LPU, PosCNN
(stride 1 and 2), SELayer, EcaLayer, BlurPool2D and BlurPool1D. All NHWC
((B, L, C) for BlurPool1D), in the input's dtype.

Parameter names are the reference's torch modules' (`conv1`..`conv3`,
`depthwise.0`, `proj.0`, `fc.0` / `fc.2`, `conv`); PosCNN's conv has no
bias, as in JAX. `convert.block_state_dict_from_jax` maps each JAX
block's params here. The depthwise convs of LPU and PosCNN stay grouped
`F.conv2d`s: JAX runs them on its plain path (`extras.py:50`), so the
depthwise kernel is not their port. BlurPool's binomial filter comes from
`math.comb`, with reflect padding.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from uformer_tpu_torch.models.layers import Eca1d, _nchw, _nhwc


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """conv on an NHWC x, its weights in x's dtype."""
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), conv.weight.to(x.dtype), b, conv.stride,
                          conv.padding, groups=conv.groups))


class SAM(nn.Module):
    """Supervised attention module (MPRNet; reference model.py:66-79):
    returns (conv1(x) * sigmoid(conv3(img)) + x, img) with
    img = conv2(x) + x_img."""

    def __init__(self, n_feat: int, kernel_size: int = 3, bias: bool = True):
        super().__init__()
        pad = kernel_size // 2
        self.conv1 = nn.Conv2d(n_feat, n_feat, kernel_size, padding=pad,
                               bias=bias)
        self.conv2 = nn.Conv2d(n_feat, 3, kernel_size, padding=pad,
                               bias=bias)
        self.conv3 = nn.Conv2d(3, n_feat, kernel_size, padding=pad,
                               bias=bias)

    def forward(self, x: torch.Tensor,
                x_img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        img = _conv(self.conv2, x) + x_img
        gate = torch.sigmoid(_conv(self.conv3, img))
        return _conv(self.conv1, x) * gate + x, img


class LPU(nn.Module):
    """Local perception unit, x + depthwise3x3(x) + bias (reference
    model.py:202-227)."""

    def __init__(self, dim: int):
        super().__init__()
        self.depthwise = nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1,
                                                 groups=dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _conv(self.depthwise[0], x)


class PosCNN(nn.Module):
    """Conv positional encoding (reference model.py:230-250): x +
    depthwise3x3(x) at stride 1, the stride-s depthwise conv alone
    otherwise."""

    def __init__(self, embed_dim: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.proj = nn.Sequential(nn.Conv2d(embed_dim, embed_dim, 3, stride,
                                            1, groups=embed_dim, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(self.proj[0], x)
        return x + y if self.stride == 1 else y


class SELayer(nn.Module):
    """Squeeze-excite over the spatial axes (reference model.py:252-277):
    mean, Linear-ReLU-Linear without biases in float32 (JAX's Dense at its
    default dtype), the sigmoid gate cast to x's dtype."""

    def __init__(self, dim: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(dim, dim // reduction, bias=False),
                                nn.ReLU(inplace=True),
                                nn.Linear(dim // reduction, dim, bias=False),
                                nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[-1]
        y = x.mean(dim=tuple(range(1, x.dim() - 1))).float()
        y = F.relu(y @ self.fc[0].weight.float().t())
        gate = torch.sigmoid(y @ self.fc[2].weight.float().t()).to(x.dtype)
        return x * gate.reshape((-1,) + (1,) * (x.dim() - 2) + (C,))


class EcaLayer(Eca1d):
    """2-D efficient channel attention (reference eca_layer,
    model.py:279-305): the same gate as Eca1d over NHWC maps."""


def _binomial(n: int) -> torch.Tensor:
    a = torch.tensor([float(math.comb(n - 1, k)) for k in range(n)],
                     dtype=torch.float64)
    return a / a.sum()


def _pads(n: int) -> Tuple[int, int]:
    return (n - 1) // 2, -(-(n - 1) // 2)


class BlurPool2D(nn.Module):
    """Anti-aliased strided downsampling (reference utils/antialias.py:
    7-58): the normalised binomial filter of `filt_size` taps per axis,
    depthwise on the reflect-padded image, then stride `stride`."""

    def __init__(self, filt_size: int = 3, stride: int = 2):
        super().__init__()
        self.filt_size, self.stride = filt_size, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, C = self.filt_size, self.stride, x.shape[-1]
        if n == 1:
            return x[:, ::s, ::s]
        a = _binomial(n)
        filt = (a[:, None] * a[None, :])
        filt = (filt / filt.sum()).to(x.dtype).to(x.device)
        lo, hi = _pads(n)
        xp = F.pad(_nchw(x), (lo, hi, lo, hi), mode="reflect")
        return _nhwc(F.conv2d(xp, filt.expand(C, 1, n, n), stride=s,
                              groups=C))


class BlurPool1D(nn.Module):
    """The 1-D variant (reference antialias.py:60-113) over (B, L, C)."""

    def __init__(self, filt_size: int = 3, stride: int = 2):
        super().__init__()
        self.filt_size, self.stride = filt_size, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, C = self.filt_size, self.stride, x.shape[-1]
        if n == 1:
            return x[:, ::s]
        filt = _binomial(n).to(x.dtype).to(x.device)
        lo, hi = _pads(n)
        xp = F.pad(x.transpose(1, 2), (lo, hi), mode="reflect")
        return F.conv1d(xp, filt.expand(C, 1, n), stride=s,
                        groups=C).transpose(1, 2)
