"""The pure-conv U-Net baseline, counterpart of `uformer_tpu/models/unet.py`
(reference model.py:83-199), selected with `--arch UNet`.

Four `ConvBlock` levels at dim * 2^k, each followed by a 4x4 stride-2
`pool{k}`; `ConvBlock5` at 16 dim; four 2x2 stride-2 transposed convs
`upv{6..9}`, each followed by the skip concat (upsampled first) and a
`ConvBlock`; `conv10` to 3 channels; the global residual in float32. A
ConvBlock is two 3x3 convs with LeakyReLU(0.01) and a 1x1 shortcut
`conv11`. Key names are the reference's (`ConvBlock{i}.block.0`,
`.block.2`, `.conv11`, `pool{i}`, `upv{i}`, `conv10`; JAX
`convert/torch_converter.py:174-191`), so a reference UNet `.pth` loads
with `load_state_dict(strict=True)`.

The activations stay NHWC in memory across the net: the input is viewed
as NCHW with channels_last strides (one permute in), every conv and the
concat keep that layout, and the output is viewed back (one permute out).
No Pallas kernel covers the net, in JAX either: the convs are cuDNN. Each
conv keeps its weights in the working dtype once `prepare_serving` has
run (`_Conv`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from uformer_tpu_torch.models.layers import Params, _Conv

CL = torch.channels_last


class _ChannelsLast(_Conv):
    """A conv whose weights, in the working dtype, are laid out
    channels_last as its activations are (prepared once for serving)."""

    def kernel_params(self, dtype: torch.dtype) -> Params:
        return {"w": self.weight.to(dtype).contiguous(memory_format=CL),
                "b": self.bias.to(dtype)}


class Conv2d(_ChannelsLast, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params_for(x.dtype, x.device)
        return F.conv2d(x, p["w"], p["b"], self.stride, self.padding)


class ConvTranspose2d(_ChannelsLast, nn.ConvTranspose2d):
    """Weights (in, out, kh, kw), the reference's layout."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.params_for(x.dtype, x.device)
        return F.conv_transpose2d(x, p["w"], p["b"], self.stride)


class ConvBlock(nn.Module):
    """Two 3x3 convs, each followed by LeakyReLU(0.01), plus a 1x1
    shortcut (reference model.py:83-105)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.block = nn.Sequential(Conv2d(in_ch, out_ch, 3, padding=1),
                                   nn.LeakyReLU(inplace=True),
                                   Conv2d(out_ch, out_ch, 3, padding=1),
                                   nn.LeakyReLU(inplace=True))
        self.conv11 = Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x) + self.conv11(x)


class UNet(nn.Module):
    def __init__(self, dim: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype  # dtype: working dtype
        for k in range(4):
            setattr(self, f"ConvBlock{k + 1}",
                    ConvBlock(3 if k == 0 else dim * 2 ** (k - 1),
                              dim * 2 ** k))
            setattr(self, f"pool{k + 1}",
                    Conv2d(dim * 2 ** k, dim * 2 ** k, 4, 2, 1))
        self.ConvBlock5 = ConvBlock(dim * 8, dim * 16)
        for k in range(4):
            c_in, c_out = dim * 2 ** (4 - k), dim * 2 ** (3 - k)
            setattr(self, f"upv{k + 6}", ConvTranspose2d(c_in, c_out, 2, 2))
            setattr(self, f"ConvBlock{k + 6}", ConvBlock(2 * c_out, c_out))
        self.conv10 = Conv2d(dim, 3, 3, padding=1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                plain: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC, H and W multiples of 16 -> (B, H, W, 3)
        float32. `mask` is ignored, as in JAX; `plain` and `generator` are
        accepted for the Uformer's signature (no kernel, no DropPath)."""
        y = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last
        skips = []
        for k in range(4):
            y = getattr(self, f"ConvBlock{k + 1}")(y)
            skips.append(y)
            y = getattr(self, f"pool{k + 1}")(y)
        y = self.ConvBlock5(y)
        for k in range(4):
            y = getattr(self, f"upv{k + 6}")(y)
            y = getattr(self, f"ConvBlock{k + 6}")(
                torch.cat([y, skips[3 - k]], dim=1))
        y = self.conv10(y).permute(0, 2, 3, 1)  # back to NHWC, no copy
        return x.float() + y.float()
