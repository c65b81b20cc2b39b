"""The Uformer U-Net, counterpart of `uformer_tpu/models/uformer.py`.

Channel plan (embed dim E): encoder E, 2E, 4E, 8E; bottleneck 16E;
decoder stages at 16E/8E/4E/2E after concatenating the upsampled path
with the encoder skip, upsampled first. The modulator and the
cross-modulator sit in the decoder stages only. Global residual `x + y`
in float32 when dd_in == 3. The stochastic-depth schedule is the
reference's (`uformer.py:54-66`); the rates take effect in training only
(`model.train()`). `token_projection` ("linear" or "conv"), `token_mlp`
("leff", "fastleff", "mlp" or "ffn") and `cross_modulator` are the
reference's options (`uformer_tpu` uformer.py:45-49). `use_checkpoint`
recomputes each block's forward in the backward (`BasicLayer`).
`drop_rate` and `attn_drop_rate` (`uformer.py:42-43`, default 0) are
dropout after `input_proj` and in every block, in training only, routed as
JAX routes them (`models/layers.py`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from uformer_tpu_torch.models.layers import (
    BasicLayer,
    Downsample,
    InputProj,
    OutputProj,
    Upsample,
    dropout,
)


class Uformer(nn.Module):
    def __init__(self, img_size: int = 256, in_chans: int = 3, dd_in: int = 3,
                 embed_dim: int = 32,
                 depths: Sequence[int] = (2,) * 9,
                 num_heads: Sequence[int] = (1, 2, 4, 8, 16, 16, 8, 4, 2),
                 win_size: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 shift_flag: bool = True, modulator: bool = False,
                 token_projection: str = "linear", token_mlp: str = "leff",
                 cross_modulator: bool = False,
                 drop_path_rate: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 use_checkpoint: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0):
        super().__init__()
        E = embed_dim
        self.dd_in, self.drop_rate = dd_in, float(drop_rate)
        self.dtype = dtype  # working dtype of the forward
        self.depths, self.drop_path_rate = list(depths), drop_path_rate
        enc, conv, dec = self.drop_path_schedule()
        cum = np.cumsum([0] + self.depths[:4])
        dcum = np.cumsum([0] + self.depths[5:])
        rates = ([enc[cum[k]:cum[k + 1]] for k in range(4)] + [conv]
                 + [dec[dcum[k]:dcum[k + 1]] for k in range(4)])

        def stage(k, dim, reso, mod=False, cross=False):
            return BasicLayer(dim, depths[k], num_heads[k], win_size, reso,
                              mlp_ratio, qkv_bias, qk_scale, shift_flag, mod,
                              rates[k], token_projection, token_mlp, cross,
                              use_checkpoint, drop_rate, attn_drop_rate)

        self.input_proj = InputProj(dd_in, E)
        self.output_proj = OutputProj(2 * E, in_chans)
        for k in range(4):
            setattr(self, f"encoderlayer_{k}",
                    stage(k, E * 2 ** k, img_size // 2 ** k))
            setattr(self, f"dowsample_{k}",
                    Downsample(E * 2 ** k, E * 2 ** (k + 1)))
        self.conv = stage(4, E * 16, img_size // 16)
        for k in range(4):
            setattr(self, f"upsample_{k}",
                    Upsample(E * 2 ** min(4, 5 - k), E * 2 ** (3 - k)))
            setattr(self, f"decoderlayer_{k}",
                    stage(5 + k, E * 2 ** (4 - k), img_size // 2 ** (3 - k),
                          modulator, cross_modulator))

    def drop_path_schedule(self) -> Tuple[List[float], List[float],
                                          List[float]]:
        """Per-block stochastic-depth rates (reference model.py:1093-1095):
        a linear ramp over the encoder blocks, reversed for the decoder,
        constant for the bottleneck. Python floats, as `uformer_tpu`
        keeps them (uformer.py:57-63)."""
        n_enc = sum(self.depths[:4])
        enc = [float(v) for v in np.linspace(0, self.drop_path_rate, n_enc)]
        conv = [float(self.drop_path_rate)] * self.depths[4]
        return enc, conv, enc[::-1]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                plain: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, dd_in) NHWC, H and W multiples of 16 * win_size.
        mask: an input mask, (B, 1, Hm, Wm) or (B, Hm, Wm, 1), resized to
        each stage (`ops.masks.input_mask_bias`); every block then takes
        the unfused route. plain=True runs every kernel's plain version
        (for comparisons). In training, `generator` draws every DropPath
        and dropout mask (`input_proj`'s dropout first)."""
        if mask is not None:
            mask = mask.to(x.device)
        y = dropout(self.input_proj(x.to(self.dtype)), self.drop_rate,
                    self.training, generator)
        skips = []
        for k in range(4):
            y = getattr(self, f"encoderlayer_{k}")(y, plain, generator, mask)
            skips.append(y)
            y = getattr(self, f"dowsample_{k}")(y)
        y = self.conv(y, plain, generator, mask)
        for k in range(4):
            up = getattr(self, f"upsample_{k}")(y)
            y = torch.cat([up, skips[3 - k]], dim=-1)
            y = getattr(self, f"decoderlayer_{k}")(y, plain, generator,
                                                   mask)
        y = self.output_proj(y).float()
        return x.float() + y if self.dd_in == 3 else y

