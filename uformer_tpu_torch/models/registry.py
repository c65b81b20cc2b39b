"""Named architectures, counterpart of `uformer_tpu/models/registry.py`.

Every arch of the JAX registry: UNet (the pure-conv baseline, at
`embed_dim`, default 32) and the Uformer family with linear projection
and LeFF: Uformer_T, Uformer_S, Uformer_S_noshift, Uformer_B,
Uformer_B_fastleff, and Uformer at any embed dim and window. Every one
builds and runs on the CPU (the kernels' plain versions); on the card the
kernels take window 8 and head dim 16 or 32 (head dim is the embed dim in
this family), and their wrappers raise before any launch at other
geometries. `use_checkpoint` recomputes each Uformer block in the
backward (UNet ignores it, as in JAX). `img_size` is
the reference's `--train_ps`: it fixes the construction-time window and
shift choices only. No arch sets the conv token projection, Mlp or the
cross-modulator, in the JAX registry either: build those through
`Uformer` directly.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from uformer_tpu_torch.models.uformer import Uformer
from uformer_tpu_torch.models.unet import UNet

_B_DEPTHS = (1, 2, 8, 8, 2, 8, 8, 2, 1)
_HEADS = (1, 2, 4, 8, 16, 16, 8, 4, 2)  # head dim = embed dim in every stage


def arch_config(opt: Dict[str, Any]) -> Dict[str, Any]:
    """The `Uformer` keyword arguments of `opt["arch"]`, as the JAX
    registry sets them (reference model_utils.py:62-78)."""
    arch = opt.get("arch", "Uformer_B")
    embed, win, depths, shift = 32, 8, (2,) * 9, True
    if arch == "Uformer":
        embed = opt.get("embed_dim", 32)
        win = opt.get("win_size", 8)
    elif arch == "Uformer_T":
        embed = 16
    elif arch == "Uformer_S_noshift":
        shift = False
    elif arch in ("Uformer_B", "Uformer_B_fastleff"):
        # fastleff differs only in the TPU's depthwise-conv backend: the
        # same function and state_dict keys (convert/torch_converter.py:69-72)
        depths = _B_DEPTHS
    elif arch != "Uformer_S":
        raise ValueError(f"unknown arch {arch!r}; available: "
                         f"{sorted(ARCHS)}")
    return dict(img_size=opt.get("train_ps", 128), embed_dim=embed,
                depths=depths, num_heads=_HEADS, win_size=win, mlp_ratio=4.0,
                modulator=True, shift_flag=shift, dd_in=opt.get("dd_in", 3),
                drop_path_rate=opt.get("drop_path_rate", 0.1),
                dtype=opt.get("dtype", torch.float32),
                use_checkpoint=bool(opt.get("use_checkpoint", False)))


ARCHS = ("UNet", "Uformer", "Uformer_T", "Uformer_S", "Uformer_S_noshift",
         "Uformer_B", "Uformer_B_fastleff")


def get_arch(opt) -> nn.Module:
    """Build a model from an options mapping or object with `.arch`,
    `.train_ps`, `.embed_dim`, `.win_size`, `.dd_in`, `.drop_path_rate`,
    `.dtype` and `.use_checkpoint`. Its weights are torch's defaults: load
    trained or seeded ones (`convert.load_numpy_state_dict`)."""
    if not isinstance(opt, dict):
        opt = {k: getattr(opt, k) for k in (
            "arch", "train_ps", "embed_dim", "win_size", "dd_in",
            "drop_path_rate", "dtype", "use_checkpoint") if hasattr(opt, k)}
    if opt.get("arch") == "UNet":  # reference model_utils.py:62-63
        return UNet(dim=opt.get("embed_dim", 32),
                    dtype=opt.get("dtype", torch.float32))
    return Uformer(**arch_config(opt))
