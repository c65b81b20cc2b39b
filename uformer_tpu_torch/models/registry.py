"""Named architectures, counterpart of `uformer_tpu/models/registry.py`.

Every arch of the JAX registry: UNet (the pure-conv baseline, at
`embed_dim`, default 32) and the Uformer family with linear projection
and LeFF: Uformer_T, Uformer_S, Uformer_S_noshift, Uformer_B,
Uformer_B_fastleff, and Uformer at any embed dim and window. Every one
builds and runs on the CPU (the kernels' plain versions). On the card the
forward (eval, serving, the CLIs) and training run through the kernels at
every window and every head dim that is a multiple of 8 up to 64 (head
dim is the embed dim in this family): every arch here at `--embed_dim`
8-64 in steps of 8, any `--win_size` and any `--train_ps`. Head dims 8,
16, 32 and 64 run the tensor-core bodies; 24, 40, 48 and 56 (Uformer at
embed 24-56, C 24-896, no power of two) the one-window bodies of kernels
1, 5 and 6 and the stage kernel (bf16 through zero-padded WMMA
fragments) and LeFF's `leff_tile` forward and `csrc/leff_bwd_heads.cu`
backward. Uformer at `--embed_dim` 72-128 in steps of 8 (head dims
72-128, C up to 2048) serves, evaluates and trains through the kernels
at windows 1-8 (the stage kernel and kernels 1, 5 and 2 on their
one-window bodies, `window_attention.FORWARD_HEAD_DIMS`, and their
backward kernels 6 and 7); above window 8, serving, the spatial path and
training alike, the card refuses it before any launch (ROADMAP.md's port
queue 2 item 9). A stage built below the
window runs at window min(reso, win);
below 8, 64 // N whole windows of N = win² tokens to a kernel tile;
above 8, the key-chunked kernels of `csrc/attention_wide.cu`, whose
backward holds dS for a bounded group of windows at a time. Other head
dims have no kernel for what a path needs: the wrappers raise before any
launch, and the train step refuses a model at such a head dim before any
launch (`LeWinBlock.backward_gap`, ROADMAP.md's port queue 2 item 9).
`use_checkpoint` recomputes each
Uformer block in the
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
