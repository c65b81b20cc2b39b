"""Named architectures, counterpart of `uformer_tpu/models/registry.py`.

This port has the Uformer family with linear projection and LeFF whose
head dim is 16 or 32 (the forward kernels' widths): Uformer_T, Uformer_S,
Uformer_S_noshift, Uformer_B, Uformer_B_fastleff, and Uformer at embed
dim 16 or 32 with window 8. `img_size` is the reference's `--train_ps`:
it fixes the construction-time window and shift choices only. No arch
sets the conv token projection, Mlp or the cross-modulator, in the JAX
registry either: build those through `Uformer` directly.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from uformer_tpu_torch.models.uformer import Uformer

_B_DEPTHS = (1, 2, 8, 8, 2, 8, 8, 2, 1)
_HEADS = (1, 2, 4, 8, 16, 16, 8, 4, 2)  # head dim = embed dim in every stage

# the other reference archs, ported with ROADMAP.md queue 1 item 8
# ("Remaining architectures and blocks")
NOT_PORTED = ("UNet",)


def arch_config(opt: Dict[str, Any]) -> Dict[str, Any]:
    """The `Uformer` keyword arguments of `opt["arch"]`, as the JAX
    registry sets them (reference model_utils.py:62-78)."""
    arch = opt.get("arch", "Uformer_B")
    embed, depths, shift = 32, (2,) * 9, True
    if arch == "Uformer":
        embed = opt.get("embed_dim", 32)
        win = opt.get("win_size", 8)
        if embed not in (16, 32) or win != 8:
            raise NotImplementedError(
                f"Uformer at embed_dim {embed}, win_size {win} is not ported "
                f"yet (embed_dim 16 or 32 and win_size 8 are): ROADMAP.md, "
                f"port queue 2, next slice 1 (win != 8)")
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
                depths=depths, num_heads=_HEADS, win_size=8, mlp_ratio=4.0,
                modulator=True, shift_flag=shift, dd_in=opt.get("dd_in", 3),
                drop_path_rate=opt.get("drop_path_rate", 0.1),
                dtype=opt.get("dtype", torch.float32))


ARCHS = ("Uformer", "Uformer_T", "Uformer_S", "Uformer_S_noshift",
         "Uformer_B", "Uformer_B_fastleff")


def get_arch(opt) -> Uformer:
    """Build a model from an options mapping or object with `.arch`,
    `.train_ps`, `.embed_dim`, `.win_size`, `.dd_in`, `.drop_path_rate`,
    `.dtype`. Its weights are torch's defaults: load trained or seeded
    ones (`convert.load_numpy_state_dict`)."""
    if not isinstance(opt, dict):
        opt = {k: getattr(opt, k) for k in (
            "arch", "train_ps", "embed_dim", "win_size", "dd_in",
            "drop_path_rate", "dtype") if hasattr(opt, k)}
    arch = opt.get("arch", "Uformer_B")
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP.md, port queue 1 item 8 "
            f"(remaining architectures and blocks)")
    return Uformer(**arch_config(opt))
