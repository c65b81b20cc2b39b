"""Named architectures, counterpart of `uformer_tpu/models/registry.py`.

This port has Uformer_B, the eval and train main paths. `img_size` is the
reference's `--train_ps`: it fixes the construction-time window and shift
choices only.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from uformer_tpu_torch.models.uformer import Uformer

_B_DEPTHS = (1, 2, 8, 8, 2, 8, 8, 2, 1)

# the other reference archs, ported with ROADMAP.md queue 1 item 8
# ("Remaining architectures and blocks")
NOT_PORTED = ("UNet", "Uformer", "Uformer_T", "Uformer_S",
              "Uformer_S_noshift", "Uformer_B_fastleff")


def _uformer_b(opt: Dict[str, Any]) -> Uformer:
    return Uformer(img_size=opt.get("train_ps", 128), embed_dim=32,
                   depths=_B_DEPTHS, num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2),
                   win_size=8, mlp_ratio=4.0, modulator=True, shift_flag=True,
                   dd_in=opt.get("dd_in", 3),
                   drop_path_rate=opt.get("drop_path_rate", 0.1),
                   dtype=opt.get("dtype", torch.float32))


ARCHS = {"Uformer_B": _uformer_b}


def get_arch(opt) -> Uformer:
    """Build a model from an options mapping or object with `.arch`,
    `.train_ps`, `.dd_in`, `.drop_path_rate`, `.dtype`. Its weights are
    torch's defaults: load trained or seeded ones
    (`convert.load_numpy_state_dict`)."""
    if not isinstance(opt, dict):
        opt = {k: getattr(opt, k) for k in ("arch", "train_ps", "dd_in",
                                            "drop_path_rate", "dtype")
               if hasattr(opt, k)}
    arch = opt.get("arch", "Uformer_B")
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP.md, port queue 1 item 8 "
            f"(remaining architectures and blocks)")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch](opt)
