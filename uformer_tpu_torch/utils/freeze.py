"""Parameter freezing, counterpart of `uformer_tpu/utils/freeze.py`
(reference `utils/model_utils.py:6-16`: freeze / unfreeze / is_frozen).

In PyTorch freezing is the parameter's own flag: `freeze` clears
`requires_grad` on the parameters whose state_dict name matches a
predicate, and `make_optimizer` (`train/train_step.py`) takes only the
trainable parameters, so a frozen one gets no update and no weight decay,
as `optax.set_to_zero` gives it in JAX (`freeze.py:29-38`). Autograd
computes no gradient for it. `is_frozen` is JAX's: every parameter
frozen.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn


def path_matches(name: str, pattern: str) -> bool:
    """True where `pattern` occurs in the state_dict name (JAX matches the
    `/`-joined param path the same way)."""
    return pattern in name


def freeze(model: nn.Module,
           predicate: Optional[Callable[[str], bool]] = None) -> nn.Module:
    """Clear requires_grad on each parameter whose name satisfies
    `predicate` (every parameter without one, as the reference's
    freeze)."""
    for name, p in model.named_parameters():
        if predicate is None or predicate(name):
            p.requires_grad_(False)
    return model


def unfreeze(model: nn.Module) -> nn.Module:
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def is_frozen(model: nn.Module) -> bool:
    """True if every parameter is frozen."""
    return not any(p.requires_grad for p in model.parameters())


def trainable_parameters(model: nn.Module) -> List[torch.Tensor]:
    return [p for p in model.parameters() if p.requires_grad]
