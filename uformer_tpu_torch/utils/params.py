"""Serving preparation, counterpart of `uformer_tpu/utils/params.py:81
cast_weights`: what JAX redoes in every trace, done once; and the
parameter count (`count_params`, `params.py:77`)."""

from __future__ import annotations

import torch
from torch import nn

from uformer_tpu_torch.models.layers import BasicLayer, _Conv


@torch.no_grad()
def prepare_serving(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make `model` run in `dtype` and keep, on the model's device, the
    kernels' weights: >= 2-D weights cast to dtype (1-D leaves and bias
    tables stay float32), Linear weights transposed to (in, out), the
    (nH, 64, 64) float32 relative-position bias gathered, and each
    stage-kernel layer's per-block weights stacked along depth. Call again
    after loading weights or moving the model."""
    model.dtype = dtype
    for m in model.modules():
        # a layer prepares either its stacked stage weights or its blocks
        if isinstance(m, (BasicLayer, _Conv)):
            m.prepare(dtype)
    return model


def count_params(params) -> int:
    """The number of parameter values of a module (its `parameters()`), a
    mapping of tensors (a state_dict's parameters) or an iterable of
    tensors (`uformer_tpu` params.py:77 over a parameter tree)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif hasattr(params, "values"):
        params = params.values()
    return sum(int(p.numel()) for p in params)
