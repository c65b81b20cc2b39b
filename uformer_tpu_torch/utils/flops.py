"""Model complexity, counterpart of `uformer_tpu/utils/flops.py`
(reference model.py:49-58,527-546,1307-1328, the hand-kept `flops()`
methods).

`model_complexity` runs one forward of the model's plain path (every
kernel's plain PyTorch version: the kernels are opaque to the counters),
in eval, without grad, on the model's own device, and counts:
- `gflops`: `torch.utils.flop_counter.FlopCounterMode`, i.e. the
  products and convolutions (mm, bmm, addmm, convolution, attention), two
  operations a multiply-add;
- `bytes_gb`: every aten op of that forward, each tensor input read and
  each output written once per op (a `TorchDispatchMode`; views move
  nothing): an upper bound, as if no op were fused.

Two differences from the JAX package's `cost_analysis()` of the compiled
program: XLA also counts elementwise work (GELU, softmax, LayerNorm,
bias adds, the residuals), which FlopCounterMode does not, so JAX's
gflops is the larger; and XLA counts the bytes of the fused program it
compiled, where `bytes_gb` counts every op apart, so the port's bytes are
the larger.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of each aten op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def model_complexity(model: nn.Module,
                     input_shape: Sequence[int] = (1, 256, 256, 3)
                     ) -> Dict[str, float]:
    """dict(params_m, gflops, bytes_gb) of one forward of `model` (a
    Uformer, UNet or LeWin block: anything called as model(x, plain=True))
    on an input of `input_shape` (NHWC), at the model's working dtype."""
    params = sum(p.numel() for p in model.parameters())
    first = next(model.parameters())
    x = torch.zeros(tuple(input_shape), device=first.device,
                    dtype=getattr(model, "dtype", first.dtype))
    was_training = model.training
    flops, nbytes = FlopCounterMode(display=False), _BytesMode()
    try:
        model.eval()
        with torch.no_grad(), flops, nbytes:
            model(x, plain=True)
    finally:
        model.train(was_training)
    return {"params_m": params / 1e6,
            "gflops": flops.get_total_flops() / 1e9,
            "bytes_gb": nbytes.total / 1e9}
