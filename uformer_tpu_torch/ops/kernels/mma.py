"""The tensor-core building block of the LeFF and stage kernels, alone.

`block_product(a, b)` runs `csrc/mma_check.cu`: a . b through the warp
products (`mma.sync` m16n8k16, fp32 accumulators in registers) and the
cp.async ring of `csrc/mma_tile.cuh`, as the LeFF tiles use them, so that
the building block can be held against `torch.matmul` on the card. It is
no port of a TPU kernel and no model path calls it. A CPU tensor takes
the plain product.
"""

from __future__ import annotations

import torch

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load


def block_product(a: torch.Tensor, b: torch.Tensor,
                  n_tiles: int = 4) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) float32; a, b bfloat16, K a multiple
    of 64, N of 8 n_tiles (the n8 tiles a warp takes: 1, 2 or 4)."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    M, K = a.shape
    N = b.shape[1]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 \
            or b.shape[0] != K or K % 64 or n_tiles not in (1, 2, 4) \
            or N % (8 * n_tiles) or not (a.is_contiguous()
                                         and b.is_contiguous()):
        raise ValueError(f"block_product: a {tuple(a.shape)} {a.dtype}, b "
                         f"{tuple(b.shape)} {b.dtype}, n_tiles {n_tiles}")
    c = torch.empty(M, N, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = load().uf_mma_check(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                  M, N, K, n_tiles, _launch.stream(a))
    _launch.check(err, "mma_check kernel")
    return c
