"""Weight-gradient reductions of the backward kernels (`csrc/wgrad.cu`).

The backward wrappers (`fused_leff_bwd`, `fused_attention_image_bwd`) call
these on CUDA tensors only, after their per-tile kernels: `wgrad` forms
A^T B over every token row, `colsum` sums rows. Both sum in a fixed order,
so results repeat bit for bit. Their plain versions are `a.T @ b` and
`t.sum(0)`, which the backward wrappers' plain VJPs stand in for on the
CPU.
"""

from __future__ import annotations

import functools

import torch

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def wgrad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K1), b (M, N) on the card, same dtype, unit column stride ->
    a^T b (K1, N) float32, summed over M in a fixed order."""
    M, K1 = a.shape
    N = b.shape[1]
    if b.shape[0] != M or a.dtype != b.dtype or a.stride(1) != 1 \
            or b.stride(1) != 1:
        raise ValueError(f"wgrad: a {tuple(a.shape)} {a.dtype}, b "
                         f"{tuple(b.shape)} {b.dtype}")
    # split M so that the output tiles make about four waves of the SMs
    tiles = -(-K1 // 128) * -(-N // 128)
    S = max(1, min(M // 64, -(-4 * _sms(a.device) // tiles)))
    out = torch.empty(K1, N, dtype=torch.float32, device=a.device)
    part = (torch.empty(S, K1, N, dtype=torch.float32, device=a.device)
            if S > 1 else None)
    err = load().uf_wgrad(_is_bf16(a), a.data_ptr(), a.stride(0),
                          b.data_ptr(), b.stride(0), out.data_ptr(),
                          _launch.ptr(part), M, K1, N, S, _launch.stream(a))
    _launch.check(err, "wgrad kernel")
    return out


def colsum(t: torch.Tensor) -> torch.Tensor:
    """t (R, K) on the card, float32 or bfloat16, unit column stride ->
    the sum of its rows (K,) float32, in a fixed order."""
    R, K = t.shape
    if t.stride(1) != 1 or t.dtype not in _launch.KERNEL_DTYPES:
        raise ValueError(f"colsum: {tuple(t.shape)} {t.dtype}")
    S = max(1, min(-(-R // 32), -(-(1 << 18) // K)))
    out = torch.empty(K, dtype=torch.float32, device=t.device)
    part = (torch.empty(S, K, dtype=torch.float32, device=t.device)
            if S > 1 else None)
    err = load().uf_colsum(_is_bf16(t), t.data_ptr(), t.stride(0),
                           out.data_ptr(), _launch.ptr(part), R, K, S,
                           _launch.stream(t))
    _launch.check(err, "colsum kernel")
    return out
