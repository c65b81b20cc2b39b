"""Weight-gradient reductions of the backward kernels (`csrc/wgrad.cu`).

The backward wrappers (`fused_leff_bwd`, `fused_attention_image_bwd`) call
these on CUDA tensors only, after their per-tile kernels: `wgrad` forms
A^T B over every token row (on `mma.sync` register tiles in bf16, with
the column sums of B, a bias gradient, from the same pass), `colsum` sums
rows. Both sum in a fixed order, so results repeat bit for bit. Their
plain versions are `a.T @ b` and `t.sum(0)`, which the backward wrappers'
plain VJPs stand in for on the CPU.
"""

from __future__ import annotations

import functools

import torch

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def wgrad_ranges(M: int, K1: int, N: int, sms: int) -> int:
    """The fixed row ranges S that wgrad splits M into: enough 128 x 128
    output tiles times ranges for about two waves of the SMs, each range
    at least 512 rows (a range's partial product is K1 x N floats)."""
    tiles = -(-K1 // 128) * -(-N // 128)
    return max(1, min(-(-M // 512), -(-2 * sms // tiles)))


def wgrad(a: torch.Tensor, b: torch.Tensor, colsum_b: bool = False):
    """a (M, K1), b (M, N) on the card, same dtype, unit column stride,
    K1 and N multiples of 8 -> a^T b (K1, N) float32, summed over M in a
    fixed order; with colsum_b, (a^T b, the column sums of b (N,) float32),
    in bf16 from the same pass over b."""
    M, K1 = a.shape
    N = b.shape[1]
    if b.shape[0] != M or a.dtype != b.dtype or a.stride(1) != 1 \
            or b.stride(1) != 1 or a.dtype not in _launch.KERNEL_DTYPES:
        raise ValueError(f"wgrad: a {tuple(a.shape)} {a.dtype}, b "
                         f"{tuple(b.shape)} {b.dtype}")
    S = wgrad_ranges(M, K1, N, sm_count(a.device))
    f32, dev = torch.float32, a.device
    out = torch.empty(K1, N, dtype=f32, device=dev)
    part = torch.empty(S, K1, N, dtype=f32, device=dev) if S > 1 else None
    cs = torch.empty(N, dtype=f32, device=dev) if colsum_b else None
    cs_part = (torch.empty(S, N, dtype=f32, device=dev)
               if colsum_b and S > 1 else None)
    err = load().uf_wgrad(_is_bf16(a), a.data_ptr(), a.stride(0),
                          b.data_ptr(), b.stride(0), out.data_ptr(),
                          _launch.ptr(part), _launch.ptr(cs),
                          _launch.ptr(cs_part), M, K1, N, S,
                          _launch.stream(a))
    _launch.check(err, "wgrad kernel")
    return (out, cs) if colsum_b else out


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
