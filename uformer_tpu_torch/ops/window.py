"""Window partition / reverse and the SW-MSA cyclic shift on NHWC tensors.

Counterpart of `uformer_tpu/ops/window.py:30-88,142-153` (the packed
variants there are a TPU lane artefact and are not ported).

The dilated path (`dilation_rate > 1`) is the reference's own operators
(reference model.py:706-711, 721-723): partition is `F.unfold(kernel_size=
win, dilation=d, padding=4*(d-1), stride=win)`, reverse the `F.fold` with
the same arguments, which the reference intends (its code crashes
upstream: it permutes a 4-D tensor with six indices). `F.fold` sums the
overlapping dilated taps, so for d > 1 reverse(partition(x)) is x weighted
by each pixel's tap count, not x, as in the JAX package. Reverse folds
the windows flipped, so that a pixel's taps add in the JAX package's
order (`_fold_flipped`). No shipped arch calls the dilated path;
dilation 1 keeps its reshapes.

Shapes:
  partition: (B, H, W, C) -> (B * nWh * nWw, win*win, C)
  reverse:   (B * nWh * nWw, win*win, C) -> (B, H, W, C)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _fold_args(win: int, d: int) -> dict:
    # the reference hard-codes padding 4 = win // 2 of its win-8 models
    return dict(kernel_size=win, dilation=d, padding=4 * (d - 1), stride=win)


def window_partition(x: torch.Tensor, win: int,
                     dilation_rate: int = 1) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, win*win, C); windows and the tokens inside
    them enumerate row-major, as in the reference."""
    B, H, W, C = x.shape
    if dilation_rate != 1:
        cols = F.unfold(x.permute(0, 3, 1, 2),
                        **_fold_args(win, int(dilation_rate)))
        # (B, C * win * win, L) -> (B * L, win * win, C)
        return cols.reshape(B, C, win * win, -1).permute(0, 3, 2, 1) \
            .reshape(-1, win * win, C)
    if H % win or W % win:
        raise ValueError(f"H={H}, W={W} must be multiples of win={win}")
    x = x.reshape(B, H // win, win, W // win, win, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, C)


def window_reverse(windows: torch.Tensor, win: int, H: int, W: int,
                   dilation_rate: int = 1) -> torch.Tensor:
    """(B*nW, win*win, C) -> (B, H, W, C); inverse of window_partition for
    dilation 1, the F.fold overlap-sum for dilation > 1 (module note)."""
    C = windows.shape[-1]
    if dilation_rate != 1:
        return _fold_flipped(windows, win, H, W, int(dilation_rate))
    B = windows.shape[0] // ((H // win) * (W // win))
    x = windows.reshape(B, H // win, W // win, win, win, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def _fold_flipped(windows: torch.Tensor, win: int, H: int, W: int,
                  d: int) -> torch.Tensor:
    """F.fold of the dilated windows, its taps added in window order.

    F.fold adds a pixel's overlapping taps in kernel-offset order, which
    is the windows' reverse order; the JAX package's scatter-add adds them
    in window order, and float sums of three or more taps (d = 2) depend
    on the order. Folding the flipped windows (window and tap order both
    reversed) onto the flipped padded canvas, with padding 0, adds them in
    window order, so the two agree bit for bit on the CPU. The canvas rows
    past the last window's reach get no tap."""
    C = windows.shape[-1]
    p, ext = 4 * (d - 1), d * (win - 1) + 1
    Hp, Wp = H + 2 * p, W + 2 * p
    oh, ow = (Hp - ext) // win + 1, (Wp - ext) // win + 1
    rest_h, rest_w = Hp - (oh - 1) * win - ext, Wp - (ow - 1) * win - ext
    wt = windows.reshape(-1, oh, ow, win, win, C).flip(1, 2, 3, 4)
    cols = wt.permute(0, 5, 3, 4, 1, 2).reshape(-1, C * win * win, oh * ow)
    canvas = F.fold(cols, (Hp - rest_h, Wp - rest_w), kernel_size=win,
                    dilation=d, stride=win).flip(2, 3)
    canvas = F.pad(canvas, (0, rest_w, 0, rest_h))
    return canvas[:, :, p:p + H, p:p + W].permute(0, 2, 3, 1)


def cyclic_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll H and W by -shift (the SW-MSA pre-shift)."""
    if shift == 0:
        return x
    return torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))


def cyclic_unshift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll H and W by +shift (reverse of cyclic_shift)."""
    if shift == 0:
        return x
    return torch.roll(x, shifts=(shift, shift), dims=(1, 2))
