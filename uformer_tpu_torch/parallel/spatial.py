"""Spatial parallelism: the image split along H over the ranks, with halo
exchanges, counterpart of `uformer_tpu/parallel/spatial.py`.

Window attention keeps the exchanges small: an image split over H needs
  * a periodic exchange of `shift` rows for the SW-MSA cyclic roll, and
  * a halo of neighbour rows for the 3x3 convs and LeFF's depthwise conv,
never ring attention. JAX's `ppermute` becomes a ring of
`dist.batch_isend_irecv`; under gloo a CUDA tensor goes through pinned
host memory (`multihost.host_staged`), the transport of ranks that share
one card. Every exchange and gather is counted (`exchange_stats`: calls,
bytes, host seconds; with host staging the clock starts after the card
has finished the work before it).

Tensors are NHWC: a rank holds rows [r Hs, (r + 1) Hs) of a (B, H, W, C)
batch, as (B, Hs, W, C). `group=None` is JAX's `axis_name=None`: the
tensor holds whole images (a replicated stage), and the exchanges are
local rolls and zero padding.

On a card tensor every LeWin block runs kernel 5
(`ops.kernels.fused_attention_block`, LN folded, the modulator in the
decoder, its windows placed at `w_off = rank (Hs / win) (W / win)` of the
level's global H x W) and kernel 2 (`ops.kernels.fused_leff`, LN folded,
no residual, on a slab with halo rows); on the CPU their plain versions.
It never takes the stage kernel or kernel 1, whose shift is inline and
would cross the shard's edge. Kernel 5 maps window i of a launch to place
(w_off + i) mod nW of one image, so a sharded stage launches it once per
image; a replicated stage (w_off 0, whole images) once per batch.

LeFF at the image's true edge: the kernel zero-pads its depthwise ring
after LN, linear1 and GELU, where a zero pixel row would become a
non-zero hidden row. So the slab takes halo rows only on interior sides
(the first rank none above, the last none below) and the kernel's own
ring is the true edge; JAX instead recomputes the two edge rows in jnp
(`spatial.py:118-162`). The halo is one row, or the fp32 tile's height
where the kernel needs the slab's rows in multiples of it
(`ops.kernels.leff.tile_rows`).
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from uformer_tpu_torch.eval.padding import tile_weights
from uformer_tpu_torch.models.layers import LEFF_MLPS, LeWinBlock
from uformer_tpu_torch.ops.kernels import fused_attention_block, fused_leff
from uformer_tpu_torch.ops.kernels.leff import tile_rows
from uformer_tpu_torch.ops.window import window_partition, window_reverse
from uformer_tpu_torch.parallel.multihost import (
    all_gather_rows,
    comm_device,
    group_rank,
    group_size,
    host_staged,
    to_host,
)

Group = Optional[dist.ProcessGroup]
_TAG_DOWN, _TAG_UP = 0, 1  # to the next rank, to the previous one


# ----------------------------------------------------------- exchanges

def _clock_start(x: torch.Tensor, group: Group) -> float:
    if host_staged(x, group):
        torch.cuda.current_stream(x.device).synchronize()
    return time.perf_counter()


def _count(t0: float, nbytes: int) -> None:
    _count.calls += 1
    _count.bytes += nbytes
    _count.seconds += time.perf_counter() - t0


_count.calls, _count.bytes, _count.seconds = 0, 0, 0.0


def exchange_stats() -> dict:
    """Exchanges and gathers since the last reset: calls, bytes sent by
    this rank, host seconds."""
    return {"calls": _count.calls, "bytes": _count.bytes,
            "seconds": _count.seconds}


def reset_exchange_stats() -> None:
    _count.calls, _count.bytes, _count.seconds = 0, 0, 0.0


def _size(group: Group) -> int:
    """Ranks that split the image: 1 for group None (whole images)."""
    return 1 if group is None else group_size(group)


def _rank(group: Group) -> int:
    return 0 if group is None else group_rank(group)


def _sharded(group: Group) -> bool:
    return _size(group) > 1


def _pass_rows(down: Optional[torch.Tensor], up: Optional[torch.Tensor],
               group: Group, periodic: bool):
    """Every rank sends `down` to the next rank and `up` to the previous
    one; returns (what the previous rank sent down, what the next rank sent
    up). Without `periodic`, nothing passes between the last rank and the
    first: None there."""
    n, r = _size(group), _rank(group)
    prev, nxt = (r - 1) % n, (r + 1) % n
    like = down if down is not None else up
    staged = host_staged(like, group)
    t0 = _clock_start(like, group)
    sends, recvs = [], []  # (tensor, group peer, tag)
    if down is not None:
        if periodic or r < n - 1:
            sends.append((down, nxt, _TAG_DOWN))
        if periodic or r > 0:
            recvs.append((down, prev, _TAG_DOWN))
    if up is not None:
        if periodic or r > 0:
            sends.append((up, prev, _TAG_UP))
        if periodic or r < n - 1:
            recvs.append((up, nxt, _TAG_UP))
    ops, got = [], {}
    for t, peer, tag in sends:
        buf = to_host(t) if staged else t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, peer), group, tag))
    for t, peer, tag in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=staged,
                          device="cpu" if staged else t.device)
        got[tag] = buf
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = {tag: (b.to(like.device, non_blocking=True) if staged else b)
           for tag, b in got.items()}
    _count(t0, sum(t.numel() * t.element_size() for t, _, _ in sends))
    return out.get(_TAG_DOWN), out.get(_TAG_UP)


def cyclic_shift_sharded(x: torch.Tensor, shift: int,
                         group: Group) -> torch.Tensor:
    """The global roll by -shift along H of an H-sharded (B, Hs, W, C)
    batch: every rank passes its first `shift` rows to the previous rank.
    With group None, a local roll."""
    if shift == 0:
        return x
    if not _sharded(group):
        return torch.roll(x, -shift, dims=1)
    _, head = _pass_rows(None, x[:, :shift], group, periodic=True)
    return torch.cat([x[:, shift:], head], dim=1)


def cyclic_unshift_sharded(x: torch.Tensor, shift: int,
                           group: Group) -> torch.Tensor:
    """The inverse of `cyclic_shift_sharded`: the global roll by +shift."""
    if shift == 0:
        return x
    if not _sharded(group):
        return torch.roll(x, shift, dims=1)
    tail, _ = _pass_rows(x[:, -shift:], None, group, periodic=True)
    return torch.cat([tail, x[:, :-shift]], dim=1)


def halo_exchange(x: torch.Tensor, halo, group: Group,
                  periodic: bool = False) -> torch.Tensor:
    """(B, Hs, W, C) extended by its neighbours' rows to (B, Hs + lo + hi,
    W, C). `halo` is an int (both sides) or a (lo, hi) pair (the 4x4
    stride-2 Downsample conv needs (1, 2)). Without `periodic`, the rows
    beyond the image's edges are zeros (a conv's zero padding). With group
    None, plain zero padding."""
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    if not _sharded(group):
        return F.pad(x, (0, 0, 0, 0, lo, hi))
    top, bottom = _pass_rows(x[:, x.shape[1] - lo:] if lo else None,
                             x[:, :hi] if hi else None, group, periodic)
    if lo and top is None:
        top = x.new_zeros((x.shape[0], lo) + x.shape[2:])
    if hi and bottom is None:
        bottom = x.new_zeros((x.shape[0], hi) + x.shape[2:])
    return torch.cat([t for t in (top, x, bottom) if t is not None], dim=1)


def _gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The whole (B, H, W, C) batch from every rank's (B, Hs, W, C)."""
    t0 = _clock_start(x, group)
    out = all_gather_rows(x, group, dim=1)
    _count(t0, x.numel() * x.element_size())
    return out


def _own_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's rows of a whole (B, H, W, C) batch."""
    rows = x.shape[1] // _size(group)
    r0 = _rank(group) * rows
    return x[:, r0:r0 + rows]


# ------------------------------------------------------------- convs

def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def dwconv_sharded(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], group: Group) -> torch.Tensor:
    """3x3 depthwise SAME conv of an H-sharded (B, Hs, W, C) batch through
    a 1-row halo; w (3, 3, C) as `ops.dwconv.depthwise_conv2d` takes it."""
    from uformer_tpu_torch.ops.dwconv import depthwise_conv2d

    return depthwise_conv2d(halo_exchange(x, 1, group), w, b)[:, 1:-1]


def conv3x3_sharded(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    group: Group) -> torch.Tensor:
    """3x3 stride-1 SAME conv (Input/OutputProj, reference
    model.py:781-846) of an H-sharded batch: a 1-row halo, W padded
    locally. w (out, in, 3, 3), the torch layout."""
    xh = halo_exchange(x, 1, group)
    return _nhwc(F.conv2d(_nchw(xh), w.to(x.dtype), b.to(x.dtype),
                          padding=(0, 1)))


def downsample_sharded(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       group: Group) -> torch.Tensor:
    """4x4 stride-2 pad-1 conv (reference Downsample, model.py:730-753) of
    an H-sharded batch. Output row j reads input rows 2j-1 .. 2j+2, so the
    rank that owns output rows [a, b) needs input rows [2a - 1, 2b + 2):
    halo (1, 2). Hs must be even."""
    if x.shape[1] % 2:
        raise ValueError(f"downsample_sharded needs an even Hs: "
                         f"{x.shape[1]}")
    xh = halo_exchange(x, (1, 2), group)
    return _nhwc(F.conv2d(_nchw(xh), w.to(x.dtype), b.to(x.dtype),
                          stride=2, padding=(0, 1)))


def upsample_local(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed conv (reference Upsample,
    model.py:756-778): output rows 2i and 2i + 1 read input row i only, so
    sharded and whole batches run the same local op. w (in, out, 2, 2)."""
    return _nhwc(F.conv_transpose2d(_nchw(x), w.to(x.dtype), b.to(x.dtype),
                                    stride=2))


# ---------------------------------------------------- sharded LeWin block

def check_spatial(model: nn.Module) -> None:
    """Raise NotImplementedError for a block the spatial path does not run:
    JAX's shipped arch space, linear projection, LeFF and no
    cross-modulator (`spatial.py:396-401`)."""
    for name, blk in model.named_modules():
        if not isinstance(blk, LeWinBlock):
            continue
        if blk.attn.token_projection != "linear" \
                or blk.token_mlp not in LEFF_MLPS \
                or blk.cross_attn is not None or blk.mlp.eca is not None:
            raise NotImplementedError(
                f"{name}: the spatial path runs linear projection, LeFF "
                f"without Eca1d and no cross-modulator, as JAX's does")


def _leff_slab_halo(x: torch.Tensor, Ch: int, group: Group) -> int:
    """Rows of halo LeFF's slab takes on an interior side: 1, or the fp32
    tile's height (the slab's rows must be a multiple of it)."""
    t = tile_rows(x, Ch)
    if x.shape[1] % t or (_sharded(group) and t > x.shape[1]):
        raise ValueError(f"LeFF on {x.shape[1]} rows a shard: the kernel "
                         f"takes multiples of {t}")
    return t


def _leff_sharded(blk: LeWinBlock, x: torch.Tensor, p: dict,
                  group: Group) -> torch.Tensor:
    """x + LeFF(LN2 x) of an H-sharded batch: kernel 2 on a slab with halo
    rows on its interior sides only (module note), cropped."""
    t = _leff_slab_halo(x, p["w1"].shape[-1], group)
    Hs = x.shape[1]
    if _sharded(group):
        n, r = _size(group), _rank(group)
        lo, hi = (0 if r == 0 else t), (0 if r == n - 1 else t)
        slab = halo_exchange(x, t, group)[:, t - lo:t + Hs + hi]
    else:
        lo, slab = 0, x
    y = fused_leff(slab.contiguous(), p["w1"], p["b1"], p["wd"], p["bd"],
                   p["w2"], p["b2"], ln_s=p["ln2_s"], ln_b=p["ln2_b"],
                   residual=False)
    return x + y[:, lo:lo + Hs]


def lewin_block_sharded(blk: LeWinBlock, x: torch.Tensor, *, H: int,
                        group: Group) -> torch.Tensor:
    """One LeWin block's eval forward on this rank's (B, Hs, W, C) rows of
    an image H rows high, equal to `blk(x)` on the gathered batch. Window
    and shift are the block's own. Hs must be a multiple of the window
    and the shift at most one window row (the small halo that makes the
    split cheap)."""
    B, Hs, W, C = x.shape
    win, shift = blk.win_size, blk.shift_size
    if Hs % win or W % win:
        raise ValueError(f"a shard of {Hs} x {W} rows holds no whole "
                         f"windows of {win}")
    p = blk.params_for(x.dtype, x.device)
    # LN1 folds into kernel 5: it commutes with the shift and partition
    y = cyclic_shift_sharded(x, shift, group)
    if shift:
        y = torch.roll(y, -shift, dims=2)  # along W: shard-local
    wnd = window_partition(y, win)
    per_image = (Hs // win) * (W // win)
    w_off = _rank(group) * per_image if _sharded(group) else 0
    parts = [wnd] if not _sharded(group) or B == 1 else \
        list(wnd.split(per_image))
    out = torch.cat([fused_attention_block(
        part.contiguous(), p["mod"], p["ln1_s"], p["ln1_b"], p["wq"],
        p["bq"], p["wkv"], p["bkv"], p["wo"], p["bo"], p["bias"], win=win,
        shift=shift, H=H, W=W, scale=blk.attn.scale,
        num_heads=blk.num_heads, has_ln=True, w_off=w_off)
        for part in parts])
    y = window_reverse(out, win, Hs, W)
    if shift:
        y = torch.roll(y, shift, dims=2)
    x = x + cyclic_unshift_sharded(y, shift, group)
    return _leff_sharded(blk, x, p, group)


@torch.no_grad()
def run_lewin_block_spatially_sharded(blk: LeWinBlock, img: torch.Tensor,
                                      group: Group) -> torch.Tensor:
    """One LeWin block over a (B, H, W, C) batch that every rank holds,
    split along H over `group`'s ranks; every rank gets the whole
    result."""
    n = _size(group)
    H = img.shape[1]
    if H % (n * blk.win_size):
        raise ValueError(f"H={H} must be a multiple of n_shards * win = "
                         f"{n} * {blk.win_size}, whole window rows a rank")
    y = lewin_block_sharded(blk, _own_rows(img, group), H=H, group=group)
    return _gather_rows(y, group) if _sharded(group) else y


# ---------------------------------------------- the whole sharded forward

def stage_at(model: nn.Module, k: int) -> nn.Module:
    """Stage k of the U: encoderlayer_0-3, conv (4), decoderlayer_0-3
    (5-8); stage k runs at level k, 8 - k in the decoder."""
    if k < 4:
        return getattr(model, f"encoderlayer_{k}")
    return model.conv if k == 4 else getattr(model, f"decoderlayer_{k - 5}")


def _prepare_blocks(model: nn.Module, dtype: torch.dtype,
                    device: torch.device) -> None:
    """Keep each block's kernel weights for dtype (a stage-kernel layer
    prepares its stacked weights only; this path runs block by block)."""
    for blk in model.modules():
        if isinstance(blk, LeWinBlock) and (
                blk._kp is None or blk._kp[:2] != (dtype, device)):
            blk.prepare(dtype)


def uformer_forward_sharded(model: nn.Module, x: torch.Tensor,
                            group: Group) -> torch.Tensor:
    """The Uformer's eval forward on this rank's (B, Hs, W, C) rows of an
    H-sharded input batch, equal to `model(x)` on the gathered batch;
    returns this rank's (B, Hs, W, 3) float32 rows of the output.

    The 3x3 convs and LeFF exchange halos, Downsample (1, 2) rows,
    Upsample none; the SW-MSA roll passes `shift` rows. Skip concats are
    channel-wise, hence shard-local. A level whose rows per rank would
    not hold whole window rows (the deep levels, H/16) runs replicated:
    gathered on the way down, each rank's rows taken again on the way up
    (its work is 1/256 of level 0's; repeating it is cheaper than fine
    exchanges). Level k is split where (H >> k) splits into n ranks of
    whole window rows."""
    check_spatial(model)
    n = _size(group)
    H, W = x.shape[1] * n, x.shape[2]
    dt = model.dtype

    def level_sharded(k: int) -> bool:
        Hk, wk = H >> k, stage_at(model, k).blocks[0].win_size
        return n > 1 and Hk % n == 0 and (Hk // n) % wk == 0

    def ensure(y, cur: bool, want: bool):
        """y between this rank's rows (True) and the whole batch."""
        if cur == want:
            return y
        return _gather_rows(y, group) if cur else _own_rows(y, group)

    def run_stage(k: int, level: int, y, sharded: bool):
        ax = group if sharded else None
        for blk in stage_at(model, k).blocks:
            y = lewin_block_sharded(blk, y, H=H >> level, group=ax)
        return y

    def conv_params(m):
        return m.params_for(dt, x.device)

    sharded = [level_sharded(k) for k in range(5)]
    y = ensure(x.to(dt), n > 1, sharded[0])
    cur = sharded[0]
    p = conv_params(model.input_proj)
    y = F.leaky_relu(conv3x3_sharded(y, p["w"], p["b"],
                                     group if cur else None), 0.01)
    skips: List[Tuple[torch.Tensor, bool]] = []
    for k in range(4):
        y = run_stage(k, k, y, cur)
        skips.append((y, cur))
        p = conv_params(getattr(model, f"dowsample_{k}"))
        y = downsample_sharded(y, p["w"], p["b"], group if cur else None)
        y = ensure(y, cur, sharded[k + 1])
        cur = sharded[k + 1]
    y = run_stage(4, 4, y, cur)
    for k in range(4):
        lvl = 3 - k
        y = ensure(y, cur, sharded[lvl])  # Upsample is halo-free: split
        cur = sharded[lvl]
        p = conv_params(getattr(model, f"upsample_{k}"))
        up = upsample_local(y, p["w"], p["b"])
        skip, skip_sharded = skips[lvl]
        y = torch.cat([up, ensure(skip, skip_sharded, cur)], dim=-1)
        y = run_stage(5 + k, lvl, y, cur)
    p = conv_params(model.output_proj)
    y = conv3x3_sharded(y, p["w"], p["b"], group if cur else None)
    y = ensure(y, cur, True).float()
    return x.float() + y if model.dd_in == 3 else y


@torch.no_grad()
def run_uformer_spatially_sharded(model: nn.Module, img: torch.Tensor,
                                  group: Group, pad: bool = True
                                  ) -> torch.Tensor:
    """The whole Uformer eval forward over a (B, H, W, C) batch (or one
    (H, W, C) image) that every rank holds, split along H over `group`;
    every rank gets the (B, H, W, 3) float32 result.

    With pad (the default) any H and W run: the batch is zero-padded at
    the bottom and right to H a multiple of lcm(16 win, n win) and W of
    16 win, and the result cropped; it equals `model` on the identically
    padded batch, cropped."""
    if img.dim() == 3:
        img = img[None]
    B, H, W, _ = img.shape
    n = _size(group)
    win = model.encoderlayer_0.win_size
    h_factor, w_factor = math.lcm(16 * win, n * win), 16 * win
    Hp, Wp = -(-H // h_factor) * h_factor, -(-W // w_factor) * w_factor
    if (Hp, Wp) != (H, W):
        if not pad:
            raise ValueError(
                f"H={H}, W={W} must be multiples of lcm(16 win, n win) = "
                f"{h_factor} and 16 win = {w_factor}; pass pad=True")
        img = F.pad(img, (0, 0, 0, Wp - W, 0, Hp - H))
    model.eval()
    _prepare_blocks(model, model.dtype, img.device)
    x = _own_rows(img, group) if n > 1 else img
    y = uformer_forward_sharded(model, x, group)
    if n > 1:
        y = _gather_rows(y, group)
    return y[:, :H, :W]


# -------------------------------------------------- sharded tiled inference

def tiled_inference_sharded(fn: Callable, img: np.ndarray, group: Group,
                            tile: int = 256, overlap: int = 32,
                            factor: int = 128, margin: Optional[int] = None,
                            tile_batch: Optional[int] = None) -> np.ndarray:
    """Overlapping-tile inference of one (1, H, W, C) image with the tiles
    split over `group`'s ranks (embarrassingly parallel): each rank
    restores its tiles through `fn` ((b, tile, tile, C) numpy in and out,
    `tile_batch` tiles a call, all of them when None), the restored tiles
    are gathered, and every rank blends them on the host with
    `eval.padding`'s weights. Every rank gets the (1, H, W, C) result."""
    if tile % factor:
        raise ValueError(f"tile {tile} is no multiple of factor {factor}")
    if margin is None:
        margin = overlap // 4
    B, H, W, C = img.shape
    if B != 1:
        raise ValueError(f"sharded tiling restores one image at a time: "
                         f"batch {B}")
    step = tile - overlap
    ys = sorted({min(y, max(H - tile, 0))
                 for y in range(0, max(H - overlap, 1), step)})
    xs = sorted({min(x, max(W - tile, 0))
                 for x in range(0, max(W - overlap, 1), step)})
    coords = [(y, x) for y in ys for x in xs]
    n, r = _size(group), _rank(group)
    coords_p = coords + [coords[-1]] * ((-len(coords)) % n)
    per = len(coords_p) // n
    tiles = np.stack([
        np.pad(img[0, y:y + tile, x:x + tile],
               ((0, max(0, tile - (H - y))), (0, max(0, tile - (W - x))),
                (0, 0)))
        for (y, x) in coords_p[r * per:(r + 1) * per]])
    cb = tile_batch or per
    mine = np.concatenate([np.asarray(fn(tiles[i:i + cb]), np.float32)
                           for i in range(0, per, cb)])
    out_tiles = mine
    if n > 1:
        t0 = time.perf_counter()
        out_tiles = all_gather_rows(
            torch.from_numpy(mine).to(comm_device(group)), group).cpu() \
            .numpy()
        _count(t0, mine.nbytes)

    acc = np.zeros((H, W, C), np.float32)
    wsum = np.zeros((H, W, 1), np.float32)
    ramp = overlap - 2 * margin
    for (y, x), out in zip(coords, out_tiles):
        y0, y1, x0, x1, w = tile_weights(y, x, min(tile, H - y),
                                         min(tile, W - x), H, W, margin, ramp)
        acc[y + y0:y + y1, x + x0:x + x1] += out[y0:y1, x0:x1] * w[..., None]
        wsum[y + y0:y + y1, x + x0:x + x1] += w[..., None]
    if float(wsum.min()) <= 0:
        raise AssertionError("tiling left uncovered pixels")
    return (acc / wsum)[None]
