"""Window-attention core: Hopper kernel and plain version.

Port of `uformer_tpu/ops/pallas/window_attention.py:fused_window_attention`
(kernel source `csrc/window_attention.cu`). On the H100 the core is
memory-bound (q, k, v read and the output written once against 64
multiply-adds per value). In bf16 persistent blocks of four warps walk
contiguous ranges of the (head, window) pairs head-major
(`window_attention_plan`), the head's bias in shared memory, the next
window's q, k and v in flight by `cp.async` while each warp runs the core
on its 16 rows in registers (`csrc/window_core_mma.cuh`, the core of
kernels 1 and 5's narrow body); fp32 runs one block per head and group of
windows on `csrc/window_core.cuh`. No model path calls it, in the JAX
package either: it is the standalone form of the core the other kernels
run. `window_attention_reference` is the plain PyTorch version.

Windows above 8 (N = win² > 64 tokens, of any size) run
`csrc/attention_wide.cu`'s core with a key-chunked online softmax
(`attention_wide`), which never holds a whole window: in bf16 on the
tensor cores (`csrc/wide_core_mma.cuh`), in fp32 on the CUDA cores, at
every head dim of `HEAD_DIMS`. Windows of N = win² < 64 tokens (win 1-7)
and head dim 8 run on the same bodies as window 8: the kernels take
64-row tiles of 64 // N whole windows (`packed_tiles`), with the bias as
its tile (`tile_bias`: -inf between two windows of a tile, so each row
weighs only its own window's keys); padding rows read as zeros and are
never written. In bf16 a head of 8 takes its QKᵀ on mma.sync.m16n8k8.
Head dim 64 (every block of an `--embed_dim 64` model) runs at every
window on the same bodies, both ways. Head dims 24, 40, 48 and 56
(`--embed_dim` 24-56) run in kernels 1, 3, 5 and 6, both ways
(`HEAD_DIMS`), and in this one above window 8; at windows 1-8 it keeps
`WINDOW_ATTENTION_HEAD_DIMS` (its bf16 register core,
`csrc/window_core_mma.cuh`, has no body for them). Head dims 72-128 in
steps of 8 (`--embed_dim` 72-128) run kernels 1, 3, 5 and 6 at windows
1-8 (`FORWARD_HEAD_DIMS`, both ways: the window, not the direction,
decides), not this kernel; other head dims, and 72-128 above window 8
and here: ROADMAP.md, port queue 2 item 9.

Unlike the block kernels, which fold the softmax scale into q before
rounding it, this kernel scales the float32 logits (the TPU kernel's
`window_attention.py:55`): in bf16 the two round differently.
"""

from __future__ import annotations

import functools

import torch

from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels._build import load
from uformer_tpu_torch.ops.kernels.attention_wide import wide_window_attention
from uformer_tpu_torch.ops.masks import NEG_BIAS, shift_window_regions

# kernels 5 and 6 above window 8, and kernel 4 there: every multiple of
# 8 up to 64
HEAD_DIMS = (8, 16, 24, 32, 40, 48, 56, 64)
# kernels 1, 3, 5 and 6 at windows 1-8 (kernels 1 and 3 at window 8 only),
# forward and backward: every multiple of 8 up to 128
FORWARD_HEAD_DIMS = tuple(range(8, 129, 8))
WINDOW_ATTENTION_HEAD_DIMS = (8, 16, 32, 64)  # kernel 4 at windows 1-8
TILE = 64  # rows of a kernel's window tile


def window_attention_plan(nH: int, Bw: int, slots: int, N: int = TILE):
    """(chunk, grid) of the bf16 body: the nH * packed_tiles(Bw, N) (head,
    tile) pairs, head-major, in contiguous ranges of `chunk` tiles, one per
    block, over at most `slots` blocks (a tile is a window at N = 64)."""
    items = nH * packed_tiles(Bw, N)
    chunk = -(-items // _launch.persistent_grid(items, slots))
    return chunk, -(-items // chunk)


def packed_tiles(Bw: int, N: int) -> int:
    """64-row tiles of Bw windows of N tokens, 64 // N whole windows each."""
    return -(-Bw // (TILE // N))


def check_window(win: int, shift: int, H: int, W: int,
                 windows=None) -> None:
    """Raise unless the kernels take this window geometry: win >= 1 (any
    window for kernels 4, 5 and 6, as in the JAX package) or, where given,
    win in `windows` (kernels 1 and 3 take (8,), as JAX's image route), H
    and W multiples of win and 0 <= shift < win."""
    if win < 1 or (windows is not None and win not in windows) \
            or H % win or W % win or not 0 <= shift < win:
        where = f"win in {tuple(windows)}" if windows is not None \
            else "win >= 1"
        raise ValueError(f"kernel needs {where}, H, W multiples of win and "
                         f"0 <= shift < win: win={win} H={H} W={W} "
                         f"shift={shift}")


def check_head_dim(C: int, num_heads: int,
                   head_dims: tuple = HEAD_DIMS) -> None:
    """Raise unless the kernel takes head dim C / num_heads: one of
    `head_dims` (HEAD_DIMS: kernels 4, 5 and 6 above window 8;
    FORWARD_HEAD_DIMS: kernels 1, 3, 5 and 6 at windows 1-8, both ways;
    WINDOW_ATTENTION_HEAD_DIMS: kernel 4 at windows 1-8,
    `window_attention_head_dims`)."""
    D = C // num_heads if num_heads > 0 and C % num_heads == 0 else None
    if D not in head_dims:
        raise ValueError(f"kernel needs head dim in {tuple(head_dims)}: "
                         f"C={C}, num_heads={num_heads} (other head dims: "
                         f"ROADMAP.md, port queue 2 item 9)")


def window_attention_head_dims(N: int) -> tuple:
    """The head dims kernel 4 takes at windows of N tokens: HEAD_DIMS above
    64 tokens (`csrc/attention_wide.cu`), WINDOW_ATTENTION_HEAD_DIMS at
    64 and below (the register core has no body for 24, 40, 48, 56)."""
    return HEAD_DIMS if N > TILE else WINDOW_ATTENTION_HEAD_DIMS


@functools.lru_cache(maxsize=None)
def _tile_index(N: int, device: torch.device):
    """Token of each tile row (t mod N) and whether rows i, j of a tile lie
    in two windows (pad rows, t >= 64 // N * N, form one group of their
    own), on `device`."""
    t = torch.arange(TILE, device=device)
    group = t // N
    return t % N, group[:, None] != group[None, :]


def tile_tokens(mod: torch.Tensor, N: int) -> torch.Tensor:
    """The (64, C) tile of a (N, C) per-token operand (the modulator):
    row t is token t mod N (pad rows too, whose outputs are dropped)."""
    if N == TILE:
        return mod
    tok, _ = _tile_index(N, mod.device)
    return mod[tok].contiguous()


def tile_bias(bias: torch.Tensor, N: int) -> torch.Tensor:
    """The (nH, 64, 64) tile of a (nH, N, N) relative-position bias: entry
    (i, j) is bias[:, i mod N, j mod N] where rows i and j lie in one
    window of the tile, else -inf (softmax weight exactly 0, unlike the
    SW-MSA mask's -100); the pad rows weigh each other, so every row's max
    is finite."""
    if N == TILE:
        return bias
    tok, apart = _tile_index(N, bias.device)
    # a scalar fill: no host tensor, so a CUDA graph can capture it
    return bias[:, tok[:, None], tok[None, :]].masked_fill(apart,
                                                           float("-inf"))


def fold_tile_tokens(dmod: torch.Tensor, N: int) -> torch.Tensor:
    """The gradient of `tile_tokens`: a (64, C) tile's gradient summed
    back to (N, C), token i taking the rows t = i (mod N) of the tile's
    64 // N whole windows (a pad row's gradient is 0 in the kernels)."""
    if N == TILE:
        return dmod
    G = TILE // N
    return dmod[:G * N].reshape(G, N, -1).sum(0)


def fold_tile_bias(dbias: torch.Tensor, N: int) -> torch.Tensor:
    """The gradient of `tile_bias` where the softmax never weighs two
    windows together: the (nH, 64, 64) tile's gradient summed back to
    (nH, N, N) over its 64 // N diagonal N x N blocks (JAX folds its lane
    packing so, `attention_block.py:856-866`); the entries between two
    windows and those of the pad rows are 0 in the kernels."""
    if N == TILE:
        return dbias
    G = TILE // N
    d = dbias[:, :G * N, :G * N].reshape(-1, G, N, G, N)
    return d.diagonal(dim1=1, dim2=3).sum(-1)



def window_mask(H: int, W: int, win: int, shift: int, n: int, w_off: int,
                device) -> torch.Tensor:
    """The SW-MSA mask of n windows whose first lies at place w_off of the
    H x W image's nW windows (row-major, wrapping): the image's (nW, win²,
    win²) mask when the n windows are whole images from place 0, which
    `ops.attention.window_attention` tiles, else one per window. Built on
    `device` from the windows' region ids (`shift_window_mask`'s values)."""
    region = torch.from_numpy(shift_window_regions(H, W, win, shift)).to(
        device)
    nW = region.shape[0]
    if n % nW or w_off % nW:
        region = region[(w_off + torch.arange(n, device=device)) % nW]
    differ = region[:, None, :] != region[:, :, None]
    return torch.zeros(differ.shape, dtype=torch.float32,
                       device=device).masked_fill_(differ, NEG_BIAS)


def window_attention_reference(q, k, v, bias, *, win, shift, H, W, scale):
    """q, k, v: (nH, Bw, N, D), window w at place w mod nW of its image;
    bias (nH, N, N). softmax(q kᵀ · scale + bias + mask) v with the
    products accumulated in float32, the logits scaled in float32, the
    softmax in float32 and the probabilities rounded to q's dtype."""
    nH, Bw, N, D = q.shape
    dt = q.dtype
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale \
        + bias.float()[:, None]
    if shift > 0:
        mask = window_mask(H, W, win, shift, Bw, 0, q.device)
        m = mask.shape[0]
        logits = (logits.reshape(nH, Bw // m, m, N, N) + mask) \
            .reshape(nH, Bw, N, N)
    probs = torch.softmax(logits, dim=-1).to(dt)
    return (probs.float() @ v.float()).to(dt)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, *, win: int, shift: int,
                           H: int, W: int, scale: float) -> torch.Tensor:
    """q, k, v: (nH, Bw, N, D), N = win² (any win), D in HEAD_DIMS above
    window 8 and in WINDOW_ATTENTION_HEAD_DIMS at windows 1-8
    (`window_attention_head_dims`), float32 or bfloat16; bias (nH, N, N)
    float32. Returns (nH, Bw, N, D). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        fused_window_attention.plain_calls += 1
        return window_attention_reference(q, k, v, bias, win=win,
                                          shift=shift, H=H, W=W, scale=scale)
    _launch.check_input(q, "(nH, Bw, N, D)")
    nH, Bw, N, D = q.shape
    check_window(win, shift, H, W)
    check_head_dim(D, 1, window_attention_head_dims(N))
    if N != win * win:
        raise ValueError(f"kernel needs N = win²: N={N} win={win}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _launch.expect(t, name, q.shape, q.dtype, q.device)
    _launch.expect(bias, "bias", (nH, N, N), torch.float32, q.device)
    if N > TILE:
        out = wide_window_attention(q, k, v, bias, win=win, shift=shift, H=H,
                                    W=W, scale=scale,
                                    count=fused_window_attention)
        fused_window_attention.launches += 1
        return out
    bias = tile_bias(bias, N)
    lib = load()
    is_bf16 = int(q.dtype == torch.bfloat16)
    chunk = grid = 0
    if is_bf16:
        slots = _launch.resident_blocks("uf_window_attention_slots",
                                        q.device.index, is_bf16, D,
                                        int(N < TILE))
        chunk, grid = window_attention_plan(nH, Bw, slots, N)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.uf_window_attention(
            is_bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), nH, Bw, D, H, W, win, shift,
            float(scale), chunk, grid, _launch.stream(q))
    _launch.check(err, "window_attention kernel")
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0
fused_window_attention.plain_calls = 0
# launches above window 8 by the core's body (`attention_wide._core`)
fused_window_attention.core_mma_launches = 0
fused_window_attention.core_fma_launches = 0
