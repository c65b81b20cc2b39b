"""The backward kernels on tensor-core tiles: LeFF (`csrc/leff_bwd_mma.cuh`),
attention (`csrc/attention_bwd_mma.cuh`) and the weight-gradient reduction
(`csrc/wgrad.cuh`).

On the CPU the host-side plans are held to what they promise: how many
hidden chunks a block of the LeFF backward takes (`chunks_per_block`), how
many windows (`windows_per_item`) or heads of a window
(`heads_per_block`) a block of the attention backward takes, and how many
row ranges the weight-gradient product is split into (`wgrad_ranges`).
The tests marked `gpu` run on the card:
`python -m pytest -m gpu tests/test_torch_port_bwd.py`. They hold the
LeFF backward against its plain VJP at every Uformer_B and Uformer_T
train shape (bs32 128^2), at H and W that are no multiple of 8, and
with the hidden chunks split over blocks and not; the attention backward
(image and windowed) at 1-4 windows per block, window counts included
that the item size does not divide, and with a window's heads split over
blocks; wgrad against torch.matmul at ragged
sizes; and both backward kernels for equal bits on two runs.
"""

import numpy as np
import pytest
import torch

from test_torch_port_kernels import (
    _attn_inputs,
    _cast,
    _check_grads,
    _cuda,
    _leff_inputs,
    _t,
)
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels import attention_block as attn_mod
from uformer_tpu_torch.ops.kernels import leff as leff_mod
from uformer_tpu_torch.ops.kernels.wgrad import wgrad, wgrad_ranges

torch.set_num_threads(1)
SMS = 132  # an H100 SXM's SMs


# ---- host-side plans (CPU) ----------------------------------------------

@pytest.mark.parametrize("tiles,chunks,C,want", [
    (32, 32, 512, 4),      # train conv: 32 8x8 tiles, 8 groups of 4
    (64, 32, 512, 7),      # train conv (A kernel, 4-row tiles): 5 groups
    (32, 16, 256, 2),      # train T conv: 8 groups of 2
    (128, 32, 512, 32),    # train dec0 (B kernel): tiles enough, no split
    (128, 16, 256, 16),    # train enc3: no split
    (32, 8, 128, 8),       # C < 256: no split
    (4, 4, 256, 2)])       # few chunks: groups of at least two
def test_chunks_per_block(tiles, chunks, C, want):
    got = leff_mod.chunks_per_block(tiles, chunks, C, SMS)
    assert got == want
    assert 1 <= got <= chunks and (got == chunks or got >= 2)


@pytest.mark.parametrize("windows,C,want", [
    (8192, 32, 4), (2048, 64, 4), (2048, 128, 4), (512, 128, 1),
    (1024, 128, 2), (600, 64, 2), (300, 16, 1), (2048, 256, 1),
    (128, 512, 1)])
def test_windows_per_item(windows, C, want):
    wn = attn_mod.windows_per_item(windows, C, SMS)
    assert wn == want
    assert wn == 1 or -(-windows // wn) >= 2 * SMS


@pytest.mark.parametrize("windows,C,nH,want", [
    (32, 512, 16, 2),     # train conv: 8 groups of 2 heads
    (32, 256, 16, 2),     # train T conv (head dim 16)
    (64, 512, 16, 2),     # 8 groups
    (128, 512, 16, 16),   # train dec0: windows enough, no split
    (128, 256, 8, 8),     # train enc3: no split
    (128, 128, 4, 4)])    # C < 256: no split
def test_heads_per_block(windows, C, nH, want):
    hpb = attn_mod.heads_per_block(windows, C, nH, SMS)
    assert hpb == want and nH % hpb == 0
    kx = 16 if C == 512 else 32
    assert hpb == nH or hpb * (C // nH) % kx == 0


@pytest.mark.parametrize("M,K1,N,want", [
    (524288, 32, 128, 264), (8192, 512, 2048, 5), (100, 48, 40, 1),
    (32768, 2048, 512, 5), (2048, 16, 48, 4)])
def test_wgrad_ranges(M, K1, N, want):
    assert wgrad_ranges(M, K1, N, SMS) == want


def test_wgrad_refuses_on_cpu():
    a = torch.zeros(64, 32)
    with pytest.raises(ValueError):  # rows differ
        wgrad(a, torch.zeros(32, 32))


# ---- on the card --------------------------------------------------------

def _leff_run(prm, has_ln=True, residual=False):
    def run(fn):
        return lambda x, g, dt: fn(x, g, *(prm[dt][k] for k in (
            "w1", "b1", "wd", "bd", "w2", "ln_s", "ln_b")), has_ln=has_ln,
            residual=residual)
    return run


def _leff_case(dev, shape, seed=40, scaled=True):
    """Seeded LeFF inputs; with `scaled`, the matrices N(0, 1 / fan-in), as
    a model's are, so that every gradient stays O(1) at C = 512."""
    C = shape[-1]
    inp = _leff_inputs(seed, *shape, 4 * C)
    if scaled:
        for k in ("w1", "w2"):
            inp[k] = inp[k] / (0.3 * np.sqrt(inp[k].shape[0]))
    x = _t(inp.pop("x"), dev).bfloat16().float()
    g = _t(np.random.default_rng(seed + 1).standard_normal(shape)
           .astype(np.float32), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("w1", "wd", "w2"))
           for dt in (torch.float32, torch.bfloat16)}
    return x, g, prm


# every (B, H, W, C) of the Uformer_B and Uformer_T bs32 128^2 steps
TRAIN_B = ([(32, 128 >> k, 128 >> k, 32 << k) for k in range(5)]
           + [(32, 16, 16, 512), (32, 32, 32, 256), (32, 64, 64, 128),
              (32, 128, 128, 64)])
TRAIN_T = ([(32, 128 >> k, 128 >> k, 16 << k) for k in range(5)]
           + [(32, 16, 16, 256), (32, 32, 32, 128), (32, 64, 64, 64),
              (32, 128, 128, 32)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(set(TRAIN_B + TRAIN_T)))
def test_leff_bwd_train_shapes_on_card(shape):
    dev = _cuda()
    x, g, prm = _leff_case(dev, shape)
    run = _leff_run(prm, residual=shape[-1] == 512)
    _check_grads(run(K.fused_leff_bwd), run(K.leff_vjp_reference), x, g,
                 shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 12, 20, 32), (1, 9, 14, 512),
                                   (2, 9, 14, 16), (1, 13, 7, 128),
                                   (1, 21, 10, 256), (2, 5, 3, 64)])
@pytest.mark.parametrize("has_ln,residual", [(True, True), (False, False)])
def test_leff_bwd_any_shape_on_card(shape, has_ln, residual):
    """H and W that are no multiple of 8 (partial tiles, masked), fp32 and
    bf16."""
    dev = _cuda()
    x, g, prm = _leff_case(dev, shape, seed=42)
    run = _leff_run(prm, has_ln, residual)
    _check_grads(run(K.fused_leff_bwd), run(K.leff_vjp_reference), x, g,
                 (shape, has_ln))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [128, 512])
@pytest.mark.parametrize("cpg", [1, 2, 3, None])
def test_leff_bwd_split_on_card(monkeypatch, C, cpg):
    """The hidden chunks of a tile split over blocks (1, 2 or 3 chunks a
    block, A's chunks independent, B's dLN partials summed in order by the
    finish pass) and not (None: all chunks in one block), at a shape the
    host would not split by itself."""
    dev = _cuda()
    monkeypatch.setattr(leff_mod, "chunks_per_block",
                        lambda tiles, chunks, C, sms: cpg or chunks)
    x, g, prm = _leff_case(dev, (1, 16, 24, C), seed=44)
    run = _leff_run(prm, residual=True)
    _check_grads(run(K.fused_leff_bwd), run(K.leff_vjp_reference), x, g,
                 (C, cpg))


def _attn_case(dev, B, H, W, C, nH, seed=50):
    inp = _attn_inputs(seed, B, H, W, C, nH)
    for k in ("wq", "wkv", "wo"):  # N(0, 1 / fan-in)
        inp[k] = inp[k] / (0.2 * np.sqrt(C))
    x = _t(inp.pop("x"), dev).bfloat16().float()
    g = _t(np.random.default_rng(seed + 1).standard_normal((B, H, W, C))
           .astype(np.float32), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    return x, g, prm


# (B, H, W, C, nH, shift): 18 windows (not a multiple of 4) at C 32-128,
# head dims 16 and 32
ATTN_ITEMS = [(2, 24, 24, 32, 2, 4), (2, 24, 24, 64, 2, 0),
              (2, 24, 24, 128, 8, 4), (1, 24, 48, 16, 1, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("geom", ATTN_ITEMS)
@pytest.mark.parametrize("wn", [1, 2, 3, 4])
def test_attention_bwd_windows_per_item_on_card(monkeypatch, geom, wn):
    dev = _cuda()
    monkeypatch.setattr(attn_mod, "windows_per_item",
                        lambda windows, C, sms: wn)
    B, H, W, C, nH, shift = geom
    x, g, prm = _attn_case(dev, B, H, W, C, nH)
    kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH,
              residual=True)

    def run(fn):
        return lambda x, g, dt: fn(x, g, *prm[dt].values(), **kw)

    _check_grads(run(K.fused_attention_image_bwd),
                 run(K.attention_image_vjp_reference), x, g, (geom, wn))
    wkw = dict(win=8, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
               num_heads=nH, has_ln=False)

    def wrun(fn):
        return lambda x, g, dt: fn(
            x.reshape(-1, 64, C), g.reshape(-1, 64, C), prm[dt]["mod"],
            None, None, *list(prm[dt].values())[3:], **wkw)

    _check_grads(wrun(K.fused_attention_block_bwd),
                 wrun(K.attention_block_vjp_reference), x, g, (geom, wn))


# (B, H, W, C, nH, shift, heads per block): a window's heads split over
# blocks, their dxm shares summed by the finish pass
ATTN_SPLITS = [(2, 16, 16, 512, 16, 4, 2), (2, 16, 16, 512, 16, 0, 8),
               (2, 16, 16, 256, 8, 4, 2), (2, 16, 16, 256, 16, 4, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("geom", ATTN_SPLITS)
def test_attention_bwd_head_split_on_card(monkeypatch, geom):
    dev = _cuda()
    B, H, W, C, nH, shift, hpb = geom
    monkeypatch.setattr(attn_mod, "heads_per_block",
                        lambda windows, C, nH, sms: hpb)
    x, g, prm = _attn_case(dev, B, H, W, C, nH, seed=52)
    kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH,
              residual=True)

    def run(fn):
        return lambda x, g, dt: fn(x, g, *prm[dt].values(), **kw)

    _check_grads(run(K.fused_attention_image_bwd),
                 run(K.attention_image_vjp_reference), x, g, geom)
    wkw = dict(win=8, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
               num_heads=nH, has_ln=False)

    def wrun(fn):
        return lambda x, g, dt: fn(
            x.reshape(-1, 64, C), g.reshape(-1, 64, C), prm[dt]["mod"],
            None, None, *list(prm[dt].values())[3:], **wkw)

    _check_grads(wrun(K.fused_attention_block_bwd),
                 wrun(K.attention_block_vjp_reference), x, g, geom)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K1,N", [(1000, 72, 200), (64, 16, 8),
                                    (4133, 512, 136), (70000, 40, 264)])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_wgrad_against_matmul_on_card(M, K1, N, dt):
    """a^T b and the column sums of b against torch.matmul and sum in fp32
    (TF32 off) on the same values: products of bf16 values are exact in
    fp32, so only the order of the sums differs."""
    dev = _cuda()
    rng = np.random.default_rng(60)
    a = torch.from_numpy(rng.standard_normal((M, K1)).astype(np.float32)) \
        .to(dev, dt)
    b = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)) \
        .to(dev, dt)
    ref = torch.matmul(a.float().T, b.float())
    out, cs = wgrad(a, b, colsum_b=True)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= \
        1e-4 * (1 + float(ref.abs().max()))
    ref_cs = b.float().sum(0)
    assert float((cs - ref_cs).abs().max()) <= \
        1e-4 * (1 + float(ref_cs.abs().max()))
    assert torch.equal(wgrad(a, b), out)


@pytest.mark.gpu
def test_backward_kernels_repeat_bits_on_card():
    """Two runs of each bf16 backward on the same inputs give equal bits
    (fixed summation orders, no atomics), split paths included."""
    dev = _cuda()
    x, g, prm = _leff_case(dev, (32, 8, 8, 512), seed=70)
    run = _leff_run(prm)(K.fused_leff_bwd)
    xb, gb = x.bfloat16(), g.bfloat16()
    for a, b in zip(run(xb, gb, torch.bfloat16), run(xb, gb, torch.bfloat16)):
        assert a is None or torch.equal(a, b)
    for B, R, C, nH in ((4, 32, 64, 2), (2, 16, 512, 16)):  # 4 windows
        # a block, then heads split
        x, g, prm = _attn_case(dev, B, R, R, C, nH, seed=71)
        kw = dict(win=8, shift=4, scale=32 ** -0.5, num_heads=nH,
                  residual=True)
        xb, gb = x.bfloat16(), g.bfloat16()
        w = prm[torch.bfloat16].values()
        one = K.fused_attention_image_bwd(xb, gb, *w, **kw)
        two = K.fused_attention_image_bwd(xb, gb, *w, **kw)
        for a, b in zip(one, two):
            assert a is None or torch.equal(a, b)
