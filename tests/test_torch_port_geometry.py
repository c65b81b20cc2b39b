"""Windows 1-8 and head dim 8 in the forward kernels: kernels 4 and 5 at
N = win² <= 64 tokens a window, head dim 8 in kernels 1, 3, 4 and 5 and
LeFF (kernel 2) at C = 8.

On the CPU, with numpy inputs from a seed and fp32 throughout, each
within 1e-4 (1 + max|ref|):
  - the port's SW-MSA mask at every window 1-8 and shift against the JAX
    package's `ops/masks.py:shift_window_mask`;
  - the plain windowed block (`attention_block_reference`) at windows 2, 4
    and 6 against JAX's Pallas `fused_attention_block` (interpret mode);
    the plain image-layout block, stage and LeFF at head dim 8 and C = 8
    against JAX's jnp references;
  - the host steps the wrappers add: the packed tiles of small windows
    (`tile_tokens`, `tile_bias`, `packed_tiles`, the plans) run through the
    kernels' algorithm in plain PyTorch (rows gathered by tile, the tile
    bias -inf between windows, region ids from each window's place as the
    kernels compute them, padding dropped) equal the plain versions;
    LeFF's hidden padded to a chunk (`pad_hidden`) equals the unpadded;
  - the kernel route of nine geometries (Uformer_B at train_ps 64 and
    32, Uformer at embed 8, at win_size 4, the flagship golden's,
    Uformer at embed 64, head dim 64, at train_ps 128 and 64 on 256^2,
    and at embed 48 and 24, head dims 48 and 24, on 256^2), counted on
    the plain path, against JAX's route conditions.
The tests marked `gpu` hold each extended kernel against its plain
version on the card (`python -m pytest -m gpu
tests/test_torch_port_geometry.py`), within the bounds of
`chip_smoke.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch import get_arch
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops import attention
from uformer_tpu_torch.ops.kernels import attention_block as ab_mod
from uformer_tpu_torch.ops.kernels import window_attention as wa_mod
from uformer_tpu_torch.ops.kernels.leff import pad_hidden
from uformer_tpu_torch.ops.masks import NEG_BIAS

torch.set_num_threads(1)
TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax.numpy as jnp
    from uformer_tpu.ops import masks
    from uformer_tpu.ops.pallas import (
        attention_block,
        attention_image,
        leff,
        stage,
    )

    return SimpleNamespace(jnp=jnp, masks=masks, ab=attention_block,
                           ai=attention_image, leff=leff, stage=stage)


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(device, dtype)


def _j(jx, a):
    return None if a is None else jx.jnp.asarray(a)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * (1 + np.abs(want).max()))


def _mk(rng, scale):
    return lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)


def _block_inputs(seed, Bw, N, C, nH, with_mod=True):
    mk = _mk(np.random.default_rng(seed), 0.3)
    return dict(x=mk(Bw, N, C), mod=mk(N, C) if with_mod else None,
                ln_s=1.0 + 0.5 * mk(C), ln_b=0.5 * mk(C), wq=mk(C, C),
                bq=mk(C), wkv=mk(C, 2 * C), bkv=mk(2 * C), wo=mk(C, C),
                bo=mk(C), bias=mk(nH, N, N))


def _leff_inputs(seed, B, H, W, C, Ch):
    mk = _mk(np.random.default_rng(seed), 0.3)
    return dict(x=mk(B, H, W, C), w1=mk(C, Ch), b1=mk(Ch), wd=mk(3, 3, Ch),
                bd=mk(Ch), w2=mk(Ch, C), b2=mk(C), ln_s=1.0 + mk(C),
                ln_b=mk(C))


# ---- the SW-MSA mask at every window -------------------------------------

MASKS = [(win, shift) for win in range(2, 9) for shift in range(1, win)]


@pytest.mark.parametrize("win,shift", MASKS)
def test_window_mask_matches_jax(jx, win, shift):
    H, W = 2 * win, 3 * win
    nW = (H // win) * (W // win)
    got = wa_mod.window_mask(H, W, win, shift, nW, 0, "cpu")
    want = jx.masks.shift_window_mask(H, W, win, shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # windows at an offset, wrapping: place (w_off + i) mod nW
    off = wa_mod.window_mask(H, W, win, shift, nW + 1, 5, "cpu")
    np.testing.assert_array_equal(
        off.numpy(), np.asarray(want)[(5 + np.arange(nW + 1)) % nW])


# ---- the plain versions against JAX --------------------------------------

# (C, heads): head dim 8 at C 8, 16 and 128; head dim 16 at C 16 and 128
WIDTHS = [(8, 1), (16, 2), (16, 1), (128, 16), (128, 8)]
BLOCK_CASES = [(win, shift, w_off, C, nH)
               for win in (2, 4, 6)
               for shift, w_off in ((0, 0), (win // 2, 0), (win // 2, 5))
               for C, nH in WIDTHS]


@pytest.mark.parametrize("win,shift,w_off,C,nH", BLOCK_CASES)
def test_attention_block_reference_matches_jax(jx, win, shift, w_off, C,
                                               nH):
    H, W = 3 * win, 2 * win
    Bw = 2 * (H // win) * (W // win) - 1  # an odd count, wrapping at w_off
    inp = _block_inputs(11, Bw, win * win, C, nH)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=False, w_off=w_off)
    got = K.attention_block_reference(*map(_t, inp.values()), **kw)
    want = jx.ab.fused_attention_block(*[_j(jx, a) for a in inp.values()],
                                       interpret=True, packed=False, **kw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("C,nH,shift,residual", [
    (32, 4, 4, True), (32, 4, 0, False), (64, 8, 4, False),
    (64, 8, 0, True)])
def test_attention_image_reference_head_dim8_matches_jax(jx, C, nH, shift,
                                                         residual):
    mk = _mk(np.random.default_rng(12), 0.2)
    inp = dict(x=mk(1, 16, 16, C), mod=mk(64, C), ln_s=1.0 + mk(C),
               ln_b=mk(C), wq=mk(C, C), bq=mk(C), wkv=mk(C, 2 * C),
               bkv=mk(2 * C), wo=mk(C, C), bo=mk(C), bias=mk(nH, 64, 64))
    kw = dict(win=8, shift=shift, scale=8 ** -0.5, num_heads=nH,
              has_ln=True, residual=residual)
    got = K.attention_image_reference(*map(_t, inp.values()), **kw)
    _close(got.numpy(), jx.ai.attention_image_reference(
        *[_j(jx, a) for a in inp.values()], **kw))


def _stage_inputs(seed, n, C, nH, Ch):
    mk = _mk(np.random.default_rng(seed), 0.1)
    return dict(ln1_s=1.0 + mk(n, C), ln1_b=mk(n, C), wq=mk(n, C, C),
                bq=mk(n, C), wk=mk(n, C, C), bk=mk(n, C), wv=mk(n, C, C),
                bv=mk(n, C), wo=mk(n, C, C), bo=mk(n, C),
                bias=mk(n, nH, 64, 64), mod=mk(n, 64, C),
                ln2_s=1.0 + mk(n, C), ln2_b=mk(n, C), w1=mk(n, C, Ch),
                b1=mk(n, Ch), wd=mk(n, 3, 3, Ch), bd=mk(n, Ch),
                w2=mk(n, Ch, C), b2=mk(n, C))


@pytest.mark.parametrize("res", [8, 16])
def test_stage_reference_head_dim8_matches_jax(jx, res):
    """The stage at an embed-8 model's bottleneck and dec0: C 128, 16
    heads of 8."""
    p = _stage_inputs(13, 2, 128, 16, 512)
    x = _mk(np.random.default_rng(14), 0.3)(1, res, res, 128)
    kw = dict(scale=8 ** -0.5, num_heads=16, use_shift=res > 8,
              has_mod=True)
    got = K.stage_reference(_t(x), {k: _t(v) for k, v in p.items()}, **kw)
    _close(got.numpy(), jx.stage.stage_reference(
        _j(jx, x), {k: _j(jx, v) for k, v in p.items()}, **kw))


LEFF8 = [(has_ln, residual, padded) for has_ln in (True, False)
         for residual in (True, False) for padded in (False, True)]


@pytest.mark.parametrize("has_ln,residual,padded", LEFF8)
def test_leff_reference_c8_matches_jax(jx, has_ln, residual, padded):
    """LeFF at C = 8 (hidden 32), LN2 over the 8 channels; the hidden
    padded to the kernel's chunk of 64 gives the same function."""
    inp = _leff_inputs(15, 2, 16, 24, 8, 32)
    names = ("w1", "b1", "wd", "bd", "w2")
    w = [_t(inp[k]) for k in names]
    if padded:
        w = list(pad_hidden(*w))
        assert w[0].shape == (8, 64) and w[4].shape == (64, 8)
    ln = dict(ln_s=_t(inp["ln_s"]), ln_b=_t(inp["ln_b"])) if has_ln else {}
    got = K.leff_reference(_t(inp["x"]), *w[:5], _t(inp["b2"]), **ln,
                           residual=residual)
    jln = ({"ln_s": _j(jx, inp["ln_s"]), "ln_b": _j(jx, inp["ln_b"])}
           if has_ln else {})
    want = jx.leff.leff_reference(
        *[_j(jx, inp[k]) for k in ("x",) + names + ("b2",)], **jln,
        residual=residual)
    _close(got.numpy(), want)


# ---- the host steps: the kernels' algorithm on packed tiles ---------------

def _regions(win, shift, H, W, w_off, wins):
    """Each token's SW-MSA region id in its own window, window i at place
    (w_off + i) mod nW, as the kernels compute it (PackedTokens.region,
    region_id_w): (len(wins), N)."""
    nWw, nW = W // win, (H // win) * (W // win)
    tt = torch.arange(win * win)
    wl = (w_off + torch.as_tensor(wins))[:, None] % nW

    def axis(g, size):
        return (g >= size - win).long() + (g >= size - shift).long()

    return 3 * axis((wl // nWw) * win + tt // win, H) + \
        axis((wl % nWw) * win + tt % win, W)


def _tiles(rows, N, Bw):
    """(T, 64) row index of each tile row into the (Bw N) rows, and
    whether it is real (the kernels' PackedTokens.pix and valid)."""
    G, T = 64 // N, wa_mod.packed_tiles(Bw, N)
    t = torch.arange(64)
    pix = torch.arange(T)[:, None] * G * N + t
    valid = (t < G * N) & (pix < Bw * N)
    return pix.clamp(max=Bw * N - 1), valid


def _tile_mask(win, shift, H, W, w_off, Bw):
    """(T, 64, 64) SW-MSA mask of each tile's rows by their own windows'
    region ids (pairs of two windows carry -inf in the tile bias)."""
    N = win * win
    pix, _ = _tiles(None, N, Bw)
    r = _regions(win, shift, H, W, w_off, range(Bw + 64)).reshape(-1)
    rid = r[(pix // N) * N + pix % N]
    return torch.where(rid[:, :, None] != rid[:, None, :], NEG_BIAS, 0.0)


def _packed_block(x, mod, wq, bq, wkv, bkv, wo, bo, bias, *, win, shift, H,
                  W, scale, num_heads, w_off):
    """Kernel 5 on packed tiles in plain PyTorch: the tiles' rows (padding
    zero), the tile modulator and bias, the per-tile mask, projections and
    the core on 64-row tiles, then the real rows."""
    Bw, N, C = x.shape
    pix, valid = _tiles(None, N, Bw)
    xt = torch.where(valid[..., None], x.reshape(Bw * N, C)[pix], 0.0)
    mod_t, bias_t = ab_mod.packed_operands(mod, bias, N)
    assert mod_t.shape == (64, C) and bias_t.shape == (num_heads, 64, 64)
    xm = xt + mod_t
    T, D = xt.shape[0], C // num_heads

    def heads(t):
        return t.reshape(T, 64, num_heads, D).transpose(1, 2)

    kv = xm @ wkv + bkv
    mask = _tile_mask(win, shift, H, W, w_off, Bw) if shift else None
    out = attention.window_attention(
        heads(xm @ wq + bq), heads(kv[..., :C]), heads(kv[..., C:]), bias_t,
        mask, scale=scale) @ wo + bo
    return out.reshape(T * 64, C)[valid.reshape(-1)].reshape(Bw, N, C)


PACKED = [(win, shift, w_off) for win in range(1, 8)
          for shift, w_off in ((0, 0), (win // 2, 0), (win // 2, 37))
          if shift or not w_off]


@pytest.mark.parametrize("win,shift,w_off", PACKED)
def test_packed_tiles_equal_the_plain_block(win, shift, w_off):
    """The kernels' packing of windows 1-7 (64 // N whole windows a tile,
    the bias -inf between them, region ids per window, padding dropped)
    computes `attention_block_reference`."""
    H, W, C, nH = 4 * win, 3 * win, 16, 2
    Bw = 2 * (H // win) * (W // win) + 3
    inp = _block_inputs(16, Bw, win * win, C, nH)
    inp.pop("ln_s")
    inp.pop("ln_b")
    kw = dict(win=win, shift=shift, H=H, W=W, scale=0.3, num_heads=nH,
              w_off=w_off)
    args = list(map(_t, inp.values()))
    want = K.attention_block_reference(args[0], args[1], None, None,
                                       *args[2:], has_ln=False, **kw)
    _close(_packed_block(*args, **kw).numpy(), want.numpy())


@pytest.mark.parametrize("win,shift", [(1, 0), (2, 1), (3, 1), (4, 2),
                                       (5, 2), (6, 3), (7, 3), (8, 4)])
def test_packed_core_equals_the_plain_core(win, shift):
    """Kernel 4's packing: each head's windows in tiles, the tile bias and
    the per-tile mask, equal `window_attention_reference`."""
    N, nH, D = win * win, 2, 8
    H, W = 2 * win, 5 * win
    Bw = 3 * (H // win) * (W // win)
    mk = _mk(np.random.default_rng(17), 0.5)
    q, k, v = (_t(mk(nH, Bw, N, D)) for _ in range(3))
    bias = _t(mk(nH, N, N))
    kw = dict(win=win, shift=shift, H=H, W=W, scale=0.35)
    want = K.window_attention_reference(q, k, v, bias, **kw)
    pix, valid = _tiles(None, N, Bw)
    T = pix.shape[0]

    def tiles(t):
        return torch.where(valid[None, ..., None],
                           t.reshape(nH, Bw * N, D)[:, pix], 0.0)

    logits = tiles(q) @ tiles(k).transpose(-1, -2) * kw["scale"] \
        + wa_mod.tile_bias(bias, N)[:, None]
    if shift:
        logits = logits + _tile_mask(win, shift, H, W, 0, Bw)
    got = torch.softmax(logits, -1) @ tiles(v)
    got = got.reshape(nH, T * 64, D)[:, valid.reshape(-1)]
    _close(got.reshape(want.shape).numpy(), want.numpy())


@pytest.mark.parametrize("N", [1, 4, 9, 16, 25, 36, 49, 64])
def test_tile_operands(N):
    """tile_tokens / tile_bias: row t is token t mod N; -inf exactly between
    two windows of a tile; every row has a finite entry; the first window's
    rows are the operands; at N = 64 the operands themselves."""
    mk = _mk(np.random.default_rng(18), 1.0)
    bias, mod = _t(mk(3, N, N)), _t(mk(N, 5))
    tb, tm = wa_mod.tile_bias(bias, N), wa_mod.tile_tokens(mod, N)
    assert tb.shape == (3, 64, 64) and tm.shape == (64, 5)
    torch.testing.assert_close(tb[:, :N, :N], bias, rtol=0, atol=0)
    torch.testing.assert_close(tm[:N], mod, rtol=0, atol=0)
    if N == 64:
        assert tb is bias and tm is mod
        return
    t = torch.arange(64)
    G = 64 // N
    same = (t // N)[:, None] == (t // N)[None, :]
    assert torch.isinf(tb[:, ~same]).all() and torch.isfinite(tb[:, same]) \
        .all()
    assert torch.isfinite(tb).any(-1).all()
    torch.testing.assert_close(tm[:G * N], mod.repeat(G, 1), rtol=0, atol=0)


@pytest.mark.parametrize("nH,Bw,N,slots", [
    (16, 128, 16, 132), (8, 512, 16, 264), (16, 512, 4, 132),
    (1, 7, 9, 5), (3, 77, 25, 40), (2, 5, 49, 7), (4, 33, 1, 132)])
def test_packed_plans_cover_every_window(nH, Bw, N, slots):
    """Kernel 4's plan over packed tiles, and kernel 5's persistent grid,
    take every (head, tile) once; the tiles take every window once."""
    T = wa_mod.packed_tiles(Bw, N)
    G = 64 // N
    assert (T - 1) * G < Bw <= T * G
    chunk, grid = wa_mod.window_attention_plan(nH, Bw, slots, N)
    items = nH * T
    assert 1 <= grid <= slots and (grid - 1) * chunk < items <= grid * chunk
    windows = np.zeros(Bw, int)
    _, valid = _tiles(None, N, Bw)
    for tile in range(T):
        rows = (tile * G * N + np.flatnonzero(valid[tile].numpy())) // N
        windows[np.unique(rows)] += 1
    assert (windows == 1).all()


def test_pad_hidden_is_exact_and_idempotent():
    inp = _leff_inputs(19, 1, 8, 8, 8, 32)
    w = [_t(inp[k]) for k in ("w1", "b1", "wd", "bd", "w2")]
    p = pad_hidden(*w)
    assert [t.shape[-1] for t in p] == [64, 64, 64, 64, 8]
    torch.testing.assert_close(p[0][:, :32], w[0], rtol=0, atol=0)
    assert not p[0][:, 32:].any() and not p[4][32:].any() \
        and not p[2][..., 32:].any()
    assert all(a is b for a, b in zip(pad_hidden(*p), p))


# ---- the route of each geometry against JAX's conditions ------------------

def _jax_route(model):
    """Launches per forward by the JAX package's conditions: the stage
    kernel where `layers.py:979-985` takes it (win 8, resolution at least
    the window, C % 128 == 0), else per block the image kernel where
    `layers.py:757-775` takes it (win 8 and C % 128 == 0, or 128 % C == 0,
    C >= 32 and a shift the packing takes), else the windowed kernel; one
    LeFF a block."""
    want = dict(stage=0, attention_image=0, attention_block=0, leff=0)
    for layer in model.modules():
        if not hasattr(layer, "stage_ok"):
            continue
        if layer.win_size == 8 and layer.resolution >= 8 \
                and layer.dim % 128 == 0:
            want["stage"] += 1
            continue
        for blk in layer.blocks:
            C, win, s = blk.dim, blk.win_size, blk.shift_size
            image = win == 8 and (C % 128 == 0 or (
                128 % C == 0 and C >= 32 and s % (128 // C) == 0))
            want["attention_image" if image else "attention_block"] += 1
            want["leff"] += 1
    return want


ROUTES = [("Uformer_B ps64", dict(arch="Uformer_B", train_ps=64), 128,
           (5, 4, 2, 6)),
          ("Uformer_B ps32", dict(arch="Uformer_B", train_ps=32), 128,
           (3, 4, 18, 22)),
          ("Uformer e8", dict(arch="Uformer", embed_dim=8, train_ps=128),
           128, (2, 8, 6, 14)),
          ("Uformer win4", dict(arch="Uformer", embed_dim=32, win_size=4,
                                train_ps=128), 128, (0, 0, 18, 18)),
          ("flagship", None, 64, (1, 8, 8, 16)),
          ("Uformer e64", dict(arch="Uformer", embed_dim=64, train_ps=128),
           256, (8, 2, 0, 2)),
          ("Uformer e64 ps64", dict(arch="Uformer", embed_dim=64,
                                    train_ps=64), 256, (7, 2, 2, 4)),
          ("Uformer e48", dict(arch="Uformer", embed_dim=48, train_ps=128),
           256, (4, 0, 10, 10)),
          ("Uformer e24", dict(arch="Uformer", embed_dim=24, train_ps=128),
           256, (2, 0, 14, 14)),
          ("Uformer e72", dict(arch="Uformer", embed_dim=72, train_ps=128),
           128, (2, 0, 14, 14)),
          ("Uformer e96", dict(arch="Uformer", embed_dim=96, train_ps=128),
           128, (6, 0, 6, 6)),
          ("Uformer e128", dict(arch="Uformer", embed_dim=128,
                                train_ps=128), 128, (9, 0, 0, 0)),
          ("Uformer e96 ps64", dict(arch="Uformer", embed_dim=96,
                                    train_ps=64), 128, (5, 0, 8, 8))]


def _flagship():
    from tests.golden.generate import FLAGSHIP

    kw = {k: v for k, v in FLAGSHIP.items() if k != "token_mlp"}
    return Uformer(**dict(kw, depths=tuple(kw["depths"]),
                          num_heads=tuple(kw["num_heads"])))


@pytest.mark.parametrize("name,opt,side,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_counts_match_jax(name, opt, side, want):
    """The eval forward's calls per kernel (stage / attention_image /
    attention_block / leff), counted on the plain path, equal JAX's
    route and the expected counts; the windowed blocks below window 8
    run at window min(reso, win) with N = win² <= 64."""
    model = (_flagship() if opt is None else get_arch(opt)).eval()
    x = torch.from_numpy(np.random.default_rng(20).uniform(
        0, 1, (1, side, side, 3)).astype(np.float32))
    K.reset_counts()
    with torch.no_grad():
        model(x)
    got = K.plain_counts()
    keys = ("stage", "attention_image", "attention_block", "leff")
    assert tuple(got[k] for k in keys) == want
    assert {k: got[k] for k in keys} == _jax_route(model)
    assert set(K.launch_counts().values()) == {0}


# ---- on the card ----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_kernel(fused, plain, x):
    """fp32: max-abs <= 1e-4 (1 + max|ref|), TF32 off. bf16: the kernel's
    error against the fp32 plain result <= 1.5x the bf16 plain version's
    error + 1e-3. x holds bf16-representable values."""
    ref = plain(x, torch.float32)
    err = float((fused(x, torch.float32) - ref).abs().max())
    assert err <= TOL * (1 + float(ref.abs().max())), err
    xb = x.bfloat16()
    e_plain = float((plain(xb, torch.bfloat16).float() - ref).abs().max())
    e_kernel = float((fused(xb, torch.bfloat16).float() - ref).abs().max())
    assert e_kernel <= 1.5 * e_plain + 1e-3, (e_kernel, e_plain)


def _cast(p, dev, dt, low=()):
    return {k: _t(v, dev, dt if k in low else torch.float32)
            for k, v in p.items()}


GPU_BLOCK = ([(win, shift, w_off, C, nH, has_ln)
              for win in (1, 2, 3, 4, 6, 7)
              for shift, w_off in ((0, 0), (win // 2, 37))
              if shift or not w_off
              for C, nH, has_ln in ((8, 1, True), (16, 2, False),
                                    (32, 1, False), (128, 16, True),
                                    (512, 16, False))]
             + [(8, s, o, C, nH, ln) for s, o in ((0, 0), (4, 37))
                for C, nH, ln in ((8, 1, False), (16, 2, True),
                                  (64, 8, False), (128, 16, True))])


@pytest.mark.gpu
@pytest.mark.parametrize("win,shift,w_off,C,nH,has_ln", GPU_BLOCK)
def test_attention_block_kernel_at_new_geometries(win, shift, w_off, C, nH,
                                                  has_ln):
    dev = _cuda()
    H, W = 4 * win, 6 * win
    Bw = 2 * (H // win) * (W // win) + 1
    inp = _block_inputs(21, Bw, win * win, C, nH)
    x = _t(inp.pop("x"), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=has_ln, w_off=w_off)

    def run(fn):
        return lambda x, dt: fn(x, *prm[dt].values(), **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_attention_block),
                  run(K.attention_block_reference), x)
    assert K.launch_counts()["attention_block"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("win,shift,D,nH", [
    (w, s, D, nH) for w in (1, 2, 3, 4, 6, 7, 8)
    for s in sorted({0, w // 2}) for D, nH in ((8, 2), (16, 1), (32, 3))])
def test_window_attention_kernel_at_new_geometries(win, shift, D, nH):
    dev = _cuda()
    N = win * win
    H, W = 2 * win, 4 * win
    Bw = 5 * (H // win) * (W // win)
    mk = _mk(np.random.default_rng(22), 0.5)
    q, k, v = (_t(mk(nH, Bw, N, D), dev).bfloat16().float()
               for _ in range(3))
    bias = _t(mk(nH, N, N), dev)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)

    def run(fn):
        return lambda x, dt: fn(x.to(dt), k.to(dt), v.to(dt), bias, **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_window_attention),
                  run(K.window_attention_reference), q)
    assert K.launch_counts()["window_attention"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("C,shift,residual", [
    (32, 4, True), (32, 0, False), (64, 4, False), (64, 0, True)])
def test_attention_image_kernel_head_dim8(C, shift, residual):
    dev = _cuda()
    nH = C // 8
    mk = _mk(np.random.default_rng(23), 0.2)
    inp = dict(mod=mk(64, C), ln_s=1.0 + mk(C), ln_b=mk(C), wq=mk(C, C),
               bq=mk(C), wkv=mk(C, 2 * C), bkv=mk(2 * C), wo=mk(C, C),
               bo=mk(C), bias=mk(nH, 64, 64))
    x = _t(mk(2, 32, 24, C), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=shift, scale=8 ** -0.5, num_heads=nH,
              residual=residual)

    def run(fn):
        return lambda x, dt: fn(x, *prm[dt].values(), **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_attention_image),
                  run(K.attention_image_reference), x)
    assert K.launch_counts()["attention_image"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("res", [8, 16])
def test_stage_kernel_head_dim8(res):
    dev = _cuda()
    p = _stage_inputs(24, 2, 128, 16, 512)
    x = _t(_mk(np.random.default_rng(25), 0.3)(2, res, res, 128),
           dev).bfloat16().float()
    prm = {dt: _cast(p, dev, dt, ("wq", "wk", "wv", "wo", "mod", "w1", "wd",
                                  "w2"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(scale=8 ** -0.5, num_heads=16, use_shift=res > 8, has_mod=True)
    K.reset_counts()
    _check_kernel(lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                  lambda x, dt: K.stage_reference(x, prm[dt], **kw), x)
    assert K.launch_counts()["stage"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("side,has_ln,residual", [
    (8, True, True), (8, False, False), (64, True, False),
    (64, False, True)])
def test_leff_kernel_c8(side, has_ln, residual):
    dev = _cuda()
    inp = _leff_inputs(26, 2, side, side, 8, 32)
    x = _t(inp.pop("x"), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("w1", "wd", "w2"))
           for dt in (torch.float32, torch.bfloat16)}

    def run(fn):
        def call(x, dt):
            p = prm[dt]
            ln = dict(ln_s=p["ln_s"], ln_b=p["ln_b"]) if has_ln else {}
            return fn(x, *(p[k] for k in ("w1", "b1", "wd", "bd", "w2",
                                          "b2")), **ln, residual=residual)
        return call

    K.reset_counts()
    _check_kernel(run(K.fused_leff), run(K.leff_reference), x)
    assert K.launch_counts()["leff"] == 2
