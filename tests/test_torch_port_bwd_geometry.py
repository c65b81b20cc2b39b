"""Windows 1-8 and head dim 8 in the backward kernels: kernel 6 on packed
tiles of windows of N = win² < 64 tokens and at head dim 8 (both layouts),
kernel 7 at C = 8, kernel 1's wide body at head dim 8, and the train step
at those geometries.

On the CPU, with numpy inputs from a seed and fp32 throughout, each
within 1e-4 (1 + max|ref|):
  (a) the windowed block's plain VJP (`attention_block_vjp_reference`, the
      CPU answer of `fused_attention_block_bwd`) at windows 1, 2, 3, 4, 6
      and 7, shift 0 and win // 2, head dim 8 at C 8 and 16, against JAX's
      Pallas `fused_attention_block_bwd` (interpret mode) and `jax.vjp` of
      its reference, all eleven outputs;
  (b) the image-layout plain VJP at head dim 8 (C 32, 64, 128) against
      `jax.vjp` of JAX's `attention_image_reference`;
  (c) LeFF's plain VJP at C = 8 (hidden 32), LN and residual each way, at
      W 16 and 32 (JAX packs 16 pixels at W 32, none at W 16), against
      JAX's `fused_leff_bwd` (interpret mode) and `jax.vjp`;
  (d) the kernels' algorithm in plain PyTorch: rows gathered by tile (pad
      rows and a partial last tile at x = g = 0), the tile bias and tile
      modulator, the VJP on 64-row tiles, dbias and dmod folded back by
      their diagonal blocks and rows, equals the plain VJP; the pad rows'
      and the cross-window entries' gradients are exactly 0;
  (e) `pad_hidden`'s gradients, sliced, equal the unpadded VJP bit for
      bit, and the padded channels' gradients are exactly 0;
  (f) the plain-path train step of a small Uformer at 64² (its bottleneck
      at window 4) and at win_size 4 against JAX's `make_train_step`.
The tests marked `gpu` hold each extended backward kernel against its
plain VJP on the card (`python -m pytest -m gpu
tests/test_torch_port_bwd_geometry.py`), within `chip_smoke.py`'s bounds.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels import attention_block as ab_mod
from uformer_tpu_torch.ops.kernels import window_attention as wa_mod
from uformer_tpu_torch.ops.kernels.leff import pad_hidden
from uformer_tpu_torch.ops.masks import NEG_BIAS
from uformer_tpu_torch.ops.norm import layer_norm
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

torch.set_num_threads(1)
TOL = 1e-4
ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
LEFF_GRADS = ("dx", "dw1", "db1", "dwd", "dbd", "dw2", "db2", "dln_s",
              "dln_b")


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops.pallas import attention_block, attention_image, leff

    return SimpleNamespace(jax=jax, jnp=jnp, ab=attention_block,
                           ai=attention_image, leff=leff)


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a).copy()).to(
        device, dtype)


def _close(got, want, what=""):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().cpu().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * (1 + np.abs(want).max()),
                               err_msg=what)


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


# ---- (a) the windowed block's VJP at windows 1-7 and head dim 8 ----------

BLOCK_BWD = [(win, shift, C, nH)
             for win in (1, 2, 3, 4, 6, 7)
             for shift in sorted({0, win // 2})
             for C, nH in ((8, 1), (16, 2))]


@pytest.mark.parametrize("win,shift,C,nH", BLOCK_BWD)
def test_attention_block_vjp_matches_jax_kernel(jx, win, shift, C, nH):
    """The plain VJP against JAX's Pallas kernel 6 (interpret mode, which
    packs 128 // N windows) and `jax.vjp` of its reference, all eleven
    outputs; LN folded in at C 8 and outside at C 16, as the model runs
    it; two whole images of windows (a partial last tile at windows 2
    and 3 on the card)."""
    H, W = 3 * win, 2 * win
    Bw = 2 * (H // win) * (W // win)
    N, has_ln = win * win, C == 8
    inp = _block_inputs(30 + win, Bw, N, C, nH)
    g = _mk(np.random.default_rng(31), 1.0)(Bw, N, C)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=has_ln)
    K.reset_counts()
    got = K.fused_attention_block_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_block_bwd"] == 1
    j = [jx.jnp.asarray(v) for v in inp.values()]
    kern = jx.ab.fused_attention_block_bwd(
        j[0], jx.jnp.asarray(g), *j[1:], has_mod=True, interpret=True,
        packed=False, **kw)
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ab.attention_block_reference(*a, **kw), *j)
    want = vjp(jx.jnp.asarray(g))
    for i, name in enumerate(ATTN_GRADS):
        if name in ("dln_s", "dln_b") and not has_ln:
            assert got[i] is None, name
            continue
        _close(got[i], kern[i], f"{name} vs kernel")
        _close(got[i], want[i], f"{name} vs jax.vjp")


# ---- (b) the image layout's VJP at head dim 8 ---------------------------

@pytest.mark.parametrize("C,shift,residual", [
    (32, 4, True), (32, 0, False), (64, 0, True), (64, 4, False),
    (128, 4, True), (128, 0, False)])
def test_attention_image_vjp_head_dim8_matches_jax(jx, C, shift, residual):
    nH = C // 8
    mk = _mk(np.random.default_rng(32), 0.2)
    inp = dict(x=mk(1, 16, 16, C), mod=mk(64, C), ln_s=1.0 + mk(C),
               ln_b=mk(C), wq=mk(C, C), bq=mk(C), wkv=mk(C, 2 * C),
               bkv=mk(2 * C), wo=mk(C, C), bo=mk(C), bias=mk(nH, 64, 64))
    g = mk(1, 16, 16, C)
    kw = dict(win=8, shift=shift, scale=8 ** -0.5, num_heads=nH,
              has_ln=True, residual=residual)
    K.reset_counts()
    got = K.fused_attention_image_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_bwd"] == 1
    j = [jx.jnp.asarray(v) for v in inp.values()]
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ai.attention_image_reference(*a, **kw), *j)
    for name, a, w in zip(ATTN_GRADS, got, vjp(jx.jnp.asarray(g))):
        _close(a, w, name)


# ---- (c) LeFF's VJP at C = 8 --------------------------------------------

@pytest.mark.parametrize("W,has_ln,residual", [
    (W, ln, r) for W in (16, 32) for ln in (True, False)
    for r in (True, False)])
def test_leff_vjp_c8_matches_jax_kernel(jx, W, has_ln, residual):
    inp = _leff_inputs(33, 2, 16, W, 8, 32)
    dy = _mk(np.random.default_rng(34), 1.0)(2, 16, W, 8)
    names = ("x", "w1", "b1", "wd", "bd", "w2", "b2", "ln_s", "ln_b")
    K.reset_counts()
    got = K.fused_leff_bwd(
        _t(inp["x"]), _t(dy), *(_t(inp[k]) for k in names[1:6]),
        _t(inp["ln_s"]), _t(inp["ln_b"]), has_ln=has_ln, residual=residual)
    assert K.plain_counts()["leff_bwd"] == 1
    J = [jx.jnp.asarray(inp[k]) for k in names]
    kern = jx.leff.fused_leff_bwd(
        J[0], jx.jnp.asarray(dy), *J[1:6], J[7], J[8], has_ln=has_ln,
        residual=residual, interpret=True)

    def ref(*a):
        return jx.leff.leff_reference(
            *a[:7], ln_s=a[7] if has_ln else None,
            ln_b=a[8] if has_ln else None, residual=residual)

    _, vjp = jx.jax.vjp(ref, *J)
    want = vjp(jx.jnp.asarray(dy))
    for i, name in enumerate(LEFF_GRADS):
        if name in ("dln_s", "dln_b") and not has_ln:
            assert got[i] is None, name
            continue
        _close(got[i], kern[i], f"{name} vs kernel")
        _close(got[i], want[i], f"{name} vs jax.vjp")


# ---- (d) the kernels' algorithm on packed tiles --------------------------

def _tiles(N, Bw):
    """(T, 64) row of each tile row in the (Bw N) rows, and whether it is
    real (the kernels' PackedTokens.pix and valid)."""
    G, T = 64 // N, wa_mod.packed_tiles(Bw, N)
    t = torch.arange(64)
    pix = torch.arange(T)[:, None] * G * N + t
    valid = (t < G * N) & (pix < Bw * N)
    return pix.clamp(max=Bw * N - 1), valid


def _tile_mask(win, shift, H, W, Bw):
    """(T, 64, 64) SW-MSA mask of each tile's rows by their own windows'
    region ids, window i at place i mod nW (pairs of two windows carry
    -inf in the tile bias)."""
    N, nWw, nW = win * win, W // win, (H // win) * (W // win)
    pix, _ = _tiles(N, Bw)
    wl = (pix // N) % nW
    tt = pix % N

    def axis(g, size):
        return (g >= size - win).long() + (g >= size - shift).long()

    rid = 3 * axis((wl // nWw) * win + tt // win, H) + \
        axis((wl % nWw) * win + tt % win, W)
    return torch.where(rid[:, :, None] != rid[:, None, :], NEG_BIAS, 0.0)


def _packed_vjp(x, g, mod, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias, *,
                win, shift, H, W, scale, num_heads, has_ln):
    """Kernel 6 on packed tiles in plain PyTorch: x and g gathered by tile
    (pad rows 0), the tile modulator and bias, the block's VJP on 64-row
    tiles by autograd, dx of the real rows, dmod and dbias folded back
    (`fold_tile_tokens`, `fold_tile_bias`). Asserts that the pad rows'
    and the cross-window gradients are exactly 0."""
    Bw, N, C = x.shape
    pix, valid = _tiles(N, Bw)
    T, D = pix.shape[0], C // num_heads

    def gather(t):
        return torch.where(valid[..., None], t.reshape(Bw * N, C)[pix], 0.0)

    mod_t, bias_t = ab_mod.packed_operands(mod, bias, N)
    leaves = [t.detach().requires_grad_(True) for t in (
        gather(x), mod_t, ln_s, ln_b, wq, bq, wkv, bkv, wo, bo, bias_t)]
    xt, mt, ls, lb, wq_, bq_, wkv_, bkv_, wo_, bo_, bt = leaves
    xm = (layer_norm(xt, ls, lb) if has_ln else xt) + mt

    def heads(t):
        return t.reshape(T, 64, num_heads, D).transpose(1, 2)

    kv = xm @ wkv_ + bkv_
    logits = heads(xm @ wq_ + bq_) * scale @ heads(kv[..., :C]) \
        .transpose(-1, -2) + bt
    if shift:
        logits = logits + _tile_mask(win, shift, H, W, Bw)[:, None]
    out = torch.softmax(logits, -1) @ heads(kv[..., C:])
    y = out.transpose(1, 2).reshape(T, 64, C) @ wo_ + bo_
    grads = torch.autograd.grad(y, leaves, gather(g), allow_unused=True)
    dxt, dmt, _, _, _, _, _, _, _, _, dbt = grads
    G = 64 // N
    same = (torch.arange(64) // N)[:, None] == (torch.arange(64) // N)
    assert not dxt[~valid].any()
    assert not dmt[G * N:].any() and not dbt[:, ~same].any()
    dx = dxt.reshape(T * 64, C)[valid.reshape(-1)].reshape(Bw, N, C)
    return ((dx, wa_mod.fold_tile_tokens(dmt, N))
            + tuple(grads[2:4])
            + tuple(grads[4:10]) + (wa_mod.fold_tile_bias(dbt, N),))


PACKED_BWD = [(win, shift, ln) for win in range(1, 8)
              for shift in sorted({0, win // 2}) for ln in (True, False)]


@pytest.mark.parametrize("win,shift,has_ln", PACKED_BWD)
def test_packed_backward_equals_the_plain_vjp(win, shift, has_ln):
    """64 // N whole windows a tile (pad rows at N 9, 25, 36, 49), 35
    windows (a partial last tile but at N 1 and 64 // 35 < 2), the tile
    bias -inf between windows, region ids per window: the folded
    gradients equal `attention_block_vjp_reference`."""
    H, W, C, nH = 4 * win, 4 * win, 16, 2
    Bw = 35
    inp = _block_inputs(35, Bw, win * win, C, nH)
    g = _t(_mk(np.random.default_rng(36), 1.0)(Bw, win * win, C))
    kw = dict(win=win, shift=shift, H=H, W=W, scale=0.3, num_heads=nH,
              has_ln=has_ln)
    args = list(map(_t, inp.values()))
    want = K.attention_block_vjp_reference(args[0], g, *args[1:], **kw)
    got = _packed_vjp(args[0], g, *args[1:], **kw)
    for name, a, w in zip(ATTN_GRADS, got, want):
        if w is None:
            assert a is None, name
            continue
        _close(a, w.numpy(), name)


@pytest.mark.parametrize("N", [1, 4, 9, 16, 25, 36, 49, 64])
def test_tile_folds_invert_the_tiles(N):
    """fold_tile_tokens / fold_tile_bias are the adjoints of tile_tokens /
    tile_bias on the entries the softmax weighs: the fold of a tile built
    from (N, C) and (nH, N, N) operands is 64 // N times them (the -inf
    entries set to 0 first), and at N = 64 the identity."""
    mk = _mk(np.random.default_rng(37), 1.0)
    bias, mod = _t(mk(3, N, N)), _t(mk(N, 5))
    G = 64 // N
    tb = wa_mod.tile_bias(bias, N)
    tb = torch.where(torch.isinf(tb), 0.0, tb)
    torch.testing.assert_close(wa_mod.fold_tile_bias(tb, N), G * bias)
    torch.testing.assert_close(
        wa_mod.fold_tile_tokens(wa_mod.tile_tokens(mod, N), N), G * mod)
    assert wa_mod.fold_tile_bias(tb, N).shape == (3, N, N)


# ---- (e) LeFF's padded hidden in the backward ----------------------------

@pytest.mark.parametrize("has_ln,residual", [(True, False), (False, True)])
def test_pad_hidden_gradients_are_the_unpadded_ones(has_ln, residual):
    """The VJP on the padded weights, sliced back to the 32 channels,
    equals the unpadded VJP bit for bit; the padded channels' gradients
    are exactly 0 (GELU(0) = 0 and w2's pad rows are 0)."""
    inp = _leff_inputs(38, 2, 12, 20, 8, 32)
    dy = _t(_mk(np.random.default_rng(39), 1.0)(2, 12, 20, 8))
    w = [_t(inp[k]) for k in ("w1", "b1", "wd", "bd", "w2")]
    ln = (_t(inp["ln_s"]), _t(inp["ln_b"]))
    kw = dict(has_ln=has_ln, residual=residual)
    want = K.leff_vjp_reference(_t(inp["x"]), dy, *w, *ln, **kw)
    got = K.leff_vjp_reference(_t(inp["x"]), dy, *pad_hidden(*w), *ln, **kw)
    sliced = (got[0], got[1][:, :32], got[2][:32], got[3][..., :32],
              got[4][:32], got[5][:32]) + tuple(got[6:])
    for name, a, b in zip(LEFF_GRADS, sliced, want):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a, b), name
    for pad in (got[1][:, 32:], got[2][32:], got[3][..., 32:], got[4][32:],
                got[5][32:]):
        assert not pad.any()


# ---- (f) the train step at window 4 against JAX --------------------------

SMALL = dict(embed_dim=8, depths=(1, 2, 1, 1, 1, 2, 1, 1, 1),
             num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), modulator=True)
# (construction options, windowed-branch blocks of a step): at 64² the
# bottleneck is 4 x 4 (window 4, head dim 16, C 128) and joins C 8 and 16
# (enc0, enc1, dec3) on the windowed branch; win_size 4 puts every block
# on 16-token windows
STEP_CASES = {"ps64": (dict(img_size=64, win_size=8), 5),
              "win4": (dict(img_size=64, win_size=4), 11)}


@pytest.fixture(scope="module")
def jax_steps(jx):
    """One JAX train step (drop path 0, no mixup, lr 1e-3) per case from
    seeded params on one 64² batch: params before and after, loss and
    gradients."""
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep

    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(40)
    batch = {"input": rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32),
             "target": rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    out = {}
    for label, (opt, _) in STEP_CASES.items():
        model = JaxUformer(attn_backend="jnp", drop_path_rate=0.0,
                           **SMALL, **opt)
        shapes = jax.eval_shape(model.init, key, jb["input"])
        prng = np.random.default_rng(41)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: (0.05 * prng.standard_normal(a.shape) + (
                jax.tree_util.keystr(path).endswith("['scale']")))
            .astype(np.float32), shapes)

        def loss(p, model=model):
            pred = model.apply(p, jb["input"], deterministic=False,
                               rngs={"dropout": jax.random.split(key)[1]})
            return jloss(pred, jb["target"])

        state = JState.create(params, jopt(lambda s: 1e-3))
        new, loss_val = jax.jit(jstep(model))(state, jb, key)
        out[label] = SimpleNamespace(
            before=state_dict_from_jax(params),
            after=state_dict_from_jax(new.params), loss=float(loss_val),
            grads=state_dict_from_jax(jax.grad(loss)(params)))
    return SimpleNamespace(batch=batch, steps=out)


@pytest.mark.parametrize("label", list(STEP_CASES))
def test_window4_train_step_matches_jax(jax_steps, label):
    """The port's plain-path step (the CPU answer of the kernel path) at
    a window-4 geometry against JAX's: loss, every gradient and every
    parameter's update (within 2e-3 lr plus four float32 spacings)."""
    opt, windowed = STEP_CASES[label]
    s = jax_steps.steps[label]
    model = Uformer(drop_path_rate=0.0, **SMALL, **opt)
    load_numpy_state_dict(model, s.before)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda k: 1e-3))
    batch = {k: torch.from_numpy(v) for k, v in jax_steps.batch.items()}
    K.reset_counts()
    loss = make_train_step(model)(state, batch,
                                  torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), s.loss, rtol=1e-5)
    counts = K.plain_counts()
    assert counts["attention_block_bwd"] == windowed == \
        counts["attention_block"]
    for name, prm in model.named_parameters():
        want = np.asarray(s.grads[name])
        np.testing.assert_allclose(
            prm.grad.numpy(), want, rtol=0,
            atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)
        before = np.asarray(s.before[name])
        err = np.abs((prm.detach().numpy() - before)
                     - (np.asarray(s.after[name]) - before))
        assert np.all(err <= 2e-3 * 1e-3 + 4 * np.spacing(np.abs(before))), \
            name


@pytest.mark.parametrize("windows,C,bf16,want", [
    (32, 128, True, ("wide", 1)),     # e8's bottleneck at bs32 (8²)
    (128, 128, True, ("wide", 1)),    # e8's dec0 at bs32 (16²)
    (512, 128, True, ("wide", 4)),
    (512, 64, True, ("narrow", 2)),   # head dim 8 at C 32-64: narrow
    (512, 128, False, ("window", 1))])
def test_attention_image_plan_takes_head_dim8_wide(windows, C, bf16, want):
    """Kernel 1's wide body takes head dim 8 at C = 128 (training runs it
    there: the stage kernel runs only in eval)."""
    from uformer_tpu_torch.ops.kernels.attention_image import \
        attention_image_plan

    assert attention_image_plan(windows, C, 8, bf16, 132) == want


# ---- the kernels on the card ---------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


DRAWS = 4  # independent inputs a bf16 comparison pools (chip_smoke.py)
FEW_ENTRIES = 64  # held by rms error in bf16 (chip_smoke.py)


def _check_bwd(fused, plain, draws, names):
    """Per gradient: fp32 kernel within 1e-4 (1 + max|ref|) of the fp32
    plain VJP, each draw; bf16 kernel within 1.5x the bf16 plain VJP's
    error + 1e-3 max(1, max|ref|) of it, on each gradient of all draws
    taken as one tensor: its max error, or its rms error where the
    gradient has at most FEW_ENTRIES entries a draw
    (chip_smoke.py:pooled_grad_bound)."""
    runs = [(fused(x, g, torch.float32), plain(x, g, torch.float32),
             plain(x.bfloat16(), g.bfloat16(), torch.bfloat16),
             fused(x.bfloat16(), g.bfloat16(), torch.bfloat16))
            for x, g in draws]
    for i, name in enumerate(names):
        if runs[0][1][i] is None:
            assert all(r[0][i] is None and r[3][i] is None for r in runs)
            continue
        for got, ref, _, _ in runs:
            err = float((got[i].float() - ref[i].float()).abs().max())
            assert err <= TOL * (1 + float(ref[i].abs().max())), (name, err)
        k, r, p, k16 = (torch.cat([run[j][i].float().reshape(-1)
                                   for run in runs]) for j in range(4))
        scale = float(r.abs().max())
        if runs[0][1][i].numel() <= FEW_ENTRIES:
            e_plain = float((p - r).pow(2).mean().sqrt())
            e16 = float((k16 - r).pow(2).mean().sqrt())
        else:
            e_plain = float((p - r).abs().max())
            e16 = float((k16 - r).abs().max())
        assert e16 <= 1.5 * e_plain + 1e-3 * max(1.0, scale), (name, e16)


def _draws(seed, *shape):
    mat, _, _ = _model_like(seed)
    return [tuple(torch.from_numpy(mat(*shape)).cuda().bfloat16().float()
                  for _ in range(2)) for _ in range(DRAWS)]


def _cast(p, dev, dt, low=()):
    return {k: _t(v, dev, dt if k in low else torch.float32)
            for k, v in p.items()}


def _model_like(seed):
    """Operand makers by the golden weights' rule (tests/golden/generate.py
    `_seeded_value`, as chip_smoke.py's seeded models): matrices N(0, 1 /
    fan-in), LayerNorm scales 1 + N(0, 0.05²), biases N(0, 0.02²); inputs
    N(0, 1)."""
    rng = np.random.default_rng(seed)

    def mat(*shape, fan_in=1):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def scale(n):
        return (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)

    def bias(n):
        return (0.02 * rng.standard_normal(n)).astype(np.float32)

    return mat, scale, bias


def _attn_prm(seed, C, nH, N):
    mat, scale, bias = _model_like(seed)
    return dict(mod=mat(N, C, fan_in=C), ln_s=scale(C), ln_b=bias(C),
                wq=mat(C, C, fan_in=C), bq=bias(C),
                wkv=mat(C, 2 * C, fan_in=C), bkv=bias(2 * C),
                wo=mat(C, C, fan_in=C), bo=bias(C),
                bias=mat(nH, N, N, fan_in=nH))


TOKENS = 1 << 15  # each draw's tokens, as chip_smoke.py's GEOM_TOKENS


# (win, shift, C, heads, has_ln, windows): TOKENS // N + 3 windows (a
# partial last tile wherever 64 // N > 1) but ps64's bottleneck at bs32
# (32 windows at C 512, its heads split over blocks). C = 8 with and
# without LN (the model's windowed branch runs it without: LN outside)
GPU_BLOCK_BWD = ([(w, s, C, nH, ln, None) for w in (1, 2, 3, 4, 5, 6, 7)
                  for s in sorted({0, w // 2})
                  for C, nH, ln in ((8, 1, False), (8, 1, True),
                                    (16, 2, True), (128, 16, False),
                                    (512, 16, True))]
                 + [(8, s, C, nH, ln, None) for s in (0, 4)
                    for C, nH, ln in ((8, 1, False), (8, 1, True),
                                      (16, 2, True))]
                 + [(4, 0, 512, 16, False, 32)])


@pytest.mark.gpu
@pytest.mark.parametrize("win,shift,C,nH,has_ln,Bw", GPU_BLOCK_BWD)
def test_attention_block_bwd_kernel_at_new_geometries(win, shift, C, nH,
                                                      has_ln, Bw):
    dev = _cuda()
    N, H, W = win * win, 16 * win, 16 * win
    Bw = Bw or TOKENS // N + 3
    prm = {dt: _cast(_attn_prm(42, C, nH, N), dev, dt,
                     ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=has_ln)
    K.reset_counts()
    _check_bwd(lambda x, g, dt: K.fused_attention_block_bwd(
                   x, g, *prm[dt].values(), **kw),
               lambda x, g, dt: K.attention_block_vjp_reference(
                   x, g, *prm[dt].values(), **kw),
               _draws(43, Bw, N, C), ATTN_GRADS)
    assert K.launch_counts()["attention_block_bwd"] == 2 * DRAWS


@pytest.mark.gpu
@pytest.mark.parametrize("C,shift,residual", [
    (32, 4, True), (64, 0, False), (128, 4, False), (128, 0, True)])
def test_attention_image_bwd_kernel_head_dim8(C, shift, residual):
    """Kernel 6 in the image layout at head dim 8, and kernel 1's wide
    body at head dim 8 (C = 128)."""
    dev = _cuda()
    nH = C // 8
    draws = _draws(44, 2, 128, 128, C)
    x = draws[0][0]
    prm = {dt: _cast(_attn_prm(45, C, nH, 64), dev, dt,
                     ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=shift, scale=8 ** -0.5, num_heads=nH,
              residual=residual)
    _check_bwd(lambda x, g, dt: K.fused_attention_image_bwd(
                   x, g, *prm[dt].values(), **kw),
               lambda x, g, dt: K.attention_image_vjp_reference(
                   x, g, *prm[dt].values(), **kw), draws, ATTN_GRADS)
    y = K.fused_attention_image(x.bfloat16(), *prm[torch.bfloat16].values(),
                                **kw)
    ref = K.attention_image_reference(x, *prm[torch.float32].values(), **kw)
    low = K.attention_image_reference(x.bfloat16(),
                                      *prm[torch.bfloat16].values(), **kw)
    assert float((y.float() - ref).abs().max()) <= \
        1.5 * float((low.float() - ref).abs().max()) + 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,has_ln,residual", [
    (128, 128, True, True), (128, 128, False, False),
    (100, 164, True, False), (100, 164, False, True)])
def test_leff_bwd_kernel_c8(H, W, has_ln, residual):
    """Kernel 7 at C = 8 with the hidden of 32 as the caller gives it (the
    wrapper pads it) and padded (as the model gives it)."""
    dev = _cuda()
    mat, scale, bias = _model_like(46)
    inp = dict(w1=mat(8, 32, fan_in=8), b1=bias(32),
               wd=mat(3, 3, 32, fan_in=9), bd=bias(32),
               w2=mat(32, 8, fan_in=32), ln_s=scale(8), ln_b=bias(8))
    prm = {dt: _cast(inp, dev, dt, ("w1", "wd", "w2"))
           for dt in (torch.float32, torch.bfloat16)}

    def run(fn, pad):
        def call(x, g, dt):
            p = prm[dt]
            w = [p[k] for k in ("w1", "b1", "wd", "bd", "w2")]
            if pad:
                w = pad_hidden(*w)
            out = fn(x, g, *w, p["ln_s"], p["ln_b"], has_ln=has_ln,
                     residual=residual)
            return (out[0], out[1][:, :32], out[2][:32], out[3][..., :32],
                    out[4][:32], out[5][:32]) + tuple(out[6:])
        return call

    draws = _draws(47, 2, H, W, 8)
    for pad in (False, True):
        _check_bwd(run(K.fused_leff_bwd, pad), run(K.leff_vjp_reference,
                                                   False), draws, LEFF_GRADS)


@pytest.mark.gpu
def test_embed8_window2_step_runs_through_the_kernels():
    """Uformer at embed 8, window 2 trains on the card: 18 launches of each
    of kernels 5, 6, 2 and 7, no plain call, a finite loss."""
    from uformer_tpu_torch import get_arch

    dev = _cuda()
    torch.manual_seed(0)
    model = get_arch({"arch": "Uformer", "embed_dim": 8, "win_size": 2,
                      "train_ps": 32}).to(dev)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 2e-4))
    x = torch.rand(2, 32, 32, 3, device=dev)
    K.reset_counts()
    loss = make_train_step(model)(state, {"input": x, "target": x},
                                  torch.Generator().manual_seed(0))
    counts = K.launch_counts()
    assert (counts["attention_block"], counts["attention_block_bwd"],
            counts["leff"], counts["leff_bwd"]) == (18, 18, 18, 18)
    assert not any(K.plain_counts().values())
    assert np.isfinite(float(loss))
