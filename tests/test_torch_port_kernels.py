"""The port's image-layout kernel modules (`uformer_tpu_torch.ops.kernels`).

On the CPU the plain PyTorch versions (`attention_image_reference`,
`leff_reference`, `stage_reference`) are held against the JAX package's jnp
references and against its Pallas kernels run with interpret=True, on the
same numpy inputs (fp32, tolerance 1e-4). The tests marked `gpu` hold each
CUDA kernel against its plain version on the card (the backward kernels,
the windowed attention backward among them, against their plain VJPs);
they decide inside the test whether a card is present and skip without
one. Run them on the card
with `python -m pytest -m gpu tests/test_torch_port_kernels.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.ops import kernels as K

torch.set_num_threads(1)
TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's references, imported by the CPU tests only: the
    card's machine has no flax, and the `gpu` tests need none of it."""
    import jax.numpy as jnp
    from uformer_tpu.ops.pallas import attention_image, leff, stage

    return SimpleNamespace(jnp=jnp, ai=attention_image, leff=leff,
                           stage=stage)


def _attn_inputs(seed, B, H, W, C, nH, with_mod=True):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s) * 0.2).astype(np.float32)

    return dict(x=mk(B, H, W, C), mod=mk(64, C) if with_mod else None,
                ln_s=1.0 + 0.5 * mk(C), ln_b=0.5 * mk(C), wq=mk(C, C),
                bq=mk(C), wkv=mk(C, 2 * C), bkv=mk(2 * C), wo=mk(C, C),
                bo=mk(C), bias=mk(nH, 64, 64))


def _leff_inputs(seed, B, H, W, C, Ch):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s) * 0.3).astype(np.float32)

    return dict(x=mk(B, H, W, C), w1=mk(C, Ch), b1=mk(Ch), wd=mk(3, 3, Ch),
                bd=mk(Ch), w2=mk(Ch, C), b2=mk(C), ln_s=1.0 + mk(C),
                ln_b=mk(C))


def _stage_inputs(seed, n, C, nH, Ch):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s) * 0.1).astype(np.float32)

    return dict(ln1_s=1.0 + mk(n, C), ln1_b=mk(n, C), wq=mk(n, C, C),
                bq=mk(n, C), wk=mk(n, C, C), bk=mk(n, C), wv=mk(n, C, C),
                bv=mk(n, C), wo=mk(n, C, C), bo=mk(n, C),
                bias=mk(n, nH, 64, 64), mod=mk(n, 64, C),
                ln2_s=1.0 + mk(n, C), ln2_b=mk(n, C), w1=mk(n, C, Ch),
                b1=mk(n, Ch), wd=mk(n, 3, 3, Ch), bd=mk(n, Ch),
                w2=mk(n, Ch, C), b2=mk(n, C))


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(device, dtype)


def _j(jx, a):
    return None if a is None else jx.jnp.asarray(a)


def _close(got, *wants):
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)


# (B, H, W, C, nH, shift, with_mod): the narrow stages as they run (C 32
# and 64, shift 4), C 128 with and without the modulator, and head dim 16
# (Uformer_T's C 32 and 64 stages)
ATTN_GEOMS = [(1, 16, 16, 32, 1, 4, True), (2, 16, 16, 64, 2, 4, False),
              (1, 16, 24, 128, 4, 0, True), (1, 16, 16, 128, 4, 4, False),
              (1, 16, 16, 128, 4, 4, True), (1, 16, 24, 32, 2, 4, True),
              (1, 16, 16, 64, 4, 0, False)]


@pytest.mark.parametrize("geom", ATTN_GEOMS)
def test_attention_image_reference_matches_jax(jx, geom):
    B, H, W, C, nH, shift, with_mod = geom
    inp = _attn_inputs(0, B, H, W, C, nH, with_mod)
    kw = dict(win=8, shift=shift, scale=0.2, num_heads=nH, has_ln=True,
              residual=True)
    got = K.attention_image_reference(*map(_t, inp.values()), **kw)
    jin = [_j(jx, a) for a in inp.values()]
    _close(got, jx.ai.attention_image_reference(*jin, **kw),
           jx.ai.fused_attention_image(*jin, interpret=True, **kw))


@pytest.mark.parametrize("shape,Ch", [((1, 8, 16, 32), 128),
                                      ((2, 8, 8, 64), 256),
                                      ((1, 16, 8, 128), 512)])
def test_leff_reference_matches_jax(jx, shape, Ch):
    inp = _leff_inputs(1, *shape, Ch)
    args = [inp[k] for k in ("x", "w1", "b1", "wd", "bd", "w2", "b2")]
    got = K.leff_reference(*map(_t, args), ln_s=_t(inp["ln_s"]),
                           ln_b=_t(inp["ln_b"]), residual=True)
    jkw = dict(ln_s=_j(jx, inp["ln_s"]), ln_b=_j(jx, inp["ln_b"]),
               residual=True)
    jargs = [_j(jx, a) for a in args]
    _close(got, jx.leff.leff_reference(*jargs, **jkw),
           jx.leff.fused_leff(*jargs, interpret=True, **jkw))


@pytest.mark.parametrize("use_shift,has_mod,nH", [
    pytest.param(True, True, 4, id="True-True"),
    pytest.param(True, False, 4, id="True-False"),
    pytest.param(True, True, 8, id="True-True-head_dim16")])
def test_stage_reference_matches_jax(jx, use_shift, has_mod, nH):
    B, H, W, C, n = 1, 16, 16, 128, 2
    p = _stage_inputs(2, n, C, nH, 4 * C)
    x = (np.random.default_rng(3).standard_normal((B, H, W, C)) * 0.3) \
        .astype(np.float32)
    kw = dict(scale=0.2, num_heads=nH, use_shift=use_shift, has_mod=has_mod)
    got = K.stage_reference(_t(x), {k: _t(v) for k, v in p.items()}, **kw)
    jp = {k: _j(jx, v) for k, v in p.items()}
    _close(got, jx.stage.stage_reference(_j(jx, x), jp, **kw),
           jx.stage.fused_stage(_j(jx, x), jp, interpret=True, **kw))


def test_wrappers_take_plain_version_on_cpu_only():
    """A CPU tensor is answered by the plain version (counted apart); any
    other device that is not CUDA is refused, never answered plainly."""
    inp = _leff_inputs(4, 1, 8, 8, 32, 128)
    args = [_t(inp[k]) for k in ("x", "w1", "b1", "wd", "bd", "w2", "b2")]
    K.reset_counts()
    y = K.fused_leff(*args, residual=True)
    _close(y, K.leff_reference(*args, residual=True))
    assert K.plain_counts()["leff"] == 1 and K.launch_counts()["leff"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_leff(args[0].to("meta"), *args[1:], residual=True)
    assert K.plain_counts()["leff"] == 1


# ---- on the card -------------------------------------------------------

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
    """numpy params -> device tensors; the keys in `low` (matrices, mod)
    in dt, the rest fp32, as the kernels take them."""
    return {k: _t(v, dev, dt if k in low else torch.float32)
            for k, v in p.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("geom", ATTN_GEOMS + [
    (2, 32, 32, 256, 8, 4, True), (2, 16, 16, 512, 16, 4, True),
    (2, 8, 8, 512, 16, 0, False)])
def test_attention_image_kernel_on_card(geom):
    dev = _cuda()
    B, H, W, C, nH, shift, with_mod = geom
    inp = _attn_inputs(5, B, H, W, C, nH, with_mod)
    x = _t(inp.pop("x"), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH)

    def run(fn):
        return lambda x, dt: fn(x, *prm[dt].values(), **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_attention_image),
                  run(K.attention_image_reference), x)
    assert K.launch_counts()["attention_image"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (2, 16, 16, 64),
                                   (2, 16, 16, 128), (2, 16, 16, 256),
                                   (2, 16, 16, 512), (2, 16, 16, 16)])
def test_leff_kernel_on_card(shape):
    dev = _cuda()
    inp = _leff_inputs(6, *shape, 4 * shape[-1])
    x = _t(inp.pop("x"), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("w1", "wd", "w2"))
           for dt in (torch.float32, torch.bfloat16)}

    def run(fn):
        return lambda x, dt: fn(x, *(prm[dt][k] for k in (
            "w1", "b1", "wd", "bd", "w2", "b2")), ln_s=prm[dt]["ln_s"],
            ln_b=prm[dt]["ln_b"], residual=True)

    K.reset_counts()
    _check_kernel(run(K.fused_leff), run(K.leff_reference), x)
    assert K.launch_counts()["leff"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("C,nH,res,n,use_shift,has_mod", [
    (128, 4, 32, 2, True, True), (256, 8, 16, 3, True, False),
    (512, 16, 8, 2, False, True), (128, 8, 32, 2, True, True),
    (256, 16, 16, 2, False, True)])
def test_stage_kernel_on_card(C, nH, res, n, use_shift, has_mod):
    dev = _cuda()
    p = _stage_inputs(7, n, C, nH, 4 * C)
    x = (_t(np.random.default_rng(8).standard_normal((2, res, res, C))
            .astype(np.float32), dev)).bfloat16().float()
    prm = {dt: _cast(p, dev, dt, ("wq", "wk", "wv", "wo", "mod", "w1", "wd",
                                  "w2"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=use_shift,
              has_mod=has_mod)
    K.reset_counts()
    _check_kernel(lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                  lambda x, dt: K.stage_reference(x, prm[dt], **kw), x)
    assert K.launch_counts()["stage"] == 2


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_input_on_card():
    dev = _cuda()
    inp = _leff_inputs(9, 1, 8, 8, 32, 128)
    args = [_t(inp[k], dev) for k in ("x", "w1", "b1", "wd", "bd", "w2",
                                      "b2")]
    with pytest.raises(TypeError):  # fp32 activations, bf16 matrix
        K.fused_leff(args[0], args[1].bfloat16(), *args[2:])
    with pytest.raises(ValueError):  # hidden width off the chunk grid
        K.fused_leff(args[0], args[1][:, :100].contiguous(), *args[2:])
    with pytest.raises(ValueError):  # not contiguous
        K.fused_leff(args[0].transpose(1, 2), *args[1:])


# ---- backward kernels on the card -------------------------------------

def _check_grads(fused, plain, x, g, what):
    """Every returned gradient, per tensor. fp32: max-abs <= 1e-4 (1 +
    max|ref|), TF32 off. bf16: the kernel's error against the fp32 plain
    VJP <= 1.5x the bf16 plain VJP's error + 1e-3 max(1, max|ref|): weight
    grads are sums over every token, so the bound scales with each
    tensor."""
    ref = plain(x, g, torch.float32)
    got = fused(x, g, torch.float32)
    assert len(got) == len(ref)
    low = plain(x.bfloat16(), g.bfloat16(), torch.bfloat16)
    got16 = fused(x.bfloat16(), g.bfloat16(), torch.bfloat16)
    for i, (r, k, p, k16) in enumerate(zip(ref, got, low, got16)):
        if r is None:
            assert k is None and k16 is None, (what, i)
            continue
        scale = float(r.abs().max())
        err = float((k.float() - r.float()).abs().max())
        assert err <= TOL * (1 + scale), (what, i, "fp32", err, scale)
        e_plain = float((p.float() - r.float()).abs().max())
        e16 = float((k16.float() - r.float()).abs().max())
        assert e16 <= 1.5 * e_plain + 1e-3 * max(1.0, scale), \
            (what, i, "bf16", e16, e_plain, scale)


# head dim 32 (Uformer_B's stages), then 16 (Uformer_T's C 32-256)
ATTN_BWD_GEOMS = [(2, 16, 16, 32, 1, 4), (2, 16, 16, 64, 2, 0),
                  (2, 16, 16, 128, 4, 4), (2, 16, 16, 256, 8, 4),
                  (2, 8, 8, 512, 16, 0), (2, 16, 16, 512, 16, 4),
                  (2, 16, 16, 32, 2, 4), (2, 16, 16, 64, 4, 0),
                  (2, 16, 16, 128, 8, 4), (2, 8, 8, 256, 16, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("geom", ATTN_BWD_GEOMS)
@pytest.mark.parametrize("residual", [True, False])
def test_attention_bwd_kernel_on_card(geom, residual):
    dev = _cuda()
    B, H, W, C, nH, shift = geom
    inp = _attn_inputs(10, B, H, W, C, nH)
    x = _t(inp.pop("x"), dev).bfloat16().float()
    g = _t(np.random.default_rng(11).standard_normal((B, H, W, C))
           .astype(np.float32), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=shift, scale=32 ** -0.5, num_heads=nH,
              residual=residual)

    def run(fn):
        return lambda x, g, dt: fn(x, g, *prm[dt].values(), **kw)

    K.reset_counts()
    _check_grads(run(K.fused_attention_image_bwd),
                 run(K.attention_image_vjp_reference), x, g, geom)
    assert K.launch_counts()["attention_bwd"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("with_mod", [True, False])
@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("C,nH", [(16, 1), (32, 2), (128, 8), (64, 2)])
def test_attention_block_bwd_kernel_on_card(C, nH, shift, has_ln, with_mod):
    """The windowed backward (kernel 6 on (Bw, 64, C) windows) against the
    plain VJP: two 32^2 images of windows, head dim 16 (Uformer_T's enc0
    and others) and 32."""
    dev = _cuda()
    inp = _attn_inputs(16, 2, 32, 32, C, nH, with_mod)
    x = _t(inp.pop("x").reshape(-1, 64, C), dev).bfloat16().float()
    g = _t(np.random.default_rng(17).standard_normal(tuple(x.shape))
           .astype(np.float32), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=shift, H=32, W=32, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=has_ln)

    def run(fn):
        return lambda x, g, dt: fn(x, g, *prm[dt].values(), **kw)

    K.reset_counts()
    _check_grads(run(K.fused_attention_block_bwd),
                 run(K.attention_block_vjp_reference), x, g,
                 (C, nH, shift, has_ln, with_mod))
    assert K.launch_counts()["attention_block_bwd"] == 2
    assert K.plain_counts()["attention_block_bwd"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("C", [16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("residual,has_ln", [(True, True), (False, True),
                                             (False, False)])
def test_leff_bwd_kernel_on_card(C, residual, has_ln):
    dev = _cuda()
    shape = (2, 16, 16, C)
    inp = _leff_inputs(12, *shape, 4 * C)
    x = _t(inp.pop("x"), dev).bfloat16().float()
    g = _t(np.random.default_rng(13).standard_normal(shape)
           .astype(np.float32), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("w1", "wd", "w2"))
           for dt in (torch.float32, torch.bfloat16)}

    def run(fn):
        return lambda x, g, dt: fn(x, g, *(prm[dt][k] for k in (
            "w1", "b1", "wd", "bd", "w2", "ln_s", "ln_b")), has_ln=has_ln,
            residual=residual)

    K.reset_counts()
    _check_grads(run(K.fused_leff_bwd), run(K.leff_vjp_reference), x, g,
                 (C, residual, has_ln))
    assert K.launch_counts()["leff_bwd"] == 2


@pytest.mark.gpu
def test_backward_wrappers_refuse_bad_input_on_card():
    dev = _cuda()
    inp = _leff_inputs(14, 1, 8, 8, 32, 128)
    x = _t(inp["x"], dev)
    args = [_t(inp[k], dev) for k in ("w1", "b1", "wd", "bd", "w2", "ln_s",
                                      "ln_b")]
    with pytest.raises(ValueError):  # dy of another dtype
        K.fused_leff_bwd(x, x.bfloat16(), *args)
    with pytest.raises(TypeError):  # bf16 matrix under fp32 activations
        K.fused_leff_bwd(x, x, args[0].bfloat16(), *args[1:])
    ainp = _attn_inputs(15, 1, 16, 16, 64, 2)
    ax = _t(ainp.pop("x"), dev)
    aprm = [_t(v, dev) for v in ainp.values()]
    with pytest.raises(ValueError):  # C 64 over 3 heads: no head dim
        K.fused_attention_image_bwd(ax, ax, *aprm, win=8, shift=0,
                                    scale=0.125, num_heads=3)
    with pytest.raises(ValueError):  # not contiguous
        K.fused_attention_image_bwd(ax.transpose(1, 2), ax, *aprm, win=8,
                                    shift=0, scale=0.125, num_heads=2)
    wnd = ax.reshape(-1, 64, 64)
    bkw = dict(win=8, shift=0, H=16, W=16, scale=0.125, num_heads=2)
    with pytest.raises(ValueError, match="w_off"):  # the JAX kernel has none
        K.fused_attention_block_bwd(wnd, wnd, *aprm, **bkw, w_off=1)
    with pytest.raises(ValueError):  # head dim 8
        K.fused_attention_block_bwd(wnd, wnd, *aprm, **dict(bkw,
                                                            num_heads=8))
    with pytest.raises(ValueError):  # g of another dtype
        K.fused_attention_block_bwd(wnd, wnd.bfloat16(), *aprm, **bkw)
    assert K.plain_counts()["attention_bwd"] == 0
    assert K.plain_counts()["attention_block_bwd"] == 0
