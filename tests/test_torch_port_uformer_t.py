"""Uformer_T in the port: the window-attention core (`fused_window_attention`),
the windowed attention block (`fused_attention_block`), and the whole
model against the JAX package.

On the CPU the plain versions are held against the JAX package's jnp
references and its Pallas kernels run with interpret=True, on the same
numpy inputs (fp32, tolerance 1e-4 (1 + max|ref|)); full-depth Uformer_T
at 128^2 is held against JAX `Uformer_T` (jnp backend) on weights carried
by `state_dict_from_jax`, and its kernel dispatches are counted. The tests
marked `gpu` hold the CUDA kernels against their plain versions on the
card and skip without one: `python -m pytest -m gpu
tests/test_torch_port_uformer_t.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch import get_arch
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.train import (
    TrainState,
    blocks_without_backward_kernel,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(1)
TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops import attention, masks
    from uformer_tpu.ops.pallas import attention_block, window_attention

    return SimpleNamespace(jax=jax, jnp=jnp, attention=attention,
                           masks=masks, ab=attention_block,
                           wa=window_attention)


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(device, dtype)


def _close(got, *wants):
    for want in wants:
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=TOL * (1 + np.abs(want).max()),
                                   rtol=0)


def _qkv_inputs(seed, nH, Bw, D):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s) * 0.5).astype(np.float32)

    return dict(q=mk(nH, Bw, 64, D), k=mk(nH, Bw, 64, D), v=mk(nH, Bw, 64, D),
                bias=mk(nH, 64, 64))


def _block_inputs(seed, Bw, C, nH, with_mod=True):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s) * 0.3).astype(np.float32)

    return dict(x=mk(Bw, 64, C), mod=mk(64, C) if with_mod else None,
                ln_s=1.0 + 0.5 * mk(C), ln_b=0.5 * mk(C), wq=mk(C, C),
                bq=mk(C), wkv=mk(C, 2 * C), bkv=mk(2 * C), wo=mk(C, C),
                bo=mk(C), bias=mk(nH, 64, 64))


T_HEADS = (1, 2, 4, 8, 16, 16, 8, 4, 2)  # Uformer_T's, head dim 16
# an H != W image of 2 x 3 windows, batch 2: 12 windows
H_IMG, W_IMG, BW = 16, 24, 12


# ---- kernel 4: the window-attention core ---------------------------------

@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("nH", [1, 2])
@pytest.mark.parametrize("D", [16, 32])
def test_window_attention_reference_matches_jax(jx, D, nH, shift):
    inp = _qkv_inputs(0, nH, BW, D)
    kw = dict(win=8, shift=shift, H=H_IMG, W=W_IMG, scale=D ** -0.5)
    got = K.window_attention_reference(*map(_t, inp.values()), **kw)
    j = {k: jx.jnp.asarray(v) for k, v in inp.items()}
    kernel = jx.wa.fused_window_attention(*j.values(), interpret=True, **kw)
    # the jnp core on (Bw, nH, N, D) with the explicit shift mask
    mask = (jx.jnp.asarray(jx.masks.shift_window_mask(H_IMG, W_IMG, 8,
                                                      shift))
            if shift else None)
    jnp_out = jx.attention._window_attention_jnp(
        *(j[k].transpose(1, 0, 2, 3) for k in ("q", "k", "v")), j["bias"],
        mask, scale=D ** -0.5)
    jnp_out = np.asarray(jnp_out).reshape(BW, 64, nH, D).transpose(2, 0, 1, 3)
    _close(got, kernel, jnp_out)


# ---- kernel 5: the windowed attention block ------------------------------

@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("with_mod", [True, False])
@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("C,nH", [(16, 1), (32, 2)])
def test_attention_block_reference_matches_jax(jx, C, nH, has_ln, with_mod,
                                               shift):
    inp = _block_inputs(1, BW, C, nH, with_mod)
    kw = dict(win=8, shift=shift, H=H_IMG, W=W_IMG, scale=0.25,
              num_heads=nH, has_ln=has_ln)
    got = K.attention_block_reference(*map(_t, inp.values()), **kw)
    j = {k: None if v is None else jx.jnp.asarray(v) for k, v in inp.items()}
    kernel = jx.ab.fused_attention_block(*j.values(), interpret=True,
                                         packed=False, **kw)
    if j["mod"] is None:  # the jnp reference adds a modulator always
        j["mod"] = jx.jnp.zeros((64, C), jx.jnp.float32)
    _close(got, jx.ab.attention_block_reference(*j.values(), **kw), kernel)


def test_attention_block_window_offset_matches_jax(jx):
    """w_off places the windows inside a larger image (the spatial path):
    the jnp reference takes no offset, so only the interpret kernel."""
    inp = _block_inputs(2, 4, 32, 2)
    kw = dict(win=8, shift=4, H=H_IMG, W=W_IMG, scale=0.25, num_heads=2,
              has_ln=True, w_off=3)
    got = K.attention_block_reference(*map(_t, inp.values()), **kw)
    j = [jx.jnp.asarray(v) for v in inp.values()]
    _close(got, jx.ab.fused_attention_block(*j, interpret=True,
                                            packed=False, **kw))
    # and the offset matters: the same windows at place 0 differ
    at0 = K.attention_block_reference(*map(_t, inp.values()),
                                      **dict(kw, w_off=0))
    assert float((got - at0).abs().max()) > 1e-3


BLOCK_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
               "dwo", "dbo", "dbias")


# Uformer_T's enc0 (C 16, one head) at both shifts, LN and the modulator
# each way; and head dim 16 at four heads
@pytest.mark.parametrize("C,nH,shift,has_ln,with_mod", [
    (16, 1, s, ln, m) for s in (0, 4) for ln in (True, False)
    for m in (True, False)] + [(64, 4, 4, True, True)])
def test_attention_block_vjp_reference_matches_jax(jx, C, nH, shift, has_ln,
                                                   with_mod):
    """The windowed block's plain VJP (the CPU answer of
    `fused_attention_block_bwd`) against `jax.vjp` of the JAX reference
    (1e-4) and JAX's unpacked Pallas kernel 6 in interpret mode (2e-4,
    test_pallas_attention_block.py's budget), gradient by gradient."""
    inp = _block_inputs(10, BW, C, nH, with_mod)
    kw = dict(win=8, shift=shift, H=H_IMG, W=W_IMG, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=has_ln)
    g = (np.random.default_rng(11).standard_normal((BW, 64, C))
         .astype(np.float32))
    K.reset_counts()
    got = K.fused_attention_block_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_block_bwd"] == 1
    j = {k: None if v is None else jx.jnp.asarray(v) for k, v in inp.items()}
    kern = jx.ab.fused_attention_block_bwd(
        j["x"], jx.jnp.asarray(g), *list(j.values())[1:], has_mod=with_mod,
        interpret=True, packed=False, **kw)
    if j["mod"] is None:  # the jnp reference adds a modulator always
        j["mod"] = jx.jnp.zeros((64, C), jx.jnp.float32)
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ab.attention_block_reference(*a, **kw), *j.values())
    want = vjp(jx.jnp.asarray(g))
    for i, name in enumerate(BLOCK_GRADS):
        if (name == "dmod" and not with_mod) or (
                name in ("dln_s", "dln_b") and not has_ln):
            assert got[i] is None, name
            continue
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(want[i]), rtol=0,
            atol=TOL * (1 + np.abs(np.asarray(want[i])).max()), err_msg=name)
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(kern[i]), rtol=0,
            atol=2 * TOL * (1 + np.abs(np.asarray(kern[i])).max()),
            err_msg=f"{name} vs kernel")


def test_attention_block_ad_gives_the_plain_vjp_on_cpu(jx):
    """The backward of attention_block_ad on the CPU is the plain VJP
    (`fused_attention_block_bwd`'s plain call): torch autograd of the plain
    version, and JAX's VJP of its reference."""
    inp = _block_inputs(3, BW, 16, 1)
    kw = dict(win=8, shift=4, H=H_IMG, W=W_IMG, scale=0.25, num_heads=1,
              has_ln=True)
    g = np.random.default_rng(4).standard_normal((BW, 64, 16)) \
        .astype(np.float32)
    args = [_t(v).requires_grad_(True) for v in inp.values()]
    K.reset_counts()
    y = K.attention_block_ad(*args, **kw)
    (y * _t(g)).sum().backward()
    got = [a.grad for a in args]
    assert K.plain_counts()["attention_block"] == 1
    assert K.plain_counts()["attention_block_bwd"] == 1
    ref = [_t(v).requires_grad_(True) for v in inp.values()]
    (K.attention_block_reference(*ref, **kw) * _t(g)).sum().backward()
    j = [jx.jnp.asarray(v) for v in inp.values()]
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ab.attention_block_reference(*a, **kw), *j)
    want = vjp(jx.jnp.asarray(g))
    for i, (a, r, w) in enumerate(zip(got, ref, want)):
        _close(a, r.grad.numpy(), w)


# ---- the slice: full-depth Uformer_T -----------------------------------

@pytest.fixture(scope="module")
def uformer_t(jx):
    """JAX Uformer_T (jnp backend) with params drawn with numpy from a seed
    (every leaf N(0, 0.05^2), LayerNorm scales around 1) over the tree of
    eval_shape, and a seeded 128^2 input."""
    from uformer_tpu import get_arch as jax_get_arch

    x = np.random.default_rng(5).uniform(0, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    model = jax_get_arch({"arch": "Uformer_T", "attn_backend": "jnp"})
    jax = jx.jax
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jx.jnp.asarray(x))
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * rng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)
    return model, params, x


def test_state_dict_from_jax_carries_uformer_t(uformer_t):
    from uformer_tpu.convert.torch_exporter import export_uformer
    from uformer_tpu_torch.convert import state_dict_from_jax

    _, params, _ = uformer_t
    sd = state_dict_from_jax(params)
    want = export_uformer(params)
    assert list(sd) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    get_arch({"arch": "Uformer_T"}).load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=True)


def test_uformer_t_matches_jax_and_routes(jx, uformer_t):
    from uformer_tpu_torch.convert import state_dict_from_jax

    model, params, x = uformer_t
    want = np.asarray(jx.jax.jit(model.apply)(params, jx.jnp.asarray(x)))
    port = get_arch({"arch": "Uformer_T", "train_ps": 128}).eval()
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          state_dict_from_jax(params).items()}, strict=True)
    K.reset_counts()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want)
    assert K.plain_counts() == {
        "stage": 4, "attention_image": 8, "leff": 10, "attention_bwd": 0,
        "attention_block_bwd": 0, "leff_bwd": 0, "window_attention": 0,
        "attention_block": 2, "dwconv3x3": 0, "dwconv3x3_qkv": 0}
    assert set(K.launch_counts().values()) == {0}


def test_uformer_t_routes_the_same_at_256():
    """At train_ps 256 (the served configuration) the same stages take
    each route, and the shifted enc0 block takes the windowed kernel."""
    model = get_arch({"arch": "Uformer_T", "train_ps": 256}).eval()
    routes = {}
    for name, layer in model.named_children():
        if not hasattr(layer, "blocks"):
            continue
        x = torch.empty(1, layer.resolution, layer.resolution, layer.dim)
        routes[name] = ("stage" if layer.uses_stage(x) else
                        tuple("image" if b.image_route else "windowed"
                              for b in layer.blocks))
    assert routes == {
        "encoderlayer_0": ("windowed", "windowed"),
        "encoderlayer_1": ("image", "image"),
        "encoderlayer_2": ("image", "image"),
        "encoderlayer_3": "stage", "conv": "stage",
        "decoderlayer_0": "stage", "decoderlayer_1": "stage",
        "decoderlayer_2": ("image", "image"),
        "decoderlayer_3": ("image", "image")}
    assert model.encoderlayer_0.blocks[1].shift_size == 4


def test_registry_refuses_what_the_kernels_do_not_take():
    """The registry builds every arch of the JAX registry: UNet (no LeWin
    block, so nothing for the kernels to refuse) and checkpointed models
    too. It builds Uformer at any geometry for the CPU; the card's kernel
    path refuses a head dim or window its kernels do not take
    (`blocks_without_backward_kernel`, naming the ROADMAP item)."""
    assert get_arch({"arch": "Uformer_T"}).encoderlayer_0.dim == 16
    assert blocks_without_backward_kernel(get_arch({"arch": "UNet"})) == []
    ck = get_arch({"arch": "Uformer_T", "use_checkpoint": True})
    assert ck.encoderlayer_0.use_checkpoint and \
        blocks_without_backward_kernel(ck) == []
    for opt in ({"arch": "Uformer", "embed_dim": 64},
                {"arch": "Uformer", "embed_dim": 16, "win_size": 4}):
        model = get_arch(opt)
        assert model.encoderlayer_0.dim == opt["embed_dim"]
        assert model.encoderlayer_0.blocks[0].win_size == \
            opt.get("win_size", 8)
        uncovered = blocks_without_backward_kernel(model)
        assert len(uncovered) == 18
        gap = model.get_submodule(uncovered[0]).backward_gap
        assert "ROADMAP.md, port queue 2 items 2-3" in gap


def test_train_guard_names_the_uncovered_blocks():
    """The kernel path trains every block the backward kernels cover: the
    image route and the windowed branch at head dim 16 or 32. Every
    registry arch is covered; a conv-projection model and other head dims
    are not."""
    from uformer_tpu_torch.models import Uformer
    from uformer_tpu_torch.models.registry import ARCHS

    for arch in ARCHS:
        assert blocks_without_backward_kernel(
            get_arch({"arch": arch, "train_ps": 128})) == [], arch
    conv = Uformer(img_size=128, embed_dim=16, depths=(1,) * 9,
                   num_heads=T_HEADS, token_projection="conv")
    assert len(blocks_without_backward_kernel(conv)) == 9
    narrow = Uformer(img_size=128, embed_dim=8, depths=(1,) * 9,
                     num_heads=T_HEADS)
    assert blocks_without_backward_kernel(narrow)[0] == \
        "encoderlayer_0.blocks.0"


# one Uformer_T train step at 128^2: per kernel, its forward and backward
T_STEP = {"stage": 0, "attention_image": 16, "attention_block": 2,
          "leff": 18, "attention_bwd": 16, "attention_block_bwd": 2,
          "leff_bwd": 18, "window_attention": 0, "dwconv3x3": 0,
          "dwconv3x3_qkv": 0}


def test_uformer_t_train_routing_counts():
    """Uformer_T (train_ps 128) in training: 16 attention-image, 2
    attention-block (enc0) and 18 LeFF forwards, and as many backwards, no
    stage kernel (plain versions on the CPU, counted apart from
    launches)."""
    model = get_arch({"arch": "Uformer_T", "train_ps": 128}).train()
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    K.reset_counts()
    y = model(x, generator=torch.Generator().manual_seed(1))
    (y - x).abs().mean().backward()
    assert K.plain_counts() == T_STEP
    assert set(K.launch_counts().values()) == {0}
    assert all(p.grad is not None for p in model.parameters())


# a Uformer_T-width model (embed 16, Uformer_T's heads: head dim 16
# everywhere) with depths cut: enc0 runs the windowed branch and dec3 the
# image route, each at shift 0 and 4
T_SMALL = dict(img_size=128, embed_dim=16, depths=(2, 1, 1, 1, 1, 1, 1, 1, 2),
               num_heads=T_HEADS, win_size=8, modulator=True)


def test_uformer_t_width_train_step_matches_jax(jx):
    """One train step of the T_SMALL model against JAX make_train_step
    (drop path 0, no mixup) from seeded params on one batch: loss, every
    gradient and every parameter's update (AdamW, lr 1e-3, weight decay on
    every parameter); the windowed branch's backward is
    `fused_attention_block_bwd`'s plain call, the image route's
    `fused_attention_image_bwd`'s."""
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep
    from uformer_tpu_torch.convert import load_numpy_state_dict, \
        state_dict_from_jax
    from uformer_tpu_torch.models import Uformer

    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(12)
    batch = {k: rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
             for k in ("input", "target")}
    model = JaxUformer(attn_backend="jnp", drop_path_rate=0.0, **T_SMALL)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(batch["input"]))
    prng = np.random.default_rng(13)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * prng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        pred = model.apply(p, jb["input"], deterministic=False,
                           rngs={"dropout": jax.random.split(key)[1]})
        return jloss(pred, jb["target"])

    grads = state_dict_from_jax(jax.jit(jax.grad(loss_fn))(params))
    state = JState.create(params, jopt(lambda s: 1e-3))
    new, jloss_val = jax.jit(jstep(model))(state, jb, key)
    before = state_dict_from_jax(params)
    after = state_dict_from_jax(new.params)

    port = load_numpy_state_dict(Uformer(drop_path_rate=0.0, **T_SMALL),
                                 before)
    pstate = TrainState(port, make_optimizer(port.parameters(),
                                             lambda s: 1e-3))
    K.reset_counts()
    loss = make_train_step(port)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jloss_val), rtol=1e-5)
    counts = K.plain_counts()
    assert (counts["attention_block"], counts["attention_block_bwd"],
            counts["attention_bwd"], counts["leff_bwd"]) == (2, 2, 9, 11)
    for name, prm in port.named_parameters():
        _close(prm.grad, grads[name])
        # the update within 2e-3 lr plus four float32 spacings of the
        # parameter (test_torch_port_train.py:_close_update), plus what the
        # gradients' difference moves Adam's first update lr g / (|g| +
        # eps): at most lr |dg| / (|g| + eps), which counts where |g| is
        # near eps (1e-8; some conv weights here)
        b, g = np.asarray(before[name]), np.asarray(grads[name])
        err = np.abs((prm.detach().numpy() - b) - (np.asarray(after[name])
                                                   - b))
        tol = 1e-3 * (2e-3 + np.abs(prm.grad.numpy() - g)
                      / (np.abs(g) + 1e-8)) + 4 * np.spacing(np.abs(b))
        assert np.all(err <= tol), (name, float((err - tol).max()))


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


@pytest.mark.gpu
@pytest.mark.parametrize("D,nH,shift", [(16, 1, 4), (16, 2, 0), (32, 2, 4),
                                        (32, 1, 0)])
def test_window_attention_kernel_on_card(D, nH, shift):
    dev = _cuda()
    inp = _qkv_inputs(7, nH, 2 * 32, D)  # two 32 x 64 images of windows
    q, k, v, bias = (_t(a, dev).bfloat16().float() for a in inp.values())
    kw = dict(win=8, shift=shift, H=32, W=64, scale=D ** -0.5)

    def run(fn):
        return lambda q, dt: fn(q.to(dt), k.to(dt), v.to(dt), bias, **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_window_attention),
                  run(K.window_attention_reference), q)
    assert K.launch_counts()["window_attention"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("C,nH,shift,has_ln,with_mod", [
    (16, 1, 4, False, False), (16, 1, 0, True, True),
    (32, 2, 4, True, False), (64, 2, 4, False, True),
    (128, 8, 4, True, True)])
def test_attention_block_kernel_on_card(C, nH, shift, has_ln, with_mod):
    dev = _cuda()
    inp = _block_inputs(8, 2 * 16, C, nH, with_mod)  # two 32^2 images
    x = _t(inp.pop("x"), dev).bfloat16().float()
    low = ("mod", "wq", "wkv", "wo")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in inp.items()}
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=shift, H=32, W=32, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=has_ln)

    def run(fn):
        return lambda x, dt: fn(x, *prm[dt].values(), **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_attention_block),
                  run(K.attention_block_reference), x)
    assert K.launch_counts()["attention_block"] == 2


@pytest.mark.gpu
def test_uformer_t_train_step_launches_on_card():
    """A Uformer_T train step on the card runs every attention and LeFF
    sub-block forward and backward through the kernels (the windowed
    block's backward included), with no plain call, and gives finite
    gradients."""
    dev = _cuda()
    torch.manual_seed(0)
    model = get_arch({"arch": "Uformer_T", "train_ps": 128}).to(dev)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 1e-4))
    step = make_train_step(model)
    x = torch.rand(2, 128, 128, 3, device=dev)
    K.reset_counts()
    loss = step(state, {"input": x, "target": x}, torch.Generator())
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert K.launch_counts() == T_STEP
    assert set(K.plain_counts().values()) == {0}
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
