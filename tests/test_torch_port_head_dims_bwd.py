"""Head dims 24, 40, 48 and 56 in the backward: `--arch Uformer
--embed_dim 48` and `--embed_dim 24` (heads 1-2-4-8-16-16-8-4-2, every
block at head dim 48 or 24, C 24-768, none a power of two) train through
the kernels: kernel 1 and its VJP, kernel 6 in every layout, kernel 7 at
widths that are not powers of two.

On the CPU, with numpy inputs from a seed and fp32 throughout, each within
1e-4 (1 + max|ref|):
  - the windowed block's plain VJP (`attention_block_vjp_reference`, the
    CPU answer of `fused_attention_block_bwd`) at head dims 24 and 48, C
    24, 48, 96 and 192, windows 8, 4 and 16, LN and modulator each way,
    against `jax.vjp` of JAX's reference, and at one cheap shape a window
    against JAX's Pallas `fused_attention_block_bwd` (interpret mode): all
    eleven outputs;
  - kernel 1's plain version and its VJP at C 384 (8 heads of 48, 16 of
    24) on 16^2, shift 0 and 4, against JAX's reference and `jax.vjp`,
    and on one case against JAX's Pallas kernel 1 and kernel 6 (interpret
    mode) as JAX's custom VJP runs them (`attention_image.py:482-520`);
  - LeFF's plain VJP at C 24 (hidden 96) and C 48, LN and residual each
    way, against JAX's `fused_leff_bwd` (interpret mode) and `jax.vjp`;
    and `fused_leff_bwd`'s hidden padding: the plain VJP on the padded
    weights, sliced back, equal bit for bit to the unpadded one;
  - the plain-path train steps of the embed-48 and embed-24 Uformer
    (depths cut to 1, as tests/test_torch_port_family.py cuts them) at
    128^2 against JAX's `make_train_step` (attn_backend "jnp") on the same
    weights: loss, every gradient, every parameter's update, and the
    launch routes (the plain calls of kernels 1, 5, 2, 6 and 7);
  - the limits: every block of the embed 24, 40, 48 and 56 models has a
    backward kernel; head dims 12, 20 and 128 are refused everywhere,
    naming ROADMAP queue 2 item 9; kernel 4 still refuses 24-56 at
    windows 1-8 and takes them above (`window_attention_head_dims`).
The tests marked `gpu` hold each extended kernel against its plain
version on the card (`python -m pytest -m gpu
tests/test_torch_port_head_dims_bwd.py`), within `chip_smoke.py`'s
bounds.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.layers import GEOMETRY_NOT_ON_KERNEL_PATH
from uformer_tpu_torch.models.registry import arch_config, get_arch
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels.attention_image import _check_geometry
from uformer_tpu_torch.ops.kernels.leff import pad_hidden
from uformer_tpu_torch.ops.kernels.window_attention import (
    HEAD_DIMS,
    WINDOW_ATTENTION_HEAD_DIMS,
    window_attention_head_dims,
    check_head_dim,
)
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel

torch.set_num_threads(1)
TOL = 1e-4
NEW_DIMS = (24, 40, 48, 56)
ITEM9 = "ROADMAP.md, port queue 2 item 9"
ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
LEFF_GRADS = ("dx", "dw1", "db1", "dwd", "dbd", "dw2", "db2", "dln_s",
              "dln_b")
E48 = {"arch": "Uformer", "embed_dim": 48, "train_ps": 128}
E24 = {"arch": "Uformer", "embed_dim": 24, "train_ps": 128}


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops import window
    from uformer_tpu.ops.pallas import attention_block, attention_image, leff

    return SimpleNamespace(jax=jax, jnp=jnp, ab=attention_block,
                           ai=attention_image, leff=leff, window=window)


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


def _attn_inputs(seed, C, nH, N, x_shape, with_mod=True):
    """x, g and the weights of an attention sub-block, matrices scaled by
    fan-in as a trained block's are."""
    rng = np.random.default_rng(seed)

    def mk(*s, scale=0.3):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    inp = dict(x=mk(*x_shape, scale=1.0), mod=mk(N, C) if with_mod else None,
               ln_s=1.0 + mk(C), ln_b=mk(C),
               wq=mk(C, C, scale=1.0) / np.sqrt(C), bq=0.1 * mk(C),
               wkv=mk(C, 2 * C, scale=1.0) / np.sqrt(C),
               bkv=0.1 * mk(2 * C), wo=mk(C, C, scale=1.0) / np.sqrt(C),
               bo=0.1 * mk(C), bias=mk(nH, N, N))
    return inp, mk(*x_shape, scale=1.0)


def _check_attn(got, wants, has_ln, with_mod=True):
    for i, name in enumerate(ATTN_GRADS):
        if (name in ("dln_s", "dln_b") and not has_ln) or \
                (name == "dmod" and not with_mod):
            assert got[i] is None, name
            continue
        for label, want in wants.items():
            _close(got[i], want[i], f"{name} vs {label}")


# ---- kernel 6 in the windowed layout ---------------------------------------

# (head dim, heads, win, has_ln, with_mod, H, against JAX's kernel too):
# windows of an H x H image
BLOCK_CASES = {
    "D24 C24 win8": (24, 1, 8, True, True, 16, True),
    "D24 C96 win8": (24, 4, 8, False, False, 16, False),
    "D48 C48 win8": (48, 1, 8, False, True, 16, False),
    "D48 C192 win8": (48, 4, 8, True, True, 16, False),
    "D24 C48 win4": (24, 2, 4, True, False, 8, True),
    "D48 C96 win4": (48, 2, 4, False, True, 8, False),
    "D24 C24 win16": (24, 1, 16, False, True, 32, True),
    "D48 C48 win16": (48, 1, 16, True, True, 32, False),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_attention_block_vjp_new_head_dims_matches_jax(jx, case):
    D, nH, win, has_ln, with_mod, H, kernel = BLOCK_CASES[case]
    C, N, Bw = D * nH, win * win, (H // win) ** 2
    inp, g = _attn_inputs(200 + D + nH + win, C, nH, N, (Bw, N, C),
                          with_mod)
    kw = dict(win=win, shift=win // 2, H=H, W=H, scale=D ** -0.5,
              num_heads=nH, has_ln=has_ln)
    K.reset_counts()
    got = K.fused_attention_block_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_block_bwd"] == 1
    j = {k: None if v is None else jx.jnp.asarray(v) for k, v in inp.items()}
    if j["mod"] is None:
        j["mod"] = jx.jnp.zeros((N, C), jx.jnp.float32)
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ab.attention_block_reference(*a, **kw), *j.values())
    wants = {"jax.vjp": vjp(jx.jnp.asarray(g))}
    if kernel:
        wants["kernel"] = jx.ab.fused_attention_block_bwd(
            *list(j.values())[:1], jx.jnp.asarray(g), *list(j.values())[1:],
            has_mod=with_mod, interpret=True, packed=False, **kw)
    _check_attn(got, wants, has_ln, with_mod)


# ---- kernel 1 and its VJP (kernel 6 in the image layout) -------------------

@pytest.mark.parametrize("nH,shift", [(8, 0), (8, 4), (16, 0), (16, 4)])
def test_attention_image_new_head_dims_matches_jax(jx, nH, shift):
    """Kernel 1's plain version and its VJP at C 384 on 16^2 against JAX's
    reference and `jax.vjp`; at 8 heads (head dim 48) and shift 4 also
    against JAX's Pallas kernel 1 and kernel 6 (interpret mode) on the
    shifted, partitioned windows, as JAX's custom VJP runs them."""
    C, side = 384, 16
    inp, g = _attn_inputs(210 + nH + shift, C, nH, 64, (1, side, side, C))
    kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH,
              has_ln=True, residual=True)
    K.reset_counts()
    y = K.fused_attention_image(*map(_t, inp.values()), **kw)
    got = K.fused_attention_image_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_image"] == 1
    assert K.plain_counts()["attention_bwd"] == 1
    j = [jx.jnp.asarray(v) for v in inp.values()]
    jg = jx.jnp.asarray(g)
    want_y, vjp = jx.jax.vjp(
        lambda *a: jx.ai.attention_image_reference(*a, **kw), *j)
    _close(y, want_y, "forward vs reference")
    wants = {"jax.vjp": vjp(jg)}
    if nH == 8 and shift == 4:
        _close(y, jx.ai.fused_attention_image(*j, interpret=True, **kw),
               "forward vs kernel 1")
        w = jx.window

        def part(v):
            return w.window_partition(w.cyclic_shift(v, shift), 8)

        kern = list(jx.ab.fused_attention_block_bwd(
            part(j[0]), part(jg), *j[1:], win=8, shift=shift, H=side,
            W=side, scale=kw["scale"], num_heads=nH, has_ln=True,
            has_mod=True, interpret=True, packed=False))
        kern[0] = w.cyclic_unshift(w.window_reverse(kern[0], 8, side, side),
                                   shift) + jg
        wants["kernel"] = kern
    _check_attn(got, wants, True)


# ---- kernel 7 at widths that are no power of two ---------------------------

def _leff_inputs(seed, C, Ch, x_shape):
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    inp = dict(x=mk(*x_shape), w1=mk(C, Ch) / np.sqrt(C),
               b1=mk(Ch, scale=0.1), wd=mk(3, 3, Ch) / 3.0,
               bd=mk(Ch, scale=0.1), w2=mk(Ch, C) / np.sqrt(Ch),
               b2=mk(C, scale=0.1), ln_s=1.0 + mk(C, scale=0.1),
               ln_b=mk(C, scale=0.1))
    return inp, mk(*x_shape)


@pytest.mark.parametrize("C,has_ln,residual", [
    (24, True, True), (24, True, False), (24, False, True),
    (24, False, False), (48, True, True), (48, False, False)])
def test_leff_vjp_new_widths_matches_jax_kernel(jx, C, has_ln, residual):
    Ch = 4 * C
    inp, dy = _leff_inputs(220 + C + 2 * has_ln + residual, C, Ch,
                           (1, 8, 12, C))
    names = list(inp)
    K.reset_counts()
    got = K.fused_leff_bwd(_t(inp["x"]), _t(dy),
                           *(_t(inp[k]) for k in names[1:6]),
                           _t(inp["ln_s"]), _t(inp["ln_b"]), has_ln=has_ln,
                           residual=residual)
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


@pytest.mark.parametrize("has_ln", [True, False])
def test_leff_vjp_padded_hidden_is_exact(has_ln):
    """`fused_leff_bwd` pads a hidden of 96 (C 24) to 128 on the card and
    slices the gradients back: the plain VJP on the padded weights, so
    sliced, equals the unpadded one bit for bit (GELU(0) = 0, the padded
    rows of w2 are zero)."""
    C, Ch = 24, 96
    inp, dy = _leff_inputs(230 + has_ln, C, Ch, (2, 8, 16, C))
    w = [_t(inp[k]) for k in ("w1", "b1", "wd", "bd", "w2")]
    padded = pad_hidden(*w)
    assert padded[0].shape == (C, 128)
    x, g = _t(inp["x"]), _t(dy)
    ln = (_t(inp["ln_s"]), _t(inp["ln_b"]))
    want = K.leff_vjp_reference(x, g, *w, *ln, has_ln=has_ln,
                                residual=True)
    got = K.leff_vjp_reference(x, g, *padded, *ln, has_ln=has_ln,
                               residual=True)
    cut = (slice(None), (slice(None), slice(0, Ch)), slice(0, Ch),
           (Ellipsis, slice(0, Ch)), slice(0, Ch), slice(0, Ch),
           slice(None), slice(None), slice(None))
    for name, a, b, s in zip(LEFF_GRADS, got, want, cut):
        if b is None:
            assert a is None, name
            continue
        assert torch.equal(a[s], b), name


# ---- the embed-48 and embed-24 models' train steps against JAX -------------

# (construction options at depth 1 a stage, plain calls of a step by the
# port's routes, JAX's `layers.py:771-775`: the image route where C % 128
# == 0, the windowed branch elsewhere)
STEP_CASES = {
    "e48": (E48, dict(attention_image=4, attention_bwd=4, attention_block=5,
                      attention_block_bwd=5, leff=9, leff_bwd=9)),
    "e24": (E24, dict(attention_image=2, attention_bwd=2, attention_block=7,
                      attention_block_bwd=7, leff=9, leff_bwd=9)),
}


def _shallow(opt):
    return dict(arch_config(opt), depths=(1,) * 9)


@pytest.fixture(scope="module")
def jax_steps(jx):
    """One JAX train step (drop path 0, no mixup, lr 1e-3) per case from
    seeded params on one 128^2 batch: params before and after, loss and
    gradients (one compiled program a case: the step and the gradients of
    its loss)."""
    from uformer_tpu import get_arch as jax_get_arch
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep

    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(240)
    batch = {k: rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
             for k in ("input", "target")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    out = {}
    for label, (opt, _) in STEP_CASES.items():
        model = jax_get_arch(dict(opt, attn_backend="jnp")).clone(
            depths=(1,) * 9, drop_path_rate=0.0)
        shapes = jax.eval_shape(model.init, key, jb["input"])
        prng = np.random.default_rng(241)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: (0.05 * prng.standard_normal(a.shape) + (
                jax.tree_util.keystr(path).endswith("['scale']")))
            .astype(np.float32), shapes)

        def loss(p, model=model):
            pred = model.apply(p, jb["input"], deterministic=False,
                               rngs={"dropout": jax.random.split(key)[1]})
            return jloss(pred, jb["target"])

        def both(state, model=model, loss=loss):
            new, value = jstep(model)(state, jb, key)
            return new.params, value, jax.grad(loss)(state.params)

        state = JState.create(params, jopt(lambda s: 1e-3))
        new, loss_val, grads = jax.jit(both)(state)
        out[label] = SimpleNamespace(
            before=state_dict_from_jax(params),
            after=state_dict_from_jax(new), loss=float(loss_val),
            grads=state_dict_from_jax(grads))
    return SimpleNamespace(batch=batch, steps=out)


@pytest.mark.parametrize("label", list(STEP_CASES))
def test_new_head_dims_train_step_matches_jax(jax_steps, label):
    """The port's plain-path step (the CPU answer of the kernel path)
    against JAX's: loss, every gradient within dg = 1e-4 max(1, max|g|),
    every parameter's update within 2e-3 lr plus four float32 spacings
    plus the most that a gradient error of dg moves a first Adam step,
    lr g / (|g| + eps): lr eps dg / (|g| - dg + eps)^2 where |g| > dg,
    else 2 lr (the gradient's sign is within its tolerance). The plain
    calls are the kernel path's launches by the port's routes."""
    opt, routes = STEP_CASES[label]
    s = jax_steps.steps[label]
    model = Uformer(**dict(_shallow(opt), drop_path_rate=0.0))
    D = opt["embed_dim"]
    assert {b.dim // b.num_heads for n, b in model.named_modules()
            if n.endswith("blocks.0")} == {D}
    load_numpy_state_dict(model, s.before)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda k: 1e-3))
    batch = {k: torch.from_numpy(v) for k, v in jax_steps.batch.items()}
    K.reset_counts()
    loss = make_train_step(model)(state, batch,
                                  torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), s.loss, rtol=1e-5)
    counts = K.plain_counts()
    assert {k: counts[k] for k in routes} == routes
    lr, eps = 1e-3, 1e-8
    for name, prm in model.named_parameters():
        want = np.asarray(s.grads[name])
        g_tol = TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(prm.grad.numpy(), want, rtol=0,
                                   atol=g_tol, err_msg=name)
        before = np.asarray(s.before[name])
        err = np.abs((prm.detach().numpy() - before)
                     - (np.asarray(s.after[name]) - before))
        g = np.abs(want)
        adam = np.where(g > g_tol, lr * eps * g_tol
                        / (np.maximum(g - g_tol, 0.0) + eps) ** 2, 2 * lr)
        tol = 2e-3 * lr + 4 * np.spacing(np.abs(before)) + adam
        assert np.all(err <= tol), (name, float((err - tol).max()))


# ---- the limits ------------------------------------------------------------

@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("win", [8, 4, 16])
def test_new_head_dims_have_a_backward_kernel_everywhere(D, win):
    """Every block of Uformer at embed D (heads 1-16, head dim D in every
    block) and window `win` is covered by a backward kernel; kernels 1, 5
    and 6 take head dim D at every C the family builds."""
    model = get_arch({"arch": "Uformer", "embed_dim": D, "win_size": win,
                      "train_ps": 128})
    assert {b.dim // b.num_heads for n, b in model.named_modules()
            if n.endswith("blocks.0")} == {D}
    assert blocks_without_backward_kernel(model) == []
    for nH in (1, 2, 4, 8, 16):
        check_head_dim(D * nH, nH)
        _check_geometry(torch.empty(1, 8, 8, D * nH), 8, 4, nH)


@pytest.mark.parametrize("D", [12, 20, 128])
def test_other_head_dims_still_refused(D):
    """A head dim that is no multiple of 8 has no kernel either way, and
    one above 64 none above window 8 or in kernel 4 (ROADMAP queue 2 item
    9; at windows 1-8 kernels 1, 5 and 6 take 72-128,
    tests/test_torch_port_head_dims_bwd_above64.py): the wrappers' checks
    raise, and a model at embed 20 (head dim 20 in every block) has no
    backward kernel for any block."""
    for dims in (HEAD_DIMS, WINDOW_ATTENTION_HEAD_DIMS):
        for nH in (1, 4, 16):
            with pytest.raises(ValueError, match=ITEM9):
                check_head_dim(D * nH, nH, dims)
    if D == 20:
        model = Uformer(img_size=128, embed_dim=20, depths=(1,) * 9)
        uncovered = blocks_without_backward_kernel(model)
        assert len(uncovered) == 9
        gap = model.get_submodule(uncovered[0]).backward_gap
        assert gap == GEOMETRY_NOT_ON_KERNEL_PATH and ITEM9 in gap


@pytest.mark.parametrize("D", NEW_DIMS)
def test_window_attention_still_refuses_new_head_dims(D):
    """Kernel 4 (no model path calls it) keeps its own head dims at
    windows 1-8: its bf16 register core has no body for 24-56 (ROADMAP
    queue 2 item 9). Above window 8 its wide core takes them."""
    assert WINDOW_ATTENTION_HEAD_DIMS == (8, 16, 32, 64)
    assert D in HEAD_DIMS
    assert window_attention_head_dims(64) == WINDOW_ATTENTION_HEAD_DIMS
    with pytest.raises(ValueError, match=ITEM9):
        check_head_dim(D, 1, WINDOW_ATTENTION_HEAD_DIMS)
    check_head_dim(D, 1, window_attention_head_dims(81))


# ---- the kernels on the card -----------------------------------------------

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
    (chip_smoke.py:pooled_grad_bound); the bf16 kernel run twice on the
    last draw gives equal bits."""
    runs = [(fused(x, g, torch.float32), plain(x, g, torch.float32),
             plain(x.bfloat16(), g.bfloat16(), torch.bfloat16),
             fused(x.bfloat16(), g.bfloat16(), torch.bfloat16))
            for x, g in draws]
    x, g = draws[-1]
    again = fused(x.bfloat16(), g.bfloat16(), torch.bfloat16)
    for i, name in enumerate(names):
        if runs[0][1][i] is None:
            assert all(r[0][i] is None and r[3][i] is None for r in runs)
            continue
        assert torch.equal(again[i], runs[-1][3][i]), name
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


def _model_like(seed):
    """Operand makers by the golden weights' rule (as chip_smoke.py's
    seeded models): matrices N(0, 1 / fan-in), LayerNorm scales 1 +
    N(0, 0.05²), biases N(0, 0.02²); inputs N(0, 1)."""
    rng = np.random.default_rng(seed)

    def mat(*shape, fan_in=1):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def scale(n):
        return (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)

    def bias(n):
        return (0.02 * rng.standard_normal(n)).astype(np.float32)

    return mat, scale, bias


def _draws(seed, *shape):
    mat, _, _ = _model_like(seed)
    return [tuple(torch.from_numpy(mat(*shape)).cuda().bfloat16().float()
                  for _ in range(2)) for _ in range(DRAWS)]


def _attn_prm(seed, C, nH, N, dev, with_mod=True):
    mat, scale, bias = _model_like(seed)
    p = dict(mod=mat(N, C, fan_in=C) if with_mod else None, ln_s=scale(C),
             ln_b=bias(C), wq=mat(C, C, fan_in=C), bq=bias(C),
             wkv=mat(C, 2 * C, fan_in=C), bkv=bias(2 * C),
             wo=mat(C, C, fan_in=C), bo=bias(C),
             bias=mat(nH, N, N, fan_in=nH))
    low = ("mod", "wq", "wkv", "wo")
    return {dt: [_t(v, dev, dt if k in low else torch.float32)
                 for k, v in p.items()]
            for dt in (torch.float32, torch.bfloat16)}


# kernel 6 windowed: (win, head dim, heads, has_ln, with_mod, windows):
# window 8 at every (D, heads) of C 24-192 (LN and modulator), packed
# window 4 and wide window 16 at two (D, heads) each
BWD_BLOCK_CASES = (
    [(8, D, nH, True, True, 40) for D in NEW_DIMS for nH in (1, 2, 4, 8)
     if D * nH <= 192]
    + [(4, 24, 4, True, False, 35), (4, 56, 1, False, True, 35),
       (16, 48, 2, True, True, 8), (16, 40, 1, False, True, 8)])


@pytest.mark.gpu
@pytest.mark.parametrize("win,D,nH,has_ln,with_mod,Bw", BWD_BLOCK_CASES)
def test_attention_block_bwd_kernel_new_head_dims(win, D, nH, has_ln,
                                                  with_mod, Bw):
    dev = _cuda()
    N, C = win * win, D * nH
    prm = _attn_prm(250 + D + nH, C, nH, N, dev, with_mod)
    kw = dict(win=win, shift=win // 2, H=16 * win, W=16 * win,
              scale=D ** -0.5, num_heads=nH, has_ln=has_ln)
    K.reset_counts()
    _check_bwd(lambda x, g, dt: K.fused_attention_block_bwd(
                   x, g, *prm[dt], **kw),
               lambda x, g, dt: K.attention_block_vjp_reference(
                   x, g, *prm[dt], **kw),
               _draws(251, Bw, N, C), ATTN_GRADS)
    assert K.launch_counts()["attention_block_bwd"] == 2 * DRAWS + 1


@pytest.mark.gpu
@pytest.mark.parametrize("C,nH,shift,residual", [
    (384, 8, 4, True), (384, 16, 0, False), (640, 16, 4, True),
    (768, 16, 4, True), (896, 16, 0, True)])
def test_attention_image_kernels_new_head_dims(C, nH, shift, residual):
    """Kernel 1 and its VJP at the image route's widths of the embed 24-56
    models (C 384-896), on 2 x 16^2."""
    dev = _cuda()
    prm = _attn_prm(260 + C // nH, C, nH, 64, dev)
    kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH,
              residual=residual)
    draws = _draws(261, 2, 16, 16, C)
    x32 = draws[0][0]
    ref = K.attention_image_reference(x32, *prm[torch.float32], **kw)
    K.reset_counts()
    y = K.fused_attention_image(x32, *prm[torch.float32], **kw)
    assert float((y - ref).abs().max()) <= TOL * (1 + float(ref.abs().max()))
    y16 = K.fused_attention_image(x32.bfloat16(), *prm[torch.bfloat16], **kw)
    p16 = K.attention_image_reference(x32.bfloat16(), *prm[torch.bfloat16],
                                      **kw)
    assert float((y16.float() - ref).abs().max()) <= \
        1.5 * float((p16.float() - ref).abs().max()) + 1e-3
    assert K.launch_counts()["attention_image"] == 2
    _check_bwd(lambda x, g, dt: K.fused_attention_image_bwd(
                   x, g, *prm[dt], **kw),
               lambda x, g, dt: K.attention_image_vjp_reference(
                   x, g, *prm[dt], **kw), draws, ATTN_GRADS)


@pytest.mark.gpu
@pytest.mark.parametrize("C", sorted({D * nH for D in NEW_DIMS
                                      for nH in (1, 2, 4, 8, 16)}))
def test_leff_bwd_kernel_new_widths(C):
    """Kernel 7 at every C of the new head dims (hidden 4C; 96, 160 and
    224 padded by the wrapper), LN and residual each way, on 12 x 20."""
    dev = _cuda()
    Ch = 4 * C
    mat, scale, bias = _model_like(270 + C)
    inp = dict(w1=mat(C, Ch, fan_in=C), b1=bias(Ch),
               wd=mat(3, 3, Ch, fan_in=9), bd=bias(Ch),
               w2=mat(Ch, C, fan_in=Ch), ln_s=scale(C), ln_b=bias(C))
    low = ("w1", "wd", "w2")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in inp.items()}
           for dt in (torch.float32, torch.bfloat16)}
    for has_ln, residual in ((True, True), (False, False)):
        def run(fn, has_ln=has_ln, residual=residual):
            def call(x, g, dt):
                p = prm[dt]
                return fn(x, g, *(p[k] for k in ("w1", "b1", "wd", "bd",
                                                 "w2")),
                          p["ln_s"], p["ln_b"], has_ln=has_ln,
                          residual=residual)
            return call

        K.reset_counts()
        _check_bwd(run(K.fused_leff_bwd), run(K.leff_vjp_reference),
                   _draws(271, 2, 12, 20, C), LEFF_GRADS)
        assert K.launch_counts()["leff_bwd"] == 2 * DRAWS + 1


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(STEP_CASES))
def test_new_head_dims_step_runs_through_the_kernels(label):
    """Uformer at embed 48 and 24 (depth 1 a stage) trains on the card at
    128^2 by the routes of STEP_CASES, no plain call, a finite loss."""
    dev = _cuda()
    opt, routes = STEP_CASES[label]
    model = Uformer(**_shallow(opt)).to(dev)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 2e-4))
    x = torch.rand(2, 128, 128, 3, device=dev)
    K.reset_counts()
    loss = make_train_step(model)(state, {"input": x, "target": x},
                                  torch.Generator().manual_seed(0))
    counts = K.launch_counts()
    assert {k: counts[k] for k in routes} == routes
    assert not any(K.plain_counts().values())
    assert np.isfinite(float(loss))
