"""Head dim 64's backward: `--arch Uformer --embed_dim 64` (every block at
head dim 64, C 64-1024, hidden up to 4096) trains through the kernels, at
windows 1-16; kernels 6 and 7 at head dim 64 and C = 1024, and head dim
64 at windows 9-16 both ways.

On the CPU, with numpy inputs from a seed and fp32 throughout, each within
1e-4 (1 + max|ref|):
  - the windowed block's plain VJP (`attention_block_vjp_reference`, the
    CPU answer of `fused_attention_block_bwd`) at head dim 64: window 4
    at C 1024 (16 heads, LN), windows 9 and 16 at C 64, against JAX's
    Pallas `fused_attention_block_bwd` (interpret mode) and `jax.vjp` of
    its reference, all eleven outputs;
  - the image layout's plain VJP at head dim 64 (C 64, one head, 16^2;
    C 1024, 16 heads, one 8^2 image) against `jax.vjp` of JAX's
    `attention_image_reference` and against JAX's Pallas kernel 6
    (interpret mode) on the shifted, partitioned windows, as JAX's
    custom VJP runs it (`attention_image.py:482-520`);
  - LeFF's plain VJP at C 1024, hidden 4096, on 8 x 8, LN and residual
    each way, against JAX's `fused_leff_bwd` (interpret mode) and
    `jax.vjp`;
  - kernel 4's plain version at N 256, head dim 64, against JAX's Pallas
    kernel 4 (interpret mode);
  - the plain-path train step of the embed-64 Uformer (depths cut to 1,
    as tests/test_torch_port_family.py cuts them) at 128^2, and of
    `--win_size 16` at 128^2, against JAX's `make_train_step` on the same
    weights: loss, every gradient, every parameter's update, and each
    model's launch routes (the kernels' plain calls);
  - every block of the embed-64 models is covered by a backward kernel.
The tests marked `gpu` hold each extended kernel against its plain
version on the card (`python -m pytest -m gpu
tests/test_torch_port_head64_bwd.py`), within `chip_smoke.py`'s bounds.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.registry import arch_config, get_arch
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel

torch.set_num_threads(1)
TOL = 1e-4
ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
LEFF_GRADS = ("dx", "dw1", "db1", "dwd", "dbd", "dw2", "db2", "dln_s",
              "dln_b")
E64 = {"arch": "Uformer", "embed_dim": 64}


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops import window
    from uformer_tpu.ops.pallas import (
        attention_block,
        attention_image,
        leff,
        window_attention,
    )

    return SimpleNamespace(jax=jax, jnp=jnp, ab=attention_block,
                           ai=attention_image, leff=leff,
                           wa=window_attention, window=window)


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
    fan-in as a trained block's are, so that C 1024's logits stay of
    order one."""
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


# ---- kernel 6 in the windowed layout at head dim 64 -------------------------

# (win, shift, C, heads, has_ln, with_mod, H): windows of an H x H image
BLOCK_CASES = {"win4 C1024": (4, 2, 1024, 16, True, True, 8),
               "win9 C64": (9, 4, 64, 1, True, False, 18),
               "win16 C64": (16, 8, 64, 1, False, True, 32)}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_attention_block_vjp_head_dim64_matches_jax(jx, case):
    win, shift, C, nH, has_ln, with_mod, H = BLOCK_CASES[case]
    N, Bw = win * win, (H // win) ** 2
    inp, g = _attn_inputs(100 + win, C, nH, N, (Bw, N, C), with_mod)
    kw = dict(win=win, shift=shift, H=H, W=H, scale=64 ** -0.5,
              num_heads=nH, has_ln=has_ln)
    K.reset_counts()
    got = K.fused_attention_block_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_block_bwd"] == 1
    j = {k: None if v is None else jx.jnp.asarray(v) for k, v in inp.items()}
    if j["mod"] is None:
        j["mod"] = jx.jnp.zeros((N, C), jx.jnp.float32)
    kern = jx.ab.fused_attention_block_bwd(
        *list(j.values())[:1], jx.jnp.asarray(g), *list(j.values())[1:],
        has_mod=with_mod, interpret=True, packed=False, **kw)
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ab.attention_block_reference(*a, **kw), *j.values())
    _check_attn(got, {"kernel": kern, "jax.vjp": vjp(jx.jnp.asarray(g))},
                has_ln, with_mod)


# ---- kernel 6 in the image layout (kernel 1's VJP) at head dim 64 ----------

@pytest.mark.parametrize("C,nH,side,shift,residual", [
    (64, 1, 16, 4, True), (1024, 16, 8, 0, False)])
def test_attention_image_vjp_head_dim64_matches_jax(jx, C, nH, side, shift,
                                                    residual):
    inp, g = _attn_inputs(110 + shift, C, nH, 64, (1, side, side, C))
    kw = dict(win=8, shift=shift, scale=64 ** -0.5, num_heads=nH,
              has_ln=True, residual=residual)
    K.reset_counts()
    got = K.fused_attention_image_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_bwd"] == 1
    j = [jx.jnp.asarray(v) for v in inp.values()]
    jg = jx.jnp.asarray(g)
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ai.attention_image_reference(*a, **kw), *j)
    # JAX's custom VJP on the card: x and g shifted and partitioned,
    # kernel 6 on the windows, dx reversed and unshifted (+ g)
    w = jx.window

    def part(v):
        return w.window_partition(w.cyclic_shift(v, shift), 8)

    kern = list(jx.ab.fused_attention_block_bwd(
        part(j[0]), part(jg), *j[1:], win=8, shift=shift, H=side, W=side,
        scale=64 ** -0.5, num_heads=nH, has_ln=True, has_mod=True,
        interpret=True, packed=False))
    kern[0] = w.cyclic_unshift(w.window_reverse(kern[0], 8, side, side),
                               shift) + (jg if residual else 0.0)
    _check_attn(got, {"kernel": kern, "jax.vjp": vjp(jg)}, True)


# ---- kernel 7 at C 1024 ----------------------------------------------------

@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("residual", [True, False])
def test_leff_vjp_c1024_matches_jax_kernel(jx, has_ln, residual):
    C, Ch = 1024, 4096
    rng = np.random.default_rng(120 + 2 * has_ln + residual)

    def mk(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    inp = dict(x=mk(1, 8, 8, C), w1=mk(C, Ch) / np.sqrt(C),
               b1=mk(Ch, scale=0.1), wd=mk(3, 3, Ch) / 3.0,
               bd=mk(Ch, scale=0.1), w2=mk(Ch, C) / np.sqrt(Ch),
               b2=mk(C, scale=0.1), ln_s=1.0 + mk(C, scale=0.1),
               ln_b=mk(C, scale=0.1))
    dy = mk(1, 8, 8, C)
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


# ---- kernel 4 at N 256, head dim 64 -----------------------------------------

@pytest.mark.parametrize("shift", [0, 8])
def test_window_core_n256_head_dim64_matches_jax_kernel(jx, shift):
    win, nH, D, H = 16, 1, 64, 32
    N, Bw = win * win, (H // win) ** 2
    rng = np.random.default_rng(130 + shift)
    inp = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
           for k, s in (("q", (nH, Bw, N, D)), ("k", (nH, Bw, N, D)),
                        ("v", (nH, Bw, N, D)), ("bias", (nH, N, N)))}
    kw = dict(win=win, shift=shift, H=H, W=H, scale=D ** -0.5)
    K.reset_counts()
    got = K.fused_window_attention(*map(_t, inp.values()), **kw)
    assert K.plain_counts()["window_attention"] == 1
    want = jx.wa.fused_window_attention(
        *(jx.jnp.asarray(v) for v in inp.values()), interpret=True, **kw)
    _close(got, want, "window core N 256 D 64")


# ---- the embed-64 models' train steps against JAX --------------------------

# (construction options at depth 1 a stage, plain calls of a step by the
# port's routes): embed 64 at 128^2 takes the image route in every block;
# at --win_size 16 every stage at window 16 takes the windowed branch but
# the 8^2 bottleneck (window 8, the image route)
STEP_CASES = {
    "e64": (dict(E64, train_ps=128),
            dict(attention_image=9, attention_bwd=9, attention_block=0,
                 attention_block_bwd=0, leff=9, leff_bwd=9)),
    "e64 win16": (dict(E64, win_size=16, train_ps=128),
                  dict(attention_image=1, attention_bwd=1, attention_block=8,
                       attention_block_bwd=8, leff=9, leff_bwd=9)),
}


def _shallow(opt):
    return dict(arch_config(opt), depths=(1,) * 9)


@pytest.fixture(scope="module")
def jax_steps(jx):
    """One JAX train step (drop path 0, no mixup, lr 1e-3) per case from
    seeded params on one 128^2 batch: params before and after, loss and
    gradients (one compiled program a case: the step and the gradients
    of its loss)."""
    from uformer_tpu import get_arch as jax_get_arch
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep

    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(140)
    batch = {k: rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
             for k in ("input", "target")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    out = {}
    for label, (opt, _) in STEP_CASES.items():
        model = jax_get_arch(dict(opt, attn_backend="jnp")).clone(
            depths=(1,) * 9, drop_path_rate=0.0)
        shapes = jax.eval_shape(model.init, key, jb["input"])
        prng = np.random.default_rng(141)
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
def test_embed64_train_step_matches_jax(jax_steps, label):
    """The port's plain-path step (the CPU answer of the kernel path)
    against JAX's: loss, every gradient within dg = 1e-4 max(1, max|g|),
    every parameter's update within 2e-3 lr plus four float32 spacings
    plus the most that a gradient error of dg moves a first Adam step,
    lr g / (|g| + eps): lr eps dg / (|g| - dg + eps)^2 where |g| > dg,
    else 2 lr (the gradient's sign is within its tolerance). The
    embed-64 model's loss is of order 10 on these seeded weights, so
    entries far below a tensor's largest gradient (the k projections at
    enc0, the upsamplers) sit within dg of 0. The plain calls are the
    kernel path's launches by the port's routes."""
    opt, routes = STEP_CASES[label]
    s = jax_steps.steps[label]
    model = Uformer(**dict(_shallow(opt), drop_path_rate=0.0))
    assert model.conv.dim == 1024 and model.conv.num_heads == 16
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


@pytest.mark.parametrize("opt", [dict(E64, train_ps=128),
                                 dict(E64, train_ps=64),
                                 dict(E64, win_size=16, train_ps=128),
                                 dict(E64, win_size=16, train_ps=256)])
def test_embed64_models_have_a_backward_kernel_everywhere(opt):
    model = get_arch(opt)
    assert {b.num_heads * 64 == b.dim for n, b in model.named_modules()
            if n.endswith(("blocks.0", "blocks.1"))} == {True}
    assert blocks_without_backward_kernel(model) == []


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


def _attn_prm(seed, C, nH, N, dev):
    mat, scale, bias = _model_like(seed)
    p = dict(mod=mat(N, C, fan_in=C), ln_s=scale(C), ln_b=bias(C),
             wq=mat(C, C, fan_in=C), bq=bias(C),
             wkv=mat(C, 2 * C, fan_in=C), bkv=bias(2 * C),
             wo=mat(C, C, fan_in=C), bo=bias(C),
             bias=mat(nH, N, N, fan_in=nH))
    low = ("mod", "wq", "wkv", "wo")
    return {dt: [_t(v, dev, dt if k in low else torch.float32)
                 for k, v in p.items()]
            for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.gpu
@pytest.mark.parametrize("win,shift,C,Bw", [
    (8, 4, 64, 40), (8, 0, 1024, 8), (8, 4, 512, 100), (4, 2, 1024, 35),
    (4, 0, 512, 403), (16, 8, 64, 8), (12, 6, 1024, 8), (9, 0, 128, 8)])
def test_attention_block_bwd_kernel_head_dim64(win, shift, C, Bw):
    dev = _cuda()
    N, nH = win * win, C // 64
    prm = _attn_prm(150, C, nH, N, dev)
    kw = dict(win=win, shift=shift, H=16 * win, W=16 * win, scale=0.125,
              num_heads=nH, has_ln=True)
    K.reset_counts()
    _check_bwd(lambda x, g, dt: K.fused_attention_block_bwd(
                   x, g, *prm[dt], **kw),
               lambda x, g, dt: K.attention_block_vjp_reference(
                   x, g, *prm[dt], **kw),
               _draws(151, Bw, N, C), ATTN_GRADS)
    assert K.launch_counts()["attention_block_bwd"] == 2 * DRAWS + 1


@pytest.mark.gpu
@pytest.mark.parametrize("C,side,shift,residual", [
    (64, 32, 4, True), (1024, 16, 4, False), (512, 64, 0, True)])
def test_attention_image_bwd_kernel_head_dim64(C, side, shift, residual):
    dev = _cuda()
    nH = C // 64
    prm = _attn_prm(152, C, nH, 64, dev)
    kw = dict(win=8, shift=shift, scale=0.125, num_heads=nH,
              residual=residual)
    _check_bwd(lambda x, g, dt: K.fused_attention_image_bwd(
                   x, g, *prm[dt], **kw),
               lambda x, g, dt: K.attention_image_vjp_reference(
                   x, g, *prm[dt], **kw),
               _draws(153, 2, side, side, C), ATTN_GRADS)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,has_ln,residual", [
    (16, 16, True, True), (12, 12, False, True), (16, 16, False, False)])
def test_leff_bwd_kernel_c1024(H, W, has_ln, residual):
    dev = _cuda()
    C, Ch = 1024, 4096
    mat, scale, bias = _model_like(154)
    inp = dict(w1=mat(C, Ch, fan_in=C), b1=bias(Ch),
               wd=mat(3, 3, Ch, fan_in=9), bd=bias(Ch),
               w2=mat(Ch, C, fan_in=Ch), ln_s=scale(C), ln_b=bias(C))
    low = ("w1", "wd", "w2")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in inp.items()}
           for dt in (torch.float32, torch.bfloat16)}

    def run(fn):
        def call(x, g, dt):
            p = prm[dt]
            return fn(x, g, *(p[k] for k in ("w1", "b1", "wd", "bd", "w2")),
                      p["ln_s"], p["ln_b"], has_ln=has_ln,
                      residual=residual)
        return call

    _check_bwd(run(K.fused_leff_bwd), run(K.leff_vjp_reference),
               _draws(155, 2, H, W, C), LEFF_GRADS)


@pytest.mark.gpu
def test_embed64_step_runs_through_the_kernels():
    """Uformer at embed 64 (depth 1 a stage) trains on the card at 128^2:
    9 launches of each of kernels 1, 6 (image layout), 2 and 7, no plain
    call, a finite loss."""
    dev = _cuda()
    model = Uformer(**_shallow(dict(E64, train_ps=128))).to(dev)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 2e-4))
    x = torch.rand(2, 128, 128, 3, device=dev)
    K.reset_counts()
    loss = make_train_step(model)(state, {"input": x, "target": x},
                                  torch.Generator().manual_seed(0))
    counts = K.launch_counts()
    assert {k: counts[k] for k in STEP_CASES["e64"][1]} == \
        STEP_CASES["e64"][1]
    assert not any(K.plain_counts().values())
    assert np.isfinite(float(loss))
