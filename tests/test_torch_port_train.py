"""The port's train path (`uformer_tpu_torch` backward references, autograd
wrappers, DropPath, train modules) against the JAX package, on the CPU.

The same numpy inputs go through both sides (fp32, tolerance 1e-4 unless
stated). JAX is imported inside fixtures only. The backward kernels run on
the card only; their `gpu` tests are in tests/test_torch_port_kernels.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.data.augment import dihedral_transform, mixup_apply, \
    mixup_batch, random_dihedral_batch
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.layers import DropPath
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.train import TrainState, charbonnier_loss, \
    make_eval_step, make_optimizer, make_train_step, step_lr_schedule, \
    tv_loss, warmup_cosine_schedule
from uformer_tpu_torch.utils.params import prepare_serving

torch.set_num_threads(1)
TOL = 1e-4
SMALL = dict(img_size=128, embed_dim=8, depths=(1, 2, 1, 1, 1, 2, 1, 1, 1),
             num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), win_size=8,
             modulator=True)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops import window
    from uformer_tpu.ops.pallas import attention_block, attention_image, leff

    return SimpleNamespace(jax=jax, jnp=jnp, window=window, ab=attention_block,
                           ai=attention_image, leff=leff)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=TOL, what=""):
    """max-abs within tol * max(1, max|want|), per tensor."""
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---- (a) LeFF VJP -------------------------------------------------------

LEFF_NAMES = ("dx", "dw1", "db1", "dwd", "dbd", "dw2", "db2", "dln_s",
              "dln_b")


def _leff_case(shape, hidden):
    rng = np.random.default_rng(0)
    C = shape[-1]

    def mk(*s, sd=0.1):
        return (rng.normal(size=s) * sd).astype(np.float32)

    return dict(x=mk(*shape, sd=0.5), w1=mk(C, hidden), b1=mk(hidden),
                wd=mk(3, 3, hidden, sd=0.2), bd=mk(hidden), w2=mk(hidden, C),
                b2=mk(C), ln_s=1.0 + mk(C), ln_b=mk(C),
                dy=mk(*shape, sd=1.0))


# shapes of tests/test_pallas_leff.py:122-148 that run outside the slow
# tier (packed p=4 with LN and residual; packed p=2 without either),
# C = 128 with LN and no residual, Uformer_T's enc0 (C 16, hidden 64;
# packed p=8) as it trains, and H and W that are no multiple of 8 (the
# card's backward masks partial tiles; the JAX kernel pads H)
@pytest.mark.parametrize("shape,hidden,has_ln,residual", [
    ((2, 16, 16, 32), 128, True, True),
    ((1, 24, 16, 64), 256, False, False),
    ((1, 8, 16, 128), 256, True, False),
    ((2, 16, 16, 16), 64, True, False),
    ((1, 12, 20, 32), 128, True, True),
    ((2, 9, 14, 16), 64, True, False)])
def test_leff_vjp_reference_matches_jax(jx, shape, hidden, has_ln, residual):
    p = _leff_case(shape, hidden)
    order = ("x", "w1", "b1", "wd", "bd", "w2", "b2", "ln_s", "ln_b")
    got = K.leff_vjp_reference(
        *(_t(p[k]) for k in ("x", "dy", "w1", "b1", "wd", "bd", "w2",
                             "ln_s", "ln_b")), has_ln=has_ln,
        residual=residual)
    J = [jx.jnp.asarray(p[k]) for k in order]

    def ref(*a):
        return jx.leff.leff_reference(
            *a[:7], ln_s=a[7] if has_ln else None,
            ln_b=a[8] if has_ln else None, residual=residual)

    _, vjp = jx.jax.vjp(ref, *J)
    want = vjp(jx.jnp.asarray(p["dy"]))
    kern = jx.leff.fused_leff_bwd(
        J[0], jx.jnp.asarray(p["dy"]), *J[1:6], J[7], J[8], has_ln=has_ln,
        residual=residual, interpret=True)
    for i, name in enumerate(LEFF_NAMES):
        if not has_ln and name in ("dln_s", "dln_b"):
            assert got[i] is None
            continue
        _close(got[i], want[i], what=name)
        # the interpret-mode kernel: tests/test_pallas_leff.py's budget
        _close(got[i], kern[i], tol=2e-4, what=f"{name} vs kernel")


# ---- (b) attention VJP --------------------------------------------------

ATTN_NAMES = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")


def _attn_case(seed, B, H, W, C, nH):
    rng = np.random.default_rng(seed)

    def mk(*s, sd=0.2):
        return (rng.standard_normal(s) * sd).astype(np.float32)

    return dict(x=mk(B, H, W, C), mod=mk(64, C), ln_s=1.0 + mk(C),
                ln_b=mk(C), wq=mk(C, C), bq=mk(C), wkv=mk(C, 2 * C),
                bkv=mk(2 * C), wo=mk(C, C), bo=mk(C), bias=mk(nH, 64, 64),
                g=mk(B, H, W, C, sd=1.0))


def _jax_block_bwd(jx, J, g, *, shift, scale, nH, residual):
    """fused_attention_block_bwd (interpret) behind the re-windowing of
    uformer_tpu attention_image.py:497-518, written out here."""
    wops = jx.window
    B, H, W, C = J[0].shape
    p = 128 // C if (C < 128 and 128 % C == 0 and C >= 32) else 1
    packed = p > 1 and shift % p == 0 and W % p == 0
    if packed:
        def part(v):
            return wops.window_partition_packed(
                wops.cyclic_shift_packed(v, shift, p), 8, p)

        def unpart(v):
            return wops.cyclic_unshift_packed(
                wops.window_reverse_packed(v, 8, H, W, p), shift, p)
    else:
        def part(v):
            return wops.window_partition(wops.cyclic_shift(v, shift), 8)

        def unpart(v):
            return wops.cyclic_unshift(wops.window_reverse(v, 8, H, W),
                                       shift)
    out = jx.ab.fused_attention_block_bwd(
        part(J[0]), part(g), *J[1:], win=8, shift=shift, H=H, W=W,
        scale=scale, num_heads=nH, has_ln=True, has_mod=True, packed=packed,
        interpret=True)
    dx = unpart(out[0])
    return (dx + g if residual else dx,) + tuple(out[1:])


# C 32 and 64 take JAX's packed backward; C 128 the plain windowed one;
# head dim 32, then 16 (Uformer_T's C 32, 64 and 128 stages)
@pytest.mark.parametrize("geom", [(1, 16, 16, 32, 1, 4, True),
                                  (1, 16, 16, 64, 2, 0, False),
                                  (1, 16, 16, 128, 4, 0, True),
                                  (1, 16, 16, 128, 4, 4, False),
                                  (1, 16, 16, 32, 2, 4, False),
                                  (1, 16, 16, 64, 4, 0, True),
                                  (1, 16, 16, 128, 8, 4, False)])
def test_attention_vjp_reference_matches_jax(jx, geom):
    B, H, W, C, nH, shift, residual = geom
    p = _attn_case(3, B, H, W, C, nH)
    order = ("x", "mod", "ln_s", "ln_b", "wq", "bq", "wkv", "bkv", "wo",
             "bo", "bias")
    kw = dict(win=8, shift=shift, scale=0.2, num_heads=nH, has_ln=True,
              residual=residual)
    got = K.attention_image_vjp_reference(
        _t(p["x"]), _t(p["g"]), *(_t(p[k]) for k in order[1:]), **kw)
    J = [jx.jnp.asarray(p[k]) for k in order]
    g = jx.jnp.asarray(p["g"])
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ai.attention_image_reference(*a, **kw), *J)
    want = vjp(g)
    kern = _jax_block_bwd(jx, J, g, shift=shift, scale=0.2, nH=nH,
                          residual=residual)
    for i, name in enumerate(ATTN_NAMES):
        _close(got[i], want[i], what=name)
        # the interpret-mode kernel: test_pallas_attention_block.py's budget
        _close(got[i], kern[i], tol=2e-4, what=f"{name} vs kernel")


# ---- (c) autograd wrappers ----------------------------------------------

def _grads(fn, args, dy):
    args = [None if a is None else a.clone().requires_grad_(True)
            for a in args]
    (fn(*args) * dy).sum().backward()
    return [None if a is None else a.grad for a in args]


@pytest.mark.parametrize("residual", [True, False])
def test_autograd_wrappers_match_plain_autograd_on_cpu(residual):
    p = _attn_case(5, 1, 16, 16, 32, 1)
    order = ("x", "mod", "ln_s", "ln_b", "wq", "bq", "wkv", "bkv", "wo",
             "bo", "bias")
    args = [_t(p[k]) for k in order]
    kw = dict(win=8, shift=4, scale=0.2, num_heads=1, residual=residual)
    dy = _t(p["g"])
    K.reset_counts()
    got = _grads(lambda *a: K.attention_image_ad(*a, **kw), args, dy)
    want = _grads(lambda *a: K.attention_image_reference(*a, **kw), args, dy)
    for name, a, b in zip(order, got, want):
        _close(a, b.numpy(), what=name)
    lp = _leff_case((1, 8, 16, 32), 128)
    lorder = ("x", "w1", "b1", "wd", "bd", "w2", "b2", "ln_s", "ln_b")
    largs = [_t(lp[k]) for k in lorder]
    dy = _t(lp["dy"])
    got = _grads(lambda *a: K.leff_ad(*a[:7], ln_s=a[7], ln_b=a[8],
                                      residual=residual), largs, dy)
    want = _grads(lambda *a: K.leff_reference(*a[:7], ln_s=a[7], ln_b=a[8],
                                              residual=residual), largs, dy)
    for name, a, b in zip(lorder, got, want):
        _close(a, b.numpy(), what=name)
    assert K.plain_counts() == {"stage": 0, "attention_image": 1, "leff": 1,
                                "attention_bwd": 1, "attention_block_bwd": 0,
                                "leff_bwd": 1, "window_attention": 0,
                                "attention_block": 0, "dwconv3x3": 0,
                                "dwconv3x3_qkv": 0}
    assert set(K.launch_counts().values()) == {0}


# ---- (d) one train step against JAX make_train_step ----------------------

# lr 5e-4, 1e-3, then cosine: the lr changes at every step
SCHEDULE = dict(base_lr=1e-3, nepoch=10, steps_per_epoch=1, warmup_epochs=2)
N_STEPS = 3


@pytest.fixture(scope="module")
def small_run(jx):
    """N_STEPS JAX train steps of the small Uformer (drop path 0, no mixup,
    lr from SCHEDULE) from seeded params on one batch, without clipping
    and with a clip at a quarter of the first gradients' global norm. For
    each step: the params before and after it, its loss and its (unclipped)
    gradients."""
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.schedules import warmup_cosine_schedule as jsched
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep

    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(0)
    batch = {"input": rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32),
             "target": rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)}
    model = JaxUformer(attn_backend="jnp", drop_path_rate=0.0, **SMALL)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(batch["input"]))
    prng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * prng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)

    def loss(p):
        pred = model.apply(p, jb["input"], deterministic=False,
                           rngs={"dropout": jax.random.split(key)[1]})
        return jloss(pred, jb["target"])

    grad_fn = jax.jit(jax.grad(loss))
    runs = {}
    for clip in (None, _global_norm(jax, grad_fn(params)) / 4):
        state = JState.create(params, jopt(jsched(**SCHEDULE),
                                           grad_clip=clip))
        step, steps = jax.jit(jstep(model)), []
        for _ in range(N_STEPS):
            grads = grad_fn(state.params)
            new, loss_val = step(state, jb, key)
            steps.append(SimpleNamespace(
                before=state_dict_from_jax(state.params),
                after=state_dict_from_jax(new.params), loss=float(loss_val),
                grads=state_dict_from_jax(grads),
                norm=_global_norm(jax, grads)))
            state = new
        runs["clip" if clip else "none"] = SimpleNamespace(clip=clip,
                                                           steps=steps)
    return SimpleNamespace(batch=batch, runs=runs)


def _global_norm(jax, tree):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(v, np.float64)))
                             for v in jax.tree_util.tree_leaves(tree))))


def _close_update(got, step, name, lr):
    """The step's update of one parameter against JAX's: within 2e-3 lr
    plus four float32 spacings of the parameter (the rounding of
    p + update). A skipped or reversed update is off by about lr, a
    missing weight decay by lr * 0.02 * |p| (2e-5 at the LayerNorm scales,
    about 1)."""
    before = np.asarray(step.before[name])
    want = np.asarray(step.after[name]) - before
    err = np.abs((got - before) - want)
    tol = 2e-3 * lr + 4 * np.spacing(np.abs(before))
    assert np.all(err <= tol), (name, float((err - tol).max()), lr)


@pytest.mark.parametrize("run,n_steps", [("none", 1), ("clip", 2),
                                         ("none", N_STEPS)],
                         ids=["first", "clip", "later"])
def test_train_step_matches_jax(small_run, run, n_steps):
    """The port's train step against JAX make_train_step, step by step:
    loss, every gradient (after the port's clipping, against JAX's
    gradients times the clip factor) and every parameter's update (AdamW
    with its moments and bias correction, the schedule's lr for the step,
    weight decay on every parameter). Before each step the model takes
    JAX's params, so each update is compared on the same params; the
    optimizer keeps its own state across the steps."""
    r = small_run.runs[run]
    model = Uformer(drop_path_rate=0.0, **SMALL)
    load_numpy_state_dict(model, r.steps[0].before)
    sched = warmup_cosine_schedule(**SCHEDULE)
    state = TrainState(model, make_optimizer(model.parameters(), sched,
                                             grad_clip=r.clip))
    step = make_train_step(model)
    batch = {k: torch.from_numpy(v) for k, v in small_run.batch.items()}
    params = dict(model.named_parameters())
    for k, s in enumerate(r.steps[:n_steps]):
        with torch.no_grad():
            for name, prm in params.items():
                prm.copy_(_t(s.before[name]))
        K.reset_counts()
        loss = step(state, batch, torch.Generator().manual_seed(0))
        np.testing.assert_allclose(float(loss), s.loss, rtol=1e-5)
        assert state.step == k + 1
        # each block's attention backward: the image route's, or the
        # windowed branch's (C 8 and 16 take the windowed one)
        counts = K.plain_counts()
        assert counts["attention_bwd"] + counts["attention_block"] == \
            sum(SMALL["depths"]) and counts["attention_block"] == 4
        assert counts["attention_block_bwd"] == 4
        factor = 1.0 if r.clip is None else min(1.0, r.clip / s.norm)
        if r.clip is not None:
            assert factor < 0.5  # the clip is active
        for name, prm in params.items():
            _close(prm.grad, s.grads[name] * factor, what=f"grad {name}")
            _close_update(prm.detach().numpy(), s, name, sched(k))


def test_optimizer_matches_optax(jx):
    """make_optimizer against uformer_tpu make_optimizer (optax) on
    parameters of order 1-10, where every tensor's weight decay shows:
    three steps with the schedule's lr, with and without clipping, the
    second step's gradients large enough to be clipped."""
    from uformer_tpu.train.schedules import warmup_cosine_schedule as jsched
    from uformer_tpu.train.train_step import make_optimizer as jopt

    jnp = jx.jnp
    rng = np.random.default_rng(4)
    shapes = {"w": (16, 8), "b": (8,), "dw": (3, 3, 4), "s": (5,)}
    params = {k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (30.0 if i == 1 else 0.1))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]
    sched = warmup_cosine_schedule(**SCHEDULE)
    for clip in (None, 1.0):
        tx = jopt(jsched(**SCHEDULE), grad_clip=clip)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        opt_state = tx.init(jp)
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in params.items()}
        opt = make_optimizer(tp.values(), sched, grad_clip=clip)
        for k, g in enumerate(grads):
            upd, opt_state = tx.update(
                {n: jnp.asarray(v) for n, v in g.items()}, opt_state, jp)
            jp = {n: jp[n] + upd[n] for n in jp}
            for n, prm in tp.items():
                prm.grad = torch.from_numpy(g[n].copy())
            opt.step_at(k)
            for n, prm in tp.items():
                want = np.asarray(jp[n])
                tol = 1e-4 * sched(k) + 4 * np.spacing(np.abs(want))
                err = np.abs(prm.detach().numpy() - want)
                assert np.all(err <= tol), (clip, k, n, float(err.max()))


# ---- (e) DropPath and its schedule --------------------------------------

def test_drop_path_masks_per_sample_and_repeats():
    x = torch.ones(64, 4, 4, 2)
    dp = DropPath(0.25).train()
    a = dp(x, torch.Generator().manual_seed(7))
    b = dp(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    flat = a.reshape(64, -1)
    # each sample is dropped or kept whole, kept ones scaled by 1/keep
    for row in flat:
        assert torch.all(row == 0) or torch.allclose(row, torch.full_like(
            row, 1 / 0.75))
    kept = int((flat[:, 0] > 0).sum())
    assert 0 < kept < 64
    assert torch.equal(dp.eval()(x), x)
    assert torch.equal(DropPath(0.0).train()(x), x)
    with pytest.raises(ValueError, match="Generator"):
        dp.train()(x)


def test_drop_path_schedule_matches_jax():
    from uformer_tpu.models import Uformer as JaxUformer

    for depths, rate in (((1, 2, 8, 8, 2, 8, 8, 2, 1), 0.1),
                         ((2,) * 9, 0.2)):
        want = JaxUformer(depths=depths, drop_path_rate=rate) \
            .drop_path_schedule()
        got = Uformer(depths=depths, drop_path_rate=rate).drop_path_schedule()
        assert got == tuple(list(w) for w in want)
        assert all(type(v) is float for part in got for v in part)
    model = get_arch({"arch": "Uformer_B", "train_ps": 128})
    rates = [b.drop_path1.rate for n in ("encoderlayer_0", "conv",
                                         "decoderlayer_3")
             for b in getattr(model, n).blocks]
    assert rates == [0.0, 0.1, 0.1, 0.0]


# ---- (f) schedules, losses, augmentations -------------------------------

def test_schedules_match_jax():
    from uformer_tpu.train import schedules as js

    for mine, theirs in (
            (warmup_cosine_schedule(2e-4, 250, 7, 3),
             js.warmup_cosine_schedule(2e-4, 250, 7, 3)),
            (step_lr_schedule(2e-4, 7), js.step_lr_schedule(2e-4, 7))):
        for step in (0, 6, 7, 20, 21, 100, 350, 1749):
            np.testing.assert_allclose(mine(step), float(theirs(step)),
                                       rtol=1e-6)


def test_losses_match_jax(jx):
    from uformer_tpu.train import losses as jl

    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(2, 16, 12, 3)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        float(charbonnier_loss(_t(a), _t(b))),
        float(jl.charbonnier_loss(jx.jnp.asarray(a), jx.jnp.asarray(b))),
        rtol=1e-6)
    np.testing.assert_allclose(float(tv_loss(_t(a), 0.5)),
                               float(jl.tv_loss(jx.jnp.asarray(a), 0.5)),
                               rtol=1e-5)


def test_mixup_matches_jax_and_is_convex(jx):
    from uformer_tpu.data.augment import mixup_batch as jmix

    jax = jx.jax
    rng = np.random.default_rng(3)
    t, i = (rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
            for _ in range(2))
    key = jax.random.PRNGKey(5)
    want_t, want_i = jmix(key, jx.jnp.asarray(t), jx.jnp.asarray(i))
    # the same lam and permutation as jmix draws them
    k_lam, k_perm = jax.random.split(key)
    lam = np.asarray(jax.random.beta(k_lam, 1.2, 1.2, (4, 1, 1, 1)))
    perm = np.asarray(jax.random.permutation(k_perm, 4))
    got_t, got_i = mixup_apply(_t(t), _t(i), _t(lam.reshape(4)), _t(perm))
    _close(got_t, want_t, tol=1e-6)
    _close(got_i, want_i, tol=1e-6)
    gen = torch.Generator().manual_seed(0)
    mt, mi = mixup_batch(gen, _t(t), _t(i))
    mt2, _ = mixup_batch(torch.Generator().manual_seed(0), _t(t), _t(i))
    assert torch.equal(mt, mt2)
    # every mixed pixel lies between the sample and some partner
    lo = np.minimum(t[:, None], t[None]).min(1)
    hi = np.maximum(t[:, None], t[None]).max(1)
    assert np.all(mt.numpy() >= lo - 1e-6) and np.all(mt.numpy() <= hi + 1e-6)
    assert mi.shape == i.shape


def test_dihedral_ops_match_jax(jx):
    from uformer_tpu.data.augment import dihedral_transform as jdi

    x = np.arange(4 * 4 * 2, dtype=np.float32).reshape(4, 4, 2)
    for k in range(8):
        _close(dihedral_transform(_t(x), k), jdi(jx.jnp.asarray(x), k),
               tol=0)
    a, b = random_dihedral_batch(torch.Generator().manual_seed(1),
                                 _t(np.stack([x, x])), _t(np.stack([x, x])))
    assert torch.equal(a, b)


# ---- (g) routing in training, and the serving-cache trap -----------------

def test_uformer_b_train_routing_counts():
    """Uformer_B (train_ps 128) in training: 40 attention and 40 LeFF
    forwards, 40 of each backward, no stage kernel (plain versions on the
    CPU, counted apart from launches)."""
    model = get_arch({"arch": "Uformer_B", "train_ps": 128}).train()
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    K.reset_counts()
    loss = charbonnier_loss(model(x, generator=torch.Generator()
                                  .manual_seed(1)), x)
    loss.backward()
    assert K.plain_counts() == {"stage": 0, "attention_image": 40,
                                "leff": 40, "attention_bwd": 40,
                                "attention_block_bwd": 0, "leff_bwd": 40,
                                "window_attention": 0, "attention_block": 0,
                                "dwconv3x3": 0, "dwconv3x3_qkv": 0}
    assert set(K.launch_counts().values()) == {0}
    assert all(p.grad is not None for p in model.parameters())


def test_prepared_model_still_gets_gradients():
    """prepare_serving caches detached weights: a model trained after it
    must not take them (every parameter gets a non-zero gradient)."""
    model = Uformer(drop_path_rate=0.0, **SMALL)
    prepare_serving(model, torch.float32)
    with torch.no_grad():
        served = make_eval_step(model)(torch.rand(1, 128, 128, 3))
    assert served.min() >= 0 and served.max() <= 1
    opt = make_optimizer(model.parameters(), lambda s: 1e-3)
    step = make_train_step(model)
    batch = {"input": torch.rand(1, 128, 128, 3),
             "target": torch.rand(1, 128, 128, 3)}
    loss = step(TrainState(model, opt), batch, torch.Generator())
    assert torch.isfinite(loss)
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.any(p.grad != 0)]
    assert missing == []
