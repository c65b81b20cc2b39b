"""Gradient checkpointing (`use_checkpoint`, `models/layers.py:BasicLayer`)
on the CPU.

A checkpointed train step against the unchecked step on the same weights,
batch and generator state, drop path 0.1 and mixup on: the loss, every
gradient, every updated parameter and the generator's state after the
step in equal bits, on the plain path and on the kernels' autograd route
(whose kernels run their plain versions on the CPU). Then the recompute's
calls per block, eval and no_grad untouched, and a checkpointed step
against JAX's `use_checkpoint=True` step at drop path 0 (fp32, 1e-4
(1 + max|ref|)). The geometry is the JAX trainer tests' tiny one (32^2,
embed 8, window 2), with two blocks in some stages. JAX is imported
inside the tests.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step, warmup_cosine_schedule

torch.set_num_threads(1)
TINY = dict(img_size=32, embed_dim=8, depths=(1, 2, 1, 1, 1, 1, 1, 2, 1),
            num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), win_size=2,
            modulator=True)
N_BLOCKS = sum(TINY["depths"])


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3))
                                .astype(np.float32))
            for k in ("input", "target")}


def _run(sd, use_checkpoint, plain, n_steps=2, drop_path_rate=0.1):
    """n_steps train steps (mixup on: step 5 onwards) from the weights sd;
    per step the loss, every gradient, the parameters after it and the
    generator's state, and the plain calls of each kernel."""
    model = Uformer(drop_path_rate=drop_path_rate,
                    use_checkpoint=use_checkpoint, **TINY)
    model.load_state_dict(sd)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 1e-3), step=5)
    step = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=1,
                           plain=plain)
    gen = torch.Generator().manual_seed(3)
    out = []
    for i in range(n_steps):
        K.reset_counts()
        loss = step(state, _batch(i), gen)
        out.append(SimpleNamespace(
            loss=loss, gen=gen.get_state(), calls=K.plain_counts(),
            grads={n: p.grad.clone() for n, p in model.named_parameters()
                   if p.grad is not None},
            params={n: p.detach().clone()
                    for n, p in model.named_parameters()}))
    return out


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    return Uformer(**TINY).state_dict()


@pytest.mark.parametrize("plain", [True, False],
                         ids=["plain", "kernel-route"])
def test_checkpointed_step_equals_unchecked_step(weights, plain):
    ref = _run(weights, False, plain)
    got = _run(weights, True, plain)
    for r, g in zip(ref, got):
        assert torch.equal(r.loss, g.loss)
        assert torch.equal(r.gen, g.gen)  # the generator ends where it did
        assert r.grads.keys() == g.grads.keys()
        # every parameter but norm_cross (none here) has a gradient
        assert len(r.grads) == len(r.params)
        for name in r.grads:
            assert torch.equal(r.grads[name], g.grads[name]), name
        for name in r.params:
            assert torch.equal(r.params[name], g.params[name]), name
    # drop path was active: the masks differ between samples or steps
    assert not torch.equal(ref[0].loss, ref[1].loss)


def test_checkpoint_recomputes_each_block_forward(weights):
    """On the kernel route each block's attention and LeFF forward run
    twice a step (the forward and the backward's recompute), their
    backward once; unchecked, once each. Window 2 takes the windowed
    branch (attention_block)."""
    once = _run(weights, False, False, n_steps=1)[0].calls
    twice = _run(weights, True, False, n_steps=1)[0].calls
    for calls, fwd in ((once, N_BLOCKS), (twice, 2 * N_BLOCKS)):
        assert calls["attention_block"] == calls["leff"] == fwd
        assert calls["attention_block_bwd"] == calls["leff_bwd"] == N_BLOCKS
        assert calls["attention_image"] == calls["attention_bwd"] == 0


def test_checkpoint_leaves_eval_and_no_grad_as_they_were(weights):
    x = _batch()["input"]
    outs = []
    for ck in (False, True):
        model = Uformer(use_checkpoint=ck, **TINY)
        model.load_state_dict(weights)
        with torch.no_grad():
            outs.append(model.eval()(x))
            outs.append(model.train()(x, generator=torch.Generator()
                                      .manual_seed(1)))
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert get_arch({"arch": "Uformer_B", "use_checkpoint": True}) \
        .decoderlayer_0.use_checkpoint


def test_drop_path_masks_drawn_ahead_are_the_forwards_masks(weights):
    """draw_drop_path gives the masks the block's forward would draw, in
    its order, and the block run with them equals the block run drawing
    them."""
    model = Uformer(drop_path_rate=0.5, **TINY).train()
    model.load_state_dict(weights)
    blk = model.encoderlayer_3.blocks[0]
    assert blk.drop_path1.rate > 0
    x = torch.randn(8, 4, 4, 64, generator=torch.Generator().manual_seed(2))
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    keep = blk.draw_drop_path(x, g1)
    assert [k.shape for k in keep] == [(8,), (8,)]
    a = blk(x, generator=g2)
    b = blk(x, keep=keep)
    assert torch.equal(a, b) and torch.equal(g1.get_state(), g2.get_state())


# ---- against JAX's use_checkpoint=True step --------------------------------

SCHEDULE = dict(base_lr=1e-3, nepoch=10, steps_per_epoch=1, warmup_epochs=2)
JAX_TINY = dict(TINY, depths=(1,) * 9)


@pytest.fixture(scope="module")
def jax_step():
    import jax
    import jax.numpy as jnp
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.schedules import warmup_cosine_schedule as jsched
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep

    batch = {k: v.numpy() for k, v in _batch(7).items()}
    model = JaxUformer(attn_backend="jnp", drop_path_rate=0.0,
                       use_checkpoint=True, **JAX_TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(batch["input"]))
    prng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * prng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    state = JState.create(params, jopt(jsched(**SCHEDULE)))
    new, loss = jax.jit(jstep(model))(state, jb, key)

    def loss_fn(p):
        pred = model.apply(p, jb["input"], deterministic=False,
                           rngs={"dropout": jax.random.split(key)[1]})
        return jloss(pred, jb["target"])

    grads = jax.jit(jax.grad(loss_fn))(params)
    return SimpleNamespace(batch=batch, before=state_dict_from_jax(params),
                           after=state_dict_from_jax(new.params),
                           grads=state_dict_from_jax(grads),
                           loss=float(loss))


def test_checkpointed_step_matches_jax_use_checkpoint(jax_step):
    """The port's checkpointed step (drop path 0) against JAX's: the loss,
    every gradient within 1e-4 max(1, max|g|), every update within 2e-3 lr
    plus four float32 spacings (and the first Adam step's swing where |g|
    is near eps, as tests/test_torch_port_unet.py states it)."""
    model = Uformer(drop_path_rate=0.0, use_checkpoint=True, **JAX_TINY)
    load_numpy_state_dict(model, jax_step.before)
    sched = warmup_cosine_schedule(**SCHEDULE)
    state = TrainState(model, make_optimizer(model.parameters(), sched))
    batch = {k: torch.from_numpy(v) for k, v in jax_step.batch.items()}
    K.reset_counts()
    loss = make_train_step(model)(state, batch,
                                  torch.Generator().manual_seed(0))
    assert K.plain_counts()["leff"] == 2 * sum(JAX_TINY["depths"])
    np.testing.assert_allclose(float(loss), jax_step.loss, rtol=1e-5)
    lr, eps = sched(0), 1e-8
    for name, p in model.named_parameters():
        if "norm_cross" in name:
            continue
        g_ref = np.asarray(jax_step.grads[name])
        g_tol = 1e-4 * max(1.0, float(np.abs(g_ref).max()))
        assert float(np.abs(p.grad.numpy() - g_ref).max()) <= g_tol, name
        before = np.asarray(jax_step.before[name])
        want = np.asarray(jax_step.after[name]) - before
        err = np.abs((p.detach().numpy() - before) - want)
        tol = (2e-3 * lr + 4 * np.spacing(np.abs(before))
               + lr * eps * g_tol / (np.abs(g_ref) + eps) ** 2)
        assert np.all(err <= tol), (name, float((err - tol).max()))
