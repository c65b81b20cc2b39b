"""One train step of `--arch Uformer --embed_dim 72` (heads
1-2-4-8-16-16-8-4-2, head dim 72 in every block, C 72-1152) with its
depths cut to 1 a stage, as tests/test_torch_port_family.py cuts them.

On the CPU: the port's plain-path step (the CPU answer of the kernel path:
kernels 1 and 6 where C % 128 == 0, kernels 5 and 6 elsewhere, kernels 2
and 7 every block) at 128^2, batch 2, against JAX's `make_train_step`
(attn_backend "jnp") on the same weights, carried across by the
state_dict converter: loss, every gradient within 1e-4 max(1, max|g|),
every parameter's update, and the plain calls by route. The test marked
`gpu` runs the same step through the kernels on the card (`python -m
pytest -m gpu tests/test_torch_port_head_dims_bwd_above64_step.py`).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.registry import arch_config
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

torch.set_num_threads(1)
TOL = 1e-4
E72 = {"arch": "Uformer", "embed_dim": 72, "train_ps": 128}
# calls a step by the port's routes, JAX's `layers.py:771-775`: the image
# route where C % 128 == 0 (the C 1152 bottleneck and dec0), the windowed
# branch elsewhere, the same count each way
ROUTES = dict(attention_image=2, attention_bwd=2, attention_block=7,
              attention_block_bwd=7, leff=9, leff_bwd=9)
BATCH = 2


def _shallow(opt):
    return dict(arch_config(opt), depths=(1,) * 9)


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step (drop path 0, no mixup, lr 1e-3) from seeded
    params on one 128^2 batch of 2: params before and after, loss and
    gradients (one compiled program: the step and the gradients of its
    loss)."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu import get_arch as jax_get_arch
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep

    rng = np.random.default_rng(360)
    batch = {k: rng.uniform(0, 1, (BATCH, 128, 128, 3)).astype(np.float32)
             for k in ("input", "target")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    model = jax_get_arch(dict(E72, attn_backend="jnp")).clone(
        depths=(1,) * 9, drop_path_rate=0.0)
    shapes = jax.eval_shape(model.init, key, jb["input"])
    prng = np.random.default_rng(361)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * prng.standard_normal(a.shape) + (
            jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)

    def loss(p):
        pred = model.apply(p, jb["input"], deterministic=False,
                           rngs={"dropout": jax.random.split(key)[1]})
        return jloss(pred, jb["target"])

    def both(state):
        new, value = jstep(model)(state, jb, key)
        return new.params, value, jax.grad(loss)(state.params)

    state = JState.create(params, jopt(lambda s: 1e-3))
    new, loss_val, grads = jax.jit(both)(state)
    return SimpleNamespace(
        batch=batch, before=state_dict_from_jax(params),
        after=state_dict_from_jax(new), loss=float(loss_val),
        grads=state_dict_from_jax(grads))


def test_e72_train_step_matches_jax(jax_step):
    """The port's plain-path step against JAX's: loss, every gradient
    within dg = 1e-4 max(1, max|g|), every parameter's update within 2e-3
    lr plus four float32 spacings plus the most that a gradient error of
    dg moves a first Adam step, lr g / (|g| + eps): lr eps dg / (|g| - dg
    + eps)^2 where |g| > dg, else 2 lr (the gradient's sign is within its
    tolerance). The plain calls are the kernel path's launches by the
    port's routes."""
    s = jax_step
    model = Uformer(**dict(_shallow(E72), drop_path_rate=0.0))
    assert {b.dim // b.num_heads for n, b in model.named_modules()
            if n.endswith("blocks.0")} == {72}
    load_numpy_state_dict(model, s.before)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda k: 1e-3))
    batch = {k: torch.from_numpy(v) for k, v in s.batch.items()}
    K.reset_counts()
    loss = make_train_step(model)(state, batch,
                                  torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), s.loss, rtol=1e-5)
    counts = K.plain_counts()
    assert {k: counts[k] for k in ROUTES} == ROUTES
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_e72_step_runs_through_the_kernels(dtype):
    """The same depth-1 e72 model trains on the card at 128^2, batch 2, by
    ROUTES' launches, no plain call, a finite loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    dev = torch.device("cuda")
    model = Uformer(**_shallow(E72)).to(dev)
    model.dtype = dtype
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 2e-4))
    x = torch.rand(BATCH, 128, 128, 3, device=dev)
    K.reset_counts()
    loss = make_train_step(model)(state, {"input": x, "target": x},
                                  torch.Generator().manual_seed(0))
    counts = K.launch_counts()
    assert {k: counts[k] for k in ROUTES} == ROUTES
    assert not any(K.plain_counts().values())
    assert np.isfinite(float(loss))
