"""Dropout (`drop_rate`, `attn_drop_rate`) as the JAX package places and
routes it, and the exports `random_crop_pair` and `count_params`.

On the CPU:
  (a) at rate 0 a model is the model without the arguments, bit for bit:
      a train step's loss, every gradient and the generator's state (drop
      path 0.1 draws its masks as before);
  (b) in eval a model at any rate is deterministic and equals rate 0;
  (c) the unfused branches that an active rate routes to (JAX's
      `_attn_with_dropout`, the unfused LeFF, dropout after the windowed
      kernel) equal JAX's jnp model in training, forward and gradients, at
      a rate whose masks keep every entry (1e-12: keep probability 1.0 in
      float32), while the routes are those of an active rate, as JAX's;
  (d) the launches of each route: drop_rate declines the image route and
      the LeFF fold, attn_drop_rate the attention kernels;
  (e) one generator gives one set of masks; the keep share is 1 - rate
      and each kept entry is scaled by exactly 1 / (1 - rate);
  (f) under `BatchRows` the masks are drawn for the global batch: a
      rank's rows of the forward equal those of the one-process forward,
      and the generator ends where it does;
  (g) a checkpointed step with dropout equals the unchecked one bit for
      bit (its masks through `DrawLog`);
  (h) `random_crop_pair` crops as JAX's at the same offsets and as the
      datasets draw them; `count_params` equals JAX's on a tiny model.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.data import random_crop_pair
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.layers import BatchRows, dropout
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step
from uformer_tpu_torch.utils import count_params

torch.set_num_threads(1)
TOL = 1e-4
SMALL = dict(img_size=64, embed_dim=8, depths=(1, 2, 1, 1, 1, 1, 1, 1, 1),
             num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), modulator=True)


def _seeded(model, seed=0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen)
                    + (1.0 if p.dim() == 1 and p.shape[0] > 0
                       and float(p.mean()) == 1.0 else 0.0))
    return model


def _batch(seed=1, B=2):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(B, 64, 64, 3, generator=gen)
    return {"input": x, "target": torch.rand(B, 64, 64, 3, generator=gen)}


def _step(model, batch, seed=3):
    """One train step (mixup on) from the generator seeded `seed`: loss,
    gradients, the generator's state after."""
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 0.0), step=5)
    gen = torch.Generator().manual_seed(seed)
    loss = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=1)(
        state, batch, gen)
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()
                  if p.grad is not None}, gen.get_state()


# ---- (a) rate 0 ------------------------------------------------------------

def test_rate_zero_is_the_model_without_dropout_bit_for_bit():
    plain = _seeded(Uformer(**SMALL))
    zero = _seeded(Uformer(drop_rate=0.0, attn_drop_rate=0.0, **SMALL))
    batch = _batch()
    a, b = _step(plain, batch), _step(zero, batch)
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    assert all(torch.equal(a[1][n], b[1][n]) for n in a[1])
    assert torch.equal(a[2], b[2])


# ---- (b) eval --------------------------------------------------------------

def test_eval_is_deterministic_at_any_rate():
    x = _batch()["input"]
    ref = _seeded(Uformer(**SMALL)).eval()
    drop = _seeded(Uformer(drop_rate=0.5, attn_drop_rate=0.5, **SMALL)).eval()
    with torch.no_grad():
        want = ref(x)
        assert torch.equal(drop(x), want) and torch.equal(drop(x), want)


# ---- (c) the unfused branches against JAX ----------------------------------

KEEP_ALL = 1e-12  # an active rate whose float32 keep probability is 1.0


@pytest.fixture(scope="module")
def jax_train(request):
    """JAX's SMALL Uformer on the jnp path (every branch unfused), drop path
    0, in training: seeded params, a 64² batch, the output and the loss's
    gradients."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.losses import charbonnier_loss as jloss

    rng = np.random.default_rng(90)
    batch = {"input": rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32),
             "target": rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxUformer(attn_backend="jnp", drop_path_rate=0.0, **SMALL)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(model.init, key, jb["input"])
    prng = np.random.default_rng(91)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * prng.standard_normal(a.shape) + (
            jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)

    def out(p):
        return model.apply(p, jb["input"], deterministic=False,
                           rngs={"dropout": key})

    def loss(p):
        return jloss(out(p), jb["target"])

    return SimpleNamespace(batch=batch, params=state_dict_from_jax(params),
                           out=np.asarray(out(params)),
                           grads=state_dict_from_jax(jax.grad(loss)(params)))


# (drop_rate, attn_drop_rate): the launches of one forward (attention_image,
# attention_block, leff) as the port routes it in training
ROUTES = {(KEEP_ALL, 0.0): (0, 10, 0), (0.0, KEEP_ALL): (0, 0, 10),
          (KEEP_ALL, KEEP_ALL): (0, 0, 0)}


@pytest.mark.parametrize("rates", list(ROUTES))
def test_unfused_branches_match_jax(jax_train, rates):
    from uformer_tpu_torch.train.losses import charbonnier_loss

    model = load_numpy_state_dict(
        Uformer(drop_path_rate=0.0, drop_rate=rates[0],
                attn_drop_rate=rates[1], **SMALL), jax_train.params).train()
    x = torch.from_numpy(jax_train.batch["input"])
    K.reset_counts()
    y = model(x, generator=torch.Generator().manual_seed(0))
    counts = K.plain_counts()
    assert (counts["attention_image"], counts["attention_block"],
            counts["leff"]) == ROUTES[rates]
    np.testing.assert_allclose(y.detach().numpy(), jax_train.out, rtol=0,
                               atol=TOL * (1 + np.abs(jax_train.out).max()))
    charbonnier_loss(y, torch.from_numpy(jax_train.batch["target"])) \
        .backward()
    for name, prm in model.named_parameters():
        if prm.grad is None:  # norm_cross: built, never applied
            continue
        want = np.asarray(jax_train.grads[name])
        np.testing.assert_allclose(
            prm.grad.numpy(), want, rtol=0,
            atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


# ---- (d) routes ------------------------------------------------------------

@pytest.mark.parametrize("rates,want", [
    ((0.0, 0.0), dict(attention_image=5, attention_block=5, leff=10,
                      attention_bwd=5, attention_block_bwd=5, leff_bwd=10)),
    ((0.1, 0.0), dict(attention_image=0, attention_block=10, leff=0,
                      attention_bwd=0, attention_block_bwd=10, leff_bwd=0)),
    ((0.0, 0.1), dict(attention_image=0, attention_block=0, leff=10,
                      attention_bwd=0, attention_block_bwd=0, leff_bwd=10)),
    ((0.1, 0.1), dict(attention_image=0, attention_block=0, leff=0,
                      attention_bwd=0, attention_block_bwd=0, leff_bwd=0))])
def test_routes_follow_jax(rates, want):
    """A train step's calls per route (JAX layers.py:700-775, :851-853);
    the same model in eval takes the kernel routes at any rate."""
    model = _seeded(Uformer(drop_rate=rates[0], attn_drop_rate=rates[1],
                            **SMALL))
    K.reset_counts()
    _step(model, _batch())
    got = K.plain_counts()
    assert {k: got[k] for k in want} == want
    K.reset_counts()
    with torch.no_grad():
        model.eval()(_batch()["input"])
    drop_eval = K.plain_counts()
    K.reset_counts()
    with torch.no_grad():
        _seeded(Uformer(**SMALL)).eval()(_batch()["input"])
    assert drop_eval == K.plain_counts()


# ---- (e) masks ---------------------------------------------------------------

def test_one_generator_one_set_of_masks():
    model = _seeded(Uformer(drop_rate=0.2, attn_drop_rate=0.2, **SMALL))
    batch = _batch()
    a, b = _step(model, batch, seed=5), _step(model, batch, seed=5)
    c = _step(model, batch, seed=6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_keep_share_and_scale(rate):
    x = torch.full((64, 64, 64), 3.0)
    y = dropout(x, rate, True, torch.Generator().manual_seed(7))
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    assert torch.equal(y[kept], (x / (1 - rate))[kept])
    assert torch.equal(dropout(x, rate, False, None), x)
    assert torch.equal(dropout(x.bfloat16(), rate, True,
                               torch.Generator().manual_seed(7))
                       .float() != 0, kept)


# ---- (f) the global batch ------------------------------------------------------

def test_data_parallel_rows_draw_the_global_batch():
    """A rank holding rows [2, 4) of a batch of 4 (`BatchRows`) gets those
    rows of the one-process forward: every DropPath and dropout mask is
    drawn for the global batch (windows and probabilities too)."""
    model = _seeded(Uformer(drop_rate=0.2, attn_drop_rate=0.2,
                            drop_path_rate=0.2, **SMALL)).train()
    x = _batch(B=4)["input"]
    one = torch.Generator().manual_seed(11)
    rank = torch.Generator().manual_seed(11)
    with torch.no_grad():
        want = model(x, generator=one)[2:]
        got = model(x[2:], generator=BatchRows(rank, 2, 4))
    # the same masks; the products of a batch of 2 and of 4 may round apart
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(one.get_state(), rank.get_state())


# ---- (g) checkpointing -----------------------------------------------------------

def test_checkpointed_step_with_dropout_is_bit_for_bit():
    batch = _batch()
    runs = [_step(_seeded(Uformer(drop_rate=0.2, attn_drop_rate=0.2,
                                  use_checkpoint=ck, **SMALL)), batch)
            for ck in (False, True)]
    (la, ga, sa), (lb, gb, sb) = runs
    assert torch.equal(la, lb) and torch.equal(sa, sb)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


# ---- (h) exports -------------------------------------------------------------------

class _Offsets:
    """A stand-in numpy generator whose integers() are given offsets."""

    def __init__(self, *values):
        self.values = list(values)

    def integers(self, low, high):
        v = self.values.pop(0)
        assert low <= v < high
        return v


def test_random_crop_pair_matches_jax():
    import jax
    import jax.numpy as jnp
    from uformer_tpu.data import random_crop_pair as jcrop

    rng = np.random.default_rng(12)
    gt = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    noisy = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    ps = 16
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        g, n = jcrop(key, jnp.asarray(gt), jnp.asarray(noisy), ps)
        rh = int(jax.random.randint(key, (), 0, 40 - ps + 1))
        rw = int(jax.random.randint(jax.random.fold_in(key, 1), (), 0,
                                    56 - ps + 1))
        pg, pn = random_crop_pair(_Offsets(rh, rw), gt, noisy, ps)
        assert np.array_equal(pg, np.asarray(g))
        assert np.array_equal(pn, np.asarray(n))
    # a numpy generator: the row, then the column, as the datasets draw
    r = np.random.default_rng(3)
    rows, cols = int(r.integers(0, 25)), int(r.integers(0, 41))
    pg, pn = random_crop_pair(np.random.default_rng(3), torch.from_numpy(gt),
                              torch.from_numpy(noisy), ps)
    assert torch.equal(pg, torch.from_numpy(gt[rows:rows + ps,
                                               cols:cols + ps]))
    assert torch.equal(pn, torch.from_numpy(noisy[rows:rows + ps,
                                                  cols:cols + ps]))


def test_count_params_matches_jax():
    import jax
    import jax.numpy as jnp
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.utils import count_params as jcount

    model = Uformer(**SMALL)
    shapes = jax.eval_shape(
        JaxUformer(attn_backend="jnp", **SMALL).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3)))
    want = jcount(shapes)
    assert count_params(model) == want
    assert count_params(dict(model.named_parameters())) == want
    assert count_params(list(model.parameters())) == want
