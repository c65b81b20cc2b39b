"""The port's UNet (`uformer_tpu_torch.models.unet`) against the JAX
package's, on the CPU: the forward at dim 8, 64^2, one train step (loss
and every updated parameter) against JAX `make_train_step`, the weights
through `state_dict_from_jax` and a reference-format `.pth`
(`load_pth`, `load_checkpoint`), the registry, the eval and train CLIs
with `--arch UNet`, and the channels_last layout across the net.

Same numpy weights and inputs on both sides; fp32 within
1e-4 (1 + max|ref|) unless stated. JAX is imported inside the tests.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import load_checkpoint, load_pth, \
    state_dict_from_jax
from uformer_tpu_torch.models import UNet
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step, warmup_cosine_schedule
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel
from uformer_tpu_torch.utils.params import prepare_serving

torch.set_num_threads(1)
DIM, RES = 8, 64
SCHEDULE = dict(base_lr=1e-3, nepoch=10, steps_per_epoch=1, warmup_epochs=2)


@pytest.fixture(scope="module")
def jax_unet():
    """JAX UNet(dim 8) on seeded params, its 64^2 forward on a seeded
    batch of 2, and one train step (no mixup) from those params."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.models import UNet as JaxUNet
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.schedules import warmup_cosine_schedule as jsched
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep

    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(0, 1, (2, RES, RES, 3)).astype(np.float32)
             for k in ("input", "target")}
    model = JaxUNet(dim=DIM)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(batch["input"]))
    prng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (0.1 * prng.standard_normal(a.shape)).astype(np.float32),
        shapes)
    y = np.asarray(jax.jit(model.apply)(params, batch["input"]))
    state = JState.create(params, jopt(jsched(**SCHEDULE)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, loss = jax.jit(jstep(model))(state, jb, jax.random.PRNGKey(0))
    grads = jax.grad(lambda p: jloss(model.apply(p, jb["input"]),
                                     jb["target"]))(params)
    return SimpleNamespace(batch=batch, params=params, y=y,
                           before=state_dict_from_jax(params),
                           after=state_dict_from_jax(new.params),
                           grads=state_dict_from_jax(grads),
                           loss=float(loss))


def _port(sd) -> UNet:
    model = get_arch({"arch": "UNet", "embed_dim": DIM})
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    return model


def test_unet_forward_matches_jax(jax_unet):
    model = _port(jax_unet.before).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(jax_unet.batch["input"])).numpy()
    want = jax_unet.y
    assert got.shape == want.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * (1 + np.abs(want).max()))
    # prepared once for serving (weights cast and laid out channels_last):
    # the same function
    prepare_serving(model, torch.float32)
    with torch.no_grad():
        again = model(torch.from_numpy(jax_unet.batch["input"])).numpy()
    assert np.array_equal(again, got)


def test_unet_train_step_matches_jax(jax_unet):
    """One port train step from JAX's params: the loss; every gradient
    within 1e-4 max(1, max|g|) of JAX's; every parameter's update (AdamW,
    the schedule's lr, weight decay) within 2e-3 lr plus four float32
    spacings of the parameter, plus what the gradient's tolerance moves a
    first Adam step, lr g / (|g| + eps): lr eps dg / (|g| + eps)^2. That
    last term matters only where |g| is near eps (1e-8): the deep levels
    of a seeded UNet hold gradients of 1e-9 to 1e-7, whose first update
    swings with their last bits."""
    model = _port(jax_unet.before)
    sched = warmup_cosine_schedule(**SCHEDULE)
    state = TrainState(model, make_optimizer(model.parameters(), sched))
    batch = {k: torch.from_numpy(v) for k, v in jax_unet.batch.items()}
    loss = make_train_step(model)(state, batch,
                                  torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), jax_unet.loss, rtol=1e-5)
    assert blocks_without_backward_kernel(model) == []
    lr, eps = sched(0), 1e-8
    for name, p in model.named_parameters():
        g_ref = np.asarray(jax_unet.grads[name])
        g_tol = 1e-4 * max(1.0, float(np.abs(g_ref).max()))
        assert float(np.abs(p.grad.numpy() - g_ref).max()) <= g_tol, name
        before = np.asarray(jax_unet.before[name])
        want = np.asarray(jax_unet.after[name]) - before
        err = np.abs((p.detach().numpy() - before) - want)
        tol = (2e-3 * lr + 4 * np.spacing(np.abs(before))
               + lr * eps * g_tol / (np.abs(g_ref) + eps) ** 2)
        assert np.all(err <= tol), (name, float((err - tol).max()))


def test_unet_weights_round_trip_through_a_pth(jax_unet, tmp_path):
    """JAX params -> the port's state_dict -> a reference-format .pth
    (DataParallel prefix) -> load_pth and load_checkpoint: equal bits, and
    the JAX package's converter reads the file back to its params."""
    from uformer_tpu.convert.torch_converter import convert_checkpoint

    sd = jax_unet.before
    expected = {f"ConvBlock{i}.{c}.{w}" for i in range(1, 10)
                for c in ("block.0", "block.2", "conv11")
                for w in ("weight", "bias")}
    expected |= {f"{m}.{w}" for m in ("pool1", "pool2", "pool3", "pool4",
                                      "upv6", "upv7", "upv8", "upv9",
                                      "conv10") for w in ("weight", "bias")}
    assert set(sd) == expected
    # a transposed conv keeps torch's (in, out, kh, kw)
    assert sd["upv6.weight"].shape == (16 * DIM, 8 * DIM, 2, 2)
    path = str(tmp_path / "unet.pth")
    torch.save({"epoch": 1, "optimizer": {},
                "state_dict": {f"module.{k}": torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, path)
    got = load_pth(path)
    assert set(got) == set(sd)
    assert all(np.array_equal(got[k], sd[k]) for k in sd)
    model = load_checkpoint(get_arch({"arch": "UNet", "embed_dim": DIM}),
                            path)
    assert all(np.array_equal(v.numpy(), sd[k])
               for k, v in model.state_dict().items())
    import jax

    back = convert_checkpoint(path, "UNet")
    flat = jax.tree_util.tree_leaves(back)
    want = jax.tree_util.tree_leaves(jax_unet.params)
    assert len(flat) == len(want)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(flat, want))


def test_unet_keeps_channels_last_and_the_registry_default():
    model = get_arch({"arch": "UNet"})
    assert model.dim == 32 and model.conv10.in_channels == 32
    model = get_arch({"arch": "UNet", "embed_dim": DIM,
                      "use_checkpoint": True, "dtype": torch.bfloat16})
    assert model.dtype == torch.bfloat16
    outs = []
    for m in model.modules():
        if m is not model and not list(m.children()):
            m.register_forward_hook(lambda _m, _i, o: outs.append(o))
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = model(x, mask=torch.ones(1, 32, 32, 1))
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert y.is_contiguous()
    assert outs and all(o.is_contiguous(memory_format=torch.channels_last)
                        for o in outs)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("unet_pairs")
    rng = np.random.default_rng(2)
    for sub in ("groundtruth", "input"):
        (root / sub).mkdir()
    for i in range(4):
        gt = rng.uniform(0, 1, (32, 32, 3))
        for sub, img in (("groundtruth", gt), ("input", gt + 0.05)):
            cv2.imwrite(str(root / sub / f"{i}.png"), cv2.cvtColor(
                np.uint8(np.clip(img, 0, 1) * 255), cv2.COLOR_RGB2BGR))
    return root


def test_unet_through_the_train_and_eval_clis(tmp_path, pairs):
    """--arch UNet trains through the train CLI on the CPU (one epoch),
    and its model_latest.pth restores through the eval CLI's restorer."""
    from uformer_tpu_torch.eval.cli import build_restorer, eval_argparser
    from uformer_tpu_torch.train import cli

    tr, state, best = cli.main([
        "--arch", "UNet", "--embed_dim", str(DIM), "--train_ps", "32",
        "--batch_size", "2", "--nepoch", "1", "--workers", "1",
        "--save_dir", str(tmp_path), "--train_dir", str(pairs),
        "--val_dir", str(pairs), "--dtype", "float32",
        "--pretrain_weights", "", "--device", "cpu"])
    assert isinstance(tr.model, UNet) and state.step == 2
    assert np.isfinite(best) and best > 0
    latest = os.path.join(tr.model_dir, "model_latest.pth")
    args = eval_argparser().parse_args([
        "sidd", "--input_dir", str(tmp_path), "--weights", latest,
        "--arch", "UNet", "--embed_dim", str(DIM), "--device", "cpu"])
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    y = build_restorer(args)(x)
    model = load_checkpoint(get_arch({"arch": "UNet", "embed_dim": DIM}),
                            latest).eval()
    with torch.no_grad():
        want = model(torch.from_numpy(x)).clamp(0, 1).numpy()
    assert np.array_equal(y, want)
