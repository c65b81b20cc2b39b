"""The port's tensor ops (`uformer_tpu_torch.ops`) against their JAX
counterparts in `uformer_tpu.ops`, on the same numpy inputs made from a
seed. Tolerance 1e-6 (fp32): the ops are data movement or short fp32
sums."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uformer_tpu.ops import attention as jattention
from uformer_tpu.ops import dwconv as jdwconv
from uformer_tpu.ops import masks as jmasks
from uformer_tpu.ops import relpos as jrelpos
from uformer_tpu.ops import window as jwindow
from uformer_tpu_torch.ops import attention, dwconv, masks, relpos, window

torch.set_num_threads(1)
TOL = 1e-6
REPO = Path(__file__).resolve().parents[1]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("shape,win", [((2, 16, 24, 8), 8),
                                       ((1, 8, 8, 32), 4)])
def test_window_partition_reverse_shift(shape, win):
    x = _rand(0, *shape)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    wt = window.window_partition(xt, win)
    _close(wt, jwindow.window_partition(xj, win))
    _close(window.window_reverse(wt, win, shape[1], shape[2]),
           jwindow.window_reverse(jwindow.window_partition(xj, win), win,
                                  shape[1], shape[2]))
    for s in (0, win // 2):
        _close(window.cyclic_shift(xt, s), jwindow.cyclic_shift(xj, s))
        _close(window.cyclic_unshift(xt, s), jwindow.cyclic_unshift(xj, s))


@pytest.mark.parametrize("wh,ww", [(8, 8), (4, 4)])
def test_relative_position_index_and_gather_bias(wh, ww):
    np.testing.assert_array_equal(relpos.relative_position_index(wh, ww),
                                  jrelpos.relative_position_index(wh, ww))
    table = _rand(1, (2 * wh - 1) * (2 * ww - 1), 3)
    _close(relpos.gather_bias(torch.from_numpy(table), wh, ww),
           jrelpos.gather_bias(jnp.asarray(table), wh, ww))


@pytest.mark.parametrize("H,W,win,shift", [(16, 16, 8, 4), (32, 16, 8, 4),
                                           (8, 8, 4, 2)])
def test_shift_window_mask(H, W, win, shift):
    assert masks.NEG_BIAS == jmasks.NEG_BIAS
    np.testing.assert_array_equal(masks.shift_window_mask(H, W, win, shift),
                                  jmasks.shift_window_mask(H, W, win, shift))


@pytest.mark.parametrize("mask_kind", ["none", "tiled", "per_window"])
def test_window_attention_core(mask_kind):
    Bw, nH, N, D = 4, 2, 16, 8
    q, k, v = (_rand(s, Bw, nH, N, D) for s in (2, 3, 4))
    bias = _rand(5, nH, N, N)
    mask = None
    if mask_kind != "none":
        nW = 2 if mask_kind == "tiled" else Bw
        mask = np.where(_rand(6, nW, N, N) > 0.5, -100.0, 0.0) \
            .astype(np.float32)
    got = attention.window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask), scale=0.35)
    want = jattention.window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)),
        None if mask is None else jnp.asarray(mask), scale=0.35,
        backend="jnp")
    _close(got, want)


def test_depthwise_conv():
    # unit-scale outputs: a 1e-6 bound is then a few fp32 ulps
    x, w, b = _rand(7, 2, 12, 10, 16), _rand(8, 3, 3, 16) / 3, _rand(9, 16)
    got = dwconv.depthwise_conv2d(*(torch.from_numpy(a) for a in (x, w, b)))
    want = jdwconv.depthwise_conv2d(*(jnp.asarray(a) for a in (x, w, b)),
                                    backend="jnp")
    _close(got, want)


def test_import_leaves_jax_out():
    """The port imports torch and never jax (fresh interpreter), the eval
    layer, the training entry point and their CLIs, UNet, the auxiliary
    blocks, the utilities and the parallel package included."""
    code = ("import sys, uformer_tpu_torch, uformer_tpu_torch.restore, "
            "uformer_tpu_torch.convert, uformer_tpu_torch.eval, "
            "uformer_tpu_torch.config, "
            + ", ".join(f"uformer_tpu_torch.eval.{m}" for m in (
                "bundle", "cli", "dnd", "gopro_hide", "image_io", "metrics",
                "padding", "realblur", "sidd"))
            + ", " + ", ".join(f"uformer_tpu_torch.{m}" for m in (
                "data.datasets", "data.native", "data.patches",
                "train.checkpoints", "train.trainer", "train.cli",
                "models.unet", "models.extras", "utils.freeze",
                "utils.flops", "utils.debug", "model_info", "parallel",
                "parallel.mesh", "parallel.multihost",
                "parallel.sharding_rules", "parallel.spatial"))
            + "; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'uformer_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
