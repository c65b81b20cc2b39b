"""The port's model (`uformer_tpu_torch.models`) against the JAX package.

- A small Uformer (embed 8, 128^2, depths of 1-2) against JAX
  `Uformer(attn_backend="jnp")` on weights carried by `state_dict_from_jax`
  (fp32, 1e-4). Its bottleneck and dec0 (C 128) take the stage route, dec0
  shifted and the bottleneck not; the narrow stages go per block.
- `state_dict_from_jax` against `uformer_tpu.convert.torch_exporter`.
- Uformer_B at 128^2 on its plain path against the recorded torch
  activations of tests/golden/uformer_b_128.npz (the budget of
  tests/test_golden_parity.py), and its kernel routing counted on the CPU.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden.generate import STAGES, seeded_state_dict
from uformer_tpu.convert.torch_exporter import export_uformer
from uformer_tpu.models import Uformer as JaxUformer
from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.restore import Restorer

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parent / "golden" / "uformer_b_128.npz"
SMALL = dict(img_size=128, embed_dim=8, depths=(1, 2, 1, 1, 1, 2, 1, 1, 1),
             num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), win_size=8,
             modulator=True)


@pytest.fixture(scope="module")
def small():
    """JAX params of the small Uformer drawn with numpy from a seed (every
    leaf N(0, 0.05^2), LayerNorm scales around 1, so biases and modulators
    are all non-trivial), and a seeded input. The tree comes from
    eval_shape: an eager init would compile every initializer."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 128, 128, 3)) \
        .astype(np.float32)
    model = JaxUformer(attn_backend="jnp", **SMALL)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * rng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)
    return model, params, x


def test_state_dict_from_jax_matches_exporter(small):
    _, params, _ = small
    sd = state_dict_from_jax(params)
    want = export_uformer(params)
    assert list(sd) == list(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    Uformer(**SMALL).load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=True)


def test_small_uformer_matches_jax(small):
    model, params, x = small
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))
    port = Uformer(**SMALL).eval()  # eval: no drop path, stage route
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          state_dict_from_jax(params).items()}, strict=True)
    routes = [name for name, m in port.named_children()
              if hasattr(m, "stage_ok") and m.stage_ok]
    assert routes == ["conv", "decoderlayer_0"]
    assert port.conv.use_shift is False
    assert port.decoderlayer_0.use_shift is True
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_restorer_clips_and_keeps_shape(small):
    _, params, x = small
    port = Uformer(**SMALL)
    load_numpy_state_dict(port, state_dict_from_jax(params))
    restorer = Restorer(port, torch.float32, "cpu")
    y = restorer(torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0
    with torch.no_grad():
        np.testing.assert_array_equal(
            y.numpy(), port(torch.from_numpy(x)).clamp(0, 1).numpy())


def test_registry_ports_the_uformer_family():
    assert get_arch({"arch": "Uformer_B", "train_ps": 256}) \
        .conv.use_shift is True
    assert get_arch({"arch": "Uformer_B", "train_ps": 128}) \
        .conv.use_shift is False
    t = get_arch({"arch": "Uformer_T", "train_ps": 256})
    assert t.encoderlayer_0.dim == 16 and t.decoderlayer_0.num_heads == 16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch({"arch": "UNet"})
    with pytest.raises(ValueError):
        get_arch({"arch": "nope"})


def _to_nhwc(a):
    if a.ndim == 3:
        B, L, C = a.shape
        s = int(round(np.sqrt(L)))
        return a.reshape(B, s, s, C)
    return a.transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def golden_run():
    """Uformer_B (train_ps 128) on the golden weights and input, plain
    path on the CPU: its stage activations and the kernel dispatches."""
    data = np.load(GOLDEN)
    sd = seeded_state_dict(json.loads(str(data["sd_manifest"])),
                           int(data["seed"]))
    model = load_numpy_state_dict(
        get_arch({"arch": "Uformer_B", "train_ps": 128}), sd).eval()
    acts = {}
    for s in STAGES:
        getattr(model, s).register_forward_hook(
            lambda _m, _i, out, s=s: acts.__setitem__(s, out.numpy()))
    K.reset_counts()
    with torch.no_grad():
        y = model(torch.from_numpy(data["input"].transpose(0, 2, 3, 1)
                                   .copy())).numpy()
    return data, acts, y, K.plain_counts(), K.launch_counts()


def test_uformer_b_golden_anchor(golden_run):
    data, acts, y, _, _ = golden_run
    for s in STAGES:
        want = _to_nhwc(data[f"act/{s}"].astype(np.float32))
        err = np.abs(acts[s] - want).max()
        # fp16-recorded activations: budget of test_golden_parity.py
        tol = 1e-3 + 1e-3 * float(np.abs(want).max())
        assert err <= tol, f"stage {s}: max diff {err} > {tol}"
    np.testing.assert_allclose(y, data["output"].transpose(0, 2, 3, 1),
                               atol=1e-3, rtol=0)


def test_uformer_b_routing(golden_run):
    """6 stage, 4 attention-image and 4 LeFF dispatches per forward, the
    routing of the 256^2 main path; on the CPU all are plain versions."""
    *_, plain, launched = golden_run
    assert plain == {"stage": 6, "attention_image": 4, "leff": 4,
                     "attention_bwd": 0, "attention_block_bwd": 0,
                     "leff_bwd": 0, "window_attention": 0,
                     "attention_block": 0, "dwconv3x3": 0,
                     "dwconv3x3_qkv": 0}
    assert set(launched.values()) == {0}
    model = get_arch({"arch": "Uformer_B", "train_ps": 256}).eval()
    stage_layers = [name for name, m in model.named_children()
                    if hasattr(m, "uses_stage") and m.uses_stage(
                        torch.empty(1, m.resolution, m.resolution, m.dim))]
    assert stage_layers == ["encoderlayer_2", "encoderlayer_3", "conv",
                            "decoderlayer_0", "decoderlayer_1",
                            "decoderlayer_2"]
