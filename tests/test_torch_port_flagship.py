"""The port's plain path against the recorded torch activations of
tests/golden/uformer_flagship.npz, stage by stage (the budget of
tests/test_golden_parity.py, 1e-4), on the CPU.

The golden's geometry is `tests/golden/generate.py:FLAGSHIP`: embed 8,
depths 2, 64^2, window 8, heads (1, 2, 4, 8, 8, 8, 4, 2, 1). The
registry's `get_arch("Uformer", embed_dim=8)` fixes the reference's heads
(1, 2, 4, 8, 16, 16, 8, 4, 2), which differ in the bottleneck and the
decoder, so the model is built from
FLAGSHIP through `Uformer` directly; its head dim 8 has no kernel on the
card (ROADMAP.md port queue 2 item 3), and the CPU runs the plain path.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.golden.generate import FLAGSHIP, STAGES
from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import load_numpy_state_dict
from uformer_tpu_torch.models import Uformer

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parent / "golden" / "uformer_flagship.npz"
TOL = 1e-4


def _to_nhwc(a):
    if a.ndim == 3:
        B, L, C = a.shape
        s = int(round(np.sqrt(L)))
        return a.reshape(B, s, s, C)
    return a.transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def flagship():
    """The golden weights through the port's plain path: each stage's
    output and the model's output."""
    data = np.load(GOLDEN)
    sd = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
    kw = {k: v for k, v in FLAGSHIP.items() if k != "token_mlp"}
    model = load_numpy_state_dict(
        Uformer(**dict(kw, depths=tuple(kw["depths"]),
                       num_heads=tuple(kw["num_heads"]))), sd).eval()
    acts = {}
    for s in STAGES:
        getattr(model, s).register_forward_hook(
            lambda _m, _i, out, s=s: acts.__setitem__(s, out.numpy()))
    with torch.no_grad():
        y = model(torch.from_numpy(data["input"].transpose(0, 2, 3, 1)
                                   .copy())).numpy()
    return data, acts, y


@pytest.mark.parametrize("stage", STAGES)
def test_flagship_stage(flagship, stage):
    data, acts, _ = flagship
    want = _to_nhwc(data[f"act/{stage}"])
    assert acts[stage].shape == want.shape
    err = float(np.abs(acts[stage] - want).max())
    assert err <= TOL, f"stage {stage}: max diff {err}"


def test_flagship_output(flagship):
    data, _, y = flagship
    np.testing.assert_allclose(y, data["output"].transpose(0, 2, 3, 1),
                               atol=TOL, rtol=0)


def test_registry_builds_the_flagship_widths():
    """get_arch builds Uformer at embed 8 (and any window) on the CPU with
    the golden's parameter names and shapes, but for the bias tables of
    the bottleneck and the decoder, which have the registry's heads."""
    data = np.load(GOLDEN)
    golden = {k[len("sd/"):]: data[k].shape for k in data.files
              if k.startswith("sd/")}
    model = get_arch({"arch": "Uformer", "embed_dim": 8, "train_ps": 64})
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    differ = {k for k in golden if own.get(k) != golden[k]}
    assert set(golden) <= set(own)
    assert differ and all(
        k.startswith(("conv.", "decoderlayer_"))
        and k.endswith("relative_position_bias_table") for k in differ)
