"""The port's remaining blocks against the JAX package's, on the CPU: the
dilated window partition and reverse (`ops/window.py`), `Eca1d` and
`LeFF(use_eca=True)` (`models/layers.py`), and each auxiliary block of
`models/extras.py`, on the same numpy weights through
`convert.block_state_dict_from_jax`.

fp32 within 1e-4 (1 + max|ref|) unless stated; the window ops in equal
bits. JAX is imported inside the tests.
"""

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import block_state_dict_from_jax
from uformer_tpu_torch.models import extras
from uformer_tpu_torch.models.layers import Eca1d, LeFF, LeWinBlock
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.window import window_partition, window_reverse

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _seeded(jax, params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def _load(module, block, params):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            block_state_dict_from_jax(block, params).items()},
                           strict=True)
    return module


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * (1 + np.abs(want).max()))


# ---- dilated window ops ---------------------------------------------------

@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("hw", [(16, 16), (24, 40)])
def test_dilated_window_ops_match_jax_bit_for_bit(jx, d, hw):
    """Partition (F.unfold) and reverse (F.fold) at dilation d against
    `uformer_tpu.ops.window` in equal bits: reverse on seeded windows, so
    a pixel's two to four taps (d = 2) are distinct values whose float sum
    depends on their order, and on partition's own windows (x weighted by
    the tap count)."""
    from uformer_tpu.ops import window as jw

    H, W = hw
    x = np.random.default_rng(d).standard_normal((2, H, W, 5)) \
        .astype(np.float32)
    want = np.asarray(jw.window_partition(x, 8, d))
    got = window_partition(torch.from_numpy(x), 8, d).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    wnd = np.random.default_rng(d + 10).standard_normal(want.shape) \
        .astype(np.float32)
    for windows in (wnd, want):
        ref = np.asarray(jw.window_reverse(windows, 8, H, W, d))
        out = window_reverse(torch.from_numpy(np.array(windows)), 8, H, W,
                             d).numpy()
        assert out.shape == (2, H, W, 5) and np.array_equal(out, ref)


def test_dilation_one_keeps_its_reshapes():
    """d = 1 stays the plain reshape pair: reverse(partition(x)) is x."""
    x = torch.randn(2, 16, 24, 3, generator=torch.Generator().manual_seed(0))
    wnd = window_partition(x, 8)
    assert wnd.shape == (12, 64, 3)
    assert torch.equal(wnd[1].reshape(8, 8, 3), x[0, :8, 8:16])
    assert torch.equal(window_reverse(wnd, 8, 16, 24), x)
    with pytest.raises(ValueError, match="multiples"):
        window_partition(x[:, :12], 8)


# ---- Eca1d and LeFF with it -----------------------------------------------

def test_eca1d_matches_jax_and_keeps_the_reference_layout(jx):
    from uformer_tpu.models.layers import Eca1d as JEca

    x = _x((2, 8, 8, 16))
    for k in (3, 5):
        jm = JEca(k_size=k)
        p = _seeded(jx, jm.init(jx.random.PRNGKey(0), x), k)
        sd = block_state_dict_from_jax("Eca1d", p)
        # JAX's HIO (k, 1, 1) -> the reference's Conv1d weight (1, 1, k)
        assert list(sd) == ["conv.weight"] and sd["conv.weight"].shape == \
            (1, 1, k)
        assert np.array_equal(sd["conv.weight"][0, 0],
                              np.asarray(p["params"]["conv"])[:, 0, 0])
        _close(_load(Eca1d(k), "Eca1d", p)(torch.from_numpy(x)),
               jm.apply(p, x))


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_leff_with_eca_matches_jax(jx, ln, residual):
    """LeFF(use_eca=True) against JAX's (jnp path): kernel 2's route with
    its residual off, the gate, the residual after it; `mlp.eca.conv`
    keeps the reference's key. The autograd route (`leff_ad`, whose
    backward is kernel 7's plain version on the CPU) and the plain route
    give the same values and the same gradients."""
    from uformer_tpu.models.layers import LeFF as JLeFF

    x = _x((2, 8, 8, 16))
    jm = JLeFF(hidden_dim=64, use_eca=True, dw_backend="jnp")
    p = _seeded(jx, jm.init(jx.random.PRNGKey(0), x), 3)
    rng = np.random.default_rng(4)
    ln_p = ((1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
            (0.1 * rng.standard_normal(16)).astype(np.float32)) if ln \
        else None
    want = jm.apply(p, x, ln_params=ln_p, residual=residual)
    port = _load(LeFF(16, 64, use_eca=True), "LeFF", p)
    assert "eca.conv.weight" in port.state_dict()
    kw = dict(residual=residual)
    if ln:
        kw.update(ln_s=torch.from_numpy(ln_p[0]),
                  ln_b=torch.from_numpy(ln_p[1]))
    grads = []
    for plain in (True, False):
        xt = torch.from_numpy(x).requires_grad_(True)
        K.reset_counts()
        y = port(xt, plain=plain, **kw)
        _close(y, want)
        y.square().sum().backward()
        if not plain:
            assert K.plain_counts()["leff"] == 1
            assert K.plain_counts()["leff_bwd"] == 1
        grads.append([xt.grad] + [q.grad.clone() for q in port.parameters()])
        port.zero_grad()
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * (1 + float(b.abs().max())))


def test_lewin_block_builds_leff_without_eca():
    """As JAX's LeWinBlock, which exposes no use_eca: no gate, no key."""
    blk = LeWinBlock(16, 1)
    assert blk.mlp.eca is None
    assert not any("eca" in k for k in blk.state_dict())


# ---- the auxiliary blocks --------------------------------------------------

def _extras_cases():
    from uformer_tpu.models import extras as je

    return {
        "LPU": (je.LPU(), extras.LPU(16)),
        "PosCNN": (je.PosCNN(16), extras.PosCNN(16)),
        "PosCNN stride 2": (je.PosCNN(16, stride=2),
                            extras.PosCNN(16, stride=2)),
        "SELayer": (je.SELayer(reduction=4), extras.SELayer(16, 4)),
        "EcaLayer": (je.EcaLayer(), extras.EcaLayer()),
        "BlurPool2D": (je.BlurPool2D(), extras.BlurPool2D()),
        "BlurPool2D 4 taps": (je.BlurPool2D(4, 2), extras.BlurPool2D(4, 2)),
        "BlurPool2D 1 tap": (je.BlurPool2D(1, 2), extras.BlurPool2D(1, 2)),
    }


@pytest.mark.parametrize("name", ["LPU", "PosCNN", "PosCNN stride 2",
                                  "SELayer", "EcaLayer", "BlurPool2D",
                                  "BlurPool2D 4 taps", "BlurPool2D 1 tap"])
def test_extras_block_matches_jax(jx, name):
    jm, pm = _extras_cases()[name]
    x = _x((2, 8, 8, 16))
    p = _seeded(jx, jm.init(jx.random.PRNGKey(0), x), 5)
    _close(_load(pm, name.split()[0], p)(torch.from_numpy(x)),
           jm.apply(p, x))


def test_sam_matches_jax(jx):
    from uformer_tpu.models.extras import SAM as JSAM

    x, img = _x((2, 8, 8, 16)), _x((2, 8, 8, 3), 1)
    for bias in (True, False):
        jm = JSAM(n_feat=16, use_bias=bias)
        p = _seeded(jx, jm.init(jx.random.PRNGKey(0), x, img), 6)
        feats, out = _load(extras.SAM(16, bias=bias), "SAM", p)(
            torch.from_numpy(x), torch.from_numpy(img))
        want_feats, want_img = jm.apply(p, x, img)
        _close(feats, want_feats)
        _close(out, want_img)


@pytest.mark.parametrize("taps", [1, 3, 4, 5])
def test_blurpool1d_matches_jax_and_keeps_constants(jx, taps):
    from uformer_tpu.models.extras import BlurPool1D as JBlur

    x = _x((2, 16, 6))
    jm = JBlur(taps, 2)
    want = jm.apply(jm.init(jx.random.PRNGKey(0), x), x)
    _close(extras.BlurPool1D(taps, 2)(torch.from_numpy(x)), want)
    const = torch.full((1, 12, 4), 0.7)
    np.testing.assert_allclose(extras.BlurPool1D(taps, 2)(const).numpy(),
                               0.7, rtol=1e-6)
