"""The conv-projection Uformer in the port: the depthwise kernel
(`dwconv3x3`), `SepConv2d`, `ConvProjection`, the unfused block route,
`Mlp`, the cross-modulator's `Attention`, the input-mask bias, and whole
models against the JAX package.

On the CPU the plain versions are held against the JAX package's jnp
paths and its Pallas `dwconv3x3` with interpret=True, on the same numpy
inputs and on weights carried by `state_dict_from_jax` (fp32, tolerance
1e-4 (1 + max|ref|)); the recorded torch golden
tests/golden/uformer_convproj_crossmod.npz runs through the port within
1e-4, the budget of tests/test_golden_parity.py. The tests marked `gpu`
hold the CUDA kernel against its plain version on the card and skip
without one: `python -m pytest -m gpu tests/test_torch_port_convproj.py`.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import (
    _block,
    _qkv,
    load_numpy_state_dict,
    state_dict_from_jax,
)
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.layers import (
    GEOMETRY_NOT_ON_KERNEL_PATH,
    ConvProjection,
    LeWinBlock,
    SepConv2d,
)
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.masks import input_mask_bias
from uformer_tpu_torch.train import (
    TrainState,
    blocks_without_backward_kernel,
    make_optimizer,
    make_train_step,
)
from uformer_tpu_torch.utils.params import prepare_serving

torch.set_num_threads(1)
TOL = 1e-4
GOLDEN = Path(__file__).resolve().parent / "golden"
B_HEADS = (1, 2, 4, 8, 16, 16, 8, 4, 2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.models import layers
    from uformer_tpu.ops import dwconv, masks
    from uformer_tpu.ops.pallas import dwconv as pallas_dwconv

    return SimpleNamespace(jax=jax, jnp=jnp, layers=layers, masks=masks,
                           dwconv=dwconv, pallas=pallas_dwconv,
                           Uformer=JaxUformer)


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(
        device, dtype)


def _close(got, *wants):
    got = got.detach().float().numpy()
    for want in wants:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want,
                                   atol=TOL * (1 + np.abs(want).max()),
                                   rtol=0)


def _seeded_params(jx, module, seed, *args, std=0.2):
    """Params of a flax module drawn with numpy from a seed over the tree
    of eval_shape (every leaf N(0, std^2), LayerNorm scales around 1)."""
    jax = jx.jax
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (std * rng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)


def _unprefix(sd, prefix):
    return {k[len(prefix) + 1:]: torch.from_numpy(np.array(v))
            for k, v in sd.items()}


# ---- kernel 8: the depthwise 3x3 conv ----------------------------------

DW_SHAPES = [(6, 8, 8, 8), (6, 8, 8, 32), (6, 8, 8, 64), (2, 16, 24, 12)]


def _dw_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (0.3 * rng.standard_normal((3, 3, C))).astype(np.float32),
            (0.3 * rng.standard_normal(C)).astype(np.float32))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dwconv3x3_reference_matches_jax(jx, shape, with_bias):
    x, w, b = _dw_inputs(0, shape)
    b = b if with_bias else None
    got = K.dwconv3x3_reference(_t(x), _t(w), _t(b))
    jb = None if b is None else jx.jnp.asarray(b)
    kernel = jx.pallas.dwconv3x3(jx.jnp.asarray(x), jx.jnp.asarray(w), jb,
                                 interpret=True)
    jnp_out = jx.dwconv._depthwise_conv2d_jnp(jx.jnp.asarray(x),
                                              jx.jnp.asarray(w), jb)
    _close(got, kernel, jnp_out)


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dwconv3x3_reference_bf16_within_one_ulp(jx, shape):
    """bf16 x and w, fp32 bias: one rounding after fp32 sums on both
    sides, so they differ by at most one bf16 spacing of the result."""
    x, w, b = _dw_inputs(1, shape)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    got = K.dwconv3x3_reference(xb, wb, _t(b))
    assert got.dtype == torch.bfloat16
    bf = jx.jnp.bfloat16
    want = np.asarray(jx.pallas.dwconv3x3(
        jx.jnp.asarray(xb.float().numpy()).astype(bf),
        jx.jnp.asarray(wb.float().numpy()).astype(bf), jx.jnp.asarray(b),
        interpret=True).astype(jx.jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


def test_dwconv3x3_pads_each_window_with_zeros():
    """A window batch is a batch of images: the same pixels as one image
    give another answer at the window borders."""
    x, w, b = _dw_inputs(2, (1, 16, 16, 8))
    img = K.dwconv3x3_reference(_t(x), _t(w), _t(b))
    wnd = torch.from_numpy(x).reshape(1, 2, 8, 2, 8, 8) \
        .permute(0, 1, 3, 2, 4, 5).reshape(4, 8, 8, 8)
    per = K.dwconv3x3_reference(wnd, _t(w), _t(b)).reshape(1, 2, 2, 8, 8, 8) \
        .permute(0, 1, 3, 2, 4, 5).reshape(1, 16, 16, 8)
    inner = (slice(None), slice(1, 7), slice(1, 7))
    torch.testing.assert_close(per[inner], img[inner], rtol=0, atol=1e-6)
    assert float((per[:, 7] - img[:, 7]).abs().max()) > 1e-2


def test_dwconv3x3_takes_the_plain_version_on_cpu():
    x, w, b = _dw_inputs(3, (2, 8, 8, 16))
    K.reset_counts()
    y = K.dwconv3x3(_t(x), _t(w), _t(b))
    assert K.plain_counts()["dwconv3x3"] == 1
    assert set(K.launch_counts().values()) == {0}
    torch.testing.assert_close(y, K.dwconv3x3_reference(_t(x), _t(w), _t(b)),
                               rtol=0, atol=0)


# ---- SepConv2d and ConvProjection --------------------------------------

@pytest.mark.parametrize("k,stride", [(3, 1), (5, 1), (3, 2)])
def test_sepconv2d_matches_jax(jx, k, stride):
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 16)) \
        .astype(np.float32)
    mod = jx.layers.SepConv2d(24, k, stride)
    params = _seeded_params(jx, mod, 5, jx.jnp.asarray(x))
    want = mod.apply(params, jx.jnp.asarray(x))
    sd = {}
    _qkv(sd, "m", {name: params["params"] for name in ("to_q", "to_k",
                                                       "to_v")})
    port = SepConv2d(16, 24, k, stride)
    port.load_state_dict(_unprefix(
        {k_: v for k_, v in sd.items() if k_.startswith("m.to_q.")},
        "m.to_q"), strict=True)
    K.reset_counts()
    with torch.no_grad():
        got = port(_t(x), port.kernel_params(torch.float32))
    _close(got, want)
    assert K.plain_counts()["dwconv3x3"] == int(k == 3 and stride == 1)


def test_conv_projection_matches_jax(jx):
    x = np.random.default_rng(6).standard_normal((6, 64, 32)) \
        .astype(np.float32)
    mod = jx.layers.ConvProjection(num_heads=2, head_dim=16)
    params = _seeded_params(jx, mod, 7, jx.jnp.asarray(x))
    want = mod.apply(params, jx.jnp.asarray(x))
    sd = {}
    _qkv(sd, "qkv", params["params"])
    port = ConvProjection(32, 32)
    port.load_state_dict(_unprefix(sd, "qkv"), strict=True)
    with torch.no_grad():
        got = port(_t(x), port.kernel_params(torch.float32), 2)
    for g, w in zip(got, want):
        assert g.shape == (6, 2, 64, 16)
        _close(g, w)


# ---- the block: conv route, Mlp, cross-modulator, input mask -----------

BLOCKS = {  # name -> LeWinBlock options beyond dim, heads, win
    "conv": dict(token_projection="conv"),
    "conv mlp": dict(token_projection="conv", token_mlp="mlp"),
    "conv cross": dict(token_projection="conv", cross_modulator=True),
    "linear mlp cross": dict(token_mlp="ffn", cross_modulator=True),
}


def _block_pair(jx, opts, shift, modulator, x, seed, mask=None):
    """JAX LeWinBlock (jnp backend) and the port's on carried weights."""
    C = x.shape[-1]
    kw = dict(dim=C, num_heads=2, win_size=8, shift_size=shift,
              modulator=modulator, **opts)
    mod = jx.layers.LeWinBlock(attn_backend="jnp", **kw)
    jmask = None if mask is None else jx.jnp.asarray(mask)
    params = _seeded_params(jx, mod, seed, jx.jnp.asarray(x), jmask)
    want = mod.apply(params, jx.jnp.asarray(x), jmask)
    sd = {}
    _block(sd, "b", params["params"])
    port = LeWinBlock(**{k: v for k, v in kw.items() if k != "dim"},
                      dim=C).eval()
    port.load_state_dict(_unprefix(sd, "b"), strict=True)
    return port, want


@pytest.mark.parametrize("modulator", [True, False])
@pytest.mark.parametrize("shift", [0, 4])
def test_conv_block_matches_jax(jx, shift, modulator):
    x = np.random.default_rng(8).standard_normal((2, 16, 24, 32)) \
        .astype(np.float32)
    port, want = _block_pair(jx, BLOCKS["conv"], shift, modulator, x, 9)
    K.reset_counts()
    with torch.no_grad():
        got = port(_t(x))
    _close(got, want)
    # the q, k and v depthwise convs in one call of the fused form
    assert K.plain_counts()["dwconv3x3_qkv"] == 1
    assert K.plain_counts()["dwconv3x3"] == 0
    assert K.plain_counts()["leff"] == 1


@pytest.mark.parametrize("name", ["conv mlp", "conv cross",
                                  "linear mlp cross"])
def test_block_variants_match_jax(jx, name):
    x = np.random.default_rng(10).standard_normal((2, 16, 16, 32)) \
        .astype(np.float32)
    port, want = _block_pair(jx, BLOCKS[name], 4, True, x, 11)
    with torch.no_grad():
        got = port(_t(x))
    _close(got, want)


@pytest.mark.parametrize("layout,size", [("nchw", (16, 24)),
                                         ("nchw", (6, 10)),
                                         ("nhwc", (32, 40))])
def test_input_mask_bias_matches_jax(jx, layout, size):
    rng = np.random.default_rng(12)
    m = (rng.uniform(size=(2, 1) + size) > 0.5).astype(np.float32)
    if layout == "nhwc":
        m = m.transpose(0, 2, 3, 1)
    got = input_mask_bias(_t(m), 16, 24, 8)
    want = jx.masks.input_mask_bias(jx.jnp.asarray(m), 16, 24, 8)
    assert got.shape == (12, 64, 64) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("projection", ["linear", "conv"])
def test_masked_block_matches_jax(jx, projection):
    """An input mask sends the block down the unfused route, with the mask
    bias added to the shift mask."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 16, 24, 32)).astype(np.float32)
    mask = (rng.uniform(size=(2, 1, 8, 12)) > 0.3).astype(np.float32)
    port, want = _block_pair(jx, dict(token_projection=projection), 4, True,
                             x, 14, mask)
    K.reset_counts()
    with torch.no_grad():
        got = port(_t(x), mask=_t(mask))
    _close(got, want)
    assert K.plain_counts()["attention_image"] == 0
    assert K.plain_counts()["attention_block"] == 0
    with torch.no_grad():
        assert float((port(_t(x)) - got).abs().max()) > 1e-3


# ---- whole models -------------------------------------------------------

SMALL_CONV = dict(img_size=64, embed_dim=16, depths=(1,) * 9,
                  num_heads=B_HEADS, win_size=8, token_projection="conv",
                  modulator=True)


@pytest.fixture(scope="module")
def small_conv(jx):
    x = np.random.default_rng(15).uniform(0, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    model = jx.Uformer(attn_backend="jnp", **SMALL_CONV)
    params = _seeded_params(jx, model, 16, jx.jnp.asarray(x), std=0.05)
    return model, params, x


def test_state_dict_from_jax_carries_conv_blocks(small_conv):
    from uformer_tpu.convert.torch_exporter import export_uformer

    _, params, _ = small_conv
    sd = state_dict_from_jax(params)
    want = export_uformer(params)
    assert list(sd) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    assert sd["encoderlayer_0.blocks.0.attn.qkv.to_q.depthwise.weight"] \
        .shape == (16, 1, 3, 3)
    assert sd["encoderlayer_0.blocks.0.attn.qkv.to_q.pointwise.weight"] \
        .shape == (16, 16, 1, 1)


@pytest.mark.parametrize("with_mask", [False, True])
def test_small_conv_uformer_matches_jax(jx, small_conv, with_mask):
    model, params, x = small_conv
    mask = None
    if with_mask:
        mask = (np.random.default_rng(17).uniform(size=(1, 1, 64, 64))
                > 0.2).astype(np.float32)
    want = np.asarray(jx.jax.jit(model.apply)(
        params, jx.jnp.asarray(x),
        None if mask is None else jx.jnp.asarray(mask)))
    port = Uformer(**SMALL_CONV).eval()
    load_numpy_state_dict(port, state_dict_from_jax(params))
    K.reset_counts()
    with torch.no_grad():
        got = port(_t(x), mask=_t(mask))
    _close(got, want)
    assert K.plain_counts()["dwconv3x3_qkv"] == 9


def _golden():
    spec = importlib.util.spec_from_file_location(
        "golden_generate", GOLDEN / "generate.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    data = np.load(GOLDEN / "uformer_convproj_crossmod.npz")
    sd = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
    kw = dict(gen.CONVPROJ, depths=tuple(gen.CONVPROJ["depths"]),
              num_heads=tuple(gen.CONVPROJ["num_heads"]))
    return kw, data, sd


def test_convproj_golden_through_the_port():
    """The recorded torch output of the conv-projection, Mlp,
    cross-modulator Uformer at 64^2 (its bottleneck runs 4x4 windows),
    within 1e-4."""
    kw, data, sd = _golden()
    port = load_numpy_state_dict(Uformer(**kw), sd).eval()
    assert port.conv.blocks[0].win_size == 4
    K.reset_counts()
    with torch.no_grad():
        got = port(torch.from_numpy(data["input"].transpose(0, 2, 3, 1)
                                    .copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 1, 2),
                               data["output"], atol=TOL, rtol=0)
    assert K.plain_counts() == {
        "stage": 0, "attention_image": 0, "leff": 0, "attention_bwd": 0,
        "attention_block_bwd": 0, "leff_bwd": 0, "window_attention": 0,
        "attention_block": 0, "dwconv3x3": 0, "dwconv3x3_qkv": 9}


def test_golden_config_matches_jax(jx):
    """JAX Uformer of the golden's config on the golden's weights (JAX's
    converter) against the port on those weights carried back by
    `state_dict_from_jax`."""
    from uformer_tpu.convert import convert_uformer

    kw, data, sd = _golden()
    params = jx.jax.tree_util.tree_map(jx.jnp.asarray, convert_uformer(sd))
    jkw = dict(kw, token_mlp="ffn")  # "mlp" is the reference's alias
    model = jx.Uformer(attn_backend="jnp", **jkw)
    x = data["input"].transpose(0, 2, 3, 1).copy()
    want = np.asarray(jx.jax.jit(model.apply)(params, jx.jnp.asarray(x)))
    carried = state_dict_from_jax(params)
    for k, v in carried.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    port = load_numpy_state_dict(Uformer(**kw), carried).eval()
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want)


def test_serve_bconv_shape_routes_to_the_depthwise_kernel():
    """Uformer_B's widths with conv projection (the served B-conv model)
    at depth 1: 1 fused q/k/v depthwise and 1 LeFF dispatch per block, and
    no stage, attention-image or attention-block dispatch; conv weights
    prepared once, in the working dtype, biases float32."""
    model = Uformer(img_size=256, embed_dim=32, depths=(1,) * 9,
                    num_heads=B_HEADS, token_projection="conv",
                    modulator=True).eval()
    assert not any(getattr(model, n).stage_ok for n in
                   ("encoderlayer_2", "conv", "decoderlayer_0"))
    prepare_serving(model, torch.bfloat16)
    blk = model.decoderlayer_0.blocks[0]
    with torch.no_grad():
        p = blk.params_for(torch.bfloat16, torch.device("cpu"))
    assert p is blk._kp[2]
    for name in ("to_q", "to_k", "to_v"):
        q = p[name]
        assert (q["wd"].dtype, q["wp"].dtype) == (torch.bfloat16,) * 2
        assert (q["bd"].dtype, q["bp"].dtype) == (torch.float32,) * 2
        assert q["wd"].shape == (3, 3, 512)
    assert p["wd3"].shape == (3, 3, 3, 512) and p["bd3"].shape == (3, 512)
    assert (p["wd3"].dtype, p["bd3"].dtype) == (torch.bfloat16,
                                                torch.float32)
    x = torch.rand(1, 128, 128, 3)
    K.reset_counts()
    with torch.no_grad():
        y = model(x)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    assert K.plain_counts() == {
        "stage": 0, "attention_image": 0, "leff": 9, "attention_bwd": 0,
        "attention_block_bwd": 0, "leff_bwd": 0, "window_attention": 0,
        "attention_block": 0, "dwconv3x3": 0, "dwconv3x3_qkv": 9}
    assert set(K.launch_counts().values()) == {0}


def test_train_guard_names_conv_mlp_and_cross_blocks():
    """Conv projection has no backward kernel: its blocks are named. Mlp
    and cross-modulator blocks train on the kernel path (their attention
    through the attention kernels, the Mlp and the cross-attention as
    plain PyTorch, as in JAX), at head dim 32 and 16 alike."""
    conv = Uformer(img_size=128, embed_dim=32, depths=(1,) * 9,
                   num_heads=B_HEADS, token_projection="conv")
    uncovered = blocks_without_backward_kernel(conv)
    assert len(uncovered) == 9 and uncovered[0] == "encoderlayer_0.blocks.0"
    assert conv.encoderlayer_0.blocks[0].backward_gap == \
        K.DWCONV_BACKWARD_NOT_PORTED
    for embed in (32, 16):
        for opts in (dict(token_mlp="mlp"), dict(cross_modulator=True),
                     dict(token_mlp="mlp", cross_modulator=True)):
            m = Uformer(img_size=128, embed_dim=embed, depths=(1,) * 9,
                        num_heads=B_HEADS, **opts)
            assert blocks_without_backward_kernel(m) == [], (embed, opts)
    # a window below 8 (the 64^2 model's 4 x 4 bottleneck) is covered too
    # (packed tiles), and so are head dim 64 (embed 64) and a window of
    # 17; head dim 20 is not (no kernel takes it either way)
    narrow = Uformer(img_size=64, embed_dim=16, depths=(1,) * 9,
                     num_heads=B_HEADS)
    assert narrow.conv.blocks[0].win_size == 4
    assert blocks_without_backward_kernel(narrow) == []
    wide = Uformer(img_size=64, embed_dim=64, depths=(1,) * 9,
                   num_heads=B_HEADS)
    assert blocks_without_backward_kernel(wide) == []
    w17 = Uformer(img_size=32, embed_dim=16, depths=(1,) * 9,
                  num_heads=B_HEADS, win_size=17)
    assert blocks_without_backward_kernel(w17) == []
    d20 = Uformer(img_size=32, embed_dim=20, depths=(1,) * 9,
                  num_heads=B_HEADS, win_size=17)
    assert blocks_without_backward_kernel(d20)[0] == \
        "encoderlayer_0.blocks.0"
    assert d20.encoderlayer_0.blocks[0].backward_gap == \
        GEOMETRY_NOT_ON_KERNEL_PATH


def test_conv_train_step_runs_on_cpu():
    """One plain-path train step of a tiny conv-projection model: the
    depthwise conv's plain version under autograd."""
    torch.manual_seed(0)
    model = Uformer(img_size=128, embed_dim=8, depths=(1,) * 9,
                    num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1),
                    token_projection="conv", token_mlp="mlp",
                    cross_modulator=True, modulator=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 1e-3))
    step = make_train_step(model)
    rng = np.random.default_rng(18)
    x = _t(rng.uniform(0, 1, (1, 128, 128, 3)))
    K.reset_counts()
    loss = step(state, {"input": x, "target": x.clamp(0.1, 0.9)},
                torch.Generator().manual_seed(1))
    assert np.isfinite(float(loss))
    assert K.plain_counts()["dwconv3x3_qkv"] == 9
    dw = "encoderlayer_0.blocks.0.attn.qkv.to_q.depthwise.weight"
    assert float(dict(model.named_parameters())[dw].grad.abs().max()) > 0
    assert not torch.equal(before[dw], dict(model.named_parameters())[dw])


# ---- on the card -------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# chip_smoke.py's kernel shapes: each Uformer_B-conv stage's windows at
# 256^2 batch 2 (Bw, 8, 8, C), the 64^2 golden's 4x4 bottleneck, a whole
# image, an odd C without bias (scalar path) and C = 8
CARD_SHAPES = [((2048, 8, 8, 32), True), ((512, 8, 8, 64), True),
               ((128, 8, 8, 128), True), ((32, 8, 8, 256), True),
               ((8, 8, 8, 512), True), ((2, 4, 4, 128), True),
               ((2, 64, 64, 128), True), ((2, 24, 40, 12), False),
               ((128, 8, 8, 8), True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,with_bias", CARD_SHAPES)
def test_dwconv3x3_kernel_on_card(shape, with_bias):
    """fp32 (TF32 off): within 1e-4 (1 + max|ref|) of the plain version;
    bf16 (bf16 weights, fp32 bias): its error against the fp32 plain
    result within 1.5x the bf16 plain version's + 1e-3."""
    dev = _cuda()
    x, w, b = _dw_inputs(19, shape)
    x = _t(x, dev).bfloat16().float()
    w = _t(w, dev).bfloat16().float()
    b = _t(b, dev) if with_bias else None
    K.reset_counts()
    ref = K.dwconv3x3_reference(x, w, b)
    err = float((K.dwconv3x3(x, w, b) - ref).abs().max())
    assert err <= TOL * (1 + float(ref.abs().max())), err
    xb, wb = x.bfloat16(), w.bfloat16()
    e_plain = float((K.dwconv3x3_reference(xb, wb, b).float() - ref)
                    .abs().max())
    e_kernel = float((K.dwconv3x3(xb, wb, b).float() - ref).abs().max())
    assert e_kernel <= 1.5 * e_plain + 1e-3, (e_kernel, e_plain)
    assert K.launch_counts()["dwconv3x3"] == 2


@pytest.mark.gpu
def test_conv_model_refuses_to_train_on_card():
    """No backward kernel for the depthwise conv: the train step refuses a
    conv-projection model before it runs, and the wrapper refuses inputs
    that need a gradient."""
    dev = _cuda()
    x = torch.rand(2, 8, 8, 16, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="dwconv3x3"):
        K.dwconv3x3(x, torch.rand(3, 3, 16, device=dev))
    model = Uformer(img_size=128, embed_dim=16, depths=(1,) * 9,
                    num_heads=B_HEADS, token_projection="conv").to(dev)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 1e-4))
    img = torch.rand(1, 128, 128, 3, device=dev)
    K.reset_counts()
    with pytest.raises(NotImplementedError, match="dwconv3x3"):
        make_train_step(model)(state, {"input": img, "target": img},
                               torch.Generator())
    assert set(K.launch_counts().values()) == {0}


@pytest.mark.gpu
def test_mlp_cross_modulator_train_step_on_card():
    """A linear-projection Uformer with Mlp blocks and the cross-modulator
    trains on the card: its attention forward and backward through the
    kernels (image route and windowed branch, head dim 16), the Mlp and
    the cross-attention as plain PyTorch. One fp32 step, kernel path
    against plain path: loss and every gradient within 1e-4 (1 +
    max|ref|)."""
    dev = _cuda()
    torch.manual_seed(0)
    model = Uformer(img_size=128, embed_dim=16, depths=(1,) * 9,
                    num_heads=B_HEADS, token_mlp="mlp",
                    cross_modulator=True, modulator=True).to(dev)
    rng = np.random.default_rng(20)
    x = _t(rng.uniform(0, 1, (2, 128, 128, 3)), dev)
    batch = {"input": x, "target": x.clamp(0.1, 0.9)}
    out = {}
    for plain in (True, False):
        state = TrainState(model, make_optimizer(model.parameters(),
                                                 lambda s: 0.0))
        K.reset_counts()
        loss = make_train_step(model, plain=plain)(
            state, batch, torch.Generator().manual_seed(1))
        # norm_cross is built and never applied (the reference quirk)
        out[plain] = (loss, {n: p.grad.clone()
                             for n, p in model.named_parameters()
                             if "norm_cross" not in n})
    launched = K.launch_counts()
    assert launched["attention_image"] == launched["attention_bwd"] == 8
    assert launched["attention_block"] == launched["attention_block_bwd"] == 1
    assert launched["leff"] == launched["leff_bwd"] == 0
    assert set(K.plain_counts().values()) == {0}
    (l0, ref), (l1, got) = out[True], out[False]
    assert abs(float(l1) - float(l0)) <= TOL * (1 + abs(float(l0)))
    for n, r in ref.items():
        err = float((got[n] - r).abs().max())
        assert err <= TOL * (1 + float(r.abs().max())), (n, err)
