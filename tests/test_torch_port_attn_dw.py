"""Kernel 1 (`fused_attention_image`: the narrow bf16 body
`csrc/attention_narrow_mma.cuh` at C 16-64 and the stage's
`attn_wide_item` at C 128-512, both persistent) and kernel 8 (`dwconv3x3`
on a pipelined persistent walk, and `dwconv3x3_qkv`, the q, k and v
convolutions of the conv token projection in one launch).

On the CPU the plain versions are held against the JAX package's jnp
references and its Pallas kernels with interpret=True on the same numpy
inputs (fp32, tolerance 1e-4 (1 + max|ref|)): the attention sub-block at
the narrow bodies' widths and head dims, several windows per image, shift
on and off, with and without a modulator, residual on and off, and C = 256
without the residual; the fused depthwise form against three JAX
`dwconv3x3` calls and `jax.nn.relu`. The host plans (`attention_image_plan`,
`wide_windows`, `persistent_grid`, `dwconv_plan`) are held to what they
promise, and `ConvProjection` on the CPU to its plain versions, counted.
The tests marked `gpu` run on the card:
`python -m pytest -m gpu tests/test_torch_port_attn_dw.py`. They hold
kernel 1 against its plain version at every shape of serve B, serve T,
train and train T (fp32 and bf16, residual on and off, windows per work
item from the plan, forced to 1 and to the body's most), and the fused
depthwise form bit for bit against three `dwconv3x3` launches and F.relu.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_port_kernels import _attn_inputs, _cast, _cuda, _t
from uformer_tpu_torch.models.layers import ConvProjection
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels import attention_image as ai_mod
from uformer_tpu_torch.ops.kernels.dwconv import DW_SMEM, dwconv_plan

torch.set_num_threads(1)
TOL = 1e-4
SMS = 132  # an H100 SXM's SMs


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops.pallas import attention_image
    from uformer_tpu.ops.pallas import dwconv as pallas_dwconv

    return SimpleNamespace(jax=jax, jnp=jnp, ai=attention_image,
                           dw=pallas_dwconv)


def _close(got, *wants):
    got = got.detach().float().numpy()
    for want in wants:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want,
                                   atol=TOL * (1 + np.abs(want).max()),
                                   rtol=0)


# ---- kernel 1's plain version against JAX (CPU) ------------------------

# (B, H, W, C, nH, shift, with_mod, residual): the narrow body's widths at
# head dim 16 and 32, 4-6 windows per image, and C = 256 without residual
ATTN_CASES = [(2, 16, 16, 16, 1, 4, True, True),
              (1, 16, 24, 16, 1, 0, False, False),
              (2, 16, 16, 32, 2, 4, False, False),
              (1, 16, 24, 32, 1, 4, True, False),
              (1, 24, 16, 32, 2, 0, True, True),
              (1, 16, 16, 64, 4, 4, True, False),
              (2, 16, 16, 64, 2, 4, False, True),
              (1, 16, 24, 64, 2, 0, True, False),
              (1, 16, 16, 256, 8, 4, True, False)]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_image_reference_matches_jax_narrow(jx, case):
    B, H, W, C, nH, shift, with_mod, residual = case
    inp = _attn_inputs(21, B, H, W, C, nH, with_mod)
    kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH,
              has_ln=True, residual=residual)
    got = K.attention_image_reference(*map(_t, inp.values()), **kw)
    jin = [None if a is None else jx.jnp.asarray(a) for a in inp.values()]
    _close(got, jx.ai.attention_image_reference(*jin, **kw),
           jx.ai.fused_attention_image(*jin, interpret=True, **kw))


def test_attention_image_takes_the_plain_version_on_cpu():
    inp = _attn_inputs(22, 1, 16, 16, 32, 2)
    kw = dict(win=8, shift=4, scale=0.25, num_heads=2, residual=False)
    args = list(map(_t, inp.values()))
    K.reset_counts()
    y = K.fused_attention_image(*args, **kw)
    assert K.plain_counts()["attention_image"] == 1
    assert set(K.launch_counts().values()) == {0}
    torch.testing.assert_close(y, K.attention_image_reference(*args, **kw),
                               rtol=0, atol=0)


# ---- kernel 8's fused form against JAX (CPU) -----------------------------

def _dw3_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (0.3 * rng.standard_normal((3, 3, 3, C))).astype(np.float32),
            (0.3 * rng.standard_normal((3, C))).astype(np.float32))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(6, 8, 8, 32), (4, 8, 8, 13),
                                   (3, 8, 8, 8), (2, 4, 4, 24)])
def test_dwconv3x3_qkv_reference_matches_jax(jx, shape, with_bias, relu):
    x, w3, b3 = _dw3_inputs(23, shape)
    b3 = b3 if with_bias else None
    got = K.dwconv3x3_qkv_reference(_t(x), _t(w3), _t(b3), relu=relu)
    assert len(got) == 3
    for i, g in enumerate(got):
        jb = None if b3 is None else jx.jnp.asarray(b3[i])
        want = jx.dw.dwconv3x3(jx.jnp.asarray(x), jx.jnp.asarray(w3[i]), jb,
                               interpret=True)
        _close(g, jx.jax.nn.relu(want) if relu else want)


def test_dwconv3x3_qkv_takes_the_plain_version_on_cpu():
    x, w3, b3 = _dw3_inputs(24, (2, 8, 8, 16))
    K.reset_counts()
    got = K.dwconv3x3_qkv(_t(x), _t(w3), _t(b3))
    assert K.plain_counts()["dwconv3x3_qkv"] == 1
    assert K.plain_counts()["dwconv3x3"] == 0
    assert set(K.launch_counts().values()) == {0}
    for g, w in zip(got, K.dwconv3x3_qkv_reference(_t(x), _t(w3), _t(b3))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_conv_projection_goes_through_the_plain_versions_on_cpu():
    """On the CPU ConvProjection calls the fused form, which answers with
    its plain version (one counted call for q, k and v); the result is
    that of the plain route (three SepConv2d on dwconv3x3_reference and
    F.relu), bit for bit."""
    torch.manual_seed(0)
    port = ConvProjection(32, 32)
    x = torch.randn(6, 64, 32)
    with torch.no_grad():
        p = port.kernel_params(torch.float32)
        K.reset_counts()
        got = port(x, p, 2)
        assert K.plain_counts()["dwconv3x3_qkv"] == 1
        assert K.plain_counts()["dwconv3x3"] == 0
        assert set(K.launch_counts().values()) == {0}
        want = port(x, p, 2, plain=True)
        assert K.plain_counts()["dwconv3x3_qkv"] == 1  # plain: uncounted
    for g, w in zip(got, want):
        assert g.shape == (6, 2, 64, 16)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---- host plans (CPU) ---------------------------------------------------

@pytest.mark.parametrize("windows,C,D,bf16,want", [
    (8192, 32, 32, True, ("narrow", 4)),   # serve B / train enc0
    (2048, 64, 32, True, ("narrow", 4)),   # serve B enc1
    (512, 64, 16, True, ("narrow", 2)),    # serve T enc2: spread the SMs
    (300, 32, 16, True, ("narrow", 2)),
    (100, 16, 16, True, ("narrow", 1)),
    (512, 128, 32, True, ("wide", 4)),     # train enc2
    (128, 256, 32, True, ("wide", 1)),     # train enc3
    (512, 256, 32, True, ("wide", 2)),     # train dec1
    (32, 512, 32, True, ("wide", 1)),      # train conv
    (128, 128, 16, True, ("wide", 1)),     # train T enc3
    (8192, 32, 32, False, ("window", 1)),  # fp32: a window per block
    (512, 96, 32, True, ("window", 1))])   # no bf16 body at C = 96
def test_attention_image_plan(windows, C, D, bf16, want):
    assert ai_mod.attention_image_plan(windows, C, D, bf16, SMS) == want


@pytest.mark.parametrize("windows,C,want", [
    (2048, 128, 4), (512, 128, 4), (128, 128, 1), (512, 256, 2),
    (128, 256, 1), (1024, 256, 2), (128, 512, 1), (300, 128, 1)])
def test_wide_windows(windows, C, want):
    """As the stage kernel's wide_windows: the most windows per item (WN C
    <= 512) that add no round of items over one block per SM."""
    def cost(wn):  # rounds of work items over the SMs, each wn windows
        return -(-(-(-windows // wn)) // SMS) * wn

    wn = ai_mod.wide_windows(windows, SMS, C)
    assert wn == want and wn * C <= 512
    assert all(cost(wn) <= cost(w) for w in (1, 2, 4) if w * C <= 512)


@pytest.mark.parametrize("items,slots,want", [
    (512, 132, 132), (100, 264, 100), (0, 132, 1), (264, 264, 264)])
def test_persistent_grid(items, slots, want):
    assert _launch.persistent_grid(items, slots) == want


DW_PLANS = [  # (shape, esize, vec, nq) -> (nb, Th, Tw, Cc)
    ((8192, 8, 8, 32), 2, True, 3, (4, 8, 8, 32)),
    ((2048, 8, 8, 64), 2, True, 3, (2, 8, 8, 64)),
    ((32, 8, 8, 512), 2, True, 3, (2, 8, 8, 64)),
    ((8192, 8, 8, 64), 4, True, 1, (1, 8, 8, 64)),
    ((8, 256, 256, 64), 2, True, 1, (1, 4, 32, 64)),
    ((2, 24, 40, 12), 2, False, 1, (1, 2, 32, 12)),
    ((128, 8, 8, 8), 2, True, 3, (8, 8, 8, 8)),
    ((1, 9, 70, 200), 4, True, 3, (1, 1, 32, 64))]


@pytest.mark.parametrize("shape,esize,vec,nq,want", DW_PLANS)
def test_dwconv_plan(shape, esize, vec, nq, want):
    B, H, W, C = shape
    plan = dwconv_plan(B, H, W, C, esize, vec, nq)
    assert (plan.nb, plan.Th, plan.Tw, plan.Cc) == want
    assert plan.smem <= DW_SMEM
    # the tiles cover the image once: chunks x image groups x rows x cols
    assert plan.tiles == (-(-C // plan.Cc) * -(-B // plan.nb)
                          * -(-H // plan.Th) * -(-W // plan.Tw))
    V = 16 // esize if vec else 1
    assert plan.Cc % V == 0
    # whole images per tile only when a tile holds the whole image
    assert plan.nb == 1 or (plan.Th, plan.Tw) == (H, W)


# ---- on the card --------------------------------------------------------

# (cell, B, res, C, heads, modulator): every shape kernel 1 runs at in
# serve B and serve T (bs8 256^2) and the train and train T steps (bs32
# 128^2)
CARD_ATTN = ([("serve B", 8, 256, 32, 1, False), ("serve B", 8, 128, 64, 2,
                                                   False),
              ("serve B", 8, 256, 64, 2, True),
              ("serve T", 8, 128, 32, 2, False),
              ("serve T", 8, 64, 64, 4, False),
              ("serve T", 8, 128, 64, 4, True),
              ("serve T", 8, 256, 32, 2, True)]
             + [("train", 32, 128 >> k, 32 << k, 1 << k, False)
                for k in range(5)]
             + [("train", 32, 16, 512, 16, True),
                ("train", 32, 32, 256, 8, True),
                ("train", 32, 64, 128, 4, True),
                ("train", 32, 128, 64, 2, True)]
             + [("train T", 32, 64 >> k, 32 << k, 2 << k, False)
                for k in range(4)]
             + [("train T", 32, 16, 256, 16, True),
                ("train T", 32, 32, 128, 8, True),
                ("train T", 32, 64, 64, 4, True),
                ("train T", 32, 128, 32, 2, True)])


_PLAN = ai_mod.attention_image_plan


def _forced_plan(monkeypatch, mode):
    """attention_image_plan with its windows per item forced to 1 ("one")
    or the body's most ("most": 4 narrow, 512 / C wide), or as planned."""
    def forced(windows, C, D, bf16, sms):
        body, wn = _PLAN(windows, C, D, bf16, sms)
        if body == "window" or mode == "plan":
            return body, wn
        return body, 1 if mode == "one" else (4 if body == "narrow"
                                              else 512 // C)

    monkeypatch.setattr(ai_mod, "attention_image_plan", forced)


@pytest.mark.gpu
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("case", CARD_ATTN,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}-{int(c[5])}"
                              for c in CARD_ATTN])
def test_attention_image_kernel_at_model_shapes(monkeypatch, case,
                                                residual):
    """fp32 (one window per block) within 1e-4 (1 + max|ref|); bf16 (the
    narrow or wide body, windows per item as planned, 1 and the most)
    within 1.5x the bf16 plain version's error against fp32 + 1e-3."""
    dev = _cuda()
    _, B, R, C, nH, with_mod = case
    inp = _attn_inputs(25, B, R, R, C, nH, with_mod)
    for k in ("wq", "wkv", "wo"):  # N(0, 1 / C), as a model's
        inp[k] = inp[k] / (0.2 * np.sqrt(C))
    x = _t(inp.pop("x"), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=4 if R > 8 else 0, scale=(C // nH) ** -0.5,
              num_heads=nH, residual=residual)

    def run(fn, dt):
        return fn(x.to(dt), *prm[dt].values(), **kw)

    ref = run(K.attention_image_reference, torch.float32)
    err = float((run(K.fused_attention_image, torch.float32) - ref)
                .abs().max())
    assert err <= TOL * (1 + float(ref.abs().max())), err
    e_plain = float((run(K.attention_image_reference, torch.bfloat16)
                     .float() - ref).abs().max())
    for mode in ("plan", "one", "most"):
        _forced_plan(monkeypatch, mode)
        K.reset_counts()
        e_kernel = float((run(K.fused_attention_image, torch.bfloat16)
                          .float() - ref).abs().max())
        assert K.launch_counts()["attention_image"] == 1
        assert e_kernel <= 1.5 * e_plain + 1e-3, (mode, e_kernel, e_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,nH", [
    ((2, 16, 16, 16), 1), ((3, 16, 24, 32), 2), ((3, 16, 24, 32), 1),
    ((1, 24, 16, 64), 4), ((1, 24, 16, 64), 2)])
def test_attention_image_narrow_without_ln_or_mod(shape, nH):
    """The narrow body with has_ln off and no modulator, at head dim 16
    and 32, windows per item as planned."""
    dev = _cuda()
    B, H, W, C = shape
    inp = _attn_inputs(26, B, H, W, C, nH, with_mod=False)
    x = _t(inp.pop("x"), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("mod", "wq", "wkv", "wo"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=4, scale=(C // nH) ** -0.5, num_heads=nH,
              has_ln=False)

    def run(fn, dt):
        return fn(x.to(dt), *prm[dt].values(), **kw)

    ref = run(K.attention_image_reference, torch.float32)
    e_plain = float((run(K.attention_image_reference, torch.bfloat16)
                     .float() - ref).abs().max())
    e_kernel = float((run(K.fused_attention_image, torch.bfloat16).float()
                      - ref).abs().max())
    assert e_kernel <= 1.5 * e_plain + 1e-3, (e_kernel, e_plain)


# serve B-conv's (Bw, 8, 8, C) windows at bs8 256^2, an image, the 64^2
# golden's 4 x 4 windows, partial tiles in every direction, a channel
# chunk remainder, and an odd C (the scalar path)
CARD_DW = [(8192, 8, 8, 32), (2048, 8, 8, 64), (512, 8, 8, 128),
           (128, 8, 8, 256), (32, 8, 8, 512), (8, 256, 256, 64),
           (2, 4, 4, 128), (3, 17, 45, 24), (1, 9, 70, 200), (4, 8, 8, 13)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_DW)
def test_dwconv3x3_qkv_equals_three_launches(shape, dtype):
    """The fused form is three dwconv3x3 launches and F.relu, bit for bit
    (weights in x's dtype and in fp32, bias or none, ReLU on and off), and
    each of those within the bf16 / fp32 budget of its plain version."""
    dev = _cuda()
    x, w3, b3 = _dw3_inputs(27, shape)
    x = _t(x, dev).bfloat16().to(dtype)
    w3 = _t(w3, dev).bfloat16().float()
    b3 = _t(b3, dev)
    for wdt in (dtype, torch.float32):
        for b in (b3, None):
            for relu in (True, False):
                K.reset_counts()
                got = K.dwconv3x3_qkv(x, w3.to(wdt), b, relu=relu)
                assert K.launch_counts()["dwconv3x3_qkv"] == 1
                for i, g in enumerate(got):
                    # clones: a slice of w3 or b3 need not be aligned
                    one = K.dwconv3x3(x, w3[i].to(wdt).clone(),
                                      None if b is None else b[i].clone())
                    assert torch.equal(g, F.relu(one) if relu else one), \
                        (wdt, b is None, relu, i)
    ref = K.dwconv3x3_qkv_reference(x.float(), w3, b3)
    low = K.dwconv3x3_qkv_reference(x, w3.to(dtype), b3)
    for g, r, lo in zip(K.dwconv3x3_qkv(x, w3.to(dtype), b3), ref, low):
        err = float((g.float() - r).abs().max())
        if dtype == torch.float32:
            assert err <= TOL * (1 + float(r.abs().max())), err
        else:
            assert err <= 1.5 * float((lo.float() - r).abs().max()) + 1e-3


@pytest.mark.gpu
def test_dwconv3x3_qkv_refuses_gradients_and_bad_weights():
    dev = _cuda()
    x = torch.rand(2, 8, 8, 16, device=dev)
    with pytest.raises(NotImplementedError, match="dwconv3x3"):
        K.dwconv3x3_qkv(x.requires_grad_(), torch.rand(3, 3, 3, 16,
                                                       device=dev))
    with pytest.raises(ValueError):  # one weight set, not three
        K.dwconv3x3_qkv(x.detach(), torch.rand(3, 3, 16, device=dev))
