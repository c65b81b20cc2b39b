"""Kernels 4 (`fused_window_attention`) and 5 (`fused_attention_block`) on
the per-warp register window core (`csrc/window_core_mma.cuh`), which
kernel 1's narrow body shares.

On the CPU: the host plans of both kernels at every shape the models and
`chip_smoke.py` run them at (kernel 5 through kernel 1's
`attention_image_plan` and `persistent_grid`, kernel 4 through
`window_attention_plan`), each held to covering every (head, window) once;
CPU tensors taking the plain versions, counted; and the plain windowed
block against JAX's Pallas `fused_attention_block` (interpret mode) at
Uformer_T's enc0 configuration with the windows at place 37 of their
image (fp32, 1e-4 (1 + max|ref|)). The tests marked `gpu` run on the card
(`python -m pytest -m gpu tests/test_torch_port_window_mma.py`): kernel
5's narrow body and kernel 4's bf16 body against their plain versions at
head dim 16 and 32, one to four heads, with tails and offsets, and
kernel 1's narrow body with LN1 off and on, within the
bounds `chip_smoke.py` holds them to.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels import _launch
from uformer_tpu_torch.ops.kernels import attention_image as ai_mod
from uformer_tpu_torch.ops.kernels import window_attention as wa_mod

torch.set_num_threads(1)
TOL = 1e-4
SMS = 132  # an H100 SXM's SMs


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax.numpy as jnp
    from uformer_tpu.ops.pallas import attention_block

    return SimpleNamespace(jnp=jnp, ab=attention_block)


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(device, dtype)


def _block_inputs(seed, Bw, C, nH, with_mod=True):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s) * 0.3).astype(np.float32)

    return dict(x=mk(Bw, 64, C), mod=mk(64, C) if with_mod else None,
                ln_s=1.0 + 0.5 * mk(C), ln_b=0.5 * mk(C), wq=mk(C, C),
                bq=mk(C), wkv=mk(C, 2 * C), bkv=mk(2 * C), wo=mk(C, C),
                bo=mk(C), bias=mk(nH, 64, 64))


def _qkv_inputs(seed, nH, Bw, D):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (rng.standard_normal(s) * 0.5).astype(np.float32)

    return dict(q=mk(nH, Bw, 64, D), k=mk(nH, Bw, 64, D), v=mk(nH, Bw, 64, D),
                bias=mk(nH, 64, 64))


# ---- host plans (CPU) ---------------------------------------------------

# (where, Bw, C, D) -> (windows per work item): kernel 5 at Uformer_T's
# enc0 (C 16, one head) in serve T (bs8 256^2) and at batch 1 and 3, in
# train T (bs32 128^2), in chip_smoke's checks (bs2 256^2) and the Mlp +
# cross-modulator step (bs2 128^2); Uformer_B's enc1 (C 64, two heads of
# 32) in chip_smoke's checks
BLOCK_PLANS = [("serve T enc0", 8192, 16, 16, 4),
               ("serve T enc0 bs1", 1024, 16, 16, 4),
               ("serve T enc0 bs3", 3072, 16, 16, 4),
               ("train T enc0", 8192, 16, 16, 4),
               ("checks enc0 bs2", 2048, 16, 16, 4),
               ("Mlp + cross enc0 bs2", 512, 16, 16, 2),
               ("checks Uformer_B enc1", 512, 64, 32, 2)]


@pytest.mark.parametrize("where,Bw,C,D,wn", BLOCK_PLANS,
                         ids=[p[0] for p in BLOCK_PLANS])
@pytest.mark.parametrize("slots", [132, 264, 40])
def test_attention_block_plan_covers_every_window(where, Bw, C, D, wn,
                                                  slots):
    """Kernel 5's bf16 plan is kernel 1's narrow plan; its persistent grid
    of blocks, each group g of block b walking windows b wn + g + i grid
    wn (attn_narrow), takes every window once, tails included."""
    assert ai_mod.attention_image_plan(Bw, C, D, True, SMS) == ("narrow",
                                                                 wn)
    grid = _launch.persistent_grid(-(-Bw // wn), slots)
    assert grid <= slots
    seen = np.zeros(Bw, int)
    for b in range(grid):
        for g in range(wn):
            seen[np.arange(b * wn + g, Bw, grid * wn)] += 1
    assert (seen == 1).all()
    # fp32 and bf16 at C >= 128 keep a window per block
    assert ai_mod.attention_image_plan(Bw, C, D, False, SMS) == ("window", 1)


# (nH, Bw): kernel 4 at chip_smoke's core checks (Uformer_T's stages at
# bs2 256^2, Uformer_B's enc1), its timings (T's enc0 at bs8 256^2, four
# heads of 512 windows) and odd counts of windows
CORE_PLANS = [(1, 2048), (2, 512), (4, 128), (8, 32), (16, 8), (16, 32),
              (8, 128), (4, 512), (2, 2048), (1, 8192), (4, 512), (1, 1030),
              (3, 77), (2, 5)]


@pytest.mark.parametrize("slots", [132, 528, 792, 7])
@pytest.mark.parametrize("nH,Bw", CORE_PLANS)
def test_window_attention_plan_covers_every_window(nH, Bw, slots):
    """Block b of the bf16 body takes windows [b chunk, (b + 1) chunk) of
    the nH * Bw (head j / Bw, window j % Bw): every (head, window) once, no
    block idle, at most `slots` blocks, every range but the last of equal
    length, and a block's heads change at most once per Bw windows (its
    bias reloads)."""
    chunk, grid = wa_mod.window_attention_plan(nH, Bw, slots)
    items = nH * Bw
    assert 1 <= grid <= slots and (grid - 1) * chunk < items <= grid * chunk
    assert chunk == -(-items // min(items, slots))
    seen = np.zeros(items, int)
    for b in range(grid):
        js = np.arange(b * chunk, min((b + 1) * chunk, items))
        assert np.count_nonzero(np.diff(js // Bw)) <= len(js) // Bw + 1
        seen[js] += 1
    assert (seen == 1).all()


# ---- CPU tensors take the plain versions --------------------------------

def test_window_attention_takes_the_plain_version_on_cpu():
    inp = _qkv_inputs(40, 2, 13, 16)
    kw = dict(win=8, shift=4, H=16, W=24, scale=0.25)
    args = list(map(_t, inp.values()))
    K.reset_counts()
    got = K.fused_window_attention(*args, **kw)
    assert K.plain_counts()["window_attention"] == 1
    assert set(K.launch_counts().values()) == {0}
    torch.testing.assert_close(got, K.window_attention_reference(*args, **kw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("has_ln,with_mod", [(False, True), (True, False)])
def test_attention_block_takes_the_plain_version_on_cpu(has_ln, with_mod):
    inp = _block_inputs(41, 11, 16, 1, with_mod)
    kw = dict(win=8, shift=4, H=32, W=32, scale=0.25, num_heads=1,
              has_ln=has_ln, w_off=37)
    args = list(map(_t, inp.values()))
    K.reset_counts()
    got = K.fused_attention_block(*args, **kw)
    assert K.plain_counts()["attention_block"] == 1
    assert set(K.launch_counts().values()) == {0}
    torch.testing.assert_close(got, K.attention_block_reference(*args, **kw),
                               rtol=0, atol=0)


# ---- the plain block against JAX at an offset (CPU) ---------------------

@pytest.mark.parametrize("Bw", [12, 32])
@pytest.mark.parametrize("shift", [0, 4])
def test_attention_block_reference_at_offset_matches_jax(jx, shift, Bw):
    """Uformer_T's enc0 configuration (C 16, one head, LN outside, the
    block's modulator) on windows at place 37 of a 64^2 image's 64 (32
    windows wrap past the last), against JAX's unpacked Pallas kernel in
    interpret mode."""
    inp = _block_inputs(42, Bw, 16, 1)
    kw = dict(win=8, shift=shift, H=64, W=64, scale=0.25, num_heads=1,
              has_ln=False, w_off=37)
    got = K.attention_block_reference(*map(_t, inp.values()), **kw)
    j = [None if v is None else jx.jnp.asarray(v) for v in inp.values()]
    want = np.asarray(jx.ab.fused_attention_block(*j, interpret=True,
                                                  packed=False, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * (1 + np.abs(want).max()))
    if shift:  # the offset matters: the same windows at place 0 differ
        at0 = K.attention_block_reference(*map(_t, inp.values()),
                                          **dict(kw, w_off=0))
        assert float((got - at0).abs().max()) > 1e-3


# ---- on the card ---------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_kernel(fused, plain, x):
    """fp32: max-abs <= 1e-4 (1 + max|ref|), TF32 off. bf16: the kernel's
    error against the fp32 plain result <= 1.5x the bf16 plain version's
    error + 1e-3. x holds bf16-representable values."""
    ref = plain(x, torch.float32)
    err = float((fused(x, torch.float32) - ref).abs().max())
    assert err <= TOL * (1 + float(ref.abs().max())), err
    xb = x.bfloat16()
    e_plain = float((plain(xb, torch.bfloat16).float() - ref).abs().max())
    e_kernel = float((fused(xb, torch.bfloat16).float() - ref).abs().max())
    assert e_kernel <= 1.5 * e_plain + 1e-3, (e_kernel, e_plain)


# (Bw, H, W, C, nH, shift, w_off, has_ln, with_mod): Uformer_T's enc0 at
# batch 1 and 3 (tails of the persistent grid), offsets 37 and 1000, C 32
# and 64 at head dim 16 and 32, LN1 on, no modulator
CARD_BLOCK = [(1024, 256, 256, 16, 1, 4, 0, False, True),
              (3072, 256, 256, 16, 1, 4, 37, False, True),
              (1037, 256, 256, 16, 1, 0, 1000, True, False),
              (517, 128, 128, 32, 2, 4, 37, True, True),
              (300, 64, 64, 32, 1, 4, 5, False, False),
              (530, 128, 128, 64, 4, 4, 37, False, True),
              (133, 64, 64, 64, 2, 4, 63, True, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_BLOCK,
                         ids=[f"{c[0]}-{c[3]}-{c[4]}-{c[6]}"
                              for c in CARD_BLOCK])
def test_attention_block_narrow_on_card(case):
    dev = _cuda()
    Bw, H, W, C, nH, shift, w_off, has_ln, with_mod = case
    inp = _block_inputs(43, Bw, C, nH, with_mod)
    for k in ("wq", "wkv", "wo"):  # N(0, 1 / C), as a model's
        inp[k] = inp[k] / (0.3 * np.sqrt(C))
    x = _t(inp.pop("x"), dev).bfloat16().float()
    low = ("mod", "wq", "wkv", "wo")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in inp.items()}
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=has_ln, w_off=w_off)

    def run(fn):
        return lambda x, dt: fn(x, *prm[dt].values(), **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_attention_block),
                  run(K.attention_block_reference), x)
    assert K.launch_counts()["attention_block"] == 2


# (nH, Bw, D, H, W, shift): T's enc0 at batch 1, two to four heads of
# head dim 16 and 32, counts of windows that no grid divides
CARD_CORE = [(1, 1024, 16, 256, 256, 4), (2, 517, 16, 128, 128, 4),
             (4, 130, 16, 64, 64, 4), (3, 77, 32, 64, 64, 4),
             (1, 1030, 32, 256, 256, 0), (4, 512, 32, 128, 128, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CORE,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CARD_CORE])
def test_window_attention_body_on_card(case):
    dev = _cuda()
    nH, Bw, D, H, W, shift = case
    inp = _qkv_inputs(44, nH, Bw, D)
    q, k, v, bias = (_t(a, dev).bfloat16().float() for a in inp.values())
    kw = dict(win=8, shift=shift, H=H, W=W, scale=D ** -0.5)

    def run(fn):
        return lambda q, dt: fn(q.to(dt), k.to(dt), v.to(dt), bias, **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_window_attention),
                  run(K.window_attention_reference), q)
    assert K.launch_counts()["window_attention"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [False, True])
@pytest.mark.parametrize("shape,nH", [((3, 64, 64, 16), 1),
                                      ((2, 64, 96, 32), 2),
                                      ((1, 64, 64, 64), 4)])
def test_attention_image_narrow_ln_on_card(shape, nH, has_ln):
    """Kernel 1's narrow body (its core now window_core_mma.cuh's) with
    LN1 off and on, within its bound against the plain version."""
    dev = _cuda()
    B, H, W, C = shape
    inp = _block_inputs(45, 1, C, nH)
    inp.pop("x")
    for k in ("wq", "wkv", "wo"):
        inp[k] = inp[k] / (0.3 * np.sqrt(C))
    x = (torch.from_numpy(np.random.default_rng(46).standard_normal(shape)
                          .astype(np.float32)).to(dev).bfloat16().float())
    low = ("mod", "wq", "wkv", "wo")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in inp.items()}
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(win=8, shift=4, scale=(C // nH) ** -0.5, num_heads=nH,
              has_ln=has_ln, residual=False)

    def run(fn):
        return lambda x, dt: fn(x, *prm[dt].values(), **kw)

    K.reset_counts()
    _check_kernel(run(K.fused_attention_image),
                  run(K.attention_image_reference), x)
    assert K.launch_counts()["attention_image"] == 2
