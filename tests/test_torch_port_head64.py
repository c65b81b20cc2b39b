"""Head dim 64 and C = 1024 in the forward kernels: `--arch Uformer
--embed_dim 64` (heads 1-2-4-8-16-16-8-4-2 over C 64-1024, every block at
head dim 64, hidden up to 4096).

On the CPU, with numpy inputs from a seed and fp32 throughout, each within
1e-4 (1 + max|ref|):
  - the plain versions the kernels are held to on the card against JAX's
    jnp references: `attention_image_reference` at C 64 (one head) and
    C 1024 (16 heads), shift 0 and 4; `stage_reference` at C 128 and
    1024, two blocks, on 16^2 and 8^2; `leff_reference` at C 1024, hidden
    4096, on 8 x 8 with LN and residual each way;
    `attention_block_reference` at window 4, C 1024, 16 heads, with LN,
    at w_off 0 and 3 (JAX's reference on the windows at their places of
    a longer batch); the window core at head dim 64 (JAX's jnp core and
    its Pallas kernel 4 in interpret mode);
  - JAX's Pallas kernels in interpret mode where they are cheap: kernel 1
    at C 64 on 16^2, kernel 5 at window 4, C 128, head dim 64, w_off 3;
  - the port's plain path of the embed-64 Uformer (depths cut to 1, as
    tests/test_torch_port_family.py cuts them) at 128^2 against JAX
    `get_arch` with attn_backend="jnp" on the same weights, carried across
    by the state_dict converter;
  - the limits: the checks take head dim 64 both ways at every window
    (17 and 32 too); head dim 128 raises naming ROADMAP queue 2 item 9,
    and so does head dim 20 in the forward kernels' check; every block of
    the embed-64 models has a backward kernel, and an embed-24 model's
    blocks (head dim 24, forward only) name what is left
    (`LeWinBlock.backward_gap`). Head dim 64's backward itself is held
    against JAX in tests/test_torch_port_head64_bwd.py.
The launch routes of the embed-64 model (8/2/0/2 at --train_ps 128,
7/2/2/4 at 64) are cases of tests/test_torch_port_geometry.py's ROUTES.
The tests marked `gpu` hold each extended kernel against its plain
version on the card (`python -m pytest -m gpu
tests/test_torch_port_head64.py`).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.layers import GEOMETRY_NOT_ON_KERNEL_PATH
from uformer_tpu_torch.models.registry import arch_config, get_arch
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels.window_attention import (
    FORWARD_HEAD_DIMS,
    HEAD_DIMS,
    check_head_dim,
    check_window,
)
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel

torch.set_num_threads(1)
TOL = 1e-4
E64 = {"arch": "Uformer", "embed_dim": 64, "train_ps": 128}


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops import attention, masks
    from uformer_tpu.ops.pallas import (
        attention_block,
        attention_image,
        leff,
        stage,
        window_attention,
    )

    return SimpleNamespace(jax=jax, jnp=jnp, ab=attention_block,
                           ai=attention_image, leff=leff, stage=stage,
                           wa=window_attention, attention=attention,
                           masks=masks)


def _mk(seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a).copy()).to(
        device, dtype)


def _j(jx, inp):
    return {k: None if v is None else jx.jnp.asarray(v)
            for k, v in inp.items()}


def _close(got, want, what=""):
    got = got.detach().float().cpu().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * (1 + np.abs(want).max()),
                               err_msg=what)


def _attn_inputs(seed, C, nH, N, x_shape):
    """x and the weights of an attention sub-block, scaled by fan-in as a
    trained block's are, so that C 1024's logits stay of order one."""
    mk, unit = _mk(seed), _mk(seed + 1, 1.0)
    return dict(x=unit(*x_shape), mod=mk(N, C), ln_s=1.0 + mk(C),
                ln_b=mk(C), wq=unit(C, C) / np.sqrt(C), bq=0.1 * mk(C),
                wkv=unit(C, 2 * C) / np.sqrt(C), bkv=0.1 * mk(2 * C),
                wo=unit(C, C) / np.sqrt(C), bo=0.1 * mk(C),
                bias=mk(nH, N, N))


def _leff_inputs(seed, C, Ch, x_shape):
    mk, unit = _mk(seed), _mk(seed + 1, 1.0)
    return dict(x=unit(*x_shape), w1=unit(C, Ch) / np.sqrt(C),
                b1=0.1 * mk(Ch), wd=unit(3, 3, Ch) / 3.0, bd=0.1 * mk(Ch),
                w2=unit(Ch, C) / np.sqrt(Ch), b2=0.1 * mk(C),
                ln_s=1.0 + mk(C), ln_b=mk(C))


# ---- the plain versions against JAX's jnp references ----------------------

@pytest.mark.parametrize("C,nH", [(64, 1), (1024, 16)])
@pytest.mark.parametrize("shift", [0, 4])
def test_attention_image_reference_matches_jax(jx, C, nH, shift):
    inp = _attn_inputs(C + shift, C, nH, 64, (1, 16, 16, C))
    kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH)
    got = K.attention_image_reference(*map(_t, inp.values()), **kw)
    want = jx.ai.attention_image_reference(*_j(jx, inp).values(), **kw)
    _close(got, want, f"attention_image C {C} shift {shift}")


def _stage_inputs(seed, C, nH, n=2):
    mk, unit = _mk(seed, 0.1), _mk(seed + 1, 1.0)
    Ch = 4 * C
    return dict(
        ln1_s=1.0 + mk(n, C), ln1_b=mk(n, C),
        wq=unit(n, C, C) / np.sqrt(C), bq=mk(n, C),
        wk=unit(n, C, C) / np.sqrt(C), bk=mk(n, C),
        wv=unit(n, C, C) / np.sqrt(C), bv=mk(n, C),
        wo=unit(n, C, C) / np.sqrt(C), bo=mk(n, C),
        bias=mk(n, nH, 64, 64), mod=mk(n, 64, C),
        ln2_s=1.0 + mk(n, C), ln2_b=mk(n, C),
        w1=unit(n, C, Ch) / np.sqrt(C), b1=mk(n, Ch),
        wd=unit(n, 3, 3, Ch) / 3.0, bd=mk(n, Ch),
        w2=unit(n, Ch, C) / np.sqrt(Ch), b2=mk(n, C))


@pytest.mark.parametrize("C,nH", [(128, 2), (1024, 16)])
@pytest.mark.parametrize("side", [16, 8])
def test_stage_reference_matches_jax(jx, C, nH, side):
    p = _stage_inputs(C + side, C, nH)
    x = _mk(C + side + 7, 1.0)(1, side, side, C)
    kw = dict(scale=64 ** -0.5, num_heads=nH, use_shift=True, has_mod=True)
    got = K.stage_reference(_t(x), {k: _t(v) for k, v in p.items()}, **kw)
    want = jx.stage.stage_reference(jx.jnp.asarray(x), _j(jx, p), **kw)
    _close(got, want, f"stage C {C} {side}^2")


@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("residual", [True, False])
def test_leff_reference_matches_jax_at_c1024(jx, has_ln, residual):
    inp = _leff_inputs(30 + 2 * has_ln + residual, 1024, 4096,
                       (1, 8, 8, 1024))
    ln = ("ln_s", "ln_b")
    args = [inp[k] for k in inp if k not in ln]
    kw = dict(residual=residual)
    lkw = {k: inp[k] for k in ln} if has_ln else {}
    got = K.leff_reference(*map(_t, args), **{k: _t(v) for k, v in
                                              lkw.items()}, **kw)
    want = jx.leff.leff_reference(*map(jx.jnp.asarray, args),
                                  **{k: jx.jnp.asarray(v)
                                     for k, v in lkw.items()}, **kw)
    _close(got, want, f"leff C 1024 ln {has_ln} residual {residual}")


@pytest.mark.parametrize("w_off", [0, 3])
def test_attention_block_reference_matches_jax_at_c1024(jx, w_off):
    """Window 4, C 1024, 16 heads, LN1, shift 2 on 16^2 (16 windows an
    image): the port's windows at places w_off.. against JAX's reference
    on a batch that holds them at those places (w_off leading windows,
    padded to whole images)."""
    win, C, nH, H = 4, 1024, 16, 16
    N, nW, Bw = win * win, 16, 20
    inp = _attn_inputs(40 + w_off, C, nH, N, (Bw, N, C))
    kw = dict(win=win, shift=2, H=H, W=H, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=True)
    got = K.attention_block_reference(*map(_t, inp.values()), **kw,
                                      w_off=w_off)
    total = -(-(w_off + Bw) // nW) * nW
    xj = np.zeros((total, N, C), np.float32)
    xj[w_off:w_off + Bw] = inp["x"]
    j = _j(jx, dict(inp, x=xj))
    want = np.asarray(jx.ab.attention_block_reference(*j.values(), **kw))
    _close(got, want[w_off:w_off + Bw], f"attention_block w_off {w_off}")


@pytest.mark.parametrize("win", [4, 8])
@pytest.mark.parametrize("shift_half", [False, True])
def test_window_core_matches_jax_at_head_dim_64(jx, win, shift_half):
    """Kernel 4's plain version at head dim 64 against JAX's jnp core and
    its Pallas kernel 4 (interpret mode)."""
    nH, D, N = 2, 64, win * win
    H = W = 2 * win
    Bw = 2 * (H // win) * (W // win)
    shift = win // 2 if shift_half else 0
    mk = _mk(50 + win + shift, 0.5)
    inp = dict(q=mk(nH, Bw, N, D), k=mk(nH, Bw, N, D), v=mk(nH, Bw, N, D),
               bias=mk(nH, N, N))
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)
    K.reset_counts()
    got = K.fused_window_attention(*map(_t, inp.values()), **kw)
    assert K.plain_counts()["window_attention"] == 1
    j = _j(jx, inp)
    mask = (jx.jnp.asarray(jx.masks.shift_window_mask(H, W, win, shift))
            if shift else None)
    core = jx.attention._window_attention_jnp(
        *(j[k].transpose(1, 0, 2, 3) for k in ("q", "k", "v")), j["bias"],
        mask, scale=D ** -0.5)
    core = np.asarray(core).reshape(Bw, N, nH, D).transpose(2, 0, 1, 3)
    _close(got, core, "window core jnp")
    _close(got, jx.wa.fused_window_attention(*j.values(), interpret=True,
                                             **kw), "window core kernel")


# ---- JAX's Pallas kernels in interpret mode ---------------------------------

@pytest.mark.parametrize("shift", [0, 4])
def test_attention_image_matches_jax_kernel_at_c64(jx, shift):
    """Kernel 1 at C 64, one head (an embed-64 model's enc0): the port's
    plain version against JAX's Pallas kernel (its pixel-packed narrow
    variant) in interpret mode."""
    inp = _attn_inputs(60 + shift, 64, 1, 64, (1, 16, 16, 64))
    kw = dict(win=8, shift=shift, scale=64 ** -0.5, num_heads=1)
    K.reset_counts()
    got = K.fused_attention_image(*map(_t, inp.values()), **kw)
    assert K.plain_counts()["attention_image"] == 1
    want = jx.ai.fused_attention_image(*_j(jx, inp).values(),
                                       interpret=True, **kw)
    _close(got, want, f"attention_image C 64 shift {shift}")


@pytest.mark.parametrize("shift,w_off", [(0, 0), (2, 3)])
def test_attention_block_matches_jax_kernel_at_head_dim_64(jx, shift, w_off):
    """Kernel 5 at window 4, C 128, head dim 64 (two heads), LN1: the
    port's plain version against JAX's Pallas kernel in interpret mode,
    the windows at place w_off of 8 x 8 images."""
    win, C, nH, H = 4, 128, 2, 8
    N = win * win
    inp = _attn_inputs(70 + shift, C, nH, N, (6, N, C))
    kw = dict(win=win, shift=shift, H=H, W=H, scale=64 ** -0.5,
              num_heads=nH, has_ln=True)
    K.reset_counts()
    got = K.fused_attention_block(*map(_t, inp.values()), **kw, w_off=w_off)
    assert K.plain_counts()["attention_block"] == 1
    want = jx.ab.fused_attention_block(*_j(jx, inp).values(),
                                       interpret=True, packed=False,
                                       w_off=w_off, **kw)
    _close(got, want, f"attention_block shift {shift} w_off {w_off}")


# ---- the embed-64 model ---------------------------------------------------

def test_embed64_uformer_matches_jax(jx):
    """`--arch Uformer --embed_dim 64` at one block a stage, 128^2: the
    port's plain path against JAX's jnp model on the same seeded weights,
    every attention and LeFF through the kernels' wrappers (their plain
    versions here)."""
    from uformer_tpu import get_arch as jax_get_arch

    jax, jnp = jx.jax, jx.jnp
    shallow = (1,) * 9
    jmodel = jax_get_arch(dict(E64, attn_backend="jnp")).clone(
        depths=shallow)
    x = np.random.default_rng(80).uniform(0, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(81)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * rng.standard_normal(a.shape)
                         + jax.tree_util.keystr(path).endswith("['scale']"))
        .astype(np.float32), shapes)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    port = Uformer(**dict(arch_config(E64), depths=shallow)).eval()
    assert port.conv.num_heads == 16 and port.conv.dim == 1024
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          state_dict_from_jax(params).items()}, strict=True)
    K.reset_counts()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    plain = K.plain_counts()
    assert plain["stage"] == 8 and plain["attention_image"] == 1
    _close(got, want, "embed-64 Uformer")


# ---- the refusals -------------------------------------------------------------

def test_forward_checks_take_head_dim_64():
    """Head dim 64 is one of the kernels' head dims both ways (the
    backward's since head dim 64's backward was ported), at every window
    1-16; the backward takes every head dim of the forward up to 64 (the
    multiples of 8, since head dims 24-56's backward was ported), the
    kernels 1, 3, 5 and 6 at windows 1-8 also 72-128, both ways."""
    assert HEAD_DIMS == (8, 16, 24, 32, 40, 48, 56, 64)
    assert FORWARD_HEAD_DIMS == HEAD_DIMS + tuple(range(72, 129, 8))
    for C, nH in ((64, 1), (128, 2), (512, 8), (1024, 16)):
        check_head_dim(C, nH)
        check_head_dim(C, nH, FORWARD_HEAD_DIMS)
        for win in range(1, 17):
            check_window(win, win // 2, 2 * win, 2 * win)


@pytest.mark.parametrize("C,nH,win", [(128, 1, 8), (1024, 8, 4),
                                      (2048, 16, 8), (64, 1, 9),
                                      (1024, 16, 16)])
def test_head_dim_128_and_wide_windows_at_64_raise(C, nH, win):
    """Head dim 128 is refused by the default check (kernels 4, 5 and 6
    above window 8: ROADMAP queue 2 item 9; kernels 1, 3, 5 and 6 take it
    at windows 1-8, FORWARD_HEAD_DIMS); head dim 64 runs at every window,
    17 and 32 too, and a head dim of 20 has no kernel at any window,
    forward either (item 9 again)."""
    if C // nH == 128:
        with pytest.raises(ValueError,
                           match="ROADMAP.md, port queue 2 item 9"):
            check_head_dim(C, nH)
    else:
        check_head_dim(C, nH)
        check_window(win, win // 2, 2 * win, 2 * win)
    for w in (17, 32):
        check_window(w, w // 2, 2 * w, 2 * w)
    with pytest.raises(ValueError, match="ROADMAP.md, port queue 2 item 9"):
        check_head_dim(20 * nH, nH, FORWARD_HEAD_DIMS)


@pytest.mark.parametrize("C,nH", [(64, 1), (1024, 16)])
def test_backward_check_refuses_head_dim_64(C, nH):
    """The check of the backward above window 8 (the default, HEAD_DIMS)
    takes head dim 64 (C 64 and 1024, the embed-64 model's narrowest and
    widest blocks) and refuses head dim 128 (twice the width at the same
    heads), naming ROADMAP queue 2 item 9; at windows 1-8 the backward
    takes 128 too (FORWARD_HEAD_DIMS)."""
    assert C // nH in HEAD_DIMS
    check_head_dim(C, nH)
    with pytest.raises(ValueError, match="ROADMAP.md, port queue 2 item 9"):
        check_head_dim(2 * C, nH)


def test_embed64_backward_gap_names_the_training_half():
    """Every block of an embed-64 model has a backward kernel now, at
    --train_ps 128 and 64 and at --win_size 16, 17 and 32 (its gap is
    None, and the train step refuses nothing); a model at embed 20 (head
    dim 20, which no kernel takes either way) is refused, naming what is
    left (ROADMAP queue 2 item 9)."""
    for opt in (E64, dict(E64, train_ps=64), dict(E64, win_size=16),
                dict(E64, win_size=17, train_ps=32),
                dict(E64, win_size=32)):
        model = get_arch(opt)
        assert blocks_without_backward_kernel(model) == []
        assert model.conv.blocks[0].backward_gap is None
    model = get_arch(dict(E64, embed_dim=20, train_ps=32))
    uncovered = blocks_without_backward_kernel(model)
    assert len(uncovered) == 18
    gap = model.get_submodule(uncovered[0]).backward_gap
    assert gap == GEOMETRY_NOT_ON_KERNEL_PATH
    assert "ROADMAP.md, port queue 2 item 9" in gap


# ---- the kernels on the card ----------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _check_forward(fused, plain, x32):
    """fp32 within 1e-4 (1 + max|ref|), TF32 off; bf16's error against
    the fp32 plain result within 1.5x the plain bf16 version's + 1e-3."""
    ref = plain(x32, torch.float32)
    assert _err(fused(x32, torch.float32), ref) <= \
        TOL * (1 + float(ref.abs().max()))
    x16 = x32.bfloat16()
    assert _err(fused(x16, torch.bfloat16), ref) <= \
        1.5 * _err(plain(x16, torch.bfloat16), ref) + 1e-3


def _on(inp, dev, low):
    return {dt: [None if v is None else _t(v, dev, dt if k in low
                                           else torch.float32)
                 for k, v in inp.items() if k != "x"]
            for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.gpu
@pytest.mark.parametrize("C,nH,side", [(64, 1, 64), (256, 4, 32),
                                       (1024, 16, 16)])
def test_attention_image_kernel_head_dim_64(C, nH, side):
    dev = _cuda()
    inp = _attn_inputs(90, C, nH, 64, (2, side, side, C))
    prm = _on(inp, dev, ("mod", "wq", "wkv", "wo"))
    for shift in (0, 4):
        kw = dict(win=8, shift=shift, scale=64 ** -0.5, num_heads=nH)
        K.reset_counts()
        _check_forward(
            lambda x, dt: K.fused_attention_image(x, *prm[dt], **kw),
            lambda x, dt: K.attention_image_reference(x, *prm[dt], **kw),
            _t(inp["x"], dev).bfloat16().float())
        assert K.launch_counts()["attention_image"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("C,nH,side", [(256, 4, 32), (1024, 16, 16)])
def test_stage_kernel_head_dim_64(C, nH, side):
    dev = _cuda()
    p = _stage_inputs(91, C, nH)
    low = ("wq", "wk", "wv", "wo", "mod", "w1", "wd", "w2")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in p.items()}
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(scale=64 ** -0.5, num_heads=nH, use_shift=True, has_mod=True)
    K.reset_counts()
    _check_forward(lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                   lambda x, dt: K.stage_reference(x, prm[dt], **kw),
                   _t(_mk(92, 1.0)(2, side, side, C), dev).bfloat16().float())
    assert K.launch_counts()["stage"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False])
def test_leff_kernel_c1024(has_ln):
    dev = _cuda()
    inp = _leff_inputs(93, 1024, 4096, (2, 16, 16, 1024))
    low = ("w1", "wd", "w2")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in inp.items() if k != "x"}
           for dt in (torch.float32, torch.bfloat16)}

    def run(fn):
        def call(x, dt):
            q = prm[dt]
            ln = dict(ln_s=q["ln_s"], ln_b=q["ln_b"]) if has_ln else {}
            return fn(x, *(q[k] for k in ("w1", "b1", "wd", "bd", "w2",
                                          "b2")), **ln, residual=True)
        return call

    K.reset_counts()
    _check_forward(run(K.fused_leff), run(K.leff_reference),
                   _t(inp["x"], dev).bfloat16().float())
    assert K.launch_counts()["leff"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("win,C,nH,w_off", [(4, 1024, 16, 0),
                                            (4, 1024, 16, 37),
                                            (8, 64, 1, 5), (2, 512, 8, 3)])
def test_attention_block_kernel_head_dim_64(win, C, nH, w_off):
    dev = _cuda()
    N = win * win
    inp = _attn_inputs(94, C, nH, N, (32, N, C))
    prm = _on(inp, dev, ("mod", "wq", "wkv", "wo"))
    for shift in (0, win // 2):
        kw = dict(win=win, shift=shift, H=4 * win, W=4 * win,
                  scale=64 ** -0.5, num_heads=nH, has_ln=True, w_off=w_off)
        K.reset_counts()
        _check_forward(
            lambda x, dt: K.fused_attention_block(x, *prm[dt], **kw),
            lambda x, dt: K.attention_block_reference(x, *prm[dt], **kw),
            _t(inp["x"], dev).bfloat16().float())
        assert K.launch_counts()["attention_block"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("win", [1, 3, 4, 8])
def test_window_attention_kernel_head_dim_64(win):
    dev = _cuda()
    nH, N = 2, win * win
    H = W = 4 * win
    Bw = 2 * 16
    mk = _mk(95 + win, 0.5)
    q, k, v = (_t(mk(nH, Bw, N, 64), dev).bfloat16().float()
               for _ in range(3))
    bias = _t(mk(nH, N, N), dev)
    for shift in sorted({0, win // 2}):
        kw = dict(win=win, shift=shift, H=H, W=W, scale=64 ** -0.5)

        def run(fn, kw=kw):
            return lambda x, dt: fn(x.to(dt), k.to(dt), v.to(dt), bias,
                                    **kw)

        K.reset_counts()
        _check_forward(run(K.fused_window_attention),
                       run(K.window_attention_reference), q)
        assert K.launch_counts()["window_attention"] == 2
