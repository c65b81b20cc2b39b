"""Head dims 72-128 in the forward kernels 2, 3 and 5: `--arch Uformer
--embed_dim 72-128` (heads 1-2-4-8-16-16-8-4-2, every block at head dim
E, C = E nH up to 2048; E 72, 88, 104 and 120 are 8 mod 16) served and
evaluated through the kernels at windows 1-8.

On the CPU, with numpy inputs from a seed and fp32 throughout, each within
1e-4 (1 + max|ref|):
  - `attention_block_reference` at head dims 72 and 128 at windows 8 and
    4 against JAX's jnp reference (the windows at place w_off 3 of a longer
    batch) and JAX's Pallas kernel 5 in interpret mode (w_off 3), one case
    at C 16 D on one window;
  - `stage_reference` at (C, heads) (1152, 16) and (256, 2) on 8^2 and
    16^2 against JAX's;
  - `leff_reference` at C 72, 1152 and 2048 on a 4 x 4 image against
    JAX's, and `pad_hidden` at hidden 288: the plain version on the padded
    weights equal bit for bit to the unpadded one;
  - the port's plain path of the embed-72 Uformer (depths cut to 1) at
    128^2 against JAX `get_arch` with attn_backend="jnp" on the same
    weights, carried across by the state_dict converter;
  - the limits: kernels 1, 3, 5 and 6 take head dims 72-128 at windows
    1-8 (FORWARD_HEAD_DIMS), kernels 2 and 7 every C the family builds up
    to 2048, and the train step the e72, e96 and e128 models at window 8
    (tests/test_torch_port_head_dims_bwd_above64.py holds the backward);
    kernel 4, kernels 5 and 6 above window 8 and the train step at
    --win_size 16 refuse them, naming ROADMAP queue 2 item 9; head dims
    12, 20 and 136 are refused everywhere; the spatial path's card check
    takes embed 72 and refuses it at --win_size 16.
The launch routes of e72, e96, e128 and e96 at --train_ps 64 are cases of
tests/test_torch_port_geometry.py's ROUTES. The tests marked `gpu` hold
each extended kernel against its plain version on the card at every new
head dim (`python -m pytest -m gpu tests/test_torch_port_head_dims_above64.py`).
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
from uformer_tpu_torch.ops.kernels.attention_image import _check_geometry
from uformer_tpu_torch.ops.kernels import window_attention
from uformer_tpu_torch.ops.kernels.leff import (
    MAX_C,
    check_width,
    pad_hidden,
)
from uformer_tpu_torch.ops.kernels.window_attention import (
    FORWARD_HEAD_DIMS,
    HEAD_DIMS,
    check_head_dim,
    window_attention_head_dims,
)
from uformer_tpu_torch.parallel.spatial import check_spatial_card
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel

torch.set_num_threads(1)
TOL = 1e-4
BIG_DIMS = tuple(range(72, 129, 8))
HEADS = (1, 2, 4, 8, 16)  # the family's heads a stage
ITEM9 = "ROADMAP.md, port queue 2 item 9"
E72 = {"arch": "Uformer", "embed_dim": 72, "train_ps": 128}


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops.pallas import attention_block, leff, stage

    return SimpleNamespace(jax=jax, jnp=jnp, ab=attention_block, leff=leff,
                           stage=stage)


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
    trained block's are."""
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


# ---- kernel 5's plain version against JAX ---------------------------------

# (head dim, heads, window, LN, windows): C 72-256 at windows 8 and 4
# (packed tiles on the card), and C 16 D (the bottleneck's width) on one
# window
BLOCK_CASES = [(72, 1, 8, True, 5), (72, 2, 4, False, 5),
               (128, 1, 4, True, 5), (128, 2, 8, False, 5),
               (72, 16, 8, True, 1)]


def _block_case(D, nH, win, has_ln, Bw, shift):
    """Bw windows at place w_off 3 of 4 x 4-window images."""
    C, N, H = D * nH, win * win, 4 * win
    inp = _attn_inputs(200 + D + nH + win + shift, C, nH, N, (Bw, N, C))
    kw = dict(win=win, shift=shift, H=H, W=H, scale=D ** -0.5, num_heads=nH,
              has_ln=has_ln)
    return inp, kw


@pytest.mark.parametrize("D,nH,win,has_ln,Bw", BLOCK_CASES)
@pytest.mark.parametrize("shift_half", [False, True])
def test_attention_block_reference_matches_jax(jx, D, nH, win, has_ln, Bw,
                                               shift_half):
    """The port's windows at places 3.. against JAX's reference on a
    batch that holds them at those places (3 leading windows, padded to a
    whole image of 16 windows)."""
    inp, kw = _block_case(D, nH, win, has_ln, Bw,
                          win // 2 if shift_half else 0)
    w_off = 3
    got = K.attention_block_reference(*map(_t, inp.values()), **kw,
                                      w_off=w_off)
    xj = np.zeros((16,) + inp["x"].shape[1:], np.float32)
    xj[w_off:w_off + Bw] = inp["x"]
    want = np.asarray(jx.ab.attention_block_reference(
        *_j(jx, dict(inp, x=xj)).values(), **kw))
    _close(got, want[w_off:w_off + Bw], f"attention_block D {D} {kw}")


@pytest.mark.parametrize("D,nH,win,has_ln,Bw", BLOCK_CASES)
def test_attention_block_matches_jax_kernel(jx, D, nH, win, has_ln, Bw):
    """Kernel 5's plain version against JAX's Pallas kernel in interpret
    mode (its unpacked form) at w_off 3, shifted."""
    inp, kw = _block_case(D, nH, win, has_ln, Bw, win // 2)
    K.reset_counts()
    got = K.fused_attention_block(*map(_t, inp.values()), **kw, w_off=3)
    assert K.plain_counts()["attention_block"] == 1
    want = jx.ab.fused_attention_block(*_j(jx, inp).values(),
                                       interpret=True, packed=False,
                                       w_off=3, **kw)
    _close(got, want, f"attention_block kernel D {D} {kw}")


# ---- kernels 3 and 2's plain versions against JAX -------------------------

@pytest.mark.parametrize("C,nH", [(1152, 16), (256, 2)])
@pytest.mark.parametrize("side", [8, 16])
def test_stage_reference_matches_jax(jx, C, nH, side):
    """e72's bottleneck and dec0 width (head dim 72), and C 256 at head
    dim 128 (e128's enc1 and dec3)."""
    p = _stage_inputs(C + nH + side, C, nH)
    x = _mk(nH + side + 9, 1.0)(1, side, side, C)
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=True,
              has_mod=True)
    got = K.stage_reference(_t(x), {k: _t(v) for k, v in p.items()}, **kw)
    want = jx.stage.stage_reference(jx.jnp.asarray(x), _j(jx, p), **kw)
    _close(got, want, f"stage C {C} heads {nH} {side}^2")


@pytest.mark.parametrize("C", [72, 1152, 2048])
@pytest.mark.parametrize("has_ln,residual", [(True, True), (False, False)])
def test_leff_reference_matches_jax(jx, C, has_ln, residual):
    inp = _leff_inputs(C + 2 * has_ln + residual, C, 4 * C, (1, 4, 4, C))
    ln = ("ln_s", "ln_b")
    args = [inp[k] for k in inp if k not in ln]
    lkw = {k: inp[k] for k in ln} if has_ln else {}
    got = K.leff_reference(*map(_t, args), **{k: _t(v) for k, v in
                                              lkw.items()},
                           residual=residual)
    want = jx.leff.leff_reference(*map(jx.jnp.asarray, args),
                                  **{k: jx.jnp.asarray(v)
                                     for k, v in lkw.items()},
                                  residual=residual)
    _close(got, want, f"leff C {C} ln {has_ln} residual {residual}")


@pytest.mark.parametrize("has_ln,residual", [(True, False), (False, True)])
def test_pad_hidden_at_hidden_288_keeps_the_bits(has_ln, residual):
    """C 72's hidden of 288 padded to 320 (`pad_hidden`, as the kernel
    takes it): the plain version on the padded weights equals the
    unpadded one bit for bit."""
    inp = _leff_inputs(210 + has_ln, 72, 288, (2, 6, 10, 72))
    w = [_t(inp[k]) for k in ("w1", "b1", "wd", "bd", "w2")]
    padded = pad_hidden(*w)
    assert padded[0].shape == (72, 320) and padded[4].shape == (320, 72)
    ln = dict(ln_s=_t(inp["ln_s"]), ln_b=_t(inp["ln_b"])) if has_ln else {}
    x, b2 = _t(inp["x"]), _t(inp["b2"])
    want = K.leff_reference(x, *w[:4], w[4], b2, **ln, residual=residual)
    got = K.leff_reference(x, *padded[:4], padded[4], b2, **ln,
                           residual=residual)
    assert torch.equal(got, want)


# ---- the embed-72 model ---------------------------------------------------

def test_uformer_e72_matches_jax(jx):
    """`--arch Uformer --embed_dim 72` at one block a stage, 128^2: the
    port's plain path against JAX's jnp model on the same seeded weights,
    the bottleneck and dec0 (C 1152) through the stage's plain version,
    every other block through kernels 5 and 2's."""
    from uformer_tpu import get_arch as jax_get_arch

    jax, jnp = jx.jax, jx.jnp
    shallow = (1,) * 9
    jmodel = jax_get_arch(dict(E72, attn_backend="jnp")).clone(
        depths=shallow)
    x = np.random.default_rng(72).uniform(0, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(73)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * rng.standard_normal(a.shape)
                         + jax.tree_util.keystr(path).endswith("['scale']"))
        .astype(np.float32), shapes)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    port = Uformer(**dict(arch_config(E72), depths=shallow)).eval()
    assert port.conv.num_heads == 16 and port.conv.dim == 16 * 72
    assert {blk.dim // blk.num_heads for blk in port.modules()
            if hasattr(blk, "backward_gap")} == {72}
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          state_dict_from_jax(params).items()}, strict=True)
    K.reset_counts()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    plain = K.plain_counts()
    # 128^2: the bottleneck and dec0 (8^2, C 1152) the stage, the other
    # seven levels a block each
    assert (plain["stage"], plain["attention_block"], plain["leff"]) == \
        (2, 7, 7) and plain["attention_image"] == 0
    _close(got, want, "embed-72 Uformer")


# ---- the checks ------------------------------------------------------------

def test_forward_head_dims_reach_128():
    """Kernels 1, 3, 5 and 6 take every multiple of 8 up to 128 at windows
    1-8, forward and backward alike (the window decides, not the
    direction: no backward set of its own); kernels 5 and 6 above window
    8 keep 8-64; LeFF's kernels 2 and 7 take C up to 2048 both ways."""
    assert FORWARD_HEAD_DIMS == HEAD_DIMS + BIG_DIMS
    assert HEAD_DIMS == tuple(range(8, 65, 8))
    assert not hasattr(window_attention, "BACKWARD_HEAD_DIMS")
    assert MAX_C == 2048


@pytest.mark.parametrize("D", BIG_DIMS)
def test_big_head_dims_forward_only(D):
    """Head dim D is no longer forward only: kernels 1, 3, 5 and 6 at
    windows 1-8 (FORWARD_HEAD_DIMS, kernel 1's and kernel 6's image
    geometry at window 8) and kernels 2 and 7 (every C = D nH the family
    builds, up to 2048) take it; kernel 4 at every window and kernels 5
    and 6 above window 8 refuse it, naming ROADMAP queue 2 item 9."""
    for nH in HEADS:
        C = D * nH
        check_head_dim(C, nH, FORWARD_HEAD_DIMS)  # kernels 1, 3, 5, 6
        check_width(C)  # kernels 2 and 7
        _check_geometry(torch.empty(1, 8, 8, C), 8, 0, nH)  # kernels 1, 6
        for dims in (HEAD_DIMS,  # kernels 5 and 6 above window 8
                     window_attention_head_dims(64),  # kernel 4, win 1-8
                     window_attention_head_dims(81)):  # kernel 4 above
            with pytest.raises(ValueError, match=ITEM9):
                check_head_dim(C, nH, dims)


@pytest.mark.parametrize("D", [12, 20, 136])
def test_other_head_dims_refused_everywhere(D):
    """A head dim that is no multiple of 8, or above 128, has no kernel
    either way (ROADMAP queue 2 item 9); kernels 2 and 7 refuse C past
    2048."""
    for dims in (FORWARD_HEAD_DIMS, HEAD_DIMS):
        for nH in HEADS:
            with pytest.raises(ValueError, match=ITEM9):
                check_head_dim(D * nH, nH, dims)
    with pytest.raises(ValueError, match=ITEM9 if D % 8 == 0 else "C % 8"):
        check_width(16 * D if D % 8 == 0 else D)


@pytest.mark.parametrize("opt", [E72, dict(E72, embed_dim=128),
                                 dict(E72, embed_dim=96, train_ps=64)],
                         ids=["e72", "e128", "e96ps64"])
def test_training_refused_serving_taken(opt):
    """An embed 72-128 model trains at window 8: no block is left to the
    train step's refusal, and the spatial path's card check (a forward at
    windows 1-8) takes it. At --win_size 16 every block at window 16 is
    refused before any launch (kernel 6 above window 8 keeps head dims
    8-64), naming what is left; the blocks that fall back to window 8
    (resolution 8 and below) are not. Built on the meta device: the checks
    read the geometry only."""
    with torch.device("meta"):
        model = get_arch(opt)
        win16 = get_arch(dict(opt, win_size=16))
    assert blocks_without_backward_kernel(model) == []
    check_spatial_card(model)
    uncovered = blocks_without_backward_kernel(win16)
    blocks = {n: m for n, m in win16.named_modules()
              if hasattr(m, "backward_gap")}
    assert uncovered == [n for n, m in blocks.items() if m.win_size > 8]
    assert 0 < len(uncovered) < 18
    gap = win16.get_submodule(uncovered[0]).backward_gap
    assert gap == GEOMETRY_NOT_ON_KERNEL_PATH and ITEM9 in gap
    assert str(HEAD_DIMS) in gap


def test_spatial_card_check_refuses_e72_above_window_8():
    """The spatial path's card check refuses embed 72 at --win_size 16
    (kernel 5 above window 8 keeps head dims 8-64) and embed 136 at every
    window, naming ROADMAP queue 2 item 9."""
    with torch.device("meta"):
        win16 = get_arch(dict(E72, win_size=16, train_ps=256))
        e136 = get_arch(dict(E72, embed_dim=136))
    assert {blk.win_size for blk in win16.modules()
            if hasattr(blk, "backward_gap")} == {16}
    for model in (win16, e136):
        with pytest.raises(NotImplementedError, match=ITEM9):
            check_spatial_card(model)


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
@pytest.mark.parametrize("D", BIG_DIMS)
@pytest.mark.parametrize("win,nH", [(8, 1), (8, 16), (4, 16)])
def test_attention_block_kernel_big_head_dims(D, win, nH):
    """Kernel 5 at every new head dim on 1 and 16 heads at window 8, and
    on 16 heads (C 16 D, the bottleneck's width) in packed window-4
    tiles; shift win / 2, LN and modulator each way, w_off 0 and 37."""
    dev = _cuda()
    N, C = win * win, D * nH
    for has_ln, with_mod, w_off in ((True, True, 0), (False, False, 37)):
        inp = _attn_inputs(220 + D + nH + win, C, nH, N, (18, N, C))
        if not with_mod:
            inp["mod"] = None
        prm = _on(inp, dev, ("mod", "wq", "wkv", "wo"))
        kw = dict(win=win, shift=win // 2, H=4 * win, W=4 * win,
                  scale=D ** -0.5, num_heads=nH, has_ln=has_ln, w_off=w_off)
        K.reset_counts()
        _check_forward(
            lambda x, dt: K.fused_attention_block(x, *prm[dt], **kw),
            lambda x, dt: K.attention_block_reference(x, *prm[dt], **kw),
            _t(inp["x"], dev).bfloat16().float())
        assert K.launch_counts()["attention_block"] == 2


# kernel 3 at the stages of e72 (C 1152 on 16 heads), e96 (C 384-1536)
# and e128 (C 128-2048)
GPU_STAGES = [(1152, 16), (384, 4), (768, 8), (1536, 16), (128, 1),
              (256, 2), (512, 4), (1024, 8), (2048, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,nH", GPU_STAGES)
def test_stage_kernel_big_head_dims(C, nH):
    dev = _cuda()
    p = _stage_inputs(230, C, nH)
    low = ("wq", "wk", "wv", "wo", "mod", "w1", "wd", "w2")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in p.items()}
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=True,
              has_mod=True)
    K.reset_counts()
    _check_forward(lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                   lambda x, dt: K.stage_reference(x, prm[dt], **kw),
                   _t(_mk(231, 1.0)(2, 16, 16, C), dev).bfloat16().float())
    assert K.launch_counts()["stage"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("C", sorted({D * nH for D in BIG_DIMS
                                      for nH in (1, 16)}))
def test_leff_kernel_big_widths(C):
    """Kernel 2 at C = D and 16 D for every new head dim, hidden 4C (288,
    352, 416 and 480 padded by the wrapper), with and without LN and
    residual, on 6 x 20 (no multiple of a tile's 8 columns)."""
    dev = _cuda()
    inp = _leff_inputs(240, C, 4 * C, (2, 6, 20, C))
    low = ("w1", "wd", "w2")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in inp.items() if k != "x"}
           for dt in (torch.float32, torch.bfloat16)}
    for has_ln, residual in ((True, True), (False, False)):
        def run(fn, has_ln=has_ln, residual=residual):
            def call(x, dt):
                q = prm[dt]
                ln = dict(ln_s=q["ln_s"], ln_b=q["ln_b"]) if has_ln else {}
                return fn(x, *(q[k] for k in ("w1", "b1", "wd", "bd", "w2",
                                              "b2")), **ln,
                          residual=residual)
            return call

        K.reset_counts()
        _check_forward(run(K.fused_leff), run(K.leff_reference),
                       _t(inp["x"], dev).bfloat16().float())
        assert K.launch_counts()["leff"] == 2


@pytest.mark.gpu
def test_scratch_sizes_follow_the_body_of_each_head_dim():
    """`uf_attention_needs_scratch` sizes the slots of every head dim the
    one-window bodies take (72-128 as the next multiple of 16's body) and
    returns an error for any other head dim, which
    `_launch.scratch_regions` raises, rather than a size for head dim 64;
    `uf_leff_scratch` gives slots from C 1408, in both dtypes."""
    from uformer_tpu_torch.ops.kernels import _launch
    from uformer_tpu_torch.ops.kernels._build import load

    _cuda()
    lib = load()
    for is_bf16 in (0, 1):
        for D in FORWARD_HEAD_DIMS:
            for nH in HEADS:
                n = lib.uf_attention_needs_scratch(is_bf16, D * nH, D)
                assert 0 <= n <= 2
                if D in BIG_DIMS and D % 16:  # the body of D + 8
                    assert n == lib.uf_attention_needs_scratch(
                        is_bf16, D * nH, D + 8)
        for D in (12, 20, 136, 0):
            assert lib.uf_attention_needs_scratch(is_bf16, 16 * D, D) < 0
            with pytest.raises(RuntimeError, match="CUDA error"):
                _launch.scratch_regions(lib, is_bf16, 16 * D, D)
        for C in (1152, 1280, 1408, 2048):
            slot = lib.uf_leff_scratch(is_bf16, C, 4 * C)
            assert (slot > 0) == (C >= 1408), (is_bf16, C, slot)
