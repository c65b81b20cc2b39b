"""Head dims 24, 40, 48 and 56 in the forward kernels 2, 3 and 5:
`--arch Uformer --embed_dim 48` and `--embed_dim 24` (heads
1-2-4-8-16-16-8-4-2, every block at head dim 48 or 24, C 24-768, none a
power of two; C 24, 40 and 56 are 8 mod 16).

On the CPU, with numpy inputs from a seed and fp32 throughout, each within
1e-4 (1 + max|ref|):
  - `attention_block_reference` at head dims 24 and 48 (C 24, 48, 96 and
    192) at windows 8, 4 and 16 against JAX's jnp reference (the windows
    at place w_off 3 of a longer batch) and JAX's Pallas kernel 5 in
    interpret mode (w_off 3);
  - `stage_reference` at C 384 (8 and 16 heads: head dims 48 and 24) on
    16^2 and 8^2 against JAX's;
  - `leff_reference` at C 24 (hidden 96) and C 48 against JAX's, and
    `pad_hidden` at hidden 96: the plain version on the padded weights
    equal bit for bit to the unpadded one;
  - the port's plain path of the embed-48 and embed-24 Uformer (depths
    cut to 1, as tests/test_torch_port_family.py cuts them) at 128^2
    against JAX `get_arch` with attn_backend="jnp" on the same weights,
    carried across by the state_dict converter;
  - the limits: kernels 1, 3, 5 and 6 take head dims 24-56 both ways at
    every window (HEAD_DIMS, within FORWARD_HEAD_DIMS, since their
    backward was ported: tests/test_torch_port_head_dims_bwd.py) and
    kernel 2 every C of 8's multiples; kernel 4 refuses them at windows
    1-8 (WINDOW_ATTENTION_HEAD_DIMS; above window 8 it takes them,
    tests/test_torch_port_wide_core_mma.py), head dims 12, 20 and 136
    are refused everywhere and 128 above window 8, naming ROADMAP queue
    2 item 9; a model at
    embed 20 has its train step refused (`LeWinBlock.backward_gap`), and
    the spatial path's card check takes the embed-48 and embed-24 models.
The launch routes of the two models (4/0/10/10 and 2/0/14/14 at 256^2)
are cases of tests/test_torch_port_geometry.py's ROUTES. The tests marked
`gpu` hold each extended kernel against its plain version on the card
(`python -m pytest -m gpu tests/test_torch_port_head_dims.py`).
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
from uformer_tpu_torch.ops.kernels.leff import check_width, pad_hidden
from uformer_tpu_torch.ops.kernels.window_attention import (
    FORWARD_HEAD_DIMS,
    HEAD_DIMS,
    WINDOW_ATTENTION_HEAD_DIMS,
    check_head_dim,
)
from uformer_tpu_torch.parallel.spatial import check_spatial_card
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel

torch.set_num_threads(1)
TOL = 1e-4
NEW_DIMS = (24, 40, 48, 56)
ITEM9 = "ROADMAP.md, port queue 2 item 9"
E48 = {"arch": "Uformer", "embed_dim": 48, "train_ps": 128}
E24 = {"arch": "Uformer", "embed_dim": 24, "train_ps": 128}


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

# (head dim, heads, window, LN): C 24-192 at windows 8, 4 (packed tiles on
# the card) and 16 (csrc/attention_wide.cu)
BLOCK_CASES = [(24, 1, 8, True), (24, 2, 4, False), (24, 4, 16, True),
               (24, 8, 8, False), (48, 1, 4, True), (48, 2, 8, True),
               (48, 4, 16, False)]


def _block_case(D, nH, win, has_ln, shift):
    """Windows at place w_off 3 of 4 x 4-window images, 5 of them."""
    C, N, H = D * nH, win * win, 4 * win
    inp = _attn_inputs(100 + D + nH + win + shift, C, nH, N, (5, N, C))
    kw = dict(win=win, shift=shift, H=H, W=H, scale=D ** -0.5, num_heads=nH,
              has_ln=has_ln)
    return inp, kw


@pytest.mark.parametrize("D,nH,win,has_ln", BLOCK_CASES)
@pytest.mark.parametrize("shift_half", [False, True])
def test_attention_block_reference_matches_jax(jx, D, nH, win, has_ln,
                                               shift_half):
    """The port's windows at places 3.. against JAX's reference on a
    batch that holds them at those places (3 leading windows, padded to
    whole images of 16 windows)."""
    inp, kw = _block_case(D, nH, win, has_ln, win // 2 if shift_half else 0)
    w_off, Bw = 3, inp["x"].shape[0]
    got = K.attention_block_reference(*map(_t, inp.values()), **kw,
                                      w_off=w_off)
    xj = np.zeros((16,) + inp["x"].shape[1:], np.float32)
    xj[w_off:w_off + Bw] = inp["x"]
    want = np.asarray(jx.ab.attention_block_reference(
        *_j(jx, dict(inp, x=xj)).values(), **kw))
    _close(got, want[w_off:w_off + Bw], f"attention_block D {D} {kw}")


@pytest.mark.parametrize("D,nH,win,has_ln", BLOCK_CASES)
def test_attention_block_matches_jax_kernel(jx, D, nH, win, has_ln):
    """Kernel 5's plain version against JAX's Pallas kernel in interpret
    mode (its unpacked form) at w_off 3, shifted."""
    inp, kw = _block_case(D, nH, win, has_ln, win // 2)
    K.reset_counts()
    got = K.fused_attention_block(*map(_t, inp.values()), **kw, w_off=3)
    assert K.plain_counts()["attention_block"] == 1
    want = jx.ab.fused_attention_block(*_j(jx, inp).values(),
                                       interpret=True, packed=False,
                                       w_off=3, **kw)
    _close(got, want, f"attention_block kernel D {D} {kw}")


# ---- kernels 3 and 2's plain versions against JAX -------------------------

@pytest.mark.parametrize("nH", [8, 16])
@pytest.mark.parametrize("side", [16, 8])
def test_stage_reference_matches_jax_at_c384(jx, nH, side):
    C = 384
    p = _stage_inputs(C + nH + side, C, nH)
    x = _mk(nH + side + 7, 1.0)(1, side, side, C)
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=True,
              has_mod=True)
    got = K.stage_reference(_t(x), {k: _t(v) for k, v in p.items()}, **kw)
    want = jx.stage.stage_reference(jx.jnp.asarray(x), _j(jx, p), **kw)
    _close(got, want, f"stage C {C} heads {nH} {side}^2")


@pytest.mark.parametrize("C", [24, 48])
@pytest.mark.parametrize("has_ln,residual", [(True, True), (False, False)])
def test_leff_reference_matches_jax(jx, C, has_ln, residual):
    inp = _leff_inputs(C + 2 * has_ln + residual, C, 4 * C, (2, 12, 20, C))
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
def test_pad_hidden_at_hidden_96_keeps_the_bits(has_ln, residual):
    """C 24's hidden of 96 padded to 128 (`pad_hidden`, as the kernel
    takes it): the plain version on the padded weights equals the
    unpadded one bit for bit (a pad channel's hidden is GELU(0) = 0 and
    its w2 row is zero)."""
    inp = _leff_inputs(110 + has_ln, 24, 96, (2, 12, 20, 24))
    w = [_t(inp[k]) for k in ("w1", "b1", "wd", "bd", "w2")]
    padded = pad_hidden(*w)
    assert padded[0].shape == (24, 128) and padded[4].shape == (128, 24)
    ln = dict(ln_s=_t(inp["ln_s"]), ln_b=_t(inp["ln_b"])) if has_ln else {}
    x, b2 = _t(inp["x"]), _t(inp["b2"])
    want = K.leff_reference(x, *w[:4], w[4], b2, **ln, residual=residual)
    got = K.leff_reference(x, *padded[:4], padded[4], b2, **ln,
                           residual=residual)
    assert torch.equal(got, want)


# ---- the embed-48 and embed-24 models -------------------------------------

@pytest.mark.parametrize("opt", [E48, E24], ids=["e48", "e24"])
def test_uformer_matches_jax(jx, opt):
    """`--arch Uformer --embed_dim 48` / `24` at one block a stage, 128^2:
    the port's plain path against JAX's jnp model on the same seeded
    weights, every attention and LeFF through the kernels' wrappers (their
    plain versions here)."""
    from uformer_tpu import get_arch as jax_get_arch

    jax, jnp = jx.jax, jx.jnp
    shallow = (1,) * 9
    jmodel = jax_get_arch(dict(opt, attn_backend="jnp")).clone(
        depths=shallow)
    seed = opt["embed_dim"]
    x = np.random.default_rng(seed).uniform(0, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * rng.standard_normal(a.shape)
                         + jax.tree_util.keystr(path).endswith("['scale']"))
        .astype(np.float32), shapes)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    port = Uformer(**dict(arch_config(opt), depths=shallow)).eval()
    E = opt["embed_dim"]
    assert port.conv.num_heads == 16 and port.conv.dim == 16 * E
    assert {blk.dim // blk.num_heads for blk in port.modules()
            if hasattr(blk, "backward_gap")} == {E}
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          state_dict_from_jax(params).items()}, strict=True)
    K.reset_counts()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    plain = K.plain_counts()
    # 128^2: enc3 (16^2) and the bottleneck and dec0 (8^2) at C 8 E 16 ...
    assert plain["stage"] + plain["attention_block"] == 9
    assert plain["attention_image"] == 0 and plain["leff"] == \
        plain["attention_block"]
    _close(got, want, f"embed-{E} Uformer")


# ---- the checks ------------------------------------------------------------

def test_forward_and_backward_head_dims():
    """The kernels take every multiple of 8 up to 64 both ways at every
    window, and kernels 1, 3, 5 and 6 at windows 1-8 every multiple of 8
    up to 128, both ways (tests/test_torch_port_head_dims_above64.py,
    tests/test_torch_port_head_dims_bwd_above64.py); kernel 4 (no model
    path calls it) the powers of two among 8-64 at windows 1-8."""
    assert FORWARD_HEAD_DIMS == tuple(range(8, 129, 8))
    assert HEAD_DIMS == (8, 16, 24, 32, 40, 48, 56, 64)
    assert set(HEAD_DIMS) - set(WINDOW_ATTENTION_HEAD_DIMS) == \
        set(NEW_DIMS)


@pytest.mark.parametrize("D", NEW_DIMS)
def test_new_head_dims_forward_only(D):
    """Kernels 3 and 5 (FORWARD_HEAD_DIMS), kernel 2 (every C the family
    builds at D: D nH for nH 1-16), kernel 1 and the backward (HEAD_DIMS)
    take head dim D; kernel 4 at windows 1-8 (WINDOW_ATTENTION_HEAD_DIMS)
    refuses it, naming ROADMAP queue 2 item 9."""
    for nH in (1, 2, 4, 8, 16):
        check_head_dim(D * nH, nH, FORWARD_HEAD_DIMS)
        check_width(D * nH)
        check_head_dim(D * nH, nH)
        _check_geometry(torch.empty(1, 8, 8, D * nH), 8, 0, nH)  # kernel 1
    with pytest.raises(ValueError, match=ITEM9):  # kernel 4
        check_head_dim(D, 1, WINDOW_ATTENTION_HEAD_DIMS)


@pytest.mark.parametrize("D", [12, 20, 136])
def test_other_head_dims_refused_everywhere(D):
    """A head dim that is no multiple of 8, or above 128, has no kernel
    either way, and head dim 128 none above window 8, forward or backward
    (ROADMAP queue 2 item 9); at windows 1-8 it has both."""
    for dims in (FORWARD_HEAD_DIMS, HEAD_DIMS):
        for nH in (1, 4, 16):
            with pytest.raises(ValueError, match=ITEM9):
                check_head_dim(D * nH, nH, dims)
    for nH in (1, 4, 16):
        with pytest.raises(ValueError, match=ITEM9):
            check_head_dim(128 * nH, nH, HEAD_DIMS)
        check_head_dim(128 * nH, nH, FORWARD_HEAD_DIMS)
    if D % 8:
        with pytest.raises(ValueError, match="C % 8"):
            check_width(D)


@pytest.mark.parametrize("opt", [E48, E24, dict(E48, train_ps=64)],
                         ids=["e48", "e24", "e48ps64"])
def test_training_still_refused(opt):
    """Every block of the embed-48 and embed-24 models has a kernel both
    ways now (tests/test_torch_port_head_dims_bwd.py), and the spatial
    path's card check (a forward) takes them; what the train step still
    refuses is a head dim no kernel takes: at embed 20 (head dim 20) all
    18 blocks, naming what is left."""
    model = get_arch(opt)
    assert blocks_without_backward_kernel(model) == []
    check_spatial_card(model)
    odd = get_arch(dict(opt, embed_dim=20))
    uncovered = blocks_without_backward_kernel(odd)
    assert len(uncovered) == 18
    gap = odd.get_submodule(uncovered[0]).backward_gap
    assert gap == GEOMETRY_NOT_ON_KERNEL_PATH and ITEM9 in gap
    assert str(HEAD_DIMS) in gap


def test_spatial_card_check_refuses_head_dim_20():
    odd = Uformer(img_size=128, embed_dim=20, depths=(1,) * 9)
    with pytest.raises(NotImplementedError, match=ITEM9):
        check_spatial_card(odd)


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
@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("win", [8, 4, 16])
def test_attention_block_kernel_new_head_dims(D, win):
    """Kernel 5 at every (D, heads) the family builds at window 8, and at
    1 and 4 heads at windows 4 and 16; LN and modulator each way, w_off 0
    and 37."""
    dev = _cuda()
    N = win * win
    heads = (1, 2, 4, 8, 16) if win == 8 else (1, 4)
    for nH in heads:
        C = D * nH
        for has_ln, with_mod, w_off in ((True, True, 0),
                                        (False, False, 37)):
            inp = _attn_inputs(120 + nH, C, nH, N, (32, N, C))
            if not with_mod:
                inp["mod"] = None
            prm = _on(inp, dev, ("mod", "wq", "wkv", "wo"))
            kw = dict(win=win, shift=win // 2, H=4 * win, W=4 * win,
                      scale=D ** -0.5, num_heads=nH, has_ln=has_ln,
                      w_off=w_off)
            K.reset_counts()
            _check_forward(
                lambda x, dt: K.fused_attention_block(x, *prm[dt], **kw),
                lambda x, dt: K.attention_block_reference(x, *prm[dt], **kw),
                _t(inp["x"], dev).bfloat16().float())
            assert K.launch_counts()["attention_block"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("C,nH", [(384, 16), (384, 8), (640, 16),
                                  (768, 16), (896, 16)])
@pytest.mark.parametrize("side", [16, 8])
def test_stage_kernel_new_head_dims(C, nH, side):
    dev = _cuda()
    p = _stage_inputs(130, C, nH)
    low = ("wq", "wk", "wv", "wo", "mod", "w1", "wd", "w2")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in p.items()}
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=True,
              has_mod=True)
    K.reset_counts()
    _check_forward(lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                   lambda x, dt: K.stage_reference(x, prm[dt], **kw),
                   _t(_mk(131, 1.0)(2, side, side, C), dev)
                   .bfloat16().float())
    assert K.launch_counts()["stage"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("C", sorted({D * nH for D in NEW_DIMS
                                      for nH in (1, 2, 4, 8, 16)}))
def test_leff_kernel_new_widths(C):
    """Kernel 2 at every C of the new head dims, hidden 4C (96, 160 and
    224 padded by the wrapper), with and without LN and residual, on 12 x
    20 (no multiple of a tile's 8 columns)."""
    dev = _cuda()
    inp = _leff_inputs(140, C, 4 * C, (2, 12, 20, C))
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
