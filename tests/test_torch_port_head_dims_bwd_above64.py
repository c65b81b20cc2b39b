"""Head dims 72-128 in the backward: `--arch Uformer --embed_dim 72`..`128`
(heads 1-2-4-8-16-16-8-4-2, every block at head dim E, C = E nH up to
2048; E 72, 88, 104 and 120 are 8 mod 16) train through the kernels at
windows 1-8: kernel 1 and its VJP (kernel 6 in the image layout) where C
% 128 == 0, kernel 6 windowed and on packed tiles elsewhere, kernel 7 at
every C up to 2048.

On the CPU, with numpy inputs from a seed and fp32 throughout, each within
1e-4 (1 + max|ref|):
  - kernel 6's plain VJP (`attention_block_vjp_reference`, the CPU answer
    of `fused_attention_block_bwd`) at head dims 72 and 128, windows 8 and
    4, LN and modulator each way, against `jax.vjp` of JAX's reference,
    and on one window at each head dim against JAX's Pallas
    `fused_attention_block_bwd` in interpret mode: all eleven outputs;
  - kernel 1's plain version and its VJP at C 1152 (16 heads of 72) and
    256 (2 heads of 128) on 16^2, shifts 0 and 4, against JAX's reference
    and `jax.vjp`, and at C 256 shift 4 against JAX's Pallas kernel 1 and
    kernel 6 (interpret mode) as JAX's custom VJP runs them;
  - LeFF's plain VJP at C 1152 and 2048 (hidden 4608 and 8192), LN and
    residual each way, against JAX's `fused_leff_bwd` (interpret mode)
    and `jax.vjp`;
  - host mirrors of the shared-memory layouts the new bodies size on the
    host: kernel 6's one-window body at widths 80-128
    (`csrc/attention_window_bwd.cuh`) fits the 227 KB a block may take at
    every (dtype, head dim, C) of the family, where the body's old layout
    did not; kernel 7's tiles at C 1152-2048 (`csrc/leff_bwd_heads.cu`
    in bf16, `csrc/leff_bwd.cu` in fp32) fit, their LayerNormed rows in
    device memory from the C where they miss;
  - the limits: every block of the e72, e96 and e128 models (e96 at
    --train_ps 64 too) has a backward kernel at window 8; at --win_size
    16, and at head dims 12, 20 and 136, blocks are refused, naming
    ROADMAP queue 2 item 9.
tests/test_torch_port_head_dims_bwd_above64_step.py holds the e72 model's
plain-path train step against JAX's. The tests marked `gpu` hold each new
kernel against its plain version on the card (`python -m pytest -m gpu
tests/test_torch_port_head_dims_bwd_above64.py`), within
`chip_smoke.py`'s bounds.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.models.layers import GEOMETRY_NOT_ON_KERNEL_PATH
from uformer_tpu_torch.models.registry import get_arch
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels.attention_image import _check_geometry
from uformer_tpu_torch.ops.kernels.leff import MAX_C, check_width
from uformer_tpu_torch.ops.kernels.window_attention import (
    FORWARD_HEAD_DIMS,
    HEAD_DIMS,
    check_head_dim,
)
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel

torch.set_num_threads(1)
TOL = 1e-4
BIG_DIMS = tuple(range(72, 129, 8))
HEADS = (1, 2, 4, 8, 16)  # the family's heads a stage
ITEM9 = "ROADMAP.md, port queue 2 item 9"
ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
LEFF_GRADS = ("dx", "dw1", "db1", "dwd", "dbd", "dw2", "db2", "dln_s",
              "dln_b")
E72 = {"arch": "Uformer", "embed_dim": 72, "train_ps": 128}


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops import window
    from uformer_tpu.ops.pallas import attention_block, attention_image, leff

    return SimpleNamespace(jax=jax, jnp=jnp, ab=attention_block,
                           ai=attention_image, leff=leff, window=window)


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a).copy()).to(
        device, dtype)


def _close(got, want, what=""):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().cpu().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * (1 + np.abs(want).max()),
                               err_msg=what)


def _attn_inputs(seed, C, nH, N, x_shape, with_mod=True):
    """x, g and the weights of an attention sub-block, matrices scaled by
    fan-in as a trained block's are."""
    rng = np.random.default_rng(seed)

    def mk(*s, scale=0.3):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    inp = dict(x=mk(*x_shape, scale=1.0), mod=mk(N, C) if with_mod else None,
               ln_s=1.0 + mk(C), ln_b=mk(C),
               wq=mk(C, C, scale=1.0) / np.sqrt(C), bq=0.1 * mk(C),
               wkv=mk(C, 2 * C, scale=1.0) / np.sqrt(C),
               bkv=0.1 * mk(2 * C), wo=mk(C, C, scale=1.0) / np.sqrt(C),
               bo=0.1 * mk(C), bias=mk(nH, N, N))
    return inp, mk(*x_shape, scale=1.0)


def _check_attn(got, wants, has_ln, with_mod=True):
    for i, name in enumerate(ATTN_GRADS):
        if (name in ("dln_s", "dln_b") and not has_ln) or \
                (name == "dmod" and not with_mod):
            assert got[i] is None, name
            continue
        for label, want in wants.items():
            _close(got[i], want[i], f"{name} vs {label}")


# ---- kernel 6 in the windowed layout (and packed tiles) --------------------

# (head dim, heads, win, has_ln, with_mod, H, against JAX's kernel too):
# windows of an H x H image; window 4 runs packed tiles on the card
BLOCK_CASES = {
    "D72 C72 win8": (72, 1, 8, True, True, 8, True),
    "D72 C144 win8": (72, 2, 8, False, False, 16, False),
    "D72 C144 win4": (72, 2, 4, True, False, 8, False),
    "D128 C128 win8": (128, 1, 8, False, True, 8, True),
    "D128 C256 win8": (128, 2, 8, True, True, 16, False),
    "D128 C128 win4": (128, 1, 4, False, True, 8, False),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_attention_block_vjp_big_head_dims_matches_jax(jx, case):
    D, nH, win, has_ln, with_mod, H, kernel = BLOCK_CASES[case]
    C, N, Bw = D * nH, win * win, (H // win) ** 2
    inp, g = _attn_inputs(300 + D + nH + win, C, nH, N, (Bw, N, C),
                          with_mod)
    kw = dict(win=win, shift=win // 2, H=H, W=H, scale=D ** -0.5,
              num_heads=nH, has_ln=has_ln)
    K.reset_counts()
    got = K.fused_attention_block_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_block_bwd"] == 1
    j = {k: None if v is None else jx.jnp.asarray(v) for k, v in inp.items()}
    if j["mod"] is None:
        j["mod"] = jx.jnp.zeros((N, C), jx.jnp.float32)
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ab.attention_block_reference(*a, **kw), *j.values())
    wants = {"jax.vjp": vjp(jx.jnp.asarray(g))}
    if kernel:
        wants["kernel"] = jx.ab.fused_attention_block_bwd(
            *list(j.values())[:1], jx.jnp.asarray(g), *list(j.values())[1:],
            has_mod=with_mod, interpret=True, packed=False, **kw)
    _check_attn(got, wants, has_ln, with_mod)


# ---- kernel 1 and its VJP (kernel 6 in the image layout) -------------------

@pytest.mark.parametrize("C,nH", [(1152, 16), (256, 2)])
@pytest.mark.parametrize("shift", [0, 4])
def test_attention_image_big_head_dims_matches_jax(jx, C, nH, shift):
    """Kernel 1's plain version and its VJP on 16^2 against JAX's reference
    and `jax.vjp`; at C 256 (2 heads of 128) and shift 4 also against
    JAX's Pallas kernel 1 and kernel 6 (interpret mode) on the shifted,
    partitioned windows, as JAX's custom VJP runs them."""
    side = 16
    inp, g = _attn_inputs(310 + nH + shift, C, nH, 64, (1, side, side, C))
    kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH,
              has_ln=True, residual=True)
    K.reset_counts()
    y = K.fused_attention_image(*map(_t, inp.values()), **kw)
    got = K.fused_attention_image_bwd(_t(inp["x"]), _t(g),
                                      *map(_t, list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_image"] == 1
    assert K.plain_counts()["attention_bwd"] == 1
    j = [jx.jnp.asarray(v) for v in inp.values()]
    jg = jx.jnp.asarray(g)
    want_y, vjp = jx.jax.vjp(
        lambda *a: jx.ai.attention_image_reference(*a, **kw), *j)
    _close(y, want_y, "forward vs reference")
    wants = {"jax.vjp": vjp(jg)}
    if C == 256 and shift == 4:
        _close(y, jx.ai.fused_attention_image(*j, interpret=True, **kw),
               "forward vs kernel 1")
        w = jx.window

        def part(v):
            return w.window_partition(w.cyclic_shift(v, shift), 8)

        kern = list(jx.ab.fused_attention_block_bwd(
            part(j[0]), part(jg), *j[1:], win=8, shift=shift, H=side,
            W=side, scale=kw["scale"], num_heads=nH, has_ln=True,
            has_mod=True, interpret=True, packed=False))
        kern[0] = w.cyclic_unshift(w.window_reverse(kern[0], 8, side, side),
                                   shift) + jg
        wants["kernel"] = kern
    _check_attn(got, wants, True)


# ---- kernel 7 at C 1152-2048 ------------------------------------------------

def _leff_inputs(seed, C, Ch, x_shape):
    rng = np.random.default_rng(seed)

    def mk(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    inp = dict(x=mk(*x_shape), w1=mk(C, Ch) / np.sqrt(C),
               b1=mk(Ch, scale=0.1), wd=mk(3, 3, Ch) / 3.0,
               bd=mk(Ch, scale=0.1), w2=mk(Ch, C) / np.sqrt(Ch),
               b2=mk(C, scale=0.1), ln_s=1.0 + mk(C, scale=0.1),
               ln_b=mk(C, scale=0.1))
    return inp, mk(*x_shape)


@pytest.mark.parametrize("C", [1152, 2048])
@pytest.mark.parametrize("on", [True, False], ids=["ln_res", "bare"])
def test_leff_vjp_big_widths_matches_jax_kernel(jx, C, on):
    """LeFF's plain VJP at C 1152 and 2048 on 4 x 6, LN and residual both
    on and both off, against JAX's Pallas `fused_leff_bwd` (interpret
    mode) and `jax.vjp` of its reference: all nine outputs."""
    Ch = 4 * C
    inp, dy = _leff_inputs(320 + C + on, C, Ch, (1, 4, 6, C))
    names = list(inp)
    K.reset_counts()
    got = K.fused_leff_bwd(_t(inp["x"]), _t(dy),
                           *(_t(inp[k]) for k in names[1:6]),
                           _t(inp["ln_s"]), _t(inp["ln_b"]), has_ln=on,
                           residual=on)
    assert K.plain_counts()["leff_bwd"] == 1
    J = [jx.jnp.asarray(inp[k]) for k in names]
    kern = jx.leff.fused_leff_bwd(
        J[0], jx.jnp.asarray(dy), *J[1:6], J[7], J[8], has_ln=on,
        residual=on, interpret=True)

    def ref(*a):
        return jx.leff.leff_reference(
            *a[:7], ln_s=a[7] if on else None, ln_b=a[8] if on else None,
            residual=on)

    _, vjp = jx.jax.vjp(ref, *J)
    want = vjp(jx.jnp.asarray(dy))
    for i, name in enumerate(LEFF_GRADS):
        if name in ("dln_s", "dln_b") and not on:
            assert got[i] is None, name
            continue
        _close(got[i], kern[i], f"{name} vs kernel")
        _close(got[i], want[i], f"{name} vs jax.vjp")


# ---- host mirrors of the layouts the kernels size --------------------------

SMEM_LIMIT = 232448  # the 227 KB a block may take (csrc/common.cuh)


def _take(off, nbytes):
    """csrc/common.cuh:Carver: 128-byte aligned slices."""
    return off, off + (nbytes + 127) // 128 * 128


def attn_bwd_layout(ts: int, D: int, C: int, big: bool = True) -> dict:
    """`csrc/attention_window_bwd.cuh:attn_bwd_layout<D>` at width D
    (80-128) in bytes, ts the dtype's size; `big` False restates the body's
    old layout (a 64 x 3D accumulator, a 64 x 3D staged chunk, dS in two
    halves and P's fp32 copy in fp32 too) for comparison."""
    k16 = -(-D // 16) * 16
    qkv = k16 if big else max(3 * k16, 64)
    ldq, ldp, ldacc = D + 8, 72, qkv + 4
    ldsp = ldp if big else 68
    stage = max(64 * ((k16 if big else 3 * k16) + 8), 2 * 64 * (64 + 8))
    f32_big = big and ts == 4
    out, off = {}, 0
    for name, size, keep in (
            ("q", 64 * ldq * ts, True), ("k", 64 * ldq * ts, True),
            ("v", 64 * ldq * ts, True), ("pt", 64 * ldp * ts, True),
            ("sp", 64 * ldsp * 4, not f32_big),
            ("acc", 64 * ldacc * 4, True), ("pix", 256, True),
            ("rid", 256, True), ("stats", 512, True),
            ("dsh", 64 * ldp * ts, True), ("dsl", 64 * ldp * ts, not f32_big),
            ("dh", 64 * ldq * ts, ts == 2 or big),
            ("w", stage * ts, ts == 2)):
        if keep:
            out[name], off = _take(off, size)
    out["fixed"] = off
    tile = 64 * (C + 8) * ts
    out["x_smem"] = off + tile <= SMEM_LIMIT
    if out["x_smem"]:
        _, off = _take(off, tile)
    out["do_smem"] = off + tile <= SMEM_LIMIT
    if out["do_smem"]:
        _, off = _take(off, tile)
    out["total"] = off
    out["scratch"] = ((0 if out["x_smem"] else 1)
                      | (0 if out["do_smem"] else 2)
                      | (4 if ts == 2 and not (out["x_smem"]
                                               and out["do_smem"]) else 0))
    return out


@pytest.mark.parametrize("ts", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("hd", BIG_DIMS)
def test_kernel6_big_layout_fits(ts, hd):
    """At every head dim 72-128 (on the body of the next multiple of 16)
    and every C = hd nH of the family, the one-window backward's layout
    fits; xm and dO go to device memory where they miss, and a C of 8 mod
    16 (a head of 72, 88, 104 or 120 on one head) keeps xm in shared
    memory, where its zero pad columns are. The body's old layout (three
    accumulators and a staged 3D chunk at once) did not fit at head dim
    128 in bf16: about 262 KB, its fp32 accumulator 99 KB of it."""
    D = -(-hd // 16) * 16
    for nH in HEADS:
        C = hd * nH
        lay = attn_bwd_layout(ts, D, C)
        assert lay["total"] <= SMEM_LIMIT, (C, lay["total"])
        offs = [v for k, v in lay.items()
                if k in ("q", "k", "v", "pt", "acc", "dsh", "dh", "w")]
        assert all(o % 128 == 0 for o in offs)
        if ts == 2 and C % 16:
            assert lay["x_smem"], C
    if ts == 2 and D == 128:
        old = attn_bwd_layout(2, 128, 128, big=False)
        assert old["fixed"] > SMEM_LIMIT
        assert 64 * (3 * 128 + 4) * 4 == 99328


def leff_bwd_layout(which: int, C: int, TH: int, bf16: bool) -> dict:
    """`csrc/leff_bwd_heads.cu:layout` (bf16) and `csrc/leff_bwd.cu:
    leff_bwd_layout` (fp32) in bytes: kernel A (which 0) or B (1) on TH x
    8 output tiles, the tile's LN(x) last, in shared memory where it
    fits."""
    ts = 2 if bf16 else 4
    Mo, nh = TH * 8, (TH + 2) * 10
    Mh = -(-nh // 16) * 16
    lda = (-(-C // 16) * 16 if bf16 else C) + 4
    off = 0
    sizes = [4 * Mh, 4 * Mo]
    if bf16:
        sizes.append(2 * max(128 * 72, 64 * 136))  # a staged weight piece
    if which == 0:
        sizes += [Mo * (C + 8) * ts, Mh * 68 * 4, Mo * 68 * 4,
                  8 * 64 * 10 * 4]
    else:
        sizes += [Mo * lda * 4, Mo * 68 * 4, Mh * 68 * 4, Mo * 72 * ts,
                  2 * Mo * 4]
    for size in sizes:
        _, off = _take(off, size)
    rows = Mh if which == 0 else Mo
    xn = rows * (C + 8) * ts
    smem = off + xn <= SMEM_LIMIT
    if smem:
        _, off = _take(off, xn)
    return {"total": off, "xn_smem": smem, "rows": rows}


def leff_bwd_rows(which: int, C: int, bf16: bool):
    """(TH, scratch rows) as `uf_leff_bwd_tile_rows` and
    `uf_leff_bwd_scratch` give them at C 1152-2048: the most rows with
    LN(x) in shared memory, else the most without it."""
    for in_smem in (True, False):
        for th in ((8, 4, 2) if bf16 else (8, 4, 2, 1)):
            lay = leff_bwd_layout(which, C, th, bf16)
            if lay["total"] <= SMEM_LIMIT and (lay["xn_smem"] or
                                               not in_smem):
                return th, 0 if lay["xn_smem"] else lay["rows"]
    return 0, 0


# (TH, scratch rows) of kernels A and B by dtype and C
LEFF_ROWS = {
    True: {1152: ((2, 0), (2, 0)), 1280: ((2, 0), (2, 0)),
           1408: ((4, 64), (2, 0)), 1536: ((4, 64), (2, 0)),
           1664: ((4, 64), (2, 0)), 1792: ((4, 64), (2, 0)),
           1920: ((4, 64), (2, 0)), 2048: ((4, 64), (2, 16))},
    False: {1152: ((1, 0), (2, 0)), 1280: ((4, 64), (2, 0)),
            1408: ((4, 64), (2, 0)), 1536: ((2, 48), (2, 0)),
            1664: ((2, 48), (1, 0)), 1792: ((2, 48), (1, 0)),
            1920: ((2, 48), (1, 0)), 2048: ((2, 48), (1, 0))},
}


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_leff_bwd_tiles_fit_at_c_1152_2048(bf16):
    """Kernel 7's tiles at every C 1152-2048 fit; the LN(x) rows go to
    device memory from bf16 A's C 1408 (its halo, 48 x (C + 8) at the
    2-row tile, fills the block), bf16 B's C 2048 (beside the 16 x (C + 4)
    fp32 dLN accumulator) and fp32 A's C 1280, a slot of `rows` x C a
    tile."""
    for C, want in LEFF_ROWS[bf16].items():
        got = tuple(leff_bwd_rows(which, C, bf16) for which in (0, 1))
        assert got == want, (C, got)
        for which, (th, _) in enumerate(got):
            assert leff_bwd_layout(which, C, th, bf16)["total"] <= SMEM_LIMIT


# ---- the limits ------------------------------------------------------------

@pytest.mark.parametrize("opt", [E72, dict(E72, embed_dim=96),
                                 dict(E72, embed_dim=128),
                                 dict(E72, embed_dim=96, train_ps=64)],
                         ids=["e72", "e96", "e128", "e96ps64"])
def test_big_head_dim_models_train_at_window_8(opt):
    """Every block of the model has a backward kernel at window 8; kernels
    1, 5 and 6 take its head dim (FORWARD_HEAD_DIMS, kernel 1's and 6's
    image geometry too) and kernels 2 and 7 every C it builds. Built on
    the meta device: the checks read the geometry only."""
    with torch.device("meta"):
        model = get_arch(opt)
    assert blocks_without_backward_kernel(model) == []
    D = opt["embed_dim"]
    for nH in HEADS:
        C = D * nH
        check_head_dim(C, nH, FORWARD_HEAD_DIMS)
        _check_geometry(torch.empty(1, 8, 8, C), 8, 4, nH)
        check_width(C)
    assert 16 * D <= MAX_C


@pytest.mark.parametrize("opt,refused", [
    (dict(E72, win_size=16), 16), (dict(E72, embed_dim=128, win_size=16),
                                   16),
    (dict(E72, embed_dim=136), 18), (dict(E72, embed_dim=12), 18),
    (dict(E72, embed_dim=20), 18)],
    ids=["e72win16", "e128win16", "e136", "e12", "e20"])
def test_other_geometries_refused_naming_item9(opt, refused):
    """At --win_size 16 the blocks at window 16 (all but the 8^2
    bottleneck's two at 128^2) are refused, and at head dims 136, 12 and 20
    every block, before any launch, naming ROADMAP queue 2 item 9; the
    wrappers' checks raise for them too."""
    with torch.device("meta"):
        model = get_arch(opt)
    uncovered = blocks_without_backward_kernel(model)
    assert len(uncovered) == refused
    gap = model.get_submodule(uncovered[0]).backward_gap
    assert gap == GEOMETRY_NOT_ON_KERNEL_PATH and ITEM9 in gap
    D = opt["embed_dim"]
    dims = HEAD_DIMS if opt.get("win_size", 8) > 8 else FORWARD_HEAD_DIMS
    for nH in HEADS:
        with pytest.raises(ValueError, match=ITEM9):
            check_head_dim(D * nH, nH, dims)


# ---- the kernels on the card -----------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


DRAWS = 4  # independent inputs a bf16 comparison pools (chip_smoke.py)
FEW_ENTRIES = 64  # held by rms error in bf16 (chip_smoke.py)


def _check_bwd(fused, plain, draws, names):
    """Per gradient: fp32 kernel within 1e-4 (1 + max|ref|) of the fp32
    plain VJP, each draw; bf16 kernel within 1.5x the bf16 plain VJP's
    error + 1e-3 max(1, max|ref|) of it, on each gradient of all draws
    taken as one tensor: its max error, or its rms error where the
    gradient has at most FEW_ENTRIES entries a draw
    (chip_smoke.py:pooled_grad_bound); the bf16 kernel run twice on the
    last draw gives equal bits."""
    runs = [(fused(x, g, torch.float32), plain(x, g, torch.float32),
             plain(x.bfloat16(), g.bfloat16(), torch.bfloat16),
             fused(x.bfloat16(), g.bfloat16(), torch.bfloat16))
            for x, g in draws]
    x, g = draws[-1]
    again = fused(x.bfloat16(), g.bfloat16(), torch.bfloat16)
    for i, name in enumerate(names):
        if runs[0][1][i] is None:
            assert all(r[0][i] is None and r[3][i] is None for r in runs)
            continue
        assert torch.equal(again[i], runs[-1][3][i]), name
        for got, ref, _, _ in runs:
            err = float((got[i].float() - ref[i].float()).abs().max())
            assert err <= TOL * (1 + float(ref[i].abs().max())), (name, err)
        k, r, p, k16 = (torch.cat([run[j][i].float().reshape(-1)
                                   for run in runs]) for j in range(4))
        scale = float(r.abs().max())
        if runs[0][1][i].numel() <= FEW_ENTRIES:
            e_plain = float((p - r).pow(2).mean().sqrt())
            e16 = float((k16 - r).pow(2).mean().sqrt())
        else:
            e_plain = float((p - r).abs().max())
            e16 = float((k16 - r).abs().max())
        assert e16 <= 1.5 * e_plain + 1e-3 * max(1.0, scale), (name, e16)


def _model_like(seed):
    """Operand makers by the golden weights' rule (as chip_smoke.py's
    seeded models): matrices N(0, 1 / fan-in), LayerNorm scales 1 +
    N(0, 0.05²), biases N(0, 0.02²); inputs N(0, 1)."""
    rng = np.random.default_rng(seed)

    def mat(*shape, fan_in=1):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def scale(n):
        return (1.0 + 0.05 * rng.standard_normal(n)).astype(np.float32)

    def bias(n):
        return (0.02 * rng.standard_normal(n)).astype(np.float32)

    return mat, scale, bias


def _draws(seed, *shape):
    mat, _, _ = _model_like(seed)
    return [tuple(torch.from_numpy(mat(*shape)).cuda().bfloat16().float()
                  for _ in range(2)) for _ in range(DRAWS)]


def _attn_prm(seed, C, nH, N, dev, with_mod=True):
    mat, scale, bias = _model_like(seed)
    p = dict(mod=mat(N, C, fan_in=C) if with_mod else None, ln_s=scale(C),
             ln_b=bias(C), wq=mat(C, C, fan_in=C), bq=bias(C),
             wkv=mat(C, 2 * C, fan_in=C), bkv=bias(2 * C),
             wo=mat(C, C, fan_in=C), bo=bias(C),
             bias=mat(nH, N, N, fan_in=nH))
    low = ("mod", "wq", "wkv", "wo")
    return {dt: [_t(v, dev, dt if k in low else torch.float32)
                 for k, v in p.items()]
            for dt in (torch.float32, torch.bfloat16)}


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("D", BIG_DIMS)
@pytest.mark.parametrize("nH,shift,residual", [(1, 4, True),
                                               (16, 0, False)])
def test_attention_image_kernels_big_head_dims(D, nH, shift, residual):
    """Kernel 1 and its VJP at C = D and 16 D on 2 x 16^2: the forward in
    fp32 within 1e-4 (1 + max|ref|) and in bf16 within 1.5x the plain bf16
    error + 1e-3 of the fp32 plain result; the VJP by `_check_bwd`."""
    dev = _cuda()
    C = D * nH
    prm = _attn_prm(330 + D + nH, C, nH, 64, dev)
    kw = dict(win=8, shift=shift, scale=D ** -0.5, num_heads=nH,
              residual=residual)
    draws = _draws(331 + D, 2, 16, 16, C)
    x32 = draws[0][0]
    ref = K.attention_image_reference(x32, *prm[torch.float32], **kw)
    K.reset_counts()
    y = K.fused_attention_image(x32, *prm[torch.float32], **kw)
    assert _err(y, ref) <= TOL * (1 + float(ref.abs().max()))
    y16 = K.fused_attention_image(x32.bfloat16(), *prm[torch.bfloat16], **kw)
    p16 = K.attention_image_reference(x32.bfloat16(), *prm[torch.bfloat16],
                                      **kw)
    assert _err(y16, ref) <= 1.5 * _err(p16, ref) + 1e-3
    assert K.launch_counts()["attention_image"] == 2
    _check_bwd(lambda x, g, dt: K.fused_attention_image_bwd(
                   x, g, *prm[dt], **kw),
               lambda x, g, dt: K.attention_image_vjp_reference(
                   x, g, *prm[dt], **kw), draws, ATTN_GRADS)
    assert K.launch_counts()["attention_bwd"] == 2 * DRAWS + 1
    assert not any(K.plain_counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("D", BIG_DIMS)
@pytest.mark.parametrize("win,nH,has_ln,with_mod,Bw", [
    (8, 1, True, True, 24), (4, 16, False, False, 36)])
def test_attention_block_bwd_kernel_big_head_dims(D, win, nH, has_ln,
                                                  with_mod, Bw):
    """Kernel 6 windowed at window 8 on one head and on packed window-4
    tiles at 16 heads (C 16 D, the bottleneck's width), LN and modulator
    each way, shift win / 2."""
    dev = _cuda()
    N, C = win * win, D * nH
    prm = _attn_prm(340 + D + nH, C, nH, N, dev, with_mod)
    kw = dict(win=win, shift=win // 2, H=4 * win, W=4 * win,
              scale=D ** -0.5, num_heads=nH, has_ln=has_ln)
    K.reset_counts()
    _check_bwd(lambda x, g, dt: K.fused_attention_block_bwd(
                   x, g, *prm[dt], **kw),
               lambda x, g, dt: K.attention_block_vjp_reference(
                   x, g, *prm[dt], **kw),
               _draws(341 + D, Bw, N, C), ATTN_GRADS)
    assert K.launch_counts()["attention_block_bwd"] == 2 * DRAWS + 1
    assert not any(K.plain_counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("C", range(1152, 2049, 128))
def test_leff_bwd_kernel_big_widths(C):
    """Kernel 7 at every C 1152-2048 (hidden 4C), LN and residual both on
    and both off, on 10 x 20 (partial tiles both ways)."""
    dev = _cuda()
    Ch = 4 * C
    mat, scale, bias = _model_like(350 + C)
    inp = dict(w1=mat(C, Ch, fan_in=C), b1=bias(Ch),
               wd=mat(3, 3, Ch, fan_in=9), bd=bias(Ch),
               w2=mat(Ch, C, fan_in=Ch), ln_s=scale(C), ln_b=bias(C))
    low = ("w1", "wd", "w2")
    prm = {dt: {k: _t(v, dev, dt if k in low else torch.float32)
                for k, v in inp.items()}
           for dt in (torch.float32, torch.bfloat16)}
    for on in (True, False):
        def run(fn, on=on):
            def call(x, g, dt):
                p = prm[dt]
                return fn(x, g, *(p[k] for k in ("w1", "b1", "wd", "bd",
                                                 "w2")),
                          p["ln_s"], p["ln_b"], has_ln=on, residual=on)
            return call

        K.reset_counts()
        _check_bwd(run(K.fused_leff_bwd), run(K.leff_vjp_reference),
                   _draws(351, 1, 10, 20, C), LEFF_GRADS)
        assert K.launch_counts()["leff_bwd"] == 2 * DRAWS + 1


@pytest.mark.gpu
def test_scratch_queries_match_the_host_mirrors():
    """The C entries size what the host mirrors above restate:
    `uf_attention_bwd_scratch` at every head dim 72-128 and C of the
    family (and a negated error at head dims 12, 20 and 136),
    `uf_leff_bwd_tile_rows` and `uf_leff_bwd_scratch` at C 1152-2048."""
    from uformer_tpu_torch.ops.kernels._build import load

    _cuda()
    lib = load()
    for ts in (2, 4):
        for hd in BIG_DIMS:
            for nH in HEADS:
                C = hd * nH
                want = attn_bwd_layout(ts, -(-hd // 16) * 16, C)["scratch"]
                assert lib.uf_attention_bwd_scratch(int(ts == 2), C,
                                                    nH) == want, (ts, C)
        for D in (12, 20, 136):
            assert lib.uf_attention_bwd_scratch(int(ts == 2), 4 * D, 4) < 0
    for bf16, rows in LEFF_ROWS.items():
        for C, want in rows.items():
            got = tuple((lib.uf_leff_bwd_tile_rows(w, int(bf16), C),
                         lib.uf_leff_bwd_scratch(w, int(bf16), C))
                        for w in (0, 1))
            assert got == want, (bf16, C, got)
