"""Windows of 9-16 (N = win² = 81-256 tokens) in kernels 4, 5 and 6, and
the win-16 Uformer.

On the CPU, with numpy inputs from a seed and fp32 throughout:
  (a) kernel 4's plain version (`window_attention_reference`, the CPU
      answer of `fused_window_attention`) at windows 9, 12 and 16, shift 0
      and win // 2, head dim 8 and 32, against JAX's Pallas
      `fused_window_attention` (interpret mode) and its jnp core;
  (b) kernel 5's plain version at the same windows, C 16 and 32, LN and
      the modulator each way, against JAX's jnp reference, and JAX's
      Pallas kernel 5 (interpret mode) at window 12;
  (c) kernel 6's plain VJP against `jax.vjp` of JAX's reference;
  (d) the wide kernels' algorithm in plain PyTorch (`csrc/attention_wide.cu`:
      64 query rows against 64-key chunks with a running max and sum,
      query rows padded with zeros and keys with -inf, region ids from
      each token's place) equals the plain version;
  (e) a tiny Uformer at win_size 16 (embed 8, img_size 64) against JAX:
      one forward, and one plain-path train step's loss and gradients;
  (f) the limits: every window passes `check_window` (17 and 32 too),
      kernels 1 and 3 take window 8 alone; head dims 8-64 pass
      `check_head_dim` both ways, head dim 128 raises naming ROADMAP
      queue 2 item 9; the win-16 and win-32 models train on the kernel
      path (`blocks_without_backward_kernel`), an embed-20 model (head
      dim 20) does not.
All within 1e-4 (1 + max|ref|). The tests marked `gpu` hold kernels 4, 5
and 6 at windows 9-16 against their plain versions on the card (`python
-m pytest -m gpu tests/test_torch_port_wide_windows.py`).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels.window_attention import (
    HEAD_DIMS,
    check_head_dim,
    check_window,
)
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel

torch.set_num_threads(1)
TOL = 1e-4
ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
WIDE = (9, 12, 16)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops import attention, masks
    from uformer_tpu.ops.pallas import attention_block, window_attention

    return SimpleNamespace(jax=jax, jnp=jnp, ab=attention_block,
                           wa=window_attention, attention=attention,
                           masks=masks)


def _t(a, device="cpu", dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a).copy()).to(
        device, dtype)


def _close(got, *wants, what=""):
    got = got.detach().float().cpu().numpy()
    for want in wants:
        want = np.asarray(want, dtype=np.float32)
        assert got.shape == want.shape, (what, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * (1 + np.abs(want).max()),
                                   err_msg=what)


def _mk(seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)


def _qkv_inputs(seed, nH, Bw, N, D):
    mk = _mk(seed, 0.5)
    return dict(q=mk(nH, Bw, N, D), k=mk(nH, Bw, N, D), v=mk(nH, Bw, N, D),
                bias=mk(nH, N, N))


def _block_inputs(seed, Bw, N, C, nH, with_mod=True):
    mk = _mk(seed)
    return dict(x=mk(Bw, N, C), mod=mk(N, C) if with_mod else None,
                ln_s=1.0 + 0.5 * mk(C), ln_b=0.5 * mk(C), wq=mk(C, C),
                bq=mk(C), wkv=mk(C, 2 * C), bkv=mk(2 * C), wo=mk(C, C),
                bo=mk(C), bias=mk(nH, N, N))


def _geometry(win):
    """Two images of 2 x 2 windows: every region of a shifted window."""
    H = W = 2 * win
    return H, W, 2 * (H // win) * (W // win)


# ---- (a) kernel 4 ----------------------------------------------------------

@pytest.mark.parametrize("win", WIDE)
@pytest.mark.parametrize("shift_half", [False, True])
@pytest.mark.parametrize("D,nH", [(8, 2), (32, 1)])
def test_window_attention_reference_matches_jax(jx, win, shift_half, D, nH):
    H, W, Bw = _geometry(win)
    N, shift = win * win, win // 2 if shift_half else 0
    inp = _qkv_inputs(win + D, nH, Bw, N, D)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)
    K.reset_counts()
    got = K.fused_window_attention(*map(_t, inp.values()), **kw)
    assert K.plain_counts()["window_attention"] == 1
    j = {k: jx.jnp.asarray(v) for k, v in inp.items()}
    kernel = jx.wa.fused_window_attention(*j.values(), interpret=True, **kw)
    mask = (jx.jnp.asarray(jx.masks.shift_window_mask(H, W, win, shift))
            if shift else None)
    core = jx.attention._window_attention_jnp(
        *(j[k].transpose(1, 0, 2, 3) for k in ("q", "k", "v")), j["bias"],
        mask, scale=D ** -0.5)
    core = np.asarray(core).reshape(Bw, N, nH, D).transpose(2, 0, 1, 3)
    _close(got, kernel, core, what="window_attention")


# ---- (b) kernel 5 ----------------------------------------------------------

BLOCK_CASES = [(16, 1, True, True), (16, 2, False, False),
               (32, 2, True, False), (32, 1, False, True)]


@pytest.mark.parametrize("win", WIDE)
@pytest.mark.parametrize("shift_half", [False, True])
@pytest.mark.parametrize("C,nH,has_ln,with_mod", BLOCK_CASES)
def test_attention_block_reference_matches_jax(jx, win, shift_half, C, nH,
                                               has_ln, with_mod):
    H, W, Bw = _geometry(win)
    N, shift = win * win, win // 2 if shift_half else 0
    inp = _block_inputs(win + C, Bw, N, C, nH, with_mod)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=has_ln)
    K.reset_counts()
    got = K.fused_attention_block(*map(_t, inp.values()), **kw)
    assert K.plain_counts()["attention_block"] == 1
    j = {k: None if v is None else jx.jnp.asarray(v) for k, v in inp.items()}
    if j["mod"] is None:  # the jnp reference adds a modulator always
        j["mod"] = jx.jnp.zeros((N, C), jx.jnp.float32)
    _close(got, jx.ab.attention_block_reference(*j.values(), **kw),
           what="attention_block")


@pytest.mark.parametrize("shift", [0, 6])
def test_attention_block_matches_jax_kernel_at_window12(jx, shift):
    """JAX's Pallas kernel 5 in interpret mode at N = 144 (its windowed
    body, g = max(1, 128 // N) = 1 window a step)."""
    H, W, Bw = _geometry(12)
    inp = _block_inputs(50 + shift, Bw, 144, 16, 2)
    kw = dict(win=12, shift=shift, H=H, W=W, scale=8 ** -0.5, num_heads=2,
              has_ln=True)
    got = K.fused_attention_block(*map(_t, inp.values()), **kw)
    j = [jx.jnp.asarray(v) for v in inp.values()]
    kernel = jx.ab.fused_attention_block(*j, interpret=True, packed=False,
                                         **kw)
    _close(got, kernel, what="attention_block vs interpret kernel")


# ---- (c) kernel 6 ----------------------------------------------------------

@pytest.mark.parametrize("win", WIDE)
@pytest.mark.parametrize("shift_half", [False, True])
@pytest.mark.parametrize("C,nH,has_ln,with_mod", [BLOCK_CASES[0],
                                                  BLOCK_CASES[3]])
def test_attention_block_vjp_matches_jax(jx, win, shift_half, C, nH, has_ln,
                                         with_mod):
    H, W, Bw = _geometry(win)
    N, shift = win * win, win // 2 if shift_half else 0
    inp = _block_inputs(60 + win, Bw, N, C, nH, with_mod)
    g = _mk(61, 1.0)(Bw, N, C)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
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
    want = vjp(jx.jnp.asarray(g))
    for i, name in enumerate(ATTN_GRADS):
        if (name in ("dln_s", "dln_b") and not has_ln) or \
                (name == "dmod" and not with_mod):
            assert got[i] is None, name
            continue
        _close(got[i], want[i], what=name)


# ---- (d) the wide kernels' algorithm ---------------------------------------

def _region(wl, t, H, W, win, s):
    """csrc/attention_wide.cu's region id of token t of window wl."""
    if not s:
        return 0
    nWw = W // win

    def rid(g, size):
        return int(g >= size - win) + int(g >= size - s)

    return 3 * rid((wl // nWw) * win + t // win, H) + \
        rid((wl % nWw) * win + t % win, W)


def chunked_core(q, k, v, bias, *, win, shift, H, W, scale, w_off=0):
    """The core as `wide_core_fwd` runs it, one (window, head, 64-row
    query tile) at a time: query rows past N zero, keys past N at -inf,
    64-key chunks with a running max and sum, the SW-MSA -100 from region
    ids; rows past N never written."""
    nH, Bw, N, D = q.shape
    nW = (H // win) * (W // win)
    R = 64
    T = -(-N // R) * R
    out = torch.zeros_like(q)
    for w in range(Bw):
        wl = (w_off + w) % nW
        rid = torch.tensor([_region(wl, t, H, W, win, shift)
                            for t in range(N)] + [0] * (T - N))
        for h in range(nH):
            qp = torch.zeros(T, D)
            qp[:N] = q[h, w]
            kp, vp = torch.zeros(T, D), torch.zeros(T, D)
            kp[:N], vp[:N] = k[h, w], v[h, w]
            bp = torch.zeros(T, T)
            bp[:N, :N] = bias[h]
            for i0 in range(0, T, R):
                m = torch.full((R,), float("-inf"))
                l, o = torch.zeros(R), torch.zeros(R, D)
                for j0 in range(0, T, R):
                    s = qp[i0:i0 + R] @ kp[j0:j0 + R].T * scale \
                        + bp[i0:i0 + R, j0:j0 + R]
                    s = s - 100.0 * (rid[i0:i0 + R, None]
                                     != rid[None, j0:j0 + R]).float() * \
                        bool(shift)
                    s[:, max(0, N - j0):] = float("-inf")
                    m_new = torch.maximum(m, s.max(1).values)
                    p = torch.exp(s - m_new[:, None])
                    a = torch.exp(m - m_new)
                    l = l * a + p.sum(1)
                    o = o * a[:, None] + p @ vp[j0:j0 + R]
                    m = m_new
                rows = min(R, N - i0)
                if rows > 0:
                    out[h, w, i0:i0 + rows] = (o / l[:, None])[:rows]
    return out


@pytest.mark.parametrize("win,shift,w_off", [(9, 4, 0), (12, 0, 0),
                                             (16, 8, 3), (11, 5, 1)])
def test_chunked_online_softmax_equals_plain(win, shift, w_off):
    H, W = 3 * win, 2 * win
    Bw = (H // win) * (W // win) + 1
    N, D, nH = win * win, 8, 2
    inp = {k: _t(v) for k, v in _qkv_inputs(70 + win, nH, Bw, N, D).items()}
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)
    want = K.window_attention_reference(*inp.values(), **kw) if not w_off \
        else None
    got = chunked_core(*inp.values(), w_off=w_off, **kw)
    if want is None:  # the offset windows: the plain block's mask order
        from uformer_tpu_torch.ops.kernels.window_attention import \
            window_mask
        mask = window_mask(H, W, win, shift, Bw, w_off, "cpu") if shift \
            else torch.zeros(Bw, N, N)
        logits = inp["q"] @ inp["k"].transpose(-1, -2) * kw["scale"] + \
            inp["bias"][:, None] + mask
        want = torch.softmax(logits, -1) @ inp["v"]
    _close(got, want.numpy(), what="chunked core")


# ---- (e) the win-16 Uformer against JAX ------------------------------------

TINY = dict(img_size=64, embed_dim=8, win_size=16,
            depths=(1, 2, 1, 1, 1, 1, 1, 1, 1),
            num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), modulator=True)


@pytest.fixture(scope="module")
def jax_win16(jx):
    """JAX's tiny win-16 Uformer (jnp attention, drop path 0): seeded
    params, a 64² batch, its eval forward, and one train step's loss and
    gradients (lr 1e-3, no mixup)."""
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.losses import charbonnier_loss as jloss

    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(80)
    batch = {"input": rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32),
             "target": rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxUformer(attn_backend="jnp", drop_path_rate=0.0, **TINY)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(model.init, key, jb["input"])
    prng = np.random.default_rng(81)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * prng.standard_normal(a.shape) + (
            jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)

    def loss(p):
        pred = model.apply(p, jb["input"], deterministic=False,
                           rngs={"dropout": key})
        return jloss(pred, jb["target"])

    value, grads = jax.value_and_grad(loss)(params)
    return SimpleNamespace(
        batch=batch, params=state_dict_from_jax(params),
        forward=np.asarray(model.apply(params, jb["input"])),
        loss=float(value), grads=state_dict_from_jax(grads))


def test_win16_uformer_forward_matches_jax(jax_win16):
    model = load_numpy_state_dict(Uformer(drop_path_rate=0.0, **TINY),
                                  jax_win16.params).eval()
    assert [b.win_size for b in model.encoderlayer_0.blocks] == [16]
    assert model.encoderlayer_1.blocks[1].shift_size == 8
    K.reset_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(jax_win16.batch["input"]))
    counts = K.plain_counts()
    # window 16 at 64², 32² and 16², the 4² bottleneck at window 4: the
    # windowed branch (kernel 5); the two 8² stages (C 64 and 128) at
    # window 8 on the image route (kernel 1)
    assert counts["attention_block"] == sum(TINY["depths"]) - 2
    assert counts["attention_image"] == 2 and counts["stage"] == 0
    _close(got, jax_win16.forward, what="forward")


def test_win16_uformer_train_step_matches_jax(jax_win16):
    model = load_numpy_state_dict(Uformer(drop_path_rate=0.0, **TINY),
                                  jax_win16.params)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 1e-3))
    batch = {k: torch.from_numpy(v) for k, v in jax_win16.batch.items()}
    K.reset_counts()
    loss = make_train_step(model)(state, batch,
                                  torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), jax_win16.loss, rtol=1e-5)
    assert K.plain_counts()["attention_block_bwd"] == \
        sum(TINY["depths"]) - 2
    for name, prm in model.named_parameters():
        want = np.asarray(jax_win16.grads[name])
        np.testing.assert_allclose(
            prm.grad.numpy(), want, rtol=0,
            atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


# ---- (f) the limits ---------------------------------------------------------

def test_windows_up_to_16_pass_and_17_raises():
    """Windows 1-17, 24, 32 and 64 pass; what raises is a window the
    image kernels do not take, a geometry that is no window's and a head
    dim outside HEAD_DIMS."""
    for win in list(range(1, 18)) + [24, 32, 64]:
        check_window(win, win // 2, 2 * win, 3 * win)
    for bad in ((0, 0, 8, 8), (17, 0, 34, 33), (17, 17, 34, 34)):
        with pytest.raises(ValueError, match="win >= 1"):
            check_window(*bad)
    with pytest.raises(ValueError):  # kernels 1 and 3 keep window 8
        check_window(16, 0, 32, 32, windows=(8,))
    for D in HEAD_DIMS:  # head dim 64 too, both ways, above window 8
        check_head_dim(D, 1)
    with pytest.raises(ValueError, match="ROADMAP.md, port queue 2 item 9"):
        check_head_dim(128, 1)


def test_win16_model_trains_on_the_kernel_path():
    wide = Uformer(img_size=128, embed_dim=32, depths=(1,) * 9,
                   win_size=16)
    assert blocks_without_backward_kernel(wide) == []
    win32 = Uformer(img_size=128, embed_dim=8, depths=(1,) * 9,
                    win_size=32)
    assert blocks_without_backward_kernel(win32) == []
    over = Uformer(img_size=128, embed_dim=20, depths=(1,) * 9,
                   win_size=32)
    uncovered = blocks_without_backward_kernel(over)
    assert uncovered[0] == "encoderlayer_0.blocks.0"
    assert "other head dims" in \
        over.get_submodule(uncovered[0]).backward_gap


# ---- the kernels on the card -----------------------------------------------

DRAWS = 4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _rms(a, b):
    return float((a.float() - b.float()).pow(2).mean().sqrt())


def _check_forward(fused, plain, x32):
    ref = plain(x32, torch.float32)
    assert _err(fused(x32, torch.float32), ref) <= \
        TOL * (1 + float(ref.abs().max()))
    x16 = x32.bfloat16()
    assert _err(fused(x16, torch.bfloat16), ref) <= \
        1.5 * _err(plain(x16, torch.bfloat16), ref) + 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("win", WIDE)
@pytest.mark.parametrize("D,nH", [(8, 2), (32, 1)])
def test_window_attention_kernel_wide(win, D, nH):
    dev = _cuda()
    H = W = 4 * win
    Bw = 2 * 16
    inp = {k: _t(v, dev).bfloat16().float()
           for k, v in _qkv_inputs(90, nH, Bw, win * win, D).items()}
    for shift in (0, win // 2):
        kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)

        def run(fn, kw=kw):
            return lambda q, dt: fn(q.to(dt), inp["k"].to(dt),
                                    inp["v"].to(dt), inp["bias"], **kw)

        K.reset_counts()
        _check_forward(run(K.fused_window_attention),
                       run(K.window_attention_reference), inp["q"])
        assert K.launch_counts()["window_attention"] == 2


def _prm(inp, dev):
    low = ("mod", "wq", "wkv", "wo")
    return {dt: [None if v is None else _t(v, dev, dt if k in low
                                           else torch.float32)
                 for k, v in list(inp.items())[1:]]
            for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.gpu
@pytest.mark.parametrize("win", WIDE)
@pytest.mark.parametrize("C,nH,has_ln,with_mod", BLOCK_CASES[:3])
def test_attention_block_kernels_wide(win, C, nH, has_ln, with_mod):
    """Kernel 5 and kernel 6 at windows 9-16: fp32 within 1e-4 (1 +
    max|ref|); bf16 within 1.5x the plain bf16 version's error + 1e-3
    (gradients: pooled over DRAWS draws, + 1e-3 max(1, max|ref|))."""
    dev = _cuda()
    H = W = 4 * win
    Bw, N = 2 * 16, win * win
    inp = _block_inputs(91, Bw, N, C, nH, with_mod)
    prm = _prm(inp, dev)
    for shift in (0, win // 2):
        kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
                  num_heads=nH, has_ln=has_ln)
        x = _t(inp["x"], dev).bfloat16().float()
        K.reset_counts()
        _check_forward(
            lambda x, dt: K.fused_attention_block(x, *prm[dt], **kw),
            lambda x, dt: K.attention_block_reference(x, *prm[dt], **kw), x)
        assert K.launch_counts()["attention_block"] == 2
        runs = []
        mk = _mk(92 + shift, 1.0)
        for _ in range(DRAWS):
            x, g = (_t(mk(Bw, N, C), dev).bfloat16().float()
                    for _ in range(2))
            runs.append([
                K.fused_attention_block_bwd(x, g, *prm[torch.float32], **kw),
                K.attention_block_vjp_reference(x, g, *prm[torch.float32],
                                                **kw),
                K.attention_block_vjp_reference(
                    x.bfloat16(), g.bfloat16(), *prm[torch.bfloat16], **kw),
                K.fused_attention_block_bwd(
                    x.bfloat16(), g.bfloat16(), *prm[torch.bfloat16], **kw)])
        for i, name in enumerate(ATTN_GRADS):
            if runs[0][1][i] is None:
                assert all(r[0][i] is None and r[3][i] is None for r in runs)
                continue
            for got, ref, _, _ in runs:
                assert _err(got[i], ref[i]) <= \
                    TOL * (1 + float(ref[i].abs().max())), name
            got, ref, low, got16 = (torch.cat([r[j][i].float().reshape(-1)
                                               for r in runs])
                                    for j in range(4))
            floor = 1e-3 * max(1.0, float(ref.abs().max()))
            # a gradient of few entries by its rms error (chip_smoke.py's
            # FEW_ENTRIES rule), the rest by max error
            err = (_rms if runs[0][1][i].numel() <= 64 else _err)
            assert err(got16, ref) <= 1.5 * err(low, ref) + floor, name
