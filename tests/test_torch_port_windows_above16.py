"""Windows above 16 (N = win² = 289, 576, 1024, 4096 tokens) in kernels 4,
5 and 6, and the win-32 Uformer.

On the CPU, with numpy inputs from a seed and fp32 throughout:
  (a) kernel 4's plain version at windows 17, 24 and 32, shift 0 and
      win // 2, against JAX's jnp core, and JAX's Pallas
      `fused_window_attention` (interpret mode) at window 17;
  (b) kernel 5's plain version at the same windows, LN and the modulator
      each way, against JAX's jnp reference, and JAX's Pallas kernel 5
      (interpret mode) at window 17;
  (c) kernel 6's plain VJP against `jax.vjp` of JAX's reference;
  (d) the wide backward's algorithm in plain PyTorch (`csrc/attention_wide.cu`:
      per (window, head, 64-row query tile) the softmax statistics over
      64-key chunks, then dS and dq chunk by chunk; per key chunk dk and
      dv over the query tiles; dS written for one `ds_groups` group of
      windows (or heads) at a time and folded into dbias group after
      group) at one group and at three, and over groups of heads, equal
      to the plain VJP; `ds_groups` itself: every (window, head) once, in
      order, each group's dS within `DS_BUDGET`; `check_int32` names the
      size that passes the kernels' 32-bit indices;
  (e) a tiny Uformer at win_size 32 (embed 8, img_size 128, depths 1 x 9)
      against JAX: one forward, and one plain-path train step's loss and
      gradients.
All within 1e-4 (1 + max|ref|). The tests marked `gpu` hold kernels 4, 5
and 6 at windows 17, 24, 32 and 64 against their plain versions on the
card, and kernel 6's bits on two runs at three dS groups or more (`python
-m pytest -m gpu tests/test_torch_port_windows_above16.py`).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels import attention_wide as AW
from uformer_tpu_torch.ops.kernels.window_attention import window_mask
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step
from uformer_tpu_torch.train.train_step import blocks_without_backward_kernel

torch.set_num_threads(1)
TOL = 1e-4
ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
WIDE = (17, 24, 32)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only (the card's machine
    has no flax)."""
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
    """One image of 2 x 2 windows: every region of a shifted window."""
    H = W = 2 * win
    return H, W, (H // win) * (W // win)


# ---- (a) kernel 4 ----------------------------------------------------------

@pytest.mark.parametrize("win", WIDE)
@pytest.mark.parametrize("shift_half", [False, True])
def test_window_attention_reference_matches_jax(jx, win, shift_half):
    H, W, Bw = _geometry(win)
    N, shift, nH, D = win * win, win // 2 if shift_half else 0, 2, 8
    inp = _qkv_inputs(win + 3 * shift_half, nH, Bw, N, D)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)
    K.reset_counts()
    got = K.fused_window_attention(*map(_t, inp.values()), **kw)
    assert K.plain_counts()["window_attention"] == 1
    j = {k: jx.jnp.asarray(v) for k, v in inp.items()}
    mask = (jx.jnp.asarray(jx.masks.shift_window_mask(H, W, win, shift))
            if shift else None)
    core = jx.attention._window_attention_jnp(
        *(j[k].transpose(1, 0, 2, 3) for k in ("q", "k", "v")), j["bias"],
        mask, scale=D ** -0.5)
    core = np.asarray(core).reshape(Bw, N, nH, D).transpose(2, 0, 1, 3)
    wants = [core]
    if win == 17:  # JAX's Pallas kernel 4, interpret mode
        wants.append(jx.wa.fused_window_attention(*j.values(),
                                                  interpret=True, **kw))
    _close(got, *wants, what="window_attention")


# ---- (b) kernel 5 ----------------------------------------------------------

BLOCK_CASES = [(16, 2, True, True), (32, 1, False, False)]


@pytest.mark.parametrize("win", WIDE)
@pytest.mark.parametrize("shift_half", [False, True])
@pytest.mark.parametrize("C,nH,has_ln,with_mod", BLOCK_CASES)
def test_attention_block_reference_matches_jax(jx, win, shift_half, C, nH,
                                               has_ln, with_mod):
    H, W, Bw = _geometry(win)
    N, shift = win * win, win // 2 if shift_half else 0
    inp = _block_inputs(win + C + shift_half, Bw, N, C, nH, with_mod)
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


@pytest.mark.parametrize("shift", [0, 8])
def test_attention_block_matches_jax_kernel_at_window17(jx, shift):
    """JAX's Pallas kernel 5 in interpret mode at N = 289 (one window a
    step, g = max(1, 128 // N) = 1)."""
    H, W, Bw = _geometry(17)
    inp = _block_inputs(40 + shift, Bw, 289, 16, 2)
    kw = dict(win=17, shift=shift, H=H, W=W, scale=8 ** -0.5, num_heads=2,
              has_ln=True)
    got = K.fused_attention_block(*map(_t, inp.values()), **kw)
    j = [jx.jnp.asarray(v) for v in inp.values()]
    kernel = jx.ab.fused_attention_block(*j, interpret=True, packed=False,
                                         **kw)
    _close(got, kernel, what="attention_block vs interpret kernel")


# ---- (c) kernel 6 ----------------------------------------------------------

@pytest.mark.parametrize("win", WIDE)
@pytest.mark.parametrize("shift_half", [False, True])
def test_attention_block_vjp_matches_jax(jx, win, shift_half):
    H, W, Bw = _geometry(win)
    N, shift = win * win, win // 2 if shift_half else 0
    C, nH, has_ln, with_mod = BLOCK_CASES[0] if shift_half else \
        BLOCK_CASES[1]
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
    want = jx.jax.jit(lambda a, g: jx.jax.vjp(
        lambda *a: jx.ab.attention_block_reference(*a, **kw), *a)[1](g))(
        list(j.values()), jx.jnp.asarray(g))
    for i, name in enumerate(ATTN_GRADS):
        if (name in ("dln_s", "dln_b") and not has_ln) or \
                (name == "dmod" and not with_mod):
            assert got[i] is None, name
            continue
        _close(got[i], want[i], what=name)


# ---- (d) the wide backward's algorithm and its dS groups ------------------

R = 64  # query rows of a tile, keys of a chunk


def _region(wl, t, H, W, win, s):
    """csrc/attention_wide.cu's region id of token t of window wl."""
    if not s:
        return 0
    nWw = W // win

    def rid(g, size):
        return int(g >= size - win) + int(g >= size - s)

    return 3 * rid((wl // nWw) * win + t // win, H) + \
        rid((wl % nWw) * win + t % win, W)


def _logits(qp, kp, bp, rid, i0, j0, N, shift, scale):
    """A 64 x 64 logit tile as the backward's `logits` takes it: q k^T
    times the scale + bias, -100 across regions, -inf at keys past N."""
    s = qp[i0:i0 + R] @ kp[j0:j0 + R].T * scale + bp[i0:i0 + R, j0:j0 + R]
    if shift:
        s = s - 100.0 * (rid[i0:i0 + R, None]
                         != rid[None, j0:j0 + R]).float()
    s[:, max(0, N - j0):] = float("-inf")
    return s


def grouped_core_bwd(q, k, v, bias, dO, *, win, shift, H, W, scale):
    """The backward core as `wide_block_bwd_parts` runs it on the card:
    per `ds_groups` group (its windows placed at w_off = the group's first
    window, its heads at their columns) `wide_core_bwd_q` (statistics,
    then dS and dq per key chunk) and `wide_core_bwd_kv` (dk, dv per key
    chunk over the query tiles, dS read back from the group's scratch),
    then the group's dS summed over its windows into its heads' dbias,
    groups in order. q, k, v, dO (nH, Bw, N, D). Returns dq, dk, dv,
    dbias and the largest scratch in bytes."""
    nH, Bw, N, D = q.shape
    T = -(-N // R) * R
    nW = (H // win) * (W // win)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    dbias = torch.zeros(nH, N, N)
    most = 0
    for w0, n, h0, nh in AW.ds_groups(Bw, nH, N):
        ds = torch.zeros(n, nh, N, N)  # the group's scratch
        most = max(most, ds.numel() * 4)
        for wi in range(n):
            w = w0 + wi
            wl = (w0 + wi) % nW  # the kernel's (w_off + w) mod nW
            rid = torch.tensor([_region(wl, t, H, W, win, shift)
                                for t in range(N)] + [0] * (T - N))
            for hi in range(nh):
                h = h0 + hi
                qp, kp, vp, gp = (torch.zeros(T, D) for _ in range(4))
                qp[:N], kp[:N], vp[:N], gp[:N] = q[h, w], k[h, w], v[h, w], \
                    dO[h, w]
                bp = torch.zeros(T, T)
                bp[:N, :N] = bias[h]
                m, l = torch.empty(T), torch.empty(T)
                for i0 in range(0, T, R):  # wide_core_bwd_q
                    mi = torch.full((R,), float("-inf"))
                    li, o = torch.zeros(R), torch.zeros(R, D)
                    for j0 in range(0, T, R):
                        s = _logits(qp, kp, bp, rid, i0, j0, N, shift, scale)
                        m_new = torch.maximum(mi, s.max(1).values)
                        p = torch.exp(s - m_new[:, None])
                        a = torch.exp(mi - m_new)
                        li = li * a + p.sum(1)
                        o = o * a[:, None] + p @ vp[j0:j0 + R]
                        mi = m_new
                    m[i0:i0 + R], l[i0:i0 + R] = mi, li
                    o = o / li[:, None]
                    Dr = (o * gp[i0:i0 + R]).sum(1)
                    acc = torch.zeros(R, D)
                    for j0 in range(0, T, R):
                        s = _logits(qp, kp, bp, rid, i0, j0, N, shift, scale)
                        p = torch.exp(s - mi[:, None]) / li[:, None]
                        dp = gp[i0:i0 + R] @ vp[j0:j0 + R].T
                        dsb = p * (dp - Dr[:, None])
                        dsb[max(0, N - i0):] = 0.0
                        dsb[:, max(0, N - j0):] = 0.0
                        rows, cols = min(R, N - i0), min(R, N - j0)
                        ds[wi, hi, i0:i0 + rows, j0:j0 + cols] = \
                            dsb[:rows, :cols]
                        acc = acc + dsb @ kp[j0:j0 + R]
                    rows = min(R, N - i0)
                    dq[h, w, i0:i0 + rows] = (acc * scale)[:rows]
                for j0 in range(0, T, R):  # wide_core_bwd_kv
                    ak, av = torch.zeros(R, D), torch.zeros(R, D)
                    for i0 in range(0, T, R):
                        s = _logits(qp, kp, bp, rid, i0, j0, N, shift, scale)
                        live = torch.zeros(R, R, dtype=torch.bool)
                        live[:max(0, N - i0), :max(0, N - j0)] = True
                        p = torch.where(live, torch.exp(
                            s - m[i0:i0 + R, None]) / l[i0:i0 + R, None],
                            torch.zeros(()))
                        av = av + p.T @ gp[i0:i0 + R]
                        dsb = torch.zeros(R, R)
                        rows, cols = min(R, N - i0), min(R, N - j0)
                        dsb[:rows, :cols] = ds[wi, hi, i0:i0 + rows,
                                               j0:j0 + cols]
                        ak = ak + dsb.T @ qp[i0:i0 + R]
                    cols = min(R, N - j0)
                    dk[h, w, j0:j0 + cols] = (ak * scale)[:cols]
                    dv[h, w, j0:j0 + cols] = av[:cols]
        dbias[h0:h0 + nh] += ds.sum(0)  # colsum, then the fold in order
    return dq, dk, dv, dbias, most


@pytest.mark.parametrize("win,shift,budget,groups", [
    (17, 8, None, 1),            # one group: the whole batch at once
    (17, 0, 2 * 2 * 289 ** 2 * 4, 3),  # 6 windows in groups of 2
    (24, 12, 576 ** 2 * 4, 12),  # one head of one window a group
])
def test_grouped_wide_backward_equals_plain_vjp(monkeypatch, win, shift,
                                                budget, groups):
    if budget is not None:
        monkeypatch.setattr(AW, "DS_BUDGET", budget)
    H, W = 2 * win, 3 * win
    nH, Bw, N, D = 2, 6, win * win, 8
    assert len(AW.ds_groups(Bw, nH, N)) == groups
    mk = _mk(90 + win, 0.5)
    q, k, v, dO = (_t(mk(nH, Bw, N, D)) for _ in range(4))
    bias = _t(mk(nH, N, N))
    scale = D ** -0.5
    dq, dk, dv, dbias, most = grouped_core_bwd(
        q, k, v, bias, dO, win=win, shift=shift, H=H, W=W, scale=scale)
    assert most <= (budget or AW.DS_BUDGET)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    mask = window_mask(H, W, win, shift, Bw, 0, "cpu") if shift \
        else torch.zeros(Bw, N, N)
    logits = (leaves[0] * scale) @ leaves[1].transpose(-1, -2) \
        + leaves[3][:, None] + mask
    out = torch.softmax(logits, -1) @ leaves[2]
    want = torch.autograd.grad(out, leaves, dO)
    for name, got, ref in zip(("dq", "dk", "dv", "dbias"),
                              (dq, dk, dv, dbias), want):
        _close(got, ref.numpy(), what=name)


@pytest.mark.parametrize("Bw,nH,N,budget,first", [
    (128, 2, 1024, None, (0, 32, 0, 2)),     # train win32's dec3: 4 groups
    (512, 1, 1024, None, (0, 64, 0, 1)),     # serve win32's enc0 shape
    (64, 1, 256, None, (0, 64, 0, 1)),       # win 16: one group
    (3, 16, 4096, None, (0, 1, 0, 4)),       # window 64, 16 heads
    (5, 2, 289, 289 ** 2 * 4, (0, 1, 0, 1)),  # a budget of one head
])
def test_ds_groups_cover_every_window_and_head_once(monkeypatch, Bw, nH, N,
                                                    budget, first):
    if budget is not None:
        monkeypatch.setattr(AW, "DS_BUDGET", budget)
    groups = AW.ds_groups(Bw, nH, N)
    assert groups[0] == first
    seen = [(w0 + i, h0 + j) for w0, n, h0, nh in groups
            for i in range(n) for j in range(nh)]
    # every (window, head) once, windows in order (the fold's order)
    assert sorted(seen) == [(w, h) for w in range(Bw) for h in range(nH)]
    assert [w for w, _ in seen] == sorted(w for w, _ in seen)
    for w0, n, h0, nh in groups:
        assert n * nh * N * N * 4 <= max(AW.DS_BUDGET, N * N * 4)
        assert n * nh <= first[1] * first[3]  # the first is the largest


def test_check_int32_names_the_size():
    AW.check_int32(tokens=2 ** 31 - 1, blocks=1)
    with pytest.raises(ValueError, match="blocks = 2147483648"):
        AW.check_int32(tokens=5, blocks=2 ** 31)


# ---- (e) the win-32 Uformer against JAX ------------------------------------

TINY = dict(img_size=128, embed_dim=8, win_size=32, depths=(1,) * 9,
            num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), modulator=True)


@pytest.fixture(scope="module")
def jax_win32(jx):
    """JAX's tiny win-32 Uformer (jnp attention, drop path 0): seeded
    params, a 128² image, its eval forward, and one train step's loss and
    gradients."""
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.losses import charbonnier_loss as jloss

    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(82)
    batch = {"input": rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32),
             "target": rng.uniform(0, 1, (1, 128, 128, 3)).astype(
                 np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxUformer(attn_backend="jnp", drop_path_rate=0.0, **TINY)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(model.init, key, jb["input"])
    prng = np.random.default_rng(83)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * prng.standard_normal(a.shape) + (
            jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)

    def loss(p):
        pred = model.apply(p, jb["input"], deterministic=False,
                           rngs={"dropout": key})
        return jloss(pred, jb["target"])

    # jitted: eager JAX takes minutes on 1024-token windows
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return SimpleNamespace(
        batch=batch, params=state_dict_from_jax(params),
        forward=np.asarray(jax.jit(model.apply)(params, jb["input"])),
        loss=float(value), grads=state_dict_from_jax(grads))


# windows 32 at 128², 64² and 32² (one window, unshifted) and in the
# decoder, 16 at enc3 and dec0 (16²): kernel 5; the 8² bottleneck (C 128)
# at window 8 on the image route: kernel 1
WIN32_ROUTE = {"attention_block": 8, "attention_image": 1, "stage": 0}


def test_win32_uformer_forward_matches_jax(jax_win32):
    model = load_numpy_state_dict(Uformer(drop_path_rate=0.0, **TINY),
                                  jax_win32.params).eval()
    assert blocks_without_backward_kernel(model) == []
    assert [model.get_submodule(f"{name}.blocks.0").win_size for name in (
        "encoderlayer_0", "encoderlayer_2", "encoderlayer_3", "conv",
        "decoderlayer_0", "decoderlayer_3")] == [32, 32, 16, 8, 16, 32]
    K.reset_counts()
    with torch.no_grad():
        got = model(torch.from_numpy(jax_win32.batch["input"]))
    counts = K.plain_counts()
    assert {k: counts[k] for k in WIN32_ROUTE} == WIN32_ROUTE
    _close(got, jax_win32.forward, what="forward")


def test_win32_uformer_train_step_matches_jax(jax_win32):
    model = load_numpy_state_dict(Uformer(drop_path_rate=0.0, **TINY),
                                  jax_win32.params)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: 1e-3))
    batch = {k: torch.from_numpy(v) for k, v in jax_win32.batch.items()}
    K.reset_counts()
    loss = make_train_step(model)(state, batch,
                                  torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), jax_win32.loss, rtol=1e-5)
    assert K.plain_counts()["attention_block_bwd"] == 8
    for name, prm in model.named_parameters():
        want = np.asarray(jax_win32.grads[name])
        np.testing.assert_allclose(
            prm.grad.numpy(), want, rtol=0,
            atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


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


def _card_geometry(win):
    """Windows of a 2 x 2 image (four windows at 64: 128²)."""
    return 2 * win, 2 * win, 4


@pytest.mark.gpu
@pytest.mark.parametrize("win", WIDE + (64,))
@pytest.mark.parametrize("D,nH", [(8, 2), (32, 1), (64, 1)])
def test_window_attention_kernel_above16(win, D, nH):
    dev = _cuda()
    H, W, Bw = _card_geometry(win)
    inp = {k: _t(v, dev).bfloat16().float()
           for k, v in _qkv_inputs(93, nH, Bw, win * win, D).items()}
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
@pytest.mark.parametrize("win", WIDE + (64,))
@pytest.mark.parametrize("C,nH,has_ln,with_mod", BLOCK_CASES
                         + [(64, 1, True, False)])
def test_attention_block_kernels_above16(monkeypatch, win, C, nH, has_ln,
                                         with_mod):
    """Kernel 5 and kernel 6 at windows 17-64: fp32 within 1e-4 (1 +
    max|ref|); bf16 within 1.5x the plain bf16 version's error + 1e-3
    (gradients: pooled over DRAWS draws, + 1e-3 max(1, max|ref|));
    kernel 6 with DS_BUDGET lowered to give three dS groups or more
    equal bit for bit to one group."""
    dev = _cuda()
    H, W, Bw = _card_geometry(win)
    N = win * win
    inp = _block_inputs(94, Bw, N, C, nH, with_mod)
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
        mk = _mk(95 + shift, 1.0)
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
            err = (_rms if runs[0][1][i].numel() <= 64 else _err)
            assert err(got16, ref) <= 1.5 * err(low, ref) + floor, name
        # with the budget lowered to one head of one window: the same
        # bits twice, and those of one group but in dbias, whose fold
        # order alone moves
        one = AW.ds_groups(Bw, nH, N)
        monkeypatch.setattr(AW, "DS_BUDGET", N * N * 4)
        assert len(AW.ds_groups(Bw, nH, N)) >= 3 > len(one)
        x16, g16 = x.bfloat16(), g.bfloat16()
        a, b = (K.fused_attention_block_bwd(x16, g16, *prm[torch.bfloat16],
                                            **kw) for _ in range(2))
        monkeypatch.undo()
        for i, name in enumerate(ATTN_GRADS):
            if a[i] is None:
                continue
            assert torch.equal(a[i], b[i]), name
            if name != "dbias":
                assert torch.equal(a[i], runs[-1][3][i]), name
            else:
                assert _err(a[i], runs[-1][3][i]) <= \
                    TOL * (1 + float(a[i].abs().max())), name
