"""The bf16 backward core of kernel 6 above window 8 on the tensor cores
(`csrc/wide_core_bwd_mma.cuh`).

The core takes JAX's rounding points (`uformer_tpu/ops/pallas/
attention_block.py:652-712`): dO = g Wo^T rounded to bf16, the logits
q k^T scaled in fp32, P normalised from the forward pass's row statistics
and rounded for dv, dS = P (dP - rowsum(dO O)) in fp32 for dbias, and
dS scale rounded once for dq and dk; O comes from the forward's core
(P rounded unnormalised, `test_torch_port_wide_core_mma.py`), and each
block of G windows sums their dS before it leaves for dbias. On the CPU:
  - an emulation of those rounding points in torch (`emulated_block_bwd`:
    bf16 operands, fp32 products, the forward's 64-key chunked online
    softmax for O and the statistics, dbias in G-window partials), with
    exact arithmetic, equals the plain fp32 VJP within 1e-4 (1 +
    max|ref|), and with its roundings stays within `chip_smoke.py`'s bf16
    gate (`pooled_grad_bound`: 1.5x the plain bf16 VJP's max error, rms
    at 64 entries or fewer, + 1e-3 max(1, max|ref|), against the fp32
    plain result) for dx, dmod, dln, every weight gradient and dbias, at
    windows 9, 16 and 32, shift 0 and win // 2, head dims 8, 24, 32 and
    64 (worst 0.907 of the gate: dx at window 16, shift 0, head dim 8);
  - phase 23's kernel-6 case nearest its gate (window 24, shift 0, C 16,
    two heads of 8, LN, 4 draws pooled) over seeds 19-30: the emulated
    core's dbias within its gate at every seed, worst 0.669 (seed 30);
  - kernel 6's plain VJP at window 12, head dim 24 (C 48, two heads),
    shift 0 and 6, against JAX's Pallas kernel 6 in interpret mode and
    `jax.vjp`;
  - the host rules: `bwd_core_windows` (the windows a block of the dq and
    dk | dv passes) and `ds_groups` at G windows a block (every (window,
    head) once, in order, groups a multiple of G windows, each group's
    G-summed dS within `DS_BUDGET`).
The tests marked `gpu` hold kernel 6 on the card against its plain VJP at
the same shapes (fp32 within 1e-4 on the CUDA-core body, bf16 within the
gate on the tensor-core body, each call counted by body in
`K.core_counts()`), at grids that keep two windows a block with a dead
window in the last block, at N no multiple of 64, with `DS_BUDGET`
lowered to one head of one window, and for equal bits on two runs:
`python -m pytest -m gpu tests/test_torch_port_wide_core_bwd_mma.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels import attention_wide as AW
from uformer_tpu_torch.ops.kernels.window_attention import window_mask

torch.set_num_threads(1)
TOL = 1e-4
BF = torch.bfloat16
CHUNK = 64  # keys of a chunk of the forward's core
WINDOWS = (9, 16, 32)
HEADS = (8, 24, 32, 64)
G_BLOCK = 2  # windows a block whose dS the emulation sums first
ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
FEW_ENTRIES = 64  # chip_smoke.py's: such a gradient is held by its rms
DRAWS = 4  # phase 23's draws pooled a case (chip_smoke.GEOM_DRAWS)


def rnd(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, as fp32."""
    return t.to(BF).float()


class Draws:
    """Operands by the golden weights' rule, in order from one numpy
    generator (`chip_smoke.py:GoldenDraws`): matrices N(0, 1 / fan-in),
    LayerNorm scales 1 + N(0, 0.05²), biases N(0, 0.02²), inputs N(0, 1)
    rounded to bf16-representable fp32."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def mat(self, *shape, fan_in):
        return (self.rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def vec(self, n, mean, std):
        return (mean + std * self.rng.standard_normal(n)).astype(np.float32)

    def xin(self, *shape):
        return rnd(torch.from_numpy(self.mat(*shape, fan_in=1)))

    def block(self, C, nH, N, with_mod):
        """{dtype: the block's operands}, as the kernels take them."""
        inp = dict(mod=self.mat(N, C, fan_in=C) if with_mod else None,
                   ln_s=self.vec(C, 1.0, 0.05), ln_b=self.vec(C, 0.0, 0.02),
                   wq=self.mat(C, C, fan_in=C), bq=self.vec(C, 0.0, 0.02),
                   wkv=self.mat(C, 2 * C, fan_in=C),
                   bkv=self.vec(2 * C, 0.0, 0.02),
                   wo=self.mat(C, C, fan_in=C), bo=self.vec(C, 0.0, 0.02),
                   bias=self.mat(nH, N, N, fan_in=nH))
        low = ("mod", "wq", "wkv", "wo")
        return {dt: {k: None if v is None else torch.from_numpy(v).to(
            dt if k in low else torch.float32) for k, v in inp.items()}
            for dt in (torch.float32, BF)}


def _mask(H, W, win, shift, Bw):
    """(Bw, N, N) SW-MSA mask of Bw windows, or None."""
    if not shift:
        return None
    m = window_mask(H, W, win, shift, Bw, 0, "cpu").float()
    return m.repeat(Bw // m.shape[0], 1, 1) if m.shape[0] != Bw else m


def emulated_core_bwd(q, k, v, dO, bias, mask, *, scale, G, exact=False):
    """The core's arithmetic on (Bw, nH, N, D) q, k, v, dO of bf16 values
    (fp32 tensors), bias (nH, N, N), mask (Bw, N, N) or None: the fp32
    logits scaled; the forward's pass over 64-key chunks (running max m
    and sum l in fp32, exp(s - m) rounded before O += P v) for O (rounded
    once) and the statistics; D = rowsum(dO O) from the fp32 O; then P =
    exp(s - m) / l, dP = dO v^T, dS = P (dP - D) in fp32, dq = r(dS scale)
    k, dk = r(dS scale)^T q, dv = r(P)^T dO, each rounded once; dbias the
    sum over blocks of G windows of each block's dS summed in window
    order. exact: no rounding. Returns O, dq, dk, dv, dbias."""
    r = (lambda t: t) if exact else rnd
    Bw, nH, N, D = q.shape
    s = (q @ k.transpose(-1, -2)) * scale + bias[None]
    if mask is not None:
        s = s + mask[:, None]
    m = torch.full(q.shape[:-1], -float("inf"))
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros_like(q)
    for j0 in range(0, N, CHUNK):
        sc = s[..., j0:j0 + CHUNK]
        m_new = torch.maximum(m, sc.amax(-1))
        a = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * a + p.sum(-1)
        o = o * a[..., None] + r(p) @ v[..., j0:j0 + CHUNK, :]
        m = m_new
    o = o * (1.0 / l)[..., None]
    di = (dO * o).sum(-1)
    P = torch.exp(s - m[..., None]) / l[..., None]
    dS = P * (dO @ v.transpose(-1, -2) - di[..., None])
    dSs = r(dS * scale)
    dq = r(dSs @ k)
    dk = r(dSs.transpose(-1, -2) @ q)
    dv = r(r(P).transpose(-1, -2) @ dO)
    parts = []
    for w0 in range(0, Bw, G):
        part = dS[w0]
        for w in range(w0 + 1, min(Bw, w0 + G)):
            part = part + dS[w]
        parts.append(part)
    dbias = parts[0]
    for part in parts[1:]:
        dbias = dbias + part
    return r(o), dq, dk, dv, dbias


def emulated_block_bwd(x, g, p, *, win, shift, H, W, scale, num_heads,
                       has_ln, G, exact=False):
    """Kernel 6 above window 8 as `csrc/attention_wide.cu` and the bf16
    core round it, the tuple of `attention_block_vjp_reference`: xm =
    [LN](x) rounded (+ mod, rounded), q | k | v = xm W + b rounded once,
    dO = g Wo^T rounded once, the core (`emulated_core_bwd`), dxm =
    dq | dk | dv [Wq | Wkv]^T in fp32, the LayerNorm VJP on it (dx rounded
    once), the weight and bias gradients in fp32."""
    r = (lambda t: t) if exact else rnd
    Bw, N, C = x.shape
    nH, D = num_heads, C // num_heads
    xf = x.float()
    y = xf
    if has_ln:
        mean = xf.mean(-1, keepdim=True)
        rstd = 1.0 / torch.sqrt(((xf - mean) ** 2).mean(-1, keepdim=True)
                                + 1e-5)
        xhat = (xf - mean) * rstd
        y = r(xhat * p["ln_s"] + p["ln_b"])
    if p["mod"] is not None:
        y = y + p["mod"].float()
    xm = r(y)
    wq, wkv, wo = p["wq"].float(), p["wkv"].float(), p["wo"].float()
    q = r(xm @ wq + p["bq"])
    kv = r(xm @ wkv + p["bkv"])
    gf = g.float()
    dO = r(gf @ wo.T)

    def heads(t):
        return t.reshape(Bw, N, nH, D).transpose(1, 2)

    def tokens(t):
        return t.transpose(1, 2).reshape(Bw * N, C)

    o, dq, dk, dv, dbias = emulated_core_bwd(
        heads(q), heads(kv[..., :C]), heads(kv[..., C:]), heads(dO),
        p["bias"], _mask(H, W, win, shift, Bw), scale=scale, G=G,
        exact=exact)
    dq, dk, dv, o = tokens(dq), tokens(dk), tokens(dv), tokens(o)
    dkv = torch.cat([dk, dv], -1)
    dxm = (torch.cat([dq, dkv], -1) @ torch.cat([wq, wkv], -1).T).reshape(
        Bw, N, C)
    dln_s = dln_b = None
    if has_ln:
        dxh = dxm * p["ln_s"]
        dx = rstd * (dxh - dxh.mean(-1, keepdim=True)
                     - xhat * (dxh * xhat).mean(-1, keepdim=True))
        dln_s = (dxm * xhat).sum((0, 1))
        dln_b = dxm.sum((0, 1))
    else:
        dx = dxm
    dmod = dxm.sum(0) if p["mod"] is not None else None
    xt, gt = xm.reshape(-1, C), gf.reshape(-1, C)
    return (r(dx), dmod, dln_s, dln_b, xt.T @ dq, dq.sum(0), xt.T @ dkv,
            dkv.sum(0), o.T @ gt, gt.sum(0), dbias)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _rms(a, b):
    return float((a.float() - b.float()).pow(2).mean().sqrt())


def pooled_ratios(runs):
    """`chip_smoke.py:pooled_grad_bound`'s bf16 gate over runs = [(got,
    ref, low)] of gradient tuples: per gradient, pooled over the runs,
    the error against ref over 1.5x the plain bf16 VJP's (low) + 1e-3
    max(1, max|ref|); rms where a run's gradient has FEW_ENTRIES or
    fewer."""
    out = {}
    for i, name in enumerate(ATTN_GRADS):
        if runs[0][1][i] is None:
            assert all(run[0][i] is None for run in runs), name
            continue
        got, ref, low = (torch.cat([run[j][i].float().reshape(-1)
                                    for run in runs]) for j in range(3))
        err = _rms if runs[0][1][i].numel() <= FEW_ENTRIES else _err
        out[name] = err(got, ref) / (
            1.5 * err(low, ref) + 1e-3 * max(1.0, float(ref.abs().max())))
    return out


def _geometry(win):
    """One image of 2 x 2 windows at window 32, two at 9 and 16: every
    region of a shifted window."""
    images = 1 if win >= 32 else 2
    return 2 * win, 2 * win, 4 * images


def _case(win, shift, D):
    nH = 2 if D < 32 else 1
    C = D * nH
    H, W, Bw = _geometry(win)
    N = win * win
    d = Draws(4000 + win + D)
    has_ln = D != 32  # LN on at three head dims, off at one
    prm = d.block(C, nH, N, with_mod=True)
    x, g = d.xin(Bw, N, C), d.xin(Bw, N, C)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5,
              num_heads=nH, has_ln=has_ln)
    return x, g, prm, kw


# ---- the emulation on the CPU -----------------------------------------------

@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("shift_half", [False, True])
@pytest.mark.parametrize("D", HEADS)
def test_emulated_block_bwd(win, shift_half, D):
    """Exact, the emulation equals the plain fp32 VJP; rounded, every
    gradient stays within the bf16 gate."""
    x, g, prm, kw = _case(win, win // 2 if shift_half else 0, D)
    ref = K.attention_block_vjp_reference(x, g, *prm[torch.float32].values(),
                                          **kw)
    exact = emulated_block_bwd(x, g, prm[torch.float32], G=G_BLOCK,
                               exact=True, **kw)
    for name, got, want in zip(ATTN_GRADS, exact, ref):
        if want is None:
            assert got is None, name
            continue
        assert _err(got, want) <= TOL * (1 + float(want.abs().max())), name
    low = K.attention_block_vjp_reference(x.to(BF), g.to(BF),
                                          *prm[BF].values(), **kw)
    got = emulated_block_bwd(x, g, prm[BF], G=G_BLOCK, **kw)
    ratios = pooled_ratios([(got, ref, low)])
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("seed", range(19, 31))
def test_emulated_window24_c16_dbias_seed_scan(seed):
    """Phase 23's kernel-6 case at window 24, shift 0, C 16 (two heads of
    8), LN, no modulator, two images of 2 x 2 windows, DRAWS draws
    pooled: the emulated core's dbias within its gate at every seed
    (worst 0.669 of it, seed 30; the worst of any gradient there 0.669
    too, dbias at seed 30)."""
    d = Draws(seed)
    prm = d.block(16, 2, 576, with_mod=False)
    kw = dict(win=24, shift=0, H=48, W=48, scale=8 ** -0.5, num_heads=2,
              has_ln=True)
    runs = []
    for _ in range(DRAWS):
        x, g = d.xin(8, 576, 16), d.xin(8, 576, 16)
        runs.append((
            emulated_block_bwd(x, g, prm[BF], G=G_BLOCK, **kw),
            K.attention_block_vjp_reference(
                x, g, *prm[torch.float32].values(), **kw),
            K.attention_block_vjp_reference(x.to(BF), g.to(BF),
                                            *prm[BF].values(), **kw)))
    ratios = pooled_ratios(runs)
    assert ratios["dbias"] <= 1.0, ratios


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.ops.pallas import attention_block

    return SimpleNamespace(jax=jax, jnp=jnp, ab=attention_block)


@pytest.mark.parametrize("shift", [0, 6])
def test_vjp_at_window12_head_dim24_matches_jax(jx, shift):
    """Kernel 6's plain VJP at window 12, C 48 (two heads of 24), LN and
    the modulator, two images of 2 x 2 windows, against JAX's Pallas
    kernel 6 in interpret mode and `jax.vjp` of its reference, fp32,
    within 1e-4 (1 + max|ref|)."""
    win, C, nH = 12, 48, 2
    H, W, Bw = _geometry(win)
    N = win * win
    rng = np.random.default_rng(70 + shift)

    def mk(*s):
        return (0.3 * rng.standard_normal(s)).astype(np.float32)

    inp = dict(x=mk(Bw, N, C), mod=mk(N, C), ln_s=1.0 + mk(C), ln_b=mk(C),
               wq=mk(C, C), bq=mk(C), wkv=mk(C, 2 * C), bkv=mk(2 * C),
               wo=mk(C, C), bo=mk(C), bias=mk(nH, N, N))
    g = (rng.standard_normal((Bw, N, C))).astype(np.float32)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=(C // nH) ** -0.5,
              num_heads=nH, has_ln=True)
    K.reset_counts()
    got = K.fused_attention_block_bwd(
        *(torch.from_numpy(a) for a in (inp["x"], g)),
        *(torch.from_numpy(a) for a in list(inp.values())[1:]), **kw)
    assert K.plain_counts()["attention_block_bwd"] == 1
    # the plain version launches nothing
    assert K.core_counts()["attention_block_bwd"] == {
        "core_mma_launches": 0, "core_fma_launches": 0}
    j = [jx.jnp.asarray(v) for v in inp.values()]
    kern = jx.ab.fused_attention_block_bwd(
        j[0], jx.jnp.asarray(g), *j[1:], has_mod=True, interpret=True,
        packed=False, **kw)
    _, vjp = jx.jax.vjp(
        lambda *a: jx.ab.attention_block_reference(*a, **kw), *j)
    want = vjp(jx.jnp.asarray(g))
    for i, name in enumerate(ATTN_GRADS):
        for ref in (kern[i], want[i]):
            ref = np.asarray(ref, dtype=np.float32)
            np.testing.assert_allclose(got[i].numpy(), ref, rtol=0,
                                       atol=TOL * (1 + np.abs(ref).max()),
                                       err_msg=name)


# ---- the host rules ---------------------------------------------------------

@pytest.mark.parametrize("Bw,nH,N,want", [
    (128, 1, 1024, 2),  # train win32's enc0: 1024 blocks at G 2
    (8, 16, 1024, 2),   # train win32's bottleneck-side stages
    (512, 1, 256, 2),   # train win16's enc0
    (64, 1, 256, 1),    # 128 blocks at G 2: fewer than the SMs
    (8, 2, 1024, 1),    # 64 blocks at G 2: fewer than the SMs
    (1, 4, 4096, 1),    # one window: never more windows than Bw
    (33, 2, 256, 2),    # Bw % G: a dead window in the last block
    (4, 1, 4096, 1),    # window 64: 128 blocks at G 2
])
def test_bwd_core_windows(Bw, nH, N, want):
    """2 windows a block, halved while the grid has fewer blocks than the
    132 SMs, never above Bw."""
    G = AW.bwd_core_windows(Bw, nH, N, 132)
    assert G == want
    assert 1 <= G <= min(Bw, AW.BWD_MAX_G)


@pytest.mark.parametrize("Bw,nH,N,G,budget,first", [
    (128, 1, 1024, 2, None, (0, 128, 0, 1)),  # train win32's enc0: 1 group
    (128, 2, 1024, 2, None, (0, 64, 0, 2)),   # dec3: two groups
    (512, 1, 1024, 2, None, (0, 128, 0, 1)),  # serve win32's enc0 shape
    (3, 16, 4096, 2, None, (0, 1, 0, 4)),     # one window's heads pass it
    (7, 2, 289, 2, 2 * 2 * 289 ** 2 * 4, (0, 4, 0, 2)),  # groups of 4
    (5, 2, 289, 2, 289 ** 2 * 4, (0, 1, 0, 1)),  # a budget of one head
])
def test_ds_groups_at_windows_a_block(monkeypatch, Bw, nH, N, G, budget,
                                      first):
    """Every (window, head) once, windows in order (the fold's order),
    groups of a multiple of G windows but for the last (or of one window
    in groups of heads), each group's G-summed dS within the budget."""
    if budget is not None:
        monkeypatch.setattr(AW, "DS_BUDGET", budget)
    groups = AW.ds_groups(Bw, nH, N, G)
    assert groups[0] == first
    seen = [(w0 + i, h0 + j) for w0, n, h0, nh in groups
            for i in range(n) for j in range(nh)]
    assert sorted(seen) == [(w, h) for w in range(Bw) for h in range(nH)]
    assert [w for w, _ in seen] == sorted(w for w, _ in seen)
    for w0, n, h0, nh in groups[:-1]:
        assert n % G == 0 or n == 1
    for w0, n, h0, nh in groups:
        rows = -(-n // min(G, n))
        assert rows * nh * N * N * 4 <= max(AW.DS_BUDGET, N * N * 4)
    # at G 1, the groups of the CUDA-core core
    assert AW.ds_groups(Bw, nH, N, 1) == AW.ds_groups(Bw, nH, N)


# ---- the kernel on the card -----------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(prm, dev):
    return {dt: {k: None if v is None else v.to(dev) for k, v in p.items()}
            for dt, p in prm.items()}


def _card_gates(x, g, prm, kw, draws=None):
    """Kernel 6 on the card: fp32 within 1e-4 (1 + max|ref|), one CUDA-core
    core launch a call; bf16 within the gate pooled over the draws ((x, g)
    and `draws`), one tensor-core launch a call, and equal bits on a
    second run. Returns the bf16 gradients of (x, g)."""
    runs, out = [], None
    for xx, gg in [(x, g)] + list(draws or []):
        K.reset_counts()
        got32 = K.fused_attention_block_bwd(xx, gg,
                                            *prm[torch.float32].values(),
                                            **kw)
        assert K.core_counts()["attention_block_bwd"] == {
            "core_mma_launches": 0, "core_fma_launches": 1}
        ref = K.attention_block_vjp_reference(
            xx, gg, *prm[torch.float32].values(), **kw)
        for name, a, b in zip(ATTN_GRADS, got32, ref):
            if b is not None:
                assert _err(a, b) <= TOL * (1 + float(b.abs().max())), name
        K.reset_counts()
        got16 = K.fused_attention_block_bwd(xx.to(BF), gg.to(BF),
                                            *prm[BF].values(), **kw)
        torch.cuda.synchronize()
        assert K.core_counts()["attention_block_bwd"] == {
            "core_mma_launches": 1, "core_fma_launches": 0}
        low = K.attention_block_vjp_reference(xx.to(BF), gg.to(BF),
                                              *prm[BF].values(), **kw)
        runs.append((got16, ref, low))
        if out is None:
            out = got16
    ratios = pooled_ratios(runs)
    assert max(ratios.values()) <= 1.0, ratios
    again = K.fused_attention_block_bwd(x.to(BF), g.to(BF),
                                        *prm[BF].values(), **kw)
    for name, a, b in zip(ATTN_GRADS, out, again):
        if a is not None:
            assert torch.equal(a, b), name
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("D", HEADS)
def test_kernel6_wide_core_on_card(win, D):
    dev = _cuda()
    for shift in (0, win // 2):
        x, g, prm, kw = _case(win, shift, D)
        _card_gates(x.to(dev), g.to(dev), _on(prm, dev), kw)


# (win, heads, head dim, windows down, windows across): one image whose
# backward grid keeps 2 windows a block (`bwd_core_windows`) with a window
# count no multiple of 2, so the last block holds a dead window
# (zero-filled, never written, never summed); N 81, 144 and 289 are no
# multiple of 64
MULTI_WINDOW = [(9, 2, 24, 5, 13), (12, 2, 40, 3, 15), (16, 2, 32, 3, 11),
                (17, 2, 56, 3, 9), (32, 1, 64, 1, 17)]


@pytest.mark.gpu
@pytest.mark.parametrize("win,nH,D,rows,cols", MULTI_WINDOW)
def test_kernel6_two_windows_a_block_on_card(win, nH, D, rows, cols):
    """Kernel 6 at two windows a block with a dead window in the last
    block, shift 0 and win // 2, LN and the modulator, against its plain
    VJP under the card gates."""
    dev = _cuda()
    H, W, Bw, N, C = rows * win, cols * win, rows * cols, win * win, nH * D
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert AW.bwd_core_windows(Bw, nH, N, sms) == 2 and Bw % 2
    d = Draws(5000 + win + D)
    prm = _on(d.block(C, nH, N, with_mod=True), dev)
    for shift in (0, win // 2):
        kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5,
                  num_heads=nH, has_ln=True)
        _card_gates(d.xin(Bw, N, C).to(dev), d.xin(Bw, N, C).to(dev), prm,
                    kw)


@pytest.mark.gpu
@pytest.mark.parametrize("win,D", [(9, 8), (24, 8), (32, 32)])
def test_kernel6_groups_of_one_head_on_card(monkeypatch, win, D):
    """DS_BUDGET lowered to one head of one window: three dS groups or
    more, equal bits on two runs, and every gradient but dbias (whose
    fold order alone moves) in the bits of the run at the module's
    budget; dbias within 1e-4 (1 + max|ref|) of it."""
    dev = _cuda()
    x, g, prm, kw = _case(win, win // 2, D)
    prm = _on(prm, dev)
    x16, g16 = x.to(dev, BF), g.to(dev, BF)
    Bw, N, _ = x.shape
    one = K.fused_attention_block_bwd(x16, g16, *prm[BF].values(), **kw)
    monkeypatch.setattr(AW, "DS_BUDGET", N * N * 4)
    assert len(AW.ds_groups(Bw, kw["num_heads"], N)) >= 3
    a, b = (K.fused_attention_block_bwd(x16, g16, *prm[BF].values(), **kw)
            for _ in range(2))
    monkeypatch.undo()
    for name, u, v, w in zip(ATTN_GRADS, a, b, one):
        if u is None:
            continue
        assert torch.equal(u, v), name
        if name != "dbias":
            assert torch.equal(u, w), name
        else:
            assert _err(u, w) <= TOL * (1 + float(w.abs().max())), name


@pytest.mark.gpu
def test_kernel6_window24_c16_on_card():
    """Phase 23's case (window 24, shift 0, C 16, two heads of 8, LN),
    seeds 19-30 as on the CPU: the kernel's gradients within the gate
    pooled over DRAWS draws."""
    dev = _cuda()
    kw = dict(win=24, shift=0, H=48, W=48, scale=8 ** -0.5, num_heads=2,
              has_ln=True)
    for seed in range(19, 31):
        d = Draws(seed)
        prm = _on(d.block(16, 2, 576, with_mod=False), dev)
        xs = [(d.xin(8, 576, 16).to(dev), d.xin(8, 576, 16).to(dev))
              for _ in range(DRAWS)]
        _card_gates(*xs[0], prm, kw, draws=xs[1:])
