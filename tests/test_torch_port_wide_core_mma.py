"""The bf16 wide-window core on the tensor cores (`csrc/wide_core_mma.cuh`):
kernels 4 and 5 above window 8.

The core rounds P where an online softmax can: exp(s - m_run) rounded to
bf16 before O += P v, O divided by the row sum once at the end. The plain
versions (and JAX) round the normalised probabilities. On the CPU:
  - an emulation of the core's rounding points, written here in torch
    (`emulated_core`: fp32 products of bf16 operands, the logits and the
    softmax in fp32 over 64-key chunks, P rounded unnormalised, O rounded
    once), with exact arithmetic, equals the plain fp32 version within
    1e-4 (1 + max|ref|) — the chunking, running max and -inf pad keys —
    and with its roundings stays within the gate `chip_smoke.py`'s
    `compare` applies (1.5x the plain bf16 version's max error + 1e-3,
    against the fp32 plain result), at windows 9, 16 and 32, shift 0 and
    win // 2, head dims 8, 24, 32 and 64, in kernel 4's form (the fp32
    logits scaled) and kernel 5's (q rounded times the rounded scale,
    inside the block's LN1 / modulator / projections as
    `csrc/attention_wide.cu` rounds them), the block at w_off 3;
  - the window-9, C 16, LN and modulator kernel-5 case (the check nearest
    its gate on the card, 0.978 with the CUDA-core core) over seeds 19-30
    at shift 0 and 4: the emulated core's worst is 0.891 of its gate
    (seed 27, shift 0), JAX's rounding points' 0.922;
  - kernel 4's plain version at head dims 24 and 48, windows 9 and 12,
    shifted and not, against JAX's Pallas `fused_window_attention` in
    interpret mode; kernel 4's head-dim check follows the window
    (`window_attention_head_dims`); `attention_wide.core_windows`, the
    windows a block of the bf16 core.
The tests marked `gpu` hold kernels 4 and 5 on the card against their
plain versions at the same shapes under those gates, and at grids that
keep 2 and 4 windows a block with dead windows in the last block
(`MULTI_WINDOW`), each bf16 call counting one tensor-core launch
(`core_mma_launches`) and each fp32 call one CUDA-core launch
(`core_fma_launches`) on its wrapper (`K.core_counts`):
`python -m pytest -m gpu tests/test_torch_port_wide_core_mma.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels import attention_wide as AW
from uformer_tpu_torch.ops.kernels.window_attention import (
    HEAD_DIMS,
    WINDOW_ATTENTION_HEAD_DIMS,
    check_head_dim,
    window_attention_head_dims,
    window_mask,
)

torch.set_num_threads(1)
TOL = 1e-4
BF = torch.bfloat16
CHUNK = 64  # keys of a chunk of the core
WINDOWS = (9, 16, 32)
HEADS = (8, 24, 32, 64)
W_OFF = 3
NO_CORE = {"core_mma_launches": 0, "core_fma_launches": 0}


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


def _mask(H, W, win, shift, Bw, w_off):
    """(Bw, N, N) SW-MSA mask of Bw windows from place w_off, or None."""
    if not shift:
        return None
    m = window_mask(H, W, win, shift, Bw, w_off, "cpu").float()
    return m.repeat(Bw // m.shape[0], 1, 1) if m.shape[0] != Bw else m


def emulated_core(q, k, v, bias, mask, *, scale, scale_q, exact=False):
    """The core's arithmetic on (Bw, nH, N, D) q, k, v of bf16 values
    (fp32 tensors), bias (nH, N, N), mask (Bw, N, N) or None: kernel 5's
    q rounded times the rounded scale (scale_q) or kernel 4's fp32 logits
    scaled; 64-key chunks with a running max m and sum l in fp32, P =
    exp(s - m) rounded to bf16 before O = O a + P v (a = exp(m_old -
    m_new)), O times 1 / l rounded once. exact: no rounding (fp32 in,
    fp32 out)."""
    r = (lambda t: t) if exact else rnd
    if scale_q:
        q, ls = r(q * r(torch.tensor(scale)).item()), 1.0
    else:
        ls = scale
    N = q.shape[-2]
    m = torch.full(q.shape[:-1], -float("inf"))
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros_like(q)
    for j0 in range(0, N, CHUNK):
        kc, vc = k[..., j0:j0 + CHUNK, :], v[..., j0:j0 + CHUNK, :]
        s = (q @ kc.transpose(-1, -2)) * ls + bias[None, :, :, j0:j0 + CHUNK]
        if mask is not None:
            s = s + mask[:, None, :, j0:j0 + CHUNK]
        m_new = torch.maximum(m, s.amax(-1))
        a = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * a + p.sum(-1)
        o = o * a[..., None] + r(p) @ vc
        m = m_new
    return r(o * (1.0 / l)[..., None])


def emulated_block(x, p, *, win, shift, H, W, scale, num_heads, has_ln,
                   w_off, exact=False):
    """Kernel 5 above window 8 as `csrc/attention_wide.cu` rounds it:
    wide_xm (LN rounded, + mod rounded), q | k | v = xm W + b rounded
    once (fp32 sums), the core (`emulated_core`), y = o Wo + bo rounded
    once."""
    r = (lambda t: t) if exact else rnd
    Bw, N, C = x.shape
    D = C // num_heads
    y = x.float()
    if has_ln:
        mean = y.mean(-1, keepdim=True)
        var = ((y - mean) ** 2).mean(-1, keepdim=True)
        y = r((y - mean) * (1.0 / torch.sqrt(var + 1e-5)) * p["ln_s"]
              + p["ln_b"])
    if p["mod"] is not None:
        y = y + p["mod"].float()
    xm = r(y)
    q = r(xm @ p["wq"].float() + p["bq"])
    kv = r(xm @ p["wkv"].float() + p["bkv"])

    def heads(t):
        return t.reshape(Bw, N, num_heads, D).transpose(1, 2)

    o = emulated_core(heads(q), heads(kv[..., :C]), heads(kv[..., C:]),
                      p["bias"], _mask(H, W, win, shift, Bw, w_off),
                      scale=scale, scale_q=True, exact=exact)
    o = o.transpose(1, 2).reshape(Bw * N, C)
    return r(o @ p["wo"].float() + p["bo"]).reshape(Bw, N, C)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def gate_ratio(got, plain, x32):
    """The bf16 gate of `chip_smoke.py:compare`: `got` (a bf16 result on
    x32's bf16 copy) against plain(x32, fp32), over 1.5x the plain bf16
    version's error + 1e-3."""
    ref = plain(x32, torch.float32)
    e_plain = _err(plain(x32.to(BF), BF), ref)
    return _err(got, ref) / (1.5 * e_plain + 1e-3)


def _geometry(win):
    """One image of 2 x 2 windows at window 32, two at 9 and 16: every
    region of a shifted window."""
    images = 1 if win >= 32 else 2
    return 2 * win, 2 * win, 4 * images


def _k4_case(win, shift, D):
    nH = 2 if D < 32 else 1
    H, W, Bw = _geometry(win)
    N = win * win
    d = Draws(1000 + win + D)
    k, v = d.xin(nH, Bw, N, D), d.xin(nH, Bw, N, D)
    bias = torch.from_numpy(d.mat(nH, N, N, fan_in=nH))
    x32 = d.xin(nH, Bw, N, D)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)
    return x32, k, v, bias, kw


def _k5_case(win, shift, D):
    nH = 2 if D < 32 else 1
    C = D * nH
    H, W, _ = _geometry(win)
    Bw = 4 * (1 if win >= 32 else 2)
    N = win * win
    d = Draws(2000 + win + D)
    has_ln = D != 32  # LN on at three head dims, off at one
    prm = d.block(C, nH, N, with_mod=True)
    x32 = d.xin(Bw, N, C)
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5,
              num_heads=nH, has_ln=has_ln, w_off=W_OFF)
    return x32, prm, kw


# ---- the emulation on the CPU -----------------------------------------------

@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("shift_half", [False, True])
@pytest.mark.parametrize("D", HEADS)
def test_emulated_kernel4_core(win, shift_half, D):
    """Kernel 4's form: exact, the emulation equals the plain fp32
    version; rounded, it stays within the bf16 gate."""
    x32, k, v, bias, kw = _k4_case(win, win // 2 if shift_half else 0, D)
    nH, Bw, N, _ = x32.shape
    mask = _mask(kw["H"], kw["W"], win, kw["shift"], Bw, 0)

    def emul(q, kk, vv, exact):
        t = [a.transpose(0, 1) for a in (q, kk, vv)]
        return emulated_core(*t, bias, mask, scale=kw["scale"],
                             scale_q=False, exact=exact).transpose(0, 1)

    def plain(x, dt):
        return K.window_attention_reference(x.to(dt), k.to(dt), v.to(dt),
                                            bias, **kw)

    ref = plain(x32, torch.float32)
    assert _err(emul(x32, k, v, True), ref) <= TOL * (1 + float(
        ref.abs().max()))
    assert gate_ratio(emul(x32, k, v, False), plain, x32) <= 1.0


@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("shift_half", [False, True])
@pytest.mark.parametrize("D", HEADS)
def test_emulated_kernel5_core(win, shift_half, D):
    """Kernel 5's form (q rounded times the rounded scale) inside the
    block, at w_off 3: exact, equal to the plain fp32 block; rounded,
    within the bf16 gate."""
    x32, prm, kw = _k5_case(win, win // 2 if shift_half else 0, D)

    def plain(x, dt):
        return K.attention_block_reference(x.to(dt), *prm[dt].values(),
                                           **kw)

    ref = plain(x32, torch.float32)
    exact = emulated_block(x32, prm[torch.float32], exact=True, **kw)
    assert _err(exact, ref) <= TOL * (1 + float(ref.abs().max()))
    got = emulated_block(x32, prm[BF], **kw)
    assert gate_ratio(got, plain, x32) <= 1.0


@pytest.mark.parametrize("seed", range(19, 31))
def test_emulated_window9_c16_seed_scan(seed):
    """Kernel 5 at window 9, C 16 (two heads of 8), LN and modulator, two
    images of 4 x 4 windows, shift 0 and 4: the emulated core within its
    gate at every seed (worst 0.891, seed 27 shift 0)."""
    for shift in (0, 4):
        d = Draws(seed)
        prm = d.block(16, 2, 81, with_mod=True)
        x32 = d.xin(32, 81, 16)
        kw = dict(win=9, shift=shift, H=36, W=36, scale=8 ** -0.5,
                  num_heads=2, has_ln=True, w_off=0)

        def plain(x, dt):
            return K.attention_block_reference(x.to(dt), *prm[dt].values(),
                                               **kw)

        assert gate_ratio(emulated_block(x32, prm[BF], **kw), plain,
                          x32) <= 1.0


# ---- kernel 4 at head dims 24-56 above window 8 ------------------------------

@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported by the CPU tests only: the card's machine
    has no flax, and the `gpu` tests need none of it."""
    import jax.numpy as jnp
    from uformer_tpu.ops.pallas import window_attention

    return SimpleNamespace(jnp=jnp, wa=window_attention)


@pytest.mark.parametrize("win", [9, 12])
@pytest.mark.parametrize("shift_half", [False, True])
@pytest.mark.parametrize("D", [24, 48])
def test_window_attention_new_head_dims_match_jax(jx, win, shift_half, D):
    """Kernel 4's plain version at head dims 24 and 48 above window 8
    against JAX's Pallas kernel in interpret mode, within 1e-4 (1 +
    max|ref|), fp32."""
    H, W, Bw = _geometry(win)
    N, shift = win * win, win // 2 if shift_half else 0
    rng = np.random.default_rng(win + D)
    inp = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
           for k, s in (("q", (1, Bw, N, D)), ("k", (1, Bw, N, D)),
                        ("v", (1, Bw, N, D)), ("bias", (1, N, N)))}
    kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)
    K.reset_counts()
    got = K.fused_window_attention(*map(torch.from_numpy, inp.values()),
                                   **kw)
    assert K.plain_counts()["window_attention"] == 1
    # the plain version launches nothing
    assert K.core_counts()["window_attention"] == NO_CORE
    want = np.asarray(jx.wa.fused_window_attention(
        *map(jx.jnp.asarray, inp.values()), interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * (1 + np.abs(want).max()))


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_window_attention_head_dims_follow_the_window(D):
    """Above window 8 kernel 4 takes every head dim of HEAD_DIMS; at
    windows 1-8 only WINDOW_ATTENTION_HEAD_DIMS (ROADMAP queue 2 item
    9)."""
    assert window_attention_head_dims(81) == HEAD_DIMS
    check_head_dim(D, 1, window_attention_head_dims(81))
    for N in (16, 49, 64):
        assert window_attention_head_dims(N) == WINDOW_ATTENTION_HEAD_DIMS
        if D in WINDOW_ATTENTION_HEAD_DIMS:
            check_head_dim(D, 1, window_attention_head_dims(N))
        else:
            with pytest.raises(ValueError, match="queue 2 item 9"):
                check_head_dim(D, 1, window_attention_head_dims(N))


@pytest.mark.parametrize("Bw,nH,N,D,want", [
    (512, 1, 1024, 32, 2),   # serve win32 stage 0
    (2048, 1, 256, 32, 2),   # serve win16 stage 0
    (512, 1, 256, 64, 4),    # kernel 4 at (1, 512, 256, 64)
    (2048, 1, 256, 64, 4),   # serve e64 win16 stage 0
    (512, 2, 256, 56, 4),
    (512, 2, 256, 48, 2),
    (8, 16, 256, 32, 2),     # the win-16 model's 16^2 stage: 256 blocks
    (8, 4, 256, 64, 1),      # 32 blocks at G 4, 64 at 2: fewer than SMs
    (2, 1, 1024, 64, 1),     # 32 blocks at G 1: fewer than the SMs
    (1, 4, 4096, 64, 1),     # one window: never more windows than Bw
    (65, 2, 81, 24, 2),      # MULTI_WINDOW: 132 blocks and more, Bw % G
    (33, 2, 256, 32, 2),
    (133, 1, 256, 64, 4),
    (34, 1, 1024, 56, 4),
])
def test_core_windows(Bw, nH, N, D, want):
    """4 windows a block at head dims 56-64, 2 below; halved while the
    grid has fewer blocks than the 132 SMs, never above Bw."""
    G = AW.core_windows(Bw, nH, N, D, 132)
    assert G == want
    assert 1 <= G <= max(1, min(Bw, 4))


# ---- the kernels on the card -------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_gates(name, fused, plain, x32):
    """Kernel `name`: fp32 within 1e-4 (1 + max|ref|), one CUDA-core
    launch; bf16 within the gate, one tensor-core launch."""
    def ran(fn, *args):
        K.reset_counts()
        out = fn(*args)
        return out, K.core_counts()[name]

    ref = plain(x32, torch.float32)
    got32, bodies = ran(fused, x32, torch.float32)
    assert bodies == {"core_mma_launches": 0, "core_fma_launches": 1}
    assert _err(got32, ref) <= TOL * (1 + float(ref.abs().max()))
    got16, bodies = ran(fused, x32.to(BF), BF)
    torch.cuda.synchronize()
    assert bodies == {"core_mma_launches": 1, "core_fma_launches": 0}
    assert gate_ratio(got16, plain, x32) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("D", HEADS)
def test_kernel4_wide_core_on_card(win, D):
    dev = _cuda()
    for shift in (0, win // 2):
        x32, k, v, bias, kw = (t.to(dev) if torch.is_tensor(t) else t
                               for t in _k4_case(win, shift, D))

        def run(fn):
            return lambda x, dt: fn(x.to(dt), k.to(dt), v.to(dt), bias,
                                    **kw)

        _card_gates("window_attention", run(K.fused_window_attention),
                    run(K.window_attention_reference), x32)


@pytest.mark.gpu
@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("D", HEADS)
def test_kernel5_wide_core_on_card(win, D):
    dev = _cuda()
    for shift in (0, win // 2):
        x32, prm, kw = _k5_case(win, shift, D)
        x32 = x32.to(dev)
        prm = {dt: {k: None if v is None else v.to(dev)
                    for k, v in p.items()} for dt, p in prm.items()}

        def run(fn):
            return lambda x, dt: fn(x.to(dt), *prm[dt].values(), **kw)

        _card_gates("attention_block", run(K.fused_attention_block),
                    run(K.attention_block_reference), x32)


# (win, heads, head dim, windows down, windows across, G): one image of
# rows x cols windows whose grid has 132 blocks or more, so `core_windows`
# keeps 2 or 4 windows a block, and whose window count is no multiple of
# G, so the last block holds dead windows (zero-filled, never written)
MULTI_WINDOW = [(9, 2, 24, 5, 13, 2), (16, 2, 32, 3, 11, 2),
                (16, 1, 64, 7, 19, 4), (32, 1, 56, 2, 17, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("win,nH,D,rows,cols,G", MULTI_WINDOW)
def test_wide_core_multi_window_blocks_on_card(win, nH, D, rows, cols, G):
    """Kernels 4 and 5 at G windows a block with a partial last block,
    shift 0 and win // 2, kernel 5 with LN, the modulator and w_off 3,
    against their plain versions under the card gates."""
    dev = _cuda()
    H, W, Bw, N, C = rows * win, cols * win, rows * cols, win * win, nH * D
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert AW.core_windows(Bw, nH, N, D, sms) == G and Bw % G
    d = Draws(3000 + win + D)
    k, v = d.xin(nH, Bw, N, D).to(dev), d.xin(nH, Bw, N, D).to(dev)
    bias = torch.from_numpy(d.mat(nH, N, N, fan_in=nH)).to(dev)
    prm = {dt: {n: None if t is None else t.to(dev) for n, t in p.items()}
           for dt, p in d.block(C, nH, N, with_mod=True).items()}
    for shift in (0, win // 2):
        kw = dict(win=win, shift=shift, H=H, W=W, scale=D ** -0.5)
        kw5 = dict(kw, num_heads=nH, has_ln=True, w_off=W_OFF)

        def k4(fn):
            return lambda x, dt: fn(x.to(dt), k.to(dt), v.to(dt), bias,
                                    **kw)

        def k5(fn):
            return lambda x, dt: fn(x.to(dt), *prm[dt].values(), **kw5)

        _card_gates("window_attention", k4(K.fused_window_attention),
                    k4(K.window_attention_reference),
                    d.xin(nH, Bw, N, D).to(dev))
        _card_gates("attention_block", k5(K.fused_attention_block),
                    k5(K.attention_block_reference),
                    d.xin(Bw, N, C).to(dev))
