"""The fp32 stage and LeFF bodies on the tensor cores: kernel 3's attention
and LeFF halves at C 64-512, head dim 16 or 32 (`csrc/attention_f32.cuh`,
`csrc/stage_f32.cu`), and kernel 2 / kernel 3's LeFF tile at C 16-512
(`csrc/leff_f32.cuh`), every product as three TF32 passes
(`csrc/mma_tf32.cuh`): each operand split once into big = rna(a) and
small = a - big (read by the mma truncated to TF32), summed as
small·big + big·small + big·big in fp32.

On the CPU:
  - an emulation of the split in torch (`tf32`: cvt.rna.tf32 as adding
    0x1000 to the bit pattern's magnitude, then clearing the low 13 bits;
    `split`: the small part a - big, which the mma reads truncated;
    `mm3`: the three passes in fp32) holds each product within
    2^-20 Σₖ|aₖ||bₖ| of an fp64 product, where one TF32 pass does not;
  - the stage's attention half and LeFF half with every product emulated
    so (`emulated_attention`, `emulated_leff`) stay within 1e-4 (1 +
    max|ref|) of the plain fp32 `attention_image_reference` /
    `leff_reference` / `stage_reference` (which other tests hold against
    JAX) at C 128, 256 and 512 (head dim 32), C 64 (head dim 16) and
    LeFF at C 16 and 32; the emulated stage against JAX's own
    `stage_reference` at C 128, the emulated LeFF against JAX's
    `leff_reference` at C 32; each prints its ratio to the gate;
  - the kernels' plans, restated here from `csrc/attention_f32.cuh`,
    `csrc/leff_f32.cuh` and `csrc/stage.cu` (`attention_layout`,
    `leff_layout`, `item_windows`; the kernels plan for themselves, and
    their `static_assert`s hold each layout within the 227 KB a block
    may take at build time): every layout within that budget, and why
    each stops where it does; which (C, D) the wrappers count as the new
    bodies (`stage.f32_stage`, `leff.f32_tile`).
The tests marked `gpu` hold each new body on the card against its plain
version at that gate (TF32 off) at every (C, D) in scope, with shift 0
and 4, with and without the modulator, with partial work items and
partial LeFF tiles, count its launches by body (`K.core_counts()`), show
that a NaN input spreads as in the plain version, and hold the fp32
block alone against an fp64 product:
`python -m pytest -m gpu tests/test_torch_port_f32_mma.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.dwconv import depthwise_conv2d
from uformer_tpu_torch.ops.kernels import leff as L
from uformer_tpu_torch.ops.kernels import stage as S
from uformer_tpu_torch.ops.kernels.mma import F32_WIDTHS, f32_product
from uformer_tpu_torch.ops.kernels.window_attention import window_mask
from uformer_tpu_torch.ops.norm import layer_norm
from uformer_tpu_torch.ops.window import (
    cyclic_shift,
    cyclic_unshift,
    window_partition,
    window_reverse,
)

torch.set_num_threads(1)
TOL = 1e-4
SPLIT_BOUND = 2.0 ** -20
NO_F32 = {"f32_mma_launches": 0, "f32_fma_launches": 0}
# (C, head dim) of the stage on the CPU, and LeFF's widths
STAGE_CASES = [(128, 32), (256, 32), (512, 32), (64, 16)]
LEFF_WIDTHS = (16, 32, 64, 128, 256, 512)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's references, imported by the CPU tests only: the
    card's machine has no flax, and the `gpu` tests need none of it."""
    import jax.numpy as jnp
    from uformer_tpu.ops.pallas import leff, stage

    return SimpleNamespace(jnp=jnp, leff=leff, stage=stage)


# ---- the split, emulated ----------------------------------------------------

def tf32(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to the nearest of 10 explicit mantissa bits,
    ties away from zero (0x1000 added to the magnitude, the low 13 bits
    cleared; the sign bit is apart, so the same add serves both signs)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc(t: torch.Tensor) -> torch.Tensor:
    """A TF32 operand as the mma reads it: the top 19 bits."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(t: torch.Tensor):
    """big = rna(t); small = t - big, which the mma reads truncated."""
    big = tf32(t)
    return big, trunc(t - big)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the fp32 bodies compute it: three TF32 passes, each
    product exact in fp32 (11 x 11 significant bits), summed in fp32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def draws(seed: int, C: int, nH: int, n: int = 1):
    """Stage operands by the golden weights' rule: matrices N(0, 1 /
    fan-in), LayerNorm scales 1 + N(0, 0.05²), biases N(0, 0.02²), the
    bias table and modulator N(0, 1 / fan-in)."""
    rng = np.random.default_rng(seed)
    Ch = 4 * C

    def mat(*shape, fan_in):
        return torch.from_numpy((rng.standard_normal(shape)
                                 / np.sqrt(fan_in)).astype(np.float32))

    def vec(*shape, mean=0.0, std=0.02):
        return torch.from_numpy(
            (mean + std * rng.standard_normal(shape)).astype(np.float32))

    return dict(ln1_s=vec(n, C, mean=1.0, std=0.05), ln1_b=vec(n, C),
                wq=mat(n, C, C, fan_in=C), bq=vec(n, C),
                wk=mat(n, C, C, fan_in=C), bk=vec(n, C),
                wv=mat(n, C, C, fan_in=C), bv=vec(n, C),
                wo=mat(n, C, C, fan_in=C), bo=vec(n, C),
                bias=mat(n, nH, 64, 64, fan_in=nH), mod=mat(n, 64, C, fan_in=C),
                ln2_s=vec(n, C, mean=1.0, std=0.05), ln2_b=vec(n, C),
                w1=mat(n, C, Ch, fan_in=C), b1=vec(n, Ch),
                wd=mat(n, 3, 3, Ch, fan_in=9), bd=vec(n, Ch),
                w2=mat(n, Ch, C, fan_in=Ch), b2=vec(n, C))


def image(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def emulated_attention(x, p, j, *, shift, scale, nH, has_mod):
    """Block j's attention half as `csrc/attention_f32.cuh` computes it:
    LN1 + mod, q (+ bias, times the scale), k, v, the fp32 logits q kᵀ +
    bias [+ the SW-MSA mask], softmax, O = P v, O wo + bo, + x; every
    product through `mm3`."""
    B, H, W, C = x.shape
    D = C // nH
    y = layer_norm(x, p["ln1_s"][j], p["ln1_b"][j])
    xm = window_partition(cyclic_shift(y, shift), 8)  # (Bw, 64, C)
    if has_mod:
        xm = xm + p["mod"][j]
    Bw = xm.shape[0]

    def heads(t):
        return t.reshape(Bw, 64, nH, D).transpose(1, 2)

    q = heads((mm3(xm, p["wq"][j]) + p["bq"][j]) * scale)
    k = heads(mm3(xm, p["wk"][j]) + p["bk"][j])
    v = heads(mm3(xm, p["wv"][j]) + p["bv"][j])
    logits = mm3(q, k.transpose(-1, -2)) + p["bias"][j][None]
    if shift:
        m = window_mask(H, W, 8, shift, Bw, 0, "cpu")
        logits = logits + m.repeat(Bw // m.shape[0], 1, 1)[:, None]
    o = mm3(torch.softmax(logits, dim=-1), v)
    o = mm3(o.transpose(1, 2).reshape(Bw, 64, C), p["wo"][j]) + p["bo"][j]
    return x + cyclic_unshift(window_reverse(o, 8, H, W), shift)


def emulated_leff(x, w1, b1, wd, bd, w2, b2, ln_s, ln_b):
    """x + LeFF(LN2 x) as `csrc/leff_f32.cuh` computes it: both products
    through `mm3`, the depthwise conv and the GELUs in fp32."""
    h = F.gelu(mm3(layer_norm(x, ln_s, ln_b), w1) + b1)
    g = F.gelu(depthwise_conv2d(h, wd, bd))
    return x + mm3(g, w2) + b2


def emulated_stage(x, p, *, scale, num_heads, use_shift, has_mod):
    for j in range(p["wq"].shape[0]):
        x = emulated_attention(x, p, j, shift=4 if use_shift and j % 2 else 0,
                               scale=scale, nH=num_heads, has_mod=has_mod)
        x = emulated_leff(x, *(p[k][j] for k in ("w1", "b1", "wd", "bd",
                                                 "w2", "b2", "ln2_s",
                                                 "ln2_b")))
    return x


def gate_ratio(got, ref) -> float:
    """max |got - ref| over the gate 1e-4 (1 + max|ref|)."""
    return float((got - ref).abs().max()) / (
        TOL * (1.0 + float(ref.abs().max())))


# ---- CPU: the split ---------------------------------------------------------

def test_tf32_rounds_to_nearest_away():
    """Exact values: 1 + 2^-11 (a tie) rounds away from zero, both signs;
    1 + 2^-11 + 2^-20 up; 1 + 2^-12 down; TF32 values stay."""
    vals = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 + 2 ** -20,
                         1 + 2 ** -12, 1 + 2 ** -10, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -10, 1.0,
                         1 + 2 ** -10, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(vals), want)
    big, small = split(vals)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)


def test_split_keeps_inf_and_nan():
    """Inf and NaN spread through the split: the rounding may turn a NaN's
    big part into -0 or Inf (0x7fffffff carries into the sign), but its
    small part (a - big) is NaN, as is an Inf's (Inf - Inf). So a NaN or
    Inf operand makes its row of the three-pass product non-finite, as in
    one fp32 product, and the other rows stay as they were."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7F800001, 0x7FC00000,
                         -0x400000, 0x7F800000, -0x800000],
                        dtype=torch.int32)
    vals = bits.view(torch.float32)
    big, small = split(vals)
    assert float(big[0]) == 0.0 and bool(torch.isinf(big[2]))
    assert bool(torch.isnan(small).all())
    assert torch.equal(big[5:], vals[5:])
    g = torch.Generator().manual_seed(3)
    a = torch.randn(8, 16, generator=g)
    b = torch.randn(16, 8, generator=g)
    for row, v in enumerate(vals):
        a[row, 2 * row + 1] = v
    got, want = mm3(a, b), a @ b
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert bool((~torch.isfinite(got[:7])).all())
    assert bool(torch.isnan(got[:5]).all())
    assert float((got[7] - want[7]).abs().max()) <= 1e-5
    got = mm3(b.T.contiguous(), a.T.contiguous())  # the NaN in b
    assert bool(torch.isnan(got[:, :5]).all())
    assert bool(torch.isfinite(got[:, 7]).all())


@pytest.mark.parametrize("K", [8, 64, 512, 2048])
def test_three_pass_product_within_fp64(K):
    """Each product of the split within 2^-20 Σₖ|aₖ||bₖ| of the fp64 one
    (worst ratio printed); a single TF32 pass is not."""
    g = torch.Generator().manual_seed(K)
    a = torch.randn(64, K, generator=g)
    b = torch.randn(K, 96, generator=g) / K ** 0.5
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    ratio = float(((mm3(a, b).double() - ref).abs() / scale).max()) \
        / SPLIT_BOUND
    one = float(((tf32(a) @ tf32(b)).double() - ref).abs().div(scale).max()) \
        / SPLIT_BOUND
    print(f"K {K}: three passes {ratio:.3f} of 2^-20, one pass {one:.1f}")
    assert ratio <= 1.0
    assert one > 1.0


# ---- CPU: the halves, emulated ---------------------------------------------

@pytest.mark.parametrize("C,D", STAGE_CASES)
@pytest.mark.parametrize("shift", [0, 4])
def test_emulated_attention_half(C, D, shift):
    """The attention half with every product in three passes against the
    plain fp32 attention sub-block (the stage's own, block 0 of a stage),
    modulator on, two 16 x 16 images."""
    nH = C // D
    p = draws(31 + C, C, nH)
    x = image(5, 2, 16, 16, C)
    wkv = torch.cat([p["wk"][0], p["wv"][0]], dim=1)
    bkv = torch.cat([p["bk"][0], p["bv"][0]])
    ref = K.attention_image_reference(
        x, p["mod"][0], p["ln1_s"][0], p["ln1_b"][0], p["wq"][0], p["bq"][0],
        wkv, bkv, p["wo"][0], p["bo"][0], p["bias"][0], win=8, shift=shift,
        scale=D ** -0.5, num_heads=nH, has_ln=True, residual=True)
    got = emulated_attention(x, p, 0, shift=shift, scale=D ** -0.5, nH=nH,
                             has_mod=True)
    ratio = gate_ratio(got, ref)
    print(f"attention C {C} D {D} shift {shift}: {ratio:.4f} of the gate")
    assert ratio <= 1.0


@pytest.mark.parametrize("C", (16, 32, 64, 128, 256, 512))
def test_emulated_leff_half(C):
    """LeFF with both products in three passes against `leff_reference`
    (LN, residual), on a 12 x 20 image: partial 8 x 8 tiles."""
    p = draws(41 + C, C, max(1, C // 32))
    args = [p[k][0] for k in ("w1", "b1", "wd", "bd", "w2", "b2")]
    ln = dict(ln_s=p["ln2_s"][0], ln_b=p["ln2_b"][0])
    x = image(6, 2, 12, 20, C)
    ref = K.leff_reference(x, *args, residual=True, **ln)
    ratio = gate_ratio(emulated_leff(x, *args, **ln), ref)
    print(f"LeFF C {C}: {ratio:.4f} of the gate")
    assert ratio <= 1.0


@pytest.mark.parametrize("C,D", STAGE_CASES)
@pytest.mark.parametrize("has_mod", [True, False])
def test_emulated_stage(C, D, has_mod):
    """Two blocks (shift 0, then 4), both halves emulated, against
    `stage_reference` on a 16 x 24 image."""
    nH = C // D
    p = draws(51 + C, C, nH, n=2)
    x = image(7, 1, 16, 24, C)
    kw = dict(scale=D ** -0.5, num_heads=nH, use_shift=True, has_mod=has_mod)
    ratio = gate_ratio(emulated_stage(x, p, **kw), K.stage_reference(x, p, **kw))
    print(f"stage C {C} D {D} mod {has_mod}: {ratio:.4f} of the gate")
    assert ratio <= 1.0


def test_emulated_stage_against_jax(jx):
    """The emulated stage at C 128 (4 heads of 32, shift, modulator)
    against JAX's `stage_reference`."""
    p = draws(61, 128, 4, n=2)
    x = image(8, 1, 16, 16, 128)
    kw = dict(scale=32 ** -0.5, num_heads=4, use_shift=True, has_mod=True)
    want = torch.from_numpy(np.array(jx.stage.stage_reference(
        jx.jnp.asarray(x.numpy()),
        {k: jx.jnp.asarray(v.numpy()) for k, v in p.items()}, **kw)))
    ratio = gate_ratio(emulated_stage(x, p, **kw), want)
    print(f"stage C 128 against JAX: {ratio:.4f} of the gate")
    assert ratio <= 1.0


def test_emulated_leff_against_jax(jx):
    """The emulated LeFF at C 32 (LN, residual) against JAX's
    `leff_reference` on a 12 x 20 image."""
    p = draws(62, 32, 1)
    names = ("w1", "b1", "wd", "bd", "w2", "b2")
    x = image(9, 2, 12, 20, 32)
    want = torch.from_numpy(np.array(jx.leff.leff_reference(
        jx.jnp.asarray(x.numpy()),
        *(jx.jnp.asarray(p[k][0].numpy()) for k in names),
        ln_s=jx.jnp.asarray(p["ln2_s"][0].numpy()),
        ln_b=jx.jnp.asarray(p["ln2_b"][0].numpy()), residual=True)))
    got = emulated_leff(x, *(p[k][0] for k in names), p["ln2_s"][0],
                        p["ln2_b"][0])
    ratio = gate_ratio(got, want)
    print(f"LeFF C 32 against JAX: {ratio:.4f} of the gate")
    assert ratio <= 1.0


# ---- CPU: the kernels' plans ------------------------------------------------

SMEM_LIMIT = 232448  # bytes of shared memory a block may take (sm_90)


def align128(n: int) -> int:
    return (n + 127) & ~127


def max_windows(C: int) -> int:
    """`csrc/attention_f32.cuh:attn_f32_max_windows`."""
    return 2 if C <= 128 else 1


def leff_rows(C: int) -> int:
    """`csrc/leff_f32.cuh:leff_f32_rows`."""
    return 4 if C == 512 else 8


def attention_layout(C: int, D: int, WN: int) -> dict:
    """`csrc/attention_f32.cuh:AttnF32<C, D, WN>`, bytes: xm (64 WN rows
    of C + 4 floats), q (then O) and k (D + 4), v (D + 8), the window's
    logits (64 x 68), the token map and three ring slots of the larger of
    a q|k|v tile (KQ x (3D + 8), KQ 32 at head dim 32, else 64) and a wo
    tile (DO x (C + 8), DO = min(D, 4096 / C))."""
    M = 64 * WN
    kq = 32 if D == 32 else 64
    do = min(D, 4096 // C)
    slot = align128(4 * max(kq * (3 * D + 8), do * (C + 8)))
    out = {"rows": M, "qkv_rows": kq, "wo_rows": do, "slot": slot}
    off = 0
    for name, size in (("xm", 4 * M * (C + 4)), ("q", 4 * M * (D + 4)),
                       ("k", 4 * M * (D + 4)), ("v", 4 * M * (D + 8)),
                       ("s", 4 * 64 * 68), ("pix", 4 * M), ("rid", 4 * M),
                       ("ring", 3 * slot)):
        out[name] = off
        off += align128(size)
    out["total"] = off
    return out


def leff_layout(C: int, TH: int) -> dict:
    """`csrc/leff_f32.cuh:LeffF32<C, TH>`, bytes: the halo of LN2(x) (rows
    padded to 16, C + 4 floats a row), the hidden chunk h and g (64 + 4
    floats a row), the halo's pixel ids and three ring slots of the
    larger of a W1 tile (min(C, 64) x 72 floats) and a W2 tile (KW2 x
    (C + 8), KW2 the power of two at most 4608 / (C + 8) and 64)."""
    rows = -(-(TH + 2) * 10 // 16) * 16
    k1 = min(C, 64)
    kw2 = 1 << (min(64, 4608 // (C + 8)).bit_length() - 1)
    chunk = L.HIDDEN_CHUNK
    slot = align128(4 * max(k1 * (chunk + 8), kw2 * (C + 8)))
    out = {"halo_rows": rows, "w1_rows": k1, "w2_rows": kw2, "slot": slot}
    off = 0
    for name, size in (("xn", 4 * rows * (C + 4)),
                       ("h", 4 * rows * (chunk + 4)),
                       ("g", 4 * TH * 8 * (chunk + 4)),
                       ("hpix", 4 * rows), ("ring", 3 * slot)):
        out[name] = off
        off += align128(size)
    out["total"] = off
    return out


def item_windows(windows: int, slots: int, most: int) -> int:
    """`csrc/stage.cu:item_windows`: the most windows a work item, up to
    `most`, that add no round of items over the resident blocks."""
    best, best_cost, wn = 1, None, 1
    while wn <= most:
        cost = -(-(-(-windows // wn)) // slots) * wn
        if best_cost is None or cost <= best_cost:
            best, best_cost = wn, cost
        wn *= 2
    return best


@pytest.mark.parametrize("C", S.F32_WIDTHS)
@pytest.mark.parametrize("D", S.F32_HEAD_DIMS)
def test_attention_layout_fits(C, D):
    """Every work item's layout within the 227 KB a block may take; at C
    256 and 512 a second window would not fit (xm and q, k, v are fp32).
    The wo tile's rows divide the head, the q|k|v tile's C."""
    for wn in range(1, max_windows(C) + 1):
        lay = attention_layout(C, D, wn)
        assert lay["total"] <= SMEM_LIMIT
        assert D % lay["wo_rows"] == 0 and C % lay["qkv_rows"] == 0
        offs = [lay[k] for k in ("xm", "q", "k", "v", "s", "pix", "rid",
                                 "ring")]
        assert offs == sorted(offs) and all(o % 128 == 0 for o in offs)
    if C >= 256:
        assert attention_layout(C, D, 2)["total"] > SMEM_LIMIT


@pytest.mark.parametrize("C", LEFF_WIDTHS)
def test_leff_layout_fits(C):
    """The fp32 tile at its rows fits; at C 512 the 8-row tile would not
    (its halo alone is 112 rows of 516 floats). W2 tiles divide a chunk
    and stay within the ring slot."""
    lay = leff_layout(C, leff_rows(C))
    assert lay["total"] <= SMEM_LIMIT
    assert 64 % lay["w2_rows"] == 0 and C % lay["w1_rows"] == 0
    assert lay["slot"] <= 18432
    if C == 512:
        assert leff_layout(C, 8)["total"] > SMEM_LIMIT


@pytest.mark.parametrize("windows,sms,C,want", [
    (128, 132, 512, 1), (2048, 132, 128, 2), (8, 132, 128, 1),
    (264, 132, 64, 2), (133, 132, 64, 2), (131, 132, 128, 1),
    (8192, 132, 256, 1), (2 * 132 - 3, 132, 128, 2)])
def test_f32_windows(windows, sms, C, want):
    """The most windows a work item (at most 2 at C 64 and 128, 1 above)
    that add no round of items over one block per SM; 2 SMs - 3 windows
    (the `gpu` cases' shape) take two an item, the last half dead."""
    assert item_windows(windows, sms, max_windows(C)) == want


def test_f32_plan_scope():
    """Head dims 16 and 32 at C 64-512 take the new bodies; 8, 24-56 and 64
    and C 1024 stay on the generic ones; LeFF at C 16-512 with whole
    hidden chunks."""
    assert all(S.f32_stage(C, D) for C in (64, 128, 256, 512)
               for D in (16, 32))
    for C, D in ((128, 8), (384, 24), (768, 48), (512, 64), (1024, 64),
                 (1024, 32), (32, 16)):
        assert not S.f32_stage(C, D)
    assert all(L.f32_tile(C, 4 * C) for C in LEFF_WIDTHS)
    assert not L.f32_tile(8, 32) and not L.f32_tile(1024, 4096)
    assert not L.f32_tile(48, 192) and not L.f32_tile(64, 96)


def test_cpu_calls_count_no_body():
    """A CPU tensor takes the plain version and counts no body."""
    K.reset_counts()
    p = draws(70, 64, 4)
    x = image(10, 1, 8, 8, 64)
    K.fused_stage(x, p, scale=0.25, num_heads=4, use_shift=False,
                  has_mod=True)
    K.fused_leff(x, *(p[k][0] for k in ("w1", "b1", "wd", "bd", "w2", "b2")))
    counts = K.core_counts()
    assert counts["stage"] == NO_F32 and counts["leff"] == NO_F32
    assert K.plain_counts()["stage"] == 1 and K.plain_counts()["leff"] == 1


# ---- on the card ------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ran(fn, name):
    K.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, K.core_counts()[name]


STAGE_GPU = [(C, D, shift, mod) for C in S.F32_WIDTHS for D in S.F32_HEAD_DIMS
             for shift, mod in ((True, True), (False, False))]


@pytest.mark.gpu
@pytest.mark.parametrize("C,D,use_shift,has_mod", STAGE_GPU)
def test_f32_stage_on_card(C, D, use_shift, has_mod):
    """The fp32 stage (two blocks) on the new bodies against
    `stage_reference` on the card: a 24 x 40 image (15 windows a batch
    row: partial items at 2 windows an item), one launch of the new
    body."""
    dev = _cuda()
    nH = C // D
    p = {k: v.to(dev) for k, v in draws(80 + C + D, C, nH, n=2).items()}
    x = image(11, 2, 24, 40, C).to(dev)
    kw = dict(scale=D ** -0.5, num_heads=nH, use_shift=use_shift,
              has_mod=has_mod)
    ref = K.stage_reference(x, p, **kw)
    got, bodies = _ran(lambda: K.fused_stage(x, p, **kw), "stage")
    assert bodies == {"f32_mma_launches": 1, "f32_fma_launches": 0}
    assert gate_ratio(got, ref) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("C", [64, 128])
def test_f32_stage_two_windows_an_item_on_card(C):
    """Two windows a work item on 2 SMs - 3 windows (`test_f32_windows`:
    the last item half dead), head dim 32, shift on."""
    dev = _cuda()
    from uformer_tpu_torch.ops.kernels.wgrad import sm_count

    nH = C // 32
    p = {k: v.to(dev) for k, v in draws(90 + C, C, nH, n=2).items()}
    x = image(12, 1, 8, 8 * (2 * sm_count(dev) - 3), C).to(dev)
    kw = dict(scale=32 ** -0.5, num_heads=nH, use_shift=True, has_mod=True)
    got, bodies = _ran(lambda: K.fused_stage(x, p, **kw), "stage")
    assert bodies["f32_mma_launches"] == 1
    assert gate_ratio(got, K.stage_reference(x, p, **kw)) <= 1.0


LEFF_GPU = [(2, 8, 8), (1, 16, 24), (1, 12, 20), (2, 64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("C", LEFF_WIDTHS)
@pytest.mark.parametrize("shape", LEFF_GPU)
def test_f32_leff_on_card(C, shape):
    """Kernel 2 in fp32 on the new tile against `leff_reference` (LN,
    residual) on square, non-square and partial-tile images."""
    dev = _cuda()
    p = draws(100 + C, C, 1)
    args = [p[k][0].to(dev) for k in ("w1", "b1", "wd", "bd", "w2", "b2")]
    ln = dict(ln_s=p["ln2_s"][0].to(dev), ln_b=p["ln2_b"][0].to(dev))
    x = image(13, *shape, C).to(dev)
    ref = K.leff_reference(x, *args, residual=True, **ln)
    got, bodies = _ran(lambda: K.fused_leff(x, *args, residual=True, **ln),
                       "leff")
    assert bodies == {"f32_mma_launches": 1, "f32_fma_launches": 0}
    assert gate_ratio(got, ref) <= 1.0
    got = K.fused_leff(x, *args)  # no LN, no residual
    assert gate_ratio(got, K.leff_reference(x, *args)) <= 1.0


@pytest.mark.gpu
def test_f32_outside_scope_on_card():
    """fp32 outside the new bodies' widths keeps the generic ones: the
    stage at head dim 64, LeFF at C 8 and 48."""
    dev = _cuda()
    p = {k: v.to(dev) for k, v in draws(110, 128, 2, n=1).items()}
    x = image(14, 1, 16, 16, 128).to(dev)
    kw = dict(scale=0.125, num_heads=2, use_shift=False, has_mod=True)
    got, bodies = _ran(lambda: K.fused_stage(x, p, **kw), "stage")
    assert bodies == {"f32_mma_launches": 0, "f32_fma_launches": 1}
    assert gate_ratio(got, K.stage_reference(x, p, **kw)) <= 1.0
    for C in (8, 48):
        q = draws(111 + C, C, 1)
        args = [q[k][0].to(dev) for k in ("w1", "b1", "wd", "bd", "w2",
                                          "b2")]
        xc = image(15, 1, 8, 8, C).to(dev)
        got, bodies = _ran(lambda: K.fused_leff(xc, *args), "leff")
        assert bodies == {"f32_mma_launches": 0, "f32_fma_launches": 1}
        assert gate_ratio(got, K.leff_reference(xc, *args)) <= 1.0


def _nan_gate(got, ref) -> None:
    """NaN exactly where the plain version has NaN, the rest within the
    gate."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert bool(torch.isnan(ref).any()) and bool(torch.isfinite(ref).any())
    keep = torch.isfinite(ref)
    assert gate_ratio(got[keep], ref[keep]) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("nan", [0x7FFFFFFF, 0x7F800001, -1])
def test_f32_nan_spreads_on_card(nan):
    """A NaN pixel (the canonical 0x7fffffff, one whose payload lies in the
    low 13 bits, and 0xffffffff, whose rounding carries to +0) spreads through the new bodies as through the plain
    version: the stage at C 128 (two blocks, shift) and kernel 2 at C 32 and 512 without LN (the NaN enters the products
    as it is)."""
    dev = _cuda()
    bad = torch.tensor([nan], dtype=torch.int32).view(torch.float32)[0]
    p = {k: v.to(dev) for k, v in draws(120, 128, 4, n=2).items()}
    x = image(16, 1, 16, 24, 128)
    x[0, 5, 9, 17] = bad
    x = x.to(dev)
    kw = dict(scale=32 ** -0.5, num_heads=4, use_shift=True, has_mod=True)
    got, bodies = _ran(lambda: K.fused_stage(x, p, **kw), "stage")
    assert bodies["f32_mma_launches"] == 1
    _nan_gate(got, K.stage_reference(x, p, **kw))
    for C in (32, 512):
        q = draws(121 + C, C, 1)
        args = [q[k][0].to(dev) for k in ("w1", "b1", "wd", "bd", "w2",
                                          "b2")]
        xc = image(17, 1, 12, 20, C)
        xc[0, 6, 11, C // 2] = bad
        xc = xc.to(dev)
        got, bodies = _ran(lambda: K.fused_leff(xc, *args), "leff")
        assert bodies["f32_mma_launches"] == 1
        _nan_gate(got, K.leff_reference(xc, *args))


def accumulation_bound(K: int, fma: bool) -> float:
    """The worst relative error (over sum_k |a_k| |b_k|) of the fp32
    block's accumulation at depth K: the FMA loop rounds each of its K
    adds to nearest (2^-24 of the running sum, at most sum |a||b|); the
    three-pass block sums the exact products of one or two k8 steps from
    zero on the tensor cores, rounding toward zero up to six times (2^-23
    of the group's sum each), and adds the sums to nearest."""
    if fma:
        return K * 2.0 ** -24
    return 6 * 2.0 ** -23 + (K // 8) * 2.0 ** -24


@pytest.mark.gpu
@pytest.mark.parametrize("C", F32_WIDTHS)
@pytest.mark.parametrize("fma", [False, True])
def test_f32_block_on_card(C, fma):
    """The fp32 block alone (both ways) within its accumulation's worst
    error of an fp64 product (the ratio printed)."""
    dev = _cuda()
    g = torch.Generator().manual_seed(C)
    a = torch.randn(256, C, generator=g).to(dev)
    b = (torch.randn(C, C, generator=g) / C ** 0.5).to(dev)
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    got = f32_product(a, b, fma=fma)
    torch.cuda.synchronize()
    rel = float(((got.double() - ref).abs() / scale).max())
    print(f"C {C} fma {fma}: {rel:.3e} of sum |a||b|, "
          f"{rel / accumulation_bound(C, fma):.3f} of the bound")
    assert rel <= accumulation_bound(C, fma)
