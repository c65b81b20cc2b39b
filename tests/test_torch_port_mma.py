"""The tensor-core LeFF and stage kernels (`csrc/leff_mma.cuh`,
`csrc/attention_mma.cuh`) and their building block (`csrc/mma_tile.cuh`).

On the CPU the plain versions are held against the JAX package at the
shapes the new tiles take (an 8 x 8 image at C = 512, a stage with shift
at C = 256, rows that are not a multiple of the old tile rows), with the
JAX references and its Pallas kernels in interpret mode (fp32, 1e-4).
The tests marked `gpu` hold the building block against `torch.matmul`,
`fused_leff` at every width on square, non-square and partial-tile
images, `fused_stage` at the serve B and serve T stage shapes, and db1
of the LeFF backward (summed from fp32, as the TPU kernel sums it)
against the plain VJP, on the card:
`python -m pytest -m gpu tests/test_torch_port_mma.py`.
"""

import numpy as np
import pytest
import torch

from test_torch_port_kernels import (
    TOL,
    _cast,
    _check_grads,
    _check_kernel,
    _close,
    _cuda,
    _j,
    _leff_inputs,
    _stage_inputs,
    _t,
    jx,  # noqa: F401  (fixture)
)
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.ops.kernels.mma import block_product

torch.set_num_threads(1)
LEFF_ARGS = ("w1", "b1", "wd", "bd", "w2", "b2")


@pytest.mark.parametrize("shape", [(1, 8, 8, 512), (1, 24, 8, 128)])
def test_leff_reference_matches_jax_at_new_tiles(jx, shape):  # noqa: F811
    """An 8 x 8 image at C = 512 (one wide tile, the conv stage of the 128^2
    train step) and 24 rows, which the old 16-row tiles would not cut. The
    matrices are N(0, 1 / fan-in), as a model's are, so that the output
    stays O(1) at C = 512 as it does at the narrow widths."""
    inp = _leff_inputs(21, *shape, 4 * shape[-1])
    for k in ("w1", "w2"):
        inp[k] = inp[k] / (0.3 * np.sqrt(inp[k].shape[0]))
    args = [inp[k] for k in ("x",) + LEFF_ARGS]
    got = K.leff_reference(*map(_t, args), ln_s=_t(inp["ln_s"]),
                           ln_b=_t(inp["ln_b"]), residual=True)
    jkw = dict(ln_s=_j(jx, inp["ln_s"]), ln_b=_j(jx, inp["ln_b"]),
               residual=True)
    jargs = [_j(jx, a) for a in args]
    _close(got, jx.leff.leff_reference(*jargs, **jkw),
           jx.leff.fused_leff(*jargs, interpret=True, **jkw))


@pytest.mark.parametrize("C,nH,res,use_shift", [(512, 16, 8, False),
                                                (256, 8, 16, True)])
def test_stage_reference_matches_jax_at_new_tiles(jx, C, nH, res,  # noqa
                                                  use_shift):
    """Two blocks at C = 512, 16 heads on an 8 x 8 image (serve B's conv
    stage shape), and at C = 256 with shift on 16 x 16."""
    p = _stage_inputs(22, 2, C, nH, 4 * C)
    for k in ("wq", "wk", "wv", "wo", "w1", "w2"):  # N(0, 1 / fan-in)
        p[k] = p[k] / (0.1 * np.sqrt(p[k].shape[1]))
    x = (np.random.default_rng(23).standard_normal((1, res, res, C)) * 0.3) \
        .astype(np.float32)
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=use_shift,
              has_mod=True)
    got = K.stage_reference(_t(x), {k: _t(v) for k, v in p.items()}, **kw)
    jp = {k: _j(jx, v) for k, v in p.items()}
    _close(got, jx.stage.stage_reference(_j(jx, x), jp, **kw),
           jx.stage.fused_stage(_j(jx, x), jp, interpret=True, **kw))


@pytest.mark.parametrize("M,N,K", [(112, 64, 512), (64, 512, 64)])
def test_block_product_plain_on_cpu(M, N, K):
    """On the CPU the building block's entry is the plain product."""
    rng = np.random.default_rng(24)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    got = block_product(a.bfloat16(), b.bfloat16())
    want = a.bfloat16().float() @ b.bfloat16().float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


# ---- on the card -------------------------------------------------------

# (M, N, K, n8 tiles a warp takes): the wide tile's first product (112
# halo rows, a 64-wide chunk, K = C) and second (K = 64, N = C), the
# narrow tile's (192 halo rows; N = C 16-64), and a ragged M
BLOCK_SHAPES = [(112, 64, 512, 4), (112, 64, 128, 4), (64, 512, 64, 4),
                (64, 256, 64, 4), (192, 64, 64, 4), (128, 32, 64, 2),
                (128, 16, 64, 1), (100, 32, 128, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,nt", BLOCK_SHAPES)
def test_block_product_on_card(M, N, K, nt):
    """mma.sync products and the cp.async ring against torch.matmul in
    fp32 (TF32 off) on the same bf16 values: the products are exact in
    fp32, so only the order of the sums differs (1e-4 (1 + max|ref|))."""
    dev = _cuda()
    rng = np.random.default_rng(25)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
        .to(dev).bfloat16()
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) \
        .to(dev).bfloat16()
    ref = torch.matmul(a.float(), b.float())
    got = block_product(a, b, nt)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    assert err <= TOL * (1 + float(ref.abs().max())), err


def _leff_run(prm, residual=True):
    def run(fn):
        return lambda x, dt: fn(x, *(prm[dt][k] for k in LEFF_ARGS),
                                ln_s=prm[dt]["ln_s"], ln_b=prm[dt]["ln_b"],
                                residual=residual)
    return run


# every width; 8 x 8 (one tile), non-square, rows and columns that leave
# partial narrow (8 x 16) tiles, 64 x 64 at C = 32 (many tiles per
# persistent block), and enough 64 x 64 images at C 128 and 256 that the
# host picks 16-row wide tiles
LEFF_SHAPES = ([(2, 8, 8, C) for C in (16, 32, 64, 128, 256, 512)]
               + [(1, 16, 24, C) for C in (16, 32, 64, 128, 256, 512)]
               + [(1, 24, 40, C) for C in (16, 32, 64, 128, 256, 512)]
               + [(2, 64, 64, 32), (4, 64, 64, 128), (4, 64, 64, 256)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LEFF_SHAPES)
def test_leff_tiles_on_card(shape):
    dev = _cuda()
    inp = _leff_inputs(26, *shape, 4 * shape[-1])
    x = _t(inp.pop("x"), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("w1", "wd", "w2"))
           for dt in (torch.float32, torch.bfloat16)}
    run = _leff_run(prm)
    K.reset_counts()
    _check_kernel(run(K.fused_leff), run(K.leff_reference), x)
    assert K.launch_counts()["leff"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 12, 20, 32), (1, 4, 12, 128),
                                   (1, 20, 12, 512), (2, 9, 7, 64),
                                   (8, 72, 60, 128)])
@pytest.mark.parametrize("residual", [True, False])
def test_leff_tiles_any_shape_on_card(shape, residual):
    """bf16 at sizes that are no multiple of 8 (the last: partial 16-row
    tiles): the mma tiles mask their partial tiles (the fp32 path keeps
    its whole tiles). The kernel's error against the fp32 plain result is
    within the bf16 bound."""
    dev = _cuda()
    inp = _leff_inputs(27, *shape, 4 * shape[-1])
    x = _t(inp.pop("x"), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("w1", "wd", "w2"))
           for dt in (torch.float32, torch.bfloat16)}
    run = _leff_run(prm, residual)
    ref = run(K.leff_reference)(x, torch.float32)
    xb = x.bfloat16()
    e_plain = float((run(K.leff_reference)(xb, torch.bfloat16).float()
                     - ref).abs().max())
    e_kernel = float((run(K.fused_leff)(xb, torch.bfloat16).float()
                      - ref).abs().max())
    assert e_kernel <= 1.5 * e_plain + 1e-3, (e_kernel, e_plain)


# serve B's stages at batch 2: (C, nH, res, n, use_shift, has_mod) of
# enc2, enc3, conv, dec0, dec1, dec2; then serve T's (head dim 16) enc3,
# conv, dec0, dec1
SERVE_B_STAGES = [(128, 4, 64, 8, True, False), (256, 8, 32, 8, True, False),
                  (512, 16, 16, 2, True, False), (512, 16, 32, 8, True, True),
                  (256, 8, 64, 8, True, True), (128, 4, 128, 2, True, True)]
SERVE_T_STAGES = [(128, 8, 32, 2, True, False), (256, 16, 16, 2, True, False),
                  (256, 16, 32, 2, True, True), (128, 8, 64, 2, True, True)]
# (batch, stage): the 16-row LeFF tile at C = 256 and 128 with 2 windows
# per attention item, and head dim 16 with 4 (the host picks both from the
# work: at batch 2 these stages take 8-row tiles and 1 window)
WIDER_STAGES = [(4, (256, 8, 64, 2, True, True)),
                (4, (128, 4, 64, 2, True, False)),
                (8, (128, 8, 64, 2, True, True))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,stage", [(2, s) for s in SERVE_B_STAGES
                                     + SERVE_T_STAGES] + WIDER_STAGES)
def test_stage_serve_shapes_on_card(B, stage):
    dev = _cuda()
    C, nH, res, n, use_shift, has_mod = stage
    p = _stage_inputs(28, n, C, nH, 4 * C)
    x = (_t(np.random.default_rng(29).standard_normal((B, res, res, C))
            .astype(np.float32), dev)).bfloat16().float()
    prm = {dt: _cast(p, dev, dt, ("wq", "wk", "wv", "wo", "mod", "w1", "wd",
                                  "w2"))
           for dt in (torch.float32, torch.bfloat16)}
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=use_shift,
              has_mod=has_mod)
    K.reset_counts()
    _check_kernel(lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                  lambda x, dt: K.stage_reference(x, prm[dt], **kw), x)
    assert K.launch_counts()["stage"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("has_ln", [True, False])
def test_leff_bwd_db1_from_fp32_on_card(has_ln):
    """db1 of the bf16 LeFF backward at C = 512 against the fp32 plain VJP:
    summed from the fp32 hidden gradient, its error is no larger than the
    bf16 plain VJP's; every other gradient within the usual bounds."""
    dev = _cuda()
    shape = (2, 16, 16, 512)
    inp = _leff_inputs(30, *shape, 4 * shape[-1])
    x = _t(inp.pop("x"), dev).bfloat16().float()
    g = _t(np.random.default_rng(31).standard_normal(shape)
           .astype(np.float32), dev).bfloat16().float()
    prm = {dt: _cast(inp, dev, dt, ("w1", "wd", "w2"))
           for dt in (torch.float32, torch.bfloat16)}

    def run(fn):
        return lambda x, g, dt: fn(x, g, *(prm[dt][k] for k in (
            "w1", "b1", "wd", "bd", "w2", "ln_s", "ln_b")), has_ln=has_ln,
            residual=True)

    _check_grads(run(K.fused_leff_bwd), run(K.leff_vjp_reference), x, g,
                 ("db1", has_ln))
    ref = run(K.leff_vjp_reference)(x, g, torch.float32)[2]
    plain = run(K.leff_vjp_reference)(x.bfloat16(), g.bfloat16(),
                                      torch.bfloat16)[2]
    got = run(K.fused_leff_bwd)(x.bfloat16(), g.bfloat16(), torch.bfloat16)[2]
    e_plain = float((plain.float() - ref).abs().max())
    e_kernel = float((got - ref).abs().max())
    assert e_kernel <= e_plain, (e_kernel, e_plain)
