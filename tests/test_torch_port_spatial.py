"""The port's spatial path (`uformer_tpu_torch.parallel.spatial`) on the
CPU, over gloo: 2 and 4 spawned ranks, torch.set_num_threads(1), one
spawn per rank count shared by the tests that read it (120 s deadline).

- The exchanges (shifts, halos of 1 and (1, 2), periodic) and the sharded
  convs (depthwise, 3x3, the 4x4 stride-2 Downsample, the Upsample) against
  the unsharded torch ops on the whole batch, rank by rank.
- The sharded LeWin block on 4 ranks against JAX `LeWinBlock.apply` on
  the same weights (`convert.block_state_dict_from_jax`), fp32, within
  JAX's own 2e-5: H 64, W 16, C 16, win 8, shift 4, 2 heads, modulator;
  and no shift, C 8. The first and last ranks hold the image's true
  edges: LeFF's slab takes halo rows on interior sides only.
- The whole Uformer (img 32, embed 8, win 2, depths 2-2-1-1-1-1-1-2-2) on
  4 ranks (levels 3-4 replicated: gathered and split again) and on 2,
  and the pad-and-batch case (24 x 28, batch 2: kernel 5 once per image
  in a sharded stage) against JAX `model.apply`, within 1e-5; every block
  through the wrappers of kernels 5 and 2 (their plain versions here).
- `tiled_inference_sharded` as the identity on 2 ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_cases as cases
from uformer_tpu.models import Uformer as JaxUformer
from uformer_tpu.models.layers import LeWinBlock as JaxLeWinBlock
from uformer_tpu_torch.convert import (
    block_state_dict_from_jax,
    state_dict_from_jax,
)
from uformer_tpu_torch.models.layers import LeWinBlock
from uformer_tpu_torch.parallel import spatial as S
from uformer_tpu_torch.parallel.multihost import spawn_ranks

torch.set_num_threads(1)
SMALL = dict(img_size=32, embed_dim=8, depths=(2, 2, 1, 1, 1, 1, 1, 2, 2),
             num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), win_size=2,
             modulator=True)
BLOCKS = {"shift": dict(H=64, W=16, C=16, win=8, shift=4, heads=2,
                        modulator=True),
          "noshift": dict(H=64, W=16, C=8, win=8, shift=0, heads=1,
                          modulator=False)}


def _seeded_params(module, x, seed):
    """flax params of `module` drawn with numpy: every leaf N(0, 0.05^2),
    LayerNorm scales around 1."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * rng.standard_normal(a.shape)
                         + jax.tree_util.keystr(path).endswith("['scale']"))
        .astype(np.float32), shapes)


@pytest.fixture(scope="module")
def jax_cases():
    """JAX's outputs and the weights in the port's names: the two blocks
    and the small Uformer at 32^2 (batch 1) and 24 x 28 (batch 2, padded
    to 32^2, the result cropped)."""
    blocks, want = {}, {}
    for i, (name, c) in enumerate(BLOCKS.items()):
        blk = JaxLeWinBlock(dim=c["C"], num_heads=c["heads"],
                            win_size=c["win"], shift_size=c["shift"],
                            modulator=c["modulator"], attn_backend="jnp")
        img = (0.5 * np.random.default_rng(i).standard_normal(
            (1, c["H"], c["W"], c["C"]))).astype(np.float32)
        params = _seeded_params(blk, img, 10 + i)
        want[name] = np.asarray(jax.jit(blk.apply)(params, img))
        blocks[name] = dict(c, img=img, sd=block_state_dict_from_jax(
            "LeWinBlock", params))
    model = JaxUformer(attn_backend="jnp", shift_flag=True, **SMALL)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    xb = rng.uniform(0, 1, (2, 24, 28, 3)).astype(np.float32)
    params = _seeded_params(model, x, 20)
    sd = state_dict_from_jax(params)
    padded = np.pad(xb, ((0, 0), (0, 8), (0, 4), (0, 0)))
    y = np.asarray(jax.jit(model.apply)(params, np.concatenate([x, padded])))
    want["model"], want["pad_batch"] = y[:1], y[1:, :24, :28]
    models = {"model": (SMALL, sd, x), "pad_batch": (SMALL, sd, xb)}
    return blocks, models, want


def _primitive_inputs(n):
    rng = np.random.default_rng(30 + n)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"x": r(2, 4 * n, 12, 6), "wd": r(3, 3, 6), "bd": r(6),
            "wc": r(5, 6, 3, 3), "bc": r(5), "wdown": r(7, 6, 4, 4),
            "bdown": r(7), "wup": r(6, 4, 2, 2), "bup": r(4)}


@pytest.fixture(scope="module")
def ranks(jax_cases):
    """{n: (primitive inputs, every rank's results)} for 4 and 2 ranks:
    4 run every case, 2 the primitives and the batch-1 Uformer."""
    blocks, models, _ = jax_cases
    out = {}
    for n, b, m in ((4, blocks, models),
                    (2, {}, {"model": models["model"]})):
        prims = _primitive_inputs(n)
        out[n] = (prims, spawn_ranks(cases.spatial, n, prims, b, m,
                                     timeout_s=120))
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_shifts_and_halos_against_the_whole_batch(ranks, n):
    prims, results = ranks[n]
    x = torch.from_numpy(prims["x"])
    Hs, s = x.shape[1] // n, cases.PRIMITIVE_SHIFT
    whole = {
        "shift": torch.roll(x, -s, dims=1), "unshift": torch.roll(x, s, 1),
        "halo1": torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1)),
        "halo12": torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 2)),
        "halo1_periodic": torch.cat([x[:, -1:], x, x[:, :1]], dim=1)}
    extra = {"shift": 0, "unshift": 0, "halo1": 2, "halo12": 3,
             "halo1_periodic": 2}
    for r, res in enumerate(results):
        for k, ref in whole.items():
            want = ref[:, r * Hs:r * Hs + Hs + extra[k]].numpy()
            np.testing.assert_array_equal(res["primitives"][k], want,
                                          err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_convs_against_torch(ranks, n):
    prims, results = ranks[n]
    whole = cases.unsharded_conv(prims["x"], prims)
    Hs = prims["x"].shape[1] // n
    rows = {"dwconv": Hs, "conv3x3": Hs, "downsample": Hs // 2,
            "upsample": 2 * Hs}
    for r, res in enumerate(results):
        for k, h in rows.items():
            np.testing.assert_allclose(
                res["primitives"][k], whole[k][:, r * h:(r + 1) * h],
                atol=1e-5, rtol=1e-5, err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("name", list(BLOCKS))
def test_sharded_lewin_block_matches_jax(jax_cases, ranks, name):
    _, _, want = jax_cases
    for res in ranks[4][1]:
        np.testing.assert_allclose(res["blocks"][name], want[name],
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n", [4, 2])
def test_sharded_uformer_matches_jax(jax_cases, ranks, n):
    """Every rank gets the whole result; 13 blocks, each one call of the
    attention-block and the LeFF wrappers (plain here), no other kernel."""
    _, _, want = jax_cases
    for res in ranks[n][1]:
        got, plain, exchanges = res["models"]["model"]
        np.testing.assert_allclose(got, want["model"], atol=1e-5, rtol=1e-5)
        assert {k: v for k, v in plain.items() if v} == \
            {"attention_block": 13, "leff": 13}
        assert exchanges["calls"] > 0 and exchanges["bytes"] > 0


def test_sharded_uformer_pad_and_batch_matches_jax(jax_cases, ranks):
    """24 x 28, batch 2, on 4 ranks: levels 0-2 split (10 blocks, kernel 5
    once per image: 20 calls), levels 3-4 replicated (3 blocks, one call
    for both images)."""
    _, _, want = jax_cases
    for res in ranks[4][1]:
        got, plain, _ = res["models"]["pad_batch"]
        assert got.shape == (2, 24, 28, 3)
        np.testing.assert_allclose(got, want["pad_batch"], atol=1e-5,
                                   rtol=1e-5)
        assert {k: v for k, v in plain.items() if v} == \
            {"attention_block": 23, "leff": 13}


@pytest.mark.parametrize("n", [2, 4])
def test_leff_slab_takes_interior_halos_only(ranks, n):
    """The first rank's slab has no row above, the last none below: the
    kernel's own zero ring is the image's edge (4 rows a rank)."""
    rows = [res["slab_rows"] for res in ranks[n][1]]
    assert rows == [[5]] + [[6]] * (n - 2) + [[5]]


def test_tiled_inference_sharded_identity(ranks):
    for res in ranks[4][1]:
        img, out = res["tiled_identity"]
        np.testing.assert_allclose(out, img, atol=1e-6)


def test_group_none_is_the_whole_image():
    """group None (JAX's axis_name None): the block on whole images equals
    the block's own eval forward, its exchanges local rolls and padding."""
    blk = LeWinBlock(16, 2, 8, 4, modulator=True).eval()
    x = torch.randn(2, 16, 24, 16, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        want = blk(x, plain=True)
        got = S.lewin_block_sharded(blk, x, H=16, group=None)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(S.halo_exchange(x, (1, 2), None)[:, 1:-2], x)
    assert torch.equal(S.cyclic_shift_sharded(x, 3, None),
                       torch.roll(x, -3, dims=1))


def test_spatial_path_refuses_what_jax_refuses():
    from uformer_tpu_torch.models import Uformer

    for kw in ({"token_projection": "conv"}, {"token_mlp": "mlp"},
               {"cross_modulator": True}):
        model = Uformer(**dict(SMALL, **kw)).eval()
        with pytest.raises(NotImplementedError, match="spatial path"):
            S.run_uformer_spatially_sharded(model, torch.rand(1, 32, 32, 3),
                                            None)
