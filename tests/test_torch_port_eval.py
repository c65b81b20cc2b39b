"""The port's eval layer (`uformer_tpu_torch.eval`, `convert.load_pth`,
`Restorer.numpy`) against the JAX package's (`uformer_tpu.eval`,
`convert_checkpoint`, `load_params`, `scripts/_common.py`'s restorer), on
the same seeded numpy inputs.

- Metrics: every function, numpy on both sides: equal (tolerance 0).
- Padding: the pad functions on numpy and torch inputs, and
  `tiled_inference` at the three configurations of tests/test_eval.py:
  equal.
- Checkpoints: a reference-format `.pth` (`module.` prefix) of the small
  Uformer: `load_pth` gives exactly JAX's `convert_checkpoint` ->
  `state_dict_from_jax` arrays; the port model loaded from it matches JAX
  `load_params` on the jnp path within 1e-4 (fp32) at 128 x 384.
- SIDD through the port's CLI (`--device cpu --arch Uformer_T`) against
  JAX `run_sidd_eval`: Idenoised.mat within 1e-4, PSNR 1e-3 dB, SSIM 1e-5.
- GoPro (per-side and square padding), DND (identity restorer, 50 x 20
  crops), RealBlur's scorer: port against JAX.
- Uformer_B at train_ps 128 on a 256^2 input dispatches 6 stage, 4
  attention-image and 4 LeFF calls, its bottleneck unshifted.
- The CLI's refusals: --mesh_data without its process group of ranks
  (the sharded CLI itself: tests/test_torch_port_parallel.py), an orbax
  directory, a token
  projection or MLP the named archs do not have, --device cuda without a
  card; an fp32 restorer runs with TF32 off and puts the caller's flags
  back.

The JAX package is imported inside the tests (the card's machine has no
flax). The `gpu` test runs the SIDD CLI on the card at 1 x 4 blocks of
256^2, fp32 and bf16, against the plain path; run it there with
`python -m pytest -m gpu tests/test_torch_port_eval.py`.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio
import torch

from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import load_checkpoint, load_pth
from uformer_tpu_torch.eval import cli, metrics, padding
from uformer_tpu_torch.eval import dnd as pdnd
from uformer_tpu_torch.eval import gopro_hide as pgopro
from uformer_tpu_torch.eval import realblur as prealblur
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.ops import kernels as K
from uformer_tpu_torch.restore import Restorer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
SMALL = dict(img_size=128, embed_dim=8, depths=(1, 2, 1, 1, 1, 2, 1, 1, 1),
             num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), win_size=8,
             modulator=True)
MAIN_PATH = {"stage": 6, "attention_image": 4, "leff": 4}


def _golden():
    """tests/golden/generate.py, loaded by path (a site package named
    `tests` may shadow this directory)."""
    spec = importlib.util.spec_from_file_location(
        "golden_generate", REPO / "tests" / "golden" / "generate.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def _write_pth(model: torch.nn.Module, seed: int, path: Path,
               wrapped: bool = True) -> Path:
    """Seeded numpy weights over the model's parameter names (the golden
    rule), saved as a reference checkpoint: {'epoch', 'state_dict' with the
    DataParallel `module.` prefix, 'optimizer'}, or a bare state_dict."""
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    sd = _golden().seeded_state_dict(keys_shapes, seed)
    if wrapped:
        obj = {"epoch": 1, "optimizer": {},
               "state_dict": {"module." + k: torch.from_numpy(v)
                              for k, v in sd.items()}}
    else:
        obj = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save(obj, path)
    return path


def _write_sidd(root: Path, n_img: int, n_blk: int, size: int,
                seed: int = 7) -> Path:
    """A SIDD validation pair in the layout of sidd.py: uint8 (n_img,
    n_blk, size, size, 3) clean blocks and noisy = clean + N(0, 0.08^2)."""
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0, 1, (n_img, n_blk, size, size, 3))
    noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1)
    root.mkdir(parents=True, exist_ok=True)
    sio.savemat(root / "ValidationGtBlocksSrgb.mat",
                {"ValidationGtBlocksSrgb": np.uint8(np.round(clean * 255))})
    sio.savemat(root / "ValidationNoisyBlocksSrgb.mat",
                {"ValidationNoisyBlocksSrgb":
                 np.uint8(np.round(noisy * 255))})
    return root


def _jax_restorer(model, params):
    """scripts/_common.py's restorer: jitted clip(model.apply) on jnp."""
    import jax
    import jax.numpy as jnp

    fwd = jax.jit(lambda p, x: jnp.clip(model.apply(p, x), 0.0, 1.0))
    return lambda x: fwd(params, jnp.asarray(x, jnp.float32))


# ---- metrics -----------------------------------------------------------

def _imgs(seed, shape=(48, 64, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    return a, b


METRIC_CASES = {
    "psnr_clamped": lambda m, a, b: m.psnr_clamped(a * 1.2 - 0.1, b),
    "batch_psnr_mean": lambda m, a, b: m.batch_psnr(
        np.stack([a, b]), np.stack([b, a])),
    "batch_psnr_sum": lambda m, a, b: m.batch_psnr(
        np.stack([a, b, a]), np.stack([b, a, a * 0.9]), average=False),
    "psnr_255": lambda m, a, b: m.psnr_255(a * 255, b * 255),
    "psnr_255_crop_y": lambda m, a, b: m.psnr_255(
        a * 255, b * 255, crop_border=4, test_y_channel=True),
    "ssim_255_float": lambda m, a, b: m.ssim_255(a, b),
    "ssim_255_uint8_crop": lambda m, a, b: m.ssim_255(
        np.uint8(a * 255), np.uint8(b * 255), crop_border=3),
    "ssim_255_gray": lambda m, a, b: m.ssim_255(a[..., 0], b[..., 0]),
    "ssim_uniform_dr1": lambda m, a, b: m.ssim_uniform(a, b),
    "ssim_uniform_dr2": lambda m, a, b: m.ssim_uniform(a, b, data_range=2.0),
    "ssim_uniform_gray_win5": lambda m, a, b: m.ssim_uniform(
        a[..., 1], b[..., 1], win_size=5),
    "ssim_gaussian_map": lambda m, a, b: m.ssim_gaussian_map(a, b),
    "ssim_gaussian_map_gray": lambda m, a, b: m.ssim_gaussian_map(
        a[..., 2], b[..., 2], data_range=2.0),
    "sidd_psnr": lambda m, a, b: m.sidd_psnr(a, b),
    "sidd_psnr_equal": lambda m, a, b: m.sidd_psnr(a, a),
    "sidd_ssim": lambda m, a, b: m.sidd_ssim(a, b),
    "psnr_b": lambda m, a, b: m.psnr_b(a * 255, b * 255),
    "psnr_b_gray": lambda m, a, b: m.psnr_b(a[..., 0] * 255,
                                            b[..., 0] * 255),
    "rgb2ycbcr": lambda m, a, b: m.rgb2ycbcr(a),
    "rgb2ycbcr_y": lambda m, a, b: m.rgb2ycbcr(b, y_only=True),
}


def _flat(v):
    if isinstance(v, tuple):
        return [np.asarray(u) for u in v]
    return [np.asarray(v)]


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_match_jax(case):
    from uformer_tpu.eval import metrics as jm

    a, b = _imgs(0)
    got, want = (METRIC_CASES[case](m, a, b) for m in (metrics, jm))
    for g, w in zip(_flat(got), _flat(want), strict=True):
        np.testing.assert_array_equal(g, w)


def test_psnr_on_torch_tensors():
    """psnr_clamped and batch_psnr take torch tensors where JAX's take jnp:
    the same values as numpy, within float32 rounding."""
    a, b = _imgs(1, (3, 32, 40, 3))
    x, y = torch.from_numpy(a * 1.3 - 0.1), torch.from_numpy(b)
    got = metrics.psnr_clamped(x, y)
    assert isinstance(got, torch.Tensor)
    assert float(got) == pytest.approx(
        float(metrics.psnr_clamped(a * 1.3 - 0.1, b)), abs=1e-4)
    assert float(metrics.batch_psnr(x, y, average=False)) == pytest.approx(
        float(metrics.batch_psnr(a * 1.3 - 0.1, b, average=False)),
        abs=1e-3)


# ---- padding and tiling -------------------------------------------------

@pytest.mark.parametrize("factor", [32, 128])
@pytest.mark.parametrize("as_torch", [False, True])
def test_padding_matches_jax(factor, as_torch):
    from uformer_tpu.eval import padding as jp

    img = np.random.default_rng(2).uniform(0, 1, (2, 40, 72, 3)) \
        .astype(np.float32)
    x = torch.from_numpy(img) if as_torch else img
    sq, mask = padding.expand2square(x, factor)
    jsq, jmask = jp.expand2square(img, factor)
    pm, orig = padding.pad_to_multiple(x, factor)
    jpm, jorig = jp.pad_to_multiple(img, factor)
    assert type(sq) is type(x) and type(pm) is type(x)
    for g, w in ((sq, jsq), (mask, jmask), (pm, jpm),
                 (padding.unexpand(sq, (40, 72), factor),
                  jp.unexpand(jsq, (40, 72), factor)),
                 (padding.unpad(pm, orig), jp.unpad(jpm, jorig))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert orig == jorig == (40, 72)
    np.testing.assert_array_equal(np.asarray(padding.unpad(pm, orig)), img)


def _box_blur(x):
    from scipy.ndimage import uniform_filter

    return np.stack([
        np.stack([uniform_filter(x[b, ..., c], 5) for c in range(3)], -1)
        for b in range(x.shape[0])])


TILED = {  # tests/test_eval.py:132-152,267-284
    "identity": ((1, 100, 180, 3), lambda x: x, dict(tile=64, overlap=16,
                                                      factor=32)),
    "box_blur": ((1, 96, 160, 3), _box_blur, dict(tile=64, overlap=16,
                                                  factor=32)),
    "batched_nonsquare": ((2, 200, 360, 3), lambda x: x * 0.5 + 0.1,
                          dict(tile=64, overlap=16, factor=32,
                               tile_batch=3)),
}


@pytest.mark.parametrize("case", sorted(TILED))
def test_tiled_inference_matches_jax(case):
    from uformer_tpu.eval import padding as jp

    shape, fn, kw = TILED[case]
    img = np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
    calls, jcalls = [], []

    def rec(log):
        return lambda x: (log.append(x.shape), fn(x))[1]

    got = padding.tiled_inference(rec(calls), img, **kw)
    want = jp.tiled_inference(rec(jcalls), img, **kw)
    np.testing.assert_array_equal(got, want)
    assert calls == jcalls


# ---- checkpoints --------------------------------------------------------

@pytest.mark.parametrize("wrapped", [True, False])
def test_load_pth_matches_jax_converter(tmp_path, wrapped):
    from uformer_tpu.convert import convert_checkpoint
    from uformer_tpu_torch.convert import state_dict_from_jax

    path = _write_pth(Uformer(**SMALL), 11, tmp_path / "w.pth", wrapped)
    got = load_pth(str(path))
    want = state_dict_from_jax(convert_checkpoint(str(path), "Uformer_B"))
    # the converter adds the relative_position_index buffers, which a
    # parameter-only checkpoint lacks
    want = {k: v for k, v in want.items()
            if not k.endswith("relative_position_index")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_checkpoint_model_matches_jax_load_params(tmp_path):
    import jax
    import jax.numpy as jnp

    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.checkpoints import load_params

    path = str(_write_pth(Uformer(**SMALL), 12, tmp_path / "w.pth"))
    x = np.random.default_rng(3).uniform(0, 1, (1, 128, 384, 3)) \
        .astype(np.float32)
    jmodel = JaxUformer(attn_backend="jnp", **SMALL)
    want = np.asarray(jax.jit(jmodel.apply)(
        jax.tree_util.tree_map(jnp.asarray, load_params(path)),
        jnp.asarray(x)))
    port = load_checkpoint(Uformer(**SMALL), path).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL


# ---- harnesses ----------------------------------------------------------

def test_sidd_cli_matches_jax(tmp_path):
    from uformer_tpu import get_arch as jax_get_arch
    from uformer_tpu.eval.sidd import run_sidd_eval
    from uformer_tpu.train.checkpoints import load_params

    data = _write_sidd(tmp_path / "sidd", 1, 2, 128)
    pth = str(_write_pth(get_arch({"arch": "Uformer_T"}), 1235,
                         tmp_path / "t.pth"))
    got = cli.main(["sidd", "--input_dir", str(data), "--result_dir",
                    str(tmp_path / "port"), "--weights", pth, "--arch",
                    "Uformer_T", "--device", "cpu"])
    jmodel = jax_get_arch({"arch": "Uformer_T", "train_ps": 128,
                           "attn_backend": "jnp"})
    want = run_sidd_eval(_jax_restorer(jmodel, load_params(pth,
                                                           "Uformer_T")),
                         str(data), str(tmp_path / "jax"))
    out, jout = (sio.loadmat(tmp_path / d / "Idenoised.mat")["Idenoised"]
                 for d in ("port", "jax"))
    assert out.shape == (1, 2, 128, 128, 3) and out.dtype == np.float32
    assert np.abs(out - jout).max() <= TOL
    assert got[0] == pytest.approx(want[0], abs=1e-3)
    assert got[1] == pytest.approx(want[1], abs=1e-5)
    assert (tmp_path / "port" / "psnr_ssim.txt").exists()


@pytest.mark.parametrize("n_img, n_blk, side", [(2, 3, 16), (1, 1, 8)])
def test_sidd_layout_matches_jax(tmp_path, n_img, n_blk, side):
    """The port's loaders give JAX's values in row-major order, and its
    submission holds JAX's values (written column-major, as savemat
    does)."""
    from uformer_tpu.eval import sidd as js
    from uformer_tpu_torch.eval import sidd as ps

    data = _write_sidd(tmp_path, n_img, n_blk, side)
    for load in ("load_sidd_val_noisy", "load_sidd_val_gt"):
        got, want = getattr(ps, load)(str(data)), getattr(js, load)(
            str(data))
        assert got.flags.c_contiguous and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    ps.save_sidd_submission(got, str(tmp_path / "port"))
    js.save_sidd_submission(want, str(tmp_path / "jax"))
    got, want = (sio.loadmat(tmp_path / d / "Idenoised.mat")["Idenoised"]
                 for d in ("port", "jax"))
    np.testing.assert_array_equal(got, want)


def _write_pairs(root: Path, n: int, h: int, w: int, seed: int = 9):
    """GoPro's layout: <root>/groundtruth and <root>/input PNGs."""
    import cv2

    rng = np.random.default_rng(seed)
    for sub in ("groundtruth", "input"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        gt = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        blur = cv2.blur(gt, (5, 5))
        cv2.imwrite(str(root / "groundtruth" / f"{i:03d}.png"), gt)
        cv2.imwrite(str(root / "input" / f"{i:03d}.png"), blur)
    return root


def _log_numbers(path: Path):
    return [float(v) for v in re.findall(r"[-\d.]+(?=[,\]])",
                                         path.read_text())]


@pytest.mark.parametrize("square_pad", [False, True])
def test_gopro_matches_jax(tmp_path, square_pad):
    cv2 = pytest.importorskip("cv2")
    import jax.numpy as jnp

    from uformer_tpu.eval.gopro_hide import run_gopro_eval
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.checkpoints import load_params

    data = _write_pairs(tmp_path / "gopro", 2, 136, 200)
    pth = str(_write_pth(Uformer(**SMALL), 13, tmp_path / "w.pth"))
    fn = Restorer(load_checkpoint(Uformer(**SMALL), pth), torch.float32,
                  "cpu").numpy
    got = pgopro.run_gopro_eval(fn, str(data), str(tmp_path / "port"),
                                square_pad=square_pad)
    jfn = _jax_restorer(JaxUformer(attn_backend="jnp", dtype=jnp.float32,
                                   **SMALL), load_params(pth))
    want = run_gopro_eval(jfn, str(data), str(tmp_path / "jax"),
                          square_pad=square_pad)
    assert got[0] == pytest.approx(want[0], abs=1e-3)
    assert got[1] == pytest.approx(want[1], abs=1e-5)
    # the log prints 4 decimals: its values agree to the last printed one
    logs = [_log_numbers(tmp_path / d / "psnr_ssim.txt")
            for d in ("port", "jax")]
    assert len(logs[0]) == len(logs[1]) == 6
    np.testing.assert_allclose(logs[0], logs[1], rtol=0, atol=1.01e-4)
    for name in ("000", "001"):
        a, b = (cv2.imread(str(tmp_path / d / f"{name}.png")).astype(int)
                for d in ("port", "jax"))
        assert a.shape == (136, 200, 3)
        assert np.abs(a - b).max() <= 1


def test_dnd_bundles_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from uformer_tpu.eval.dnd import run_dnd_eval

    rng = np.random.default_rng(4)
    src = tmp_path / "dnd"
    src.mkdir()
    for i in range(50):
        for bb in range(20):
            cv2.imwrite(str(src / f"{i + 1:04d}_{bb + 1:02d}.png"),
                        rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    n = pdnd.run_dnd_eval(lambda x: x, str(src), str(tmp_path / "port"),
                          save_images=False)
    assert n == run_dnd_eval(lambda x: x, str(src), str(tmp_path / "jax"),
                             save_images=False) == 1000
    for i in range(50):
        got, want = (sio.loadmat(tmp_path / d / "matfile" / "bundled"
                                 / f"{i + 1:04d}.mat")
                     for d in ("port", "jax"))
        assert got["israw"].item() == want["israw"].item() == 0
        assert str(got["eval_version"][0]) == "1.0"
        for bb in range(20):
            g, w = got["Idenoised"][0, bb], want["Idenoised"][0, bb]
            assert g.shape == (16, 16, 3) and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def _shifted_pair(tmp_path):
    """A smooth image and its copy shifted by 2 px and dimmed: ECC must
    find the shift."""
    import cv2

    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(6)
    gt = gaussian_filter(rng.uniform(0, 1, (96, 128, 3)), (3, 3, 0))
    gt = (gt - gt.min()) / (gt.max() - gt.min())
    prd = np.roll(gt, (2, 1), axis=(0, 1)) * 0.9
    paths = []
    for name, im in (("gt", gt), ("prd", prd)):
        p = str(tmp_path / f"{name}.png")
        cv2.imwrite(p, cv2.cvtColor(np.uint8(np.round(im * 255)),
                                    cv2.COLOR_RGB2BGR))
        paths.append(p)
    return tuple(paths)


def test_realblur_scorer_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from uformer_tpu.eval import realblur as jr

    pair = _shifted_pair(tmp_path)
    tar, prd = (prealblur.load_img(p) for p in pair)
    rng = np.random.default_rng(8)
    mask = np.float32(rng.uniform(0, 1, tar.shape) > 0.1)
    assert prealblur.masked_psnr(tar, prd * mask, mask) \
        == jr.masked_psnr(tar, prd * mask, mask)
    assert prealblur.masked_ssim(tar, prd, mask) \
        == jr.masked_ssim(tar, prd, mask)
    got, want = prealblur.score_pair(pair), jr.score_pair(pair)
    assert got == want
    assert got[0] > 25.0  # aligned: the 2 px shift is found


def test_realblur_pool_spawns(tmp_path):
    """score_realblur's pool spawns its workers (no fork of a process that
    may hold a CUDA context): the mean of score_pair over the pairs."""
    pytest.importorskip("cv2")
    pair = _shifted_pair(tmp_path)
    got = prealblur.score_realblur([pair, pair[::-1]], workers=2)
    want = [prealblur.score_pair(p) for p in (pair, pair[::-1])]
    assert got == pytest.approx(tuple(np.mean(want, axis=0)), abs=1e-12)


# ---- routing and the CLI's refusals -------------------------------------

def test_uformer_b_eval_routing():
    """The eval CLI's model: Uformer_B at train_ps 128 on a 256^2 input.
    Its bottleneck, configured at 8^2, runs unshifted at 16^2; the forward
    dispatches 6 stage, 4 attention-image and 4 LeFF calls (their plain
    versions on the CPU, launching nothing)."""
    model = get_arch({"arch": "Uformer_B", "train_ps": 128})
    assert model.conv.use_shift is False
    restorer = Restorer(model, torch.float32, "cpu")
    K.reset_counts()
    y = restorer.numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 256, 256, 3)).astype(np.float32))
    assert y.shape == (1, 256, 256, 3) and y.dtype == np.float32
    assert np.isfinite(y).all() and y.min() >= 0 and y.max() <= 1
    plain = {k: v for k, v in K.plain_counts().items() if v}
    assert plain == MAIN_PATH
    assert not any(K.launch_counts().values())


def _cli_args(tmp_path, *extra):
    return ["sidd", "--input_dir", str(tmp_path), "--result_dir",
            str(tmp_path / "out"), *extra]


@pytest.mark.parametrize("extra, error, item", [
    # --mesh_data runs since the data mesh was ported; without its process
    # group of ranks it raises (the case keeps its id)
    pytest.param(["--weights", "w.pth", "--mesh_data", "2", "--tile",
                  "256"], ValueError, "process group of 2 ranks",
                 id="extra0-NotImplementedError-queue 1 item 4"),
    # an orbax directory: the message names the route to a .pth
    (["--weights", "checkpoints/model_best"], ValueError,
     "torch_exporter.py:save_torch_checkpoint")])
def test_cli_refuses_what_waits(tmp_path, extra, error, item):
    with pytest.raises(error, match=item):
        cli.main(_cli_args(tmp_path, "--device", "cpu", *extra))


@pytest.mark.parametrize("extra", [["--token_projection", "conv"],
                                   ["--token_mlp", "mlp"]])
def test_cli_refuses_other_token_variants(tmp_path, extra):
    """The named archs fix the linear projection and the LeFF (the
    reference's get_arch; the JAX registry too): another value raises."""
    with pytest.raises(ValueError, match="fixes linear / leff"):
        cli.main(_cli_args(tmp_path, "--device", "cpu", "--weights",
                           "w.pth", *extra))


def test_cli_fp32_restorer_scopes_tf32(tmp_path):
    """An fp32 restorer runs its model with TF32 off for matmuls and cuDNN
    and leaves the process's flags as it found them."""
    torch.set_num_threads(1)
    pth = str(_write_pth(get_arch({"arch": "Uformer_T"}), 1, tmp_path
                         / "t.pth"))
    args = cli.eval_argparser().parse_args(_cli_args(
        tmp_path, "--device", "cpu", "--arch", "Uformer_T", "--weights",
        pth))
    fn = cli.build_restorer(args)
    seen = []
    fn.__wrapped__.__self__.model.register_forward_pre_hook(
        lambda *_: seen.append((torch.backends.cuda.matmul.allow_tf32,
                                torch.backends.cudnn.allow_tf32)))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        fn(np.zeros((1, 128, 128, 3), np.float32))
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert seen == [(False, False)]
    assert after == (True, True)


def test_cli_cuda_without_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pth = str(_write_pth(get_arch({"arch": "Uformer_T"}), 1, tmp_path
                         / "t.pth"))
    with pytest.raises(RuntimeError, match="never falls back"):
        cli.main(_cli_args(tmp_path, "--weights", pth))


# ---- on the card --------------------------------------------------------

@pytest.mark.gpu
def test_sidd_cli_on_card(tmp_path, monkeypatch):
    """The SIDD CLI on the card (Uformer_B, train_ps 128, seeded weights)
    at 1 x 4 blocks of 256^2: fp32 within 1e-4 (1 + max|ref|) of the fp32
    plain path; bf16's error against it within 1.5x the bf16 plain path's
    + 1e-3; 6/4/4 launches per request and no plain call. The same rules
    hold the model's output before the clamp (most of the seeded model's
    output lies outside [0, 1])."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run on sm_90a only)")
    data = _write_sidd(tmp_path / "sidd", 1, 4, 256)
    pth = str(_write_pth(get_arch({"arch": "Uformer_B"}), 1234,
                         tmp_path / "b.pth"))
    noisy = np.float32(sio.loadmat(data / "ValidationNoisyBlocksSrgb.mat")[
        "ValidationNoisyBlocksSrgb"][0]) / 255.0
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    out, raw, plain, plain_raw = {}, {}, {}, {}
    x = torch.from_numpy(noisy).cuda()
    for dt in ("float32", "bfloat16"):
        K.reset_counts()
        psnr, _ = cli.main(["sidd", "--input_dir", str(data), "--result_dir",
                            str(tmp_path / dt), "--weights", pth,
                            "--dtype", dt])
        assert np.isfinite(psnr)
        counts = K.launch_counts()
        assert {k: v for k, v in counts.items() if v} == MAIN_PATH
        assert not any(K.plain_counts().values())
        out[dt] = sio.loadmat(tmp_path / dt / "Idenoised.mat")[
            "Idenoised"][0]
        model = Restorer(load_checkpoint(get_arch({"arch": "Uformer_B"}),
                                         pth), getattr(torch, dt)).model
        with torch.no_grad():
            raw[dt] = model(x).float().cpu().numpy()
            plain_raw[dt] = model(x, plain=True).float().cpu().numpy()
        plain[dt] = np.clip(plain_raw[dt], 0, 1)
    for got, want in ((out, plain), (raw, plain_raw)):
        ref = want["float32"]
        assert np.abs(got["float32"] - ref).max() \
            <= TOL * (1 + np.abs(ref).max())
        e_plain = np.abs(want["bfloat16"] - ref).max()
        assert np.abs(got["bfloat16"] - ref).max() <= 1.5 * e_plain + 1e-3
