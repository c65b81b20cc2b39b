"""The port's training entry point against the JAX package, on the CPU.

- `config.Options`: the JAX fields and defaults, plus `device`; the
  reference recipe lines parse to the same values.
- The datasets on one PNG directory and one seed, numpy plane: equal
  bits to JAX's (`__getitem__`, `get_batch`, two epochs of
  `batch_iterator`; the val center crop; the input-only set). The native
  (C++) plane built from `native/augment.cpp` against the numpy plane.
- `generate_patches_sidd`: the same files with the same bytes as JAX's.
- Checkpoints: the reference `.pth` loads with weights_only=True, JAX's
  `load_params` reads it, and `state_dict_from_jax` of that equals the
  port's state_dict bit for bit; the AdamW state survives the round trip.
- The Trainer end to end (2 epochs, resume at epoch 3) with the
  reference's log lines; resume restores the step, the MixUp gate and
  the LR; `validate` pads 40 x 56 images and gives JAX `Trainer.validate`'s
  PSNR within 1e-3 dB on the same weights.
- `prefetch_to_device` on the CPU: order, and a producer's exception
  raised in the consumer (the JAX prefetch ends the epoch without a word).
- The registry, trainer and CLI: Uformer at embed 8, window 2 builds; a
  mesh, gradient checkpointing and a missing card raise.

Tiny geometry throughout: Uformer, embed 8, window 2, 32^2 patches,
batch 2 (as tests/test_data_and_trainer.py).
"""

import dataclasses
import argparse
import filecmp
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uformer_tpu.config as jconfig
import uformer_tpu.data.datasets as jds
from uformer_tpu_torch import config as pconfig
from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.data import datasets as pds
from uformer_tpu_torch.data import native
from uformer_tpu_torch.train import checkpoints as pckpt
from uformer_tpu_torch.train import cli
from uformer_tpu_torch.train.train_step import make_optimizer, \
    make_train_step
from uformer_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
TINY = dict(arch="Uformer", embed_dim=8, win_size=2, train_ps=32,
            batch_size=2, workers=2, dtype="float32", pretrain_weights="")
PSNR_TOL_DB = 1e-3


def _write_png(path, arr):
    import cv2

    cv2.imwrite(str(path), cv2.cvtColor(
        np.uint8(np.clip(arr, 0, 1) * 255), cv2.COLOR_RGB2BGR))


@pytest.fixture(scope="module")
def paired_dir(tmp_path_factory):
    """6 pairs of 48 x 64, input = ground truth + 0.05 (the JAX tests'
    fixture)."""
    root = tmp_path_factory.mktemp("paired")
    rng = np.random.default_rng(0)
    (root / "groundtruth").mkdir()
    (root / "input").mkdir()
    for i in range(6):
        gt = rng.uniform(0, 1, (48, 64, 3))
        _write_png(root / "groundtruth" / f"{i}.png", gt)
        _write_png(root / "input" / f"{i}.png", np.clip(gt + 0.05, 0, 1))
    return root


def _equal_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# ------------------------------------------------------------------ options

def test_options_fields_and_defaults_match_jax():
    port = {f.name: (f.type, f.default)
            for f in dataclasses.fields(pconfig.Options)}
    jax_ = {f.name: (f.type, f.default)
            for f in dataclasses.fields(jconfig.Options)}
    assert port.pop("device") == ("str", "cuda")
    assert port == jax_


RECIPES = [
    "--arch Uformer_B --batch_size 32 --gpu 0 --train_ps 128 --env "
    "32_0705_1 --embed_dim 32 --warmup --mode denoising",
    "--arch Uformer_B --batch_size 8 --train_ps 256 --nepoch 3000 "
    "--checkpoint 500 --dataset GoPro --warmup --mode deblurring",
    "--warmup --no-warmup --resume --mesh_data 4 --lr_initial 3e-4",
    ""]


@pytest.mark.parametrize("line", RECIPES)
def test_recipe_lines_parse_as_in_jax(line):
    def parse(mod):
        p = argparse.ArgumentParser()
        mod.add_options_to_parser(p)
        return dataclasses.asdict(mod.options_from_args(
            p.parse_args(line.split())))

    port = parse(pconfig)
    assert port.pop("device") == "cuda"
    assert port == parse(jconfig)


# ------------------------------------------------------------------ data

def test_train_dataset_equals_jax(paired_dir):
    """__getitem__, get_batch and two epochs of batch_iterator on the
    numpy plane, one seed: equal bits."""
    def pair(seed):
        return (jds.PairedTrainDataset(str(paired_dir), patch_size=32,
                                       seed=seed, native=False),
                pds.PairedTrainDataset(str(paired_dir), patch_size=32,
                                       seed=seed, native=False))

    j, p = pair(3)
    for i in range(len(j)):
        assert all(_equal_bits(a, b) for a, b in zip(j[i], p[i]))
    j, p = pair(4)
    for idx in ([0, 3, 5, 1], [2, 2, 4, 0]):
        assert all(_equal_bits(a, b)
                   for a, b in zip(j.get_batch(idx), p.get_batch(idx)))
    j, p = pair(1234)
    for epoch in (1, 2):
        jb = list(jds.batch_iterator(j, 2, seed=1234 + epoch))
        pb = list(pds.batch_iterator(p, 2, seed=1234 + epoch))
        assert len(jb) == len(pb) == 3
        for a, b in zip(jb, pb):
            assert a.keys() == b.keys()
            assert all(_equal_bits(a[k], b[k]) for k in a)
    for ds in (j, p):
        ds.close()


def test_getitem_datasets_through_batch_iterator_equal_jax(paired_dir):
    """A dataset without get_batch goes through the sample pool, in the
    same order, with the same draws."""
    class NoBatch:
        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            return self.ds[i]

    # one worker: the draws then follow the index order in both
    j = NoBatch(jds.PairedTrainDataset(str(paired_dir), 32, seed=9,
                                       native=False))
    p = NoBatch(pds.PairedTrainDataset(str(paired_dir), 32, seed=9,
                                       native=False))
    for a, b in zip(jds.batch_iterator(j, 3, seed=2, num_threads=1),
                    pds.batch_iterator(p, 3, seed=2, num_threads=1)):
        assert all(_equal_bits(a[k], b[k]) for k in a)


@pytest.mark.parametrize("crop", [None, 32])
def test_val_dataset_equals_jax(paired_dir, crop):
    j = jds.PairedValDataset(str(paired_dir), center_crop=crop)
    p = pds.PairedValDataset(str(paired_dir), center_crop=crop)
    assert len(j) == len(p) == 6
    for i in range(6):
        (jg, jn, jname), (pg, pn, pname) = j[i], p[i]
        assert jname == pname == str(i)
        assert _equal_bits(jg, pg) and _equal_bits(jn, pn)
        assert pg.shape == ((crop, crop, 3) if crop else (48, 64, 3))


def test_input_only_and_factories_equal_jax(paired_dir):
    j = jds.get_test_data(str(paired_dir / "input"))
    p = pds.get_test_data(str(paired_dir / "input"))
    assert len(j) == len(p) == 6
    for i in range(6):
        assert _equal_bits(j[i][0], p[i][0]) and j[i][1] == p[i][1]
    assert pds.get_training_data(str(paired_dir), {"patch_size": 16}).ps == 16
    assert pds.get_validation_data(str(paired_dir)).center_crop is None
    assert pds.get_validation_deblur_data(
        str(paired_dir), {"patch_size": 32}).center_crop == 32


def test_train_dataset_refuses_an_empty_directory(tmp_path):
    with pytest.raises(ValueError, match="no paired data"):
        pds.PairedTrainDataset(str(tmp_path))


def test_native_plane_against_the_numpy_plane(paired_dir):
    """The C++ plane (built from native/augment.cpp into the port's
    _build/, never under native/) crops and turns exactly as the numpy
    plane, on the same draws. It normalises by multiplying by the float32
    reciprocal of 255 where numpy divides: its values are equal bits to
    that product, and within one float32 ulp of the numpy plane's."""
    import cv2

    so = native.library_path()
    assert native.native_available()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "uformer_tpu_torch"
    nat = pds.PairedTrainDataset(str(paired_dir), 32, seed=5, native=True)
    num = pds.PairedTrainDataset(str(paired_dir), 32, seed=5, native=False)
    assert pds.PairedTrainDataset(str(paired_dir), 32).use_native
    idx = [0, 5, 2, 3, 1, 4]
    g1, n1 = nat.get_batch(idx)
    g2, n2 = num.get_batch(idx)
    rng = np.random.default_rng(5)
    inv = np.float32(1) / np.float32(255)
    for j, i in enumerate(idx):
        r = int(rng.integers(0, 48 - 32 + 1))
        c = int(rng.integers(0, 64 - 32 + 1))
        k = int(rng.integers(0, 8))
        for sub, got in (("groundtruth", g1), ("input", n1)):
            u8 = cv2.cvtColor(cv2.imread(str(paired_dir / sub / f"{i}.png")),
                              cv2.COLOR_BGR2RGB)
            want = pds._apply_dihedral(u8[r:r + 32, c:c + 32], k) \
                .astype(np.float32) * inv
            assert _equal_bits(got[j], want), (sub, i, k)
    for a, b in ((g1, g2), (n1, n2)):
        ulps = np.abs(a.view(np.int32) - b.view(np.int32))
        assert a.shape == b.shape == (6, 32, 32, 3) and ulps.max() <= 1
    for ds in (nat, num):
        ds.close()


def test_native_refuses_a_crop_outside_the_image():
    img = np.zeros((40, 40, 3), np.uint8)
    with pytest.raises(ValueError, match="outside"):
        native.augment_pair_batch([img], [img], 32, np.array([9]),
                                  np.array([0]), np.array([0]))


def test_generate_patches_equal_jax(tmp_path):
    import cv2

    from uformer_tpu.data.patches import generate_patches_sidd as jgen
    from uformer_tpu_torch.data.patches import main

    rng = np.random.default_rng(0)
    for s in range(2):
        scene = tmp_path / "src" / f"000{s}_scene"
        scene.mkdir(parents=True)
        for n in (f"000{s}_GT_SRGB_010.PNG", f"000{s}_NOISY_SRGB_010.PNG"):
            cv2.imwrite(str(scene / n),
                        np.uint8(rng.uniform(0, 255, (80, 72, 3))))
    assert jgen(str(tmp_path / "src"), str(tmp_path / "j"), ps=32,
                num_patches=3, num_cores=2) == 6
    assert main(["--src_dir", str(tmp_path / "src"), "--tar_dir",
                 str(tmp_path / "p"), "--ps", "32", "--num_patches", "3",
                 "--num_cores", "2"]) == 6
    for sub in ("groundtruth", "input"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "p" / sub))
        assert len(names) == 6
        _, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "j" / sub, tmp_path / "p" / sub, names, shallow=False)
        assert mismatch == errors == []


# ------------------------------------------------------------------ prefetch

def test_prefetch_on_the_cpu_keeps_order():
    batches = [{"input": np.full((2, 4, 4, 3), i, np.float32),
                "target": np.full((2, 4, 4, 3), -i, np.float32)}
               for i in range(7)]
    got = list(pds.prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(got) == 7
    for i, b in enumerate(got):
        assert isinstance(b["input"], torch.Tensor)
        assert torch.equal(b["input"], torch.full((2, 4, 4, 3), float(i)))
        assert torch.equal(b["target"], torch.full((2, 4, 4, 3), -float(i)))


def test_prefetch_raises_the_producers_exception():
    """Divergence from the JAX prefetch, which ends the epoch early
    without a word: the batches before the fault arrive, then its
    exception."""
    def source():
        for i in range(3):
            yield {"input": np.full((1, 2), i, np.float32)}
        raise OSError("decode failed")

    seen = []
    with pytest.raises(OSError, match="decode failed"):
        for b in pds.prefetch_to_device(source(), "cpu"):
            seen.append(float(b["input"][0, 0]))
    assert seen == [0.0, 1.0, 2.0]


def test_prefetch_stops_its_thread_when_the_consumer_stops():
    def endless():
        i = 0
        while True:
            yield {"input": np.full((1,), i, np.float32)}
            i += 1

    it = pds.prefetch_to_device(endless(), "cpu", size=1)
    assert float(next(it)["input"][0]) == 0.0
    it.close()
    assert not any(t.name == "prefetch_to_device" and t.is_alive()
                   for t in threading.enumerate())


# ------------------------------------------------------------------ checkpoints

def _tiny_model():
    return get_arch({"arch": "Uformer", "embed_dim": 8, "win_size": 2,
                     "train_ps": 32})


def _one_step(model, seed=0):
    opt = make_optimizer(model.parameters(), lambda s: 2e-4)
    step = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=4)
    from uformer_tpu_torch.train.train_step import TrainState

    state = TrainState(model, opt)
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(2, 32, 32, 3, generator=g)
    step(state, {"input": x, "target": x}, g)
    return state


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_roundtrip_and_jax_load_params(tmp_path, async_save):
    from uformer_tpu.train.checkpoints import load_params as jload_params

    torch.manual_seed(0)
    model = _tiny_model()
    state = _one_step(model)
    path = pckpt.save_checkpoint(str(tmp_path), "model_best", 3,
                                 model.state_dict(),
                                 state.optimizer.state_dict(), step=7,
                                 async_save=async_save)
    assert path == str(tmp_path / "model_best.pth")
    assert pckpt.load_start_epoch(path) == 3  # waits for the save
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"epoch", "state_dict", "optimizer", "step"}
    assert ckpt["epoch"] == 3 and ckpt["step"] == 7
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in ckpt["state_dict"].items())
    assert set(ckpt["state_dict"]) == set(sd)

    # the AdamW state loads into a fresh optimizer, bit for bit
    fresh = make_optimizer(_tiny_model().parameters(), lambda s: 2e-4)
    saved, epoch = pckpt.load_optim(path)
    assert epoch == 3
    fresh.load_state_dict(saved)
    for a, b in zip(state.optimizer.state.values(), fresh.state.values()):
        assert a.keys() == b.keys() == {"step", "exp_avg", "exp_avg_sq"}
        assert all(torch.equal(a[k], b[k]) for k in a)

    # the JAX package reads the port's file; back through the exporter's
    # mirror it is the port's state_dict, bit for bit
    back = state_dict_from_jax(jload_params(path, "Uformer"))
    assert set(back) == set(sd)
    for k, v in back.items():
        assert _equal_bits(v, sd[k].numpy()), k
    own = pckpt.load_params(path)
    assert all(_equal_bits(v, sd[k].numpy()) for k, v in own.items())
    with pytest.raises(ValueError,
                       match="torch_exporter.py:save_torch_checkpoint"):
        pckpt.load_params(str(tmp_path / "model_best"))


# ------------------------------------------------------------------ trainer

LOG_FORMATS = {
    "start": r"===> Start Epoch \d+ End Epoch \d+",
    "eval": r"\[Ep \d+ it \d+\t PSNR SIDD: \d+\.\d{4}\t\] ----  "
            r"\[best_Ep \d+ best_it \d+ Best_PSNR \d+\.\d{4}\] ",
    "epoch": r"Epoch: \d+\tTime: \d+\.\d{4}\tLoss: \d+\.\d{4}\t"
             r"LearningRate \d+\.\d{6}",
    "resume": r"Resume from .*model_latest\.pth at epoch \d+ \(step \d+\)",
    "end": r"Now time is : \d{4}-\d\d-\d\dT[\d:.]+",
}


def _log_lines(trainer):
    with open(trainer.logname) as f:
        return f.read().splitlines()


def test_trainer_end_to_end_and_resume(tmp_path, paired_dir):
    """Two epochs through the train CLI on the CPU (3 steps an epoch,
    validation every step), the three checkpoints, the reference's log
    lines; then --resume --nepoch 3 continues at epoch 3 from step 6."""
    args = ["--arch", "Uformer", "--embed_dim", "8", "--win_size", "2",
            "--train_ps", "32", "--batch_size", "2", "--nepoch", "2",
            "--workers", "2", "--warmup", "--warmup_epochs", "1",
            "--save_dir", str(tmp_path / "logs"), "--train_dir",
            str(paired_dir), "--val_dir", str(paired_dir), "--dtype",
            "float32", "--pretrain_weights", "", "--checkpoint", "2",
            "--device", "cpu"]
    tr, state, best = cli.main(args)
    assert state.step == 6 and tr.steps_per_epoch == 3
    assert best > 10  # +0.05 noise, near-identity restoration
    assert sorted(os.listdir(tr.model_dir)) == [
        "model_best.pth", "model_epoch_2.pth", "model_latest.pth"]
    lines = _log_lines(tr)
    kinds = [next((k for k, rx in LOG_FORMATS.items()
                   if re.fullmatch(rx, line)), None) for line in lines[1:]]
    assert kinds == ["start"] + (["eval"] * 3 + ["epoch"]) * 2 + ["end"], \
        lines
    epoch_lr = [line.rsplit(" ", 1)[1] for line in lines
                if line.startswith("Epoch: ")]
    assert epoch_lr == [f"{tr.sched(3):.6f}", f"{tr.sched(6):.6f}"]
    latest = torch.load(os.path.join(tr.model_dir, "model_latest.pth"),
                        weights_only=True)
    assert latest["epoch"] == 2 and latest["step"] == 6

    tr2, state2, _ = cli.main(args + ["--resume", "--nepoch", "3"])
    assert tr2.start_epoch == 3 and state2.step == 9
    lines2 = _log_lines(tr2)
    assert re.fullmatch(LOG_FORMATS["resume"], lines2[1])
    assert lines2[1].endswith("at epoch 3 (step 6)")
    assert [line.rsplit(" ", 1)[1] for line in lines2
            if line.startswith("Epoch: ")] == [f"{tr2.sched(9):.6f}"]


def test_resume_restores_step_mixup_and_lr(tmp_path):
    """As tests/test_data_and_trainer.py's resume test: a checkpoint at the
    end of epoch 6 restores the step, so the MixUp gate (epoch > 5) fires
    and the schedule continues from the true position; the weights and
    AdamW moments come back bit for bit."""
    opt = pconfig.Options(**TINY, nepoch=10, warmup=True, warmup_epochs=1,
                          mode="denoising", save_dir=str(tmp_path),
                          device="cpu")
    tr = Trainer(opt)
    spe = 4
    tr.build(steps_per_epoch=spe)
    state = tr.init_state(resume=False)
    _one_step_state = make_train_step(tr.model, steps_per_epoch=spe)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 32, 32, 3, generator=g)
    _one_step_state(state, {"input": x, "target": x}, g)
    step_saved = 6 * spe
    pckpt.save_checkpoint(tr.model_dir, "model_latest", 6,
                          tr.model.state_dict(), state.optimizer.state_dict(),
                          step=step_saved)
    saved_sd = {k: v.clone() for k, v in tr.model.state_dict().items()}
    saved_moments = [{k: v.clone() for k, v in s.items()}
                     for s in state.optimizer.state.values()]

    state2 = tr.init_state(resume=True)
    assert state2.step == step_saved and tr.start_epoch == 7
    assert all(torch.equal(saved_sd[k], v)
               for k, v in tr.model.state_dict().items())
    for a, b in zip(saved_moments, state2.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert tr.sched(state2.step - 1) == tr.sched(step_saved - 1)
    assert tr.sched(step_saved - 1) != tr.sched(-1)

    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3))
                                 .astype(np.float32))
             for k in ("input", "target")}
    step_mix = make_train_step(tr.model, mixup_after_epoch=5,
                               steps_per_epoch=spe)
    step_plain = make_train_step(tr.model, mixup_after_epoch=None,
                                 steps_per_epoch=spe)
    loss_mix = step_mix(state2, batch, torch.Generator().manual_seed(0))
    state3 = tr.init_state(resume=True)
    loss_plain = step_plain(state3, batch, torch.Generator().manual_seed(0))
    assert abs(float(loss_mix) - float(loss_plain)) > 1e-6


def _seeded_jax_params(model, x):
    """Params of the JAX model drawn with numpy from a seed over its
    eval_shape tree (no compiled initialiser)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * rng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)


def test_validate_pads_and_matches_jax(tmp_path):
    """40 x 56 images (no multiple of win_size * 16 = 32): JAX
    Trainer.validate (attn_backend jnp) and the port's on the same weights
    give the same mean PSNR within 1e-3 dB."""
    from uformer_tpu.train.train_step import TrainState as JaxState
    from uformer_tpu.train.trainer import Trainer as JaxTrainer

    kw = dict(TINY, nepoch=1, attn_backend="jnp")
    jtr = JaxTrainer(jconfig.Options(**kw, save_dir=str(tmp_path / "j")))
    jtr.build(steps_per_epoch=1)
    ptr = Trainer(pconfig.Options(**kw, save_dir=str(tmp_path / "p"),
                                  device="cpu"))
    ptr.build(steps_per_epoch=1)
    pstate = ptr.init_state(resume=False)
    params = _seeded_jax_params(jtr.model, np.zeros((1, 32, 32, 3),
                                                    np.float32))
    load_numpy_state_dict(ptr.model, state_dict_from_jax(params))
    jstate = JaxState.create(jax.tree_util.tree_map(jnp.asarray, params),
                             jtr.tx)

    rng = np.random.default_rng(2)
    gts = [rng.uniform(0, 1, (1, 40, 56, 3)).astype(np.float32)
           for _ in range(2)]
    noisy = [np.clip(g + rng.normal(0, 0.05, g.shape), 0, 1)
             .astype(np.float32) for g in gts]
    jpsnr = jtr.validate(jstate, [{"input": jnp.asarray(n),
                                   "target": jnp.asarray(g)}
                                  for n, g in zip(noisy, gts)])
    ppsnr = ptr.validate(pstate, [{"input": torch.from_numpy(n),
                                   "target": torch.from_numpy(g)}
                                  for n, g in zip(noisy, gts)])
    assert np.isfinite(ppsnr) and ppsnr > 0
    assert abs(ppsnr - jpsnr) <= PSNR_TOL_DB, (ppsnr, jpsnr)


# ------------------------------------------------------------------ refusals

def test_registry_builds_uformer_at_embed_8_window_2():
    model = _tiny_model().train()
    assert model.encoderlayer_0.dim == 8
    assert model.encoderlayer_0.blocks[1].win_size == 2
    assert model.encoderlayer_0.blocks[1].shift_size == 1
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    y = model(x, generator=torch.Generator().manual_seed(1))
    y.square().mean().backward()
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert all(p.grad is not None for n, p in model.named_parameters()
               if "norm_cross" not in n)


@pytest.mark.parametrize("field, value, error, item", [
    # the ids of the cases before the data mesh was ported
    pytest.param("mesh_data", 2, ValueError, "process group of 2 ranks",
                 id="mesh_data-2-queue 1 item 4"),
    pytest.param("mesh_model", 2, NotImplementedError, "queue 1 item 4",
                 id="mesh_model-2-queue 1 item 4"),
    pytest.param("use_checkpoint", True, None, None,
                 id="use_checkpoint-True-None")])
def test_trainer_cli_and_registry_refuse_what_is_not_ported(
        tmp_path, paired_dir, field, value, error, item):
    """A 'model' axis waits for queue 1 item 4 and is refused before
    anything is built; `mesh_data` 2 runs data-parallel, and without its
    process group of 2 ranks it is refused before anything is built.
    `--use_checkpoint` is ported: an epoch of the train CLI on the CPU
    with it ends with the same weights, bit for bit, as without it."""
    flag = [f"--{field}"] + ([] if value is True else [str(value)])
    if item is None:
        args = ["--arch", "Uformer", "--embed_dim", "8", "--win_size", "2",
                "--train_ps", "32", "--batch_size", "2", "--nepoch", "1",
                "--workers", "1", "--train_dir", str(paired_dir),
                "--val_dir", str(paired_dir), "--dtype", "float32",
                "--pretrain_weights", "", "--device", "cpu"]
        runs = [cli.main(args + ["--save_dir", str(tmp_path / name)] + extra)
                for name, extra in (("plain", []), ("ckpt", flag))]
        (tr, state, _), (tr_ck, state_ck, _) = runs
        assert tr_ck.model.encoderlayer_0.use_checkpoint
        assert state.step == state_ck.step == 3
        for (n, a), b in zip(tr.model.named_parameters(),
                             tr_ck.model.parameters()):
            assert torch.equal(a, b), n
        assert get_arch({"arch": "Uformer_B", "use_checkpoint": True}) \
            .conv.use_checkpoint
        return
    opt = pconfig.Options(**TINY, save_dir=str(tmp_path), device="cpu",
                          **{field: value})
    with pytest.raises(error, match=item):
        Trainer(opt)
    with pytest.raises(error, match=item):
        cli.main(["--device", "cpu", "--save_dir", str(tmp_path)] + flag)
    assert not os.listdir(tmp_path)  # raised before anything was built


def test_unknown_dtype_or_backend_raises(tmp_path):
    for kw in ({"dtype": "float16"}, {"attn_backend": "triton"}):
        opt = pconfig.Options(**dict(TINY, **kw), save_dir=str(tmp_path),
                              device="cpu")
        with pytest.raises(ValueError):
            Trainer(opt)


def test_no_card_fails_and_never_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = pconfig.Options(**TINY, save_dir=str(tmp_path))
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="never falls back"):
        Trainer(opt)
    with pytest.raises(RuntimeError, match="never falls back"):
        cli.main(["--save_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
