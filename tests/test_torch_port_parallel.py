"""The port's data-parallel layer (`uformer_tpu_torch.parallel`: multihost,
mesh, sharding_rules) and its hooks in the data plane, the train step, the
trainer and both CLIs, on the CPU over gloo: ranks spawned by
`spawn_ranks` (torch.set_num_threads(1), 120 s deadline), one spawn per
scenario shared by the tests that read it.

- `local_batch_slice`/`local_batch_range` against JAX's; `batch_iterator`
  with `local_range` against the full iterator's rows (the port's copy of
  JAX's `test_batch_iterator_local_range`, and the paired dataset, whose
  crops are the global batch's draws).
- A 2-rank fp32 step of a small Uformer (drop path 0.1, MixUp on) against
  the one-process step on the global batch: loss, every gradient and
  parameter within 1e-5 max(1, max|ref|), the generators' states in equal
  bits; at 1 rank, equal bits. `replicate` with `verify` refuses ranks
  that differ, then makes them equal.
- An epoch of the train CLI on 2 ranks (`--mesh_data 2`): both end with
  weights in equal bits, rank 0 alone wrote files, and the weights equal
  a one-process run within 1e-5; the eval CLI's sharded tiles and its
  GoPro harness on 2 ranks against one process.
- `param_placements` against JAX's `param_shardings` on one tree.
- The refusals: a 'model' axis, a mesh without its group, the eval CLI's
  `--mesh_data` without `--tile`; a rank that fails or hangs fails the
  run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_cases as cases
from uformer_tpu.data.datasets import batch_iterator as jax_batch_iterator
from uformer_tpu.models import Uformer as JaxUformer
from uformer_tpu.parallel import make_mesh as jax_make_mesh
from uformer_tpu.parallel.multihost import local_batch_slice as jax_slice
from uformer_tpu.parallel.sharding_rules import param_shardings
from uformer_tpu_torch.convert import state_dict_from_jax
from uformer_tpu_torch.data import datasets as pds
from uformer_tpu_torch.eval import cli as ecli
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.parallel import make_mesh
from uformer_tpu_torch.parallel.multihost import (
    init_multihost,
    local_batch_range,
    local_batch_slice,
    rank_device,
    spawn_ranks,
)
from uformer_tpu_torch.parallel.sharding_rules import param_placements
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step

torch.set_num_threads(1)
SMALL = dict(img_size=32, embed_dim=8, depths=(1, 2, 1, 1, 1, 1, 1, 2, 1),
             num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), win_size=2,
             modulator=True, drop_path_rate=0.1)
STEP_SEED, STEP_LR = 5, 2e-4
ARCH = ["--arch", "Uformer", "--embed_dim", "8", "--win_size", "2",
        "--train_ps", "32", "--device", "cpu"]


def _close(got, want, what=""):
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


# ------------------------------------------------------------ rows, data

def test_local_batch_slice_and_range_match_jax():
    """One process: the whole batch, as JAX's at process_count 1; the
    ranks' values come from the 2-rank step (below)."""
    for b in (1, 8, 32):
        assert local_batch_slice(b) == jax_slice(b) == (0, b)
        assert local_batch_range(b) == (0, b)


def test_batch_iterator_local_range():
    class DS:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            a = np.full((4, 4, 3), float(i), np.float32)
            return a, a

    full = list(pds.batch_iterator(DS(), 4, shuffle=True, seed=7))
    half = list(pds.batch_iterator(DS(), 4, shuffle=True, seed=7,
                                   local_range=(2, 2)))
    assert len(full) == len(half)
    for f, h in zip(full, half):
        np.testing.assert_array_equal(f["input"][2:4], h["input"])
    jax_half = list(jax_batch_iterator(DS(), 4, shuffle=True, seed=7,
                                       local_range=(2, 2)))
    for h, j in zip(half, jax_half):
        np.testing.assert_array_equal(h["input"], j["input"])
    with pytest.raises(ValueError, match="drop_last"):
        next(pds.batch_iterator(DS(), 4, drop_last=False,
                                local_range=(0, 2)))


@pytest.fixture(scope="module")
def paired_dir(tmp_path_factory):
    """8 pairs of 48 x 64 PNGs, input = ground truth + 0.05."""
    import cv2

    root = tmp_path_factory.mktemp("paired")
    rng = np.random.default_rng(0)
    for sub in ("groundtruth", "input"):
        (root / sub).mkdir()
    for i in range(8):
        gt = rng.uniform(0, 1, (48, 64, 3))
        for sub, a in (("groundtruth", gt), ("input", gt + 0.05)):
            cv2.imwrite(str(root / sub / f"{i}.png"), cv2.cvtColor(
                np.uint8(np.clip(a, 0, 1) * 255), cv2.COLOR_RGB2BGR))
    return root


def test_local_range_draws_the_global_batch(paired_dir):
    """Each rank's rows of a paired dataset's epoch are the one-process
    epoch's rows, crops and dihedral ops included, bit for bit (numpy
    plane)."""
    def epoch(local_range=None):
        ds = pds.PairedTrainDataset(str(paired_dir), patch_size=32,
                                    native=False)
        return list(pds.batch_iterator(ds, 4, seed=3,
                                       local_range=local_range))

    full = epoch()
    for r0 in (0, 2):
        for f, h in zip(full, epoch((r0, 2))):
            for k in ("input", "target"):
                np.testing.assert_array_equal(f[k][r0:r0 + 2], h[k])


# ------------------------------------------------------------ the step

def _seeded_sd():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return {k: v.numpy() for k, v in Uformer(**SMALL).state_dict()
                .items()}


def _step_batch():
    rng = np.random.default_rng(1)
    return {k: rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
            for k in ("input", "target")}


@pytest.fixture(scope="module")
def one_process_step():
    """The one-process step on the global batch of 4."""
    from uformer_tpu_torch.convert import load_numpy_state_dict

    model = load_numpy_state_dict(Uformer(**SMALL), _seeded_sd())
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lambda s: STEP_LR), step=5)
    step = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=1)
    gen = torch.Generator().manual_seed(STEP_SEED)
    loss = step(state, {k: torch.from_numpy(v)
                        for k, v in _step_batch().items()}, gen)
    return {"loss": float(loss), "gen": gen.get_state().numpy(),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": {n: p.detach().numpy()
                       for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def ranks_step():
    """{n: every rank's step} at 2 ranks and at 1."""
    args = (SMALL, _seeded_sd(), _step_batch(), STEP_SEED, STEP_LR)
    return {n: spawn_ranks(cases.data_parallel_step, n, *args,
                           timeout_s=120) for n in (2, 1)}


def test_two_rank_step_equals_one_process_step(ranks_step,
                                               one_process_step):
    ref = one_process_step
    two = ranks_step[2]
    _close(np.mean([r["loss"] for r in two]), ref["loss"], "loss")
    for r in two:
        assert r["grads"].keys() == ref["grads"].keys()
        for n, g in ref["grads"].items():
            _close(r["grads"][n], g, n)
        for n, p in ref["params"].items():
            _close(r["params"][n], p, n)
    for n in ref["params"]:  # one model on every rank: equal bits
        np.testing.assert_array_equal(two[0]["params"][n],
                                      two[1]["params"][n])


def test_mixup_and_drop_path_draw_the_global_batch(ranks_step,
                                                   one_process_step):
    """Every rank's generator ends where the one-process step's does."""
    for r in ranks_step[2] + ranks_step[1]:
        np.testing.assert_array_equal(r["gen"], one_process_step["gen"])


def test_one_rank_ddp_step_equals_the_bare_step(ranks_step,
                                                one_process_step):
    (one,) = ranks_step[1]
    assert one["loss"] == one_process_step["loss"]
    for n, g in one_process_step["grads"].items():
        np.testing.assert_array_equal(one["grads"][n], g, err_msg=n)
    for n, p in one_process_step["params"].items():
        np.testing.assert_array_equal(one["params"][n], p, err_msg=n)


def test_rows_gather_and_replicate(ranks_step):
    """Rank i of n owns rows [i B/n, (i + 1) B/n) of a batch of 8 (JAX's
    local_batch_slice); the gathered rows are the global batch; replicate
    with verify refuses ranks whose weights differ, and without it gives
    every rank rank 0's."""
    two = ranks_step[2]
    assert [r["rows"] for r in two] == [((0, 4), (0, 4)), ((4, 4), (4, 4))]
    np.testing.assert_array_equal(two[0]["gathered"],
                                  _step_batch()["input"])
    assert two[0]["crc_before"] != two[1]["crc_before"]
    for r in two:
        assert "weights differ across ranks" in r["verify"]
        assert r["crc_after"] == two[0]["crc_before"]
    assert ranks_step[1][0]["verify"] == "passed"


# ------------------------------------------------------------ the CLIs

def _train_argv(data, save_dir, *extra):
    return ARCH + ["--batch_size", "4", "--nepoch", "1", "--workers", "1",
                   "--train_dir", str(data), "--val_dir", str(data),
                   "--dtype", "float32", "--pretrain_weights", "",
                   "--save_dir", str(save_dir), *extra]


def _eval_argv(harness, data, weights, *extra):
    return [harness, "--input_dir", str(data), "--weights", str(weights),
            *ARCH[:-2], "--device", "cpu", "--tile", "128", *extra]


@pytest.fixture(scope="module")
def cli_runs(paired_dir, tmp_path_factory):
    """The train CLI for one epoch (2 steps of 4) on 2 ranks and in one
    process, then the eval CLI on each run's weights: the sharded tiled
    restorer on a 200 x 300 image and the GoPro harness over the pairs."""
    tmp = tmp_path_factory.mktemp("cli")
    image = np.random.default_rng(2).uniform(0, 1, (1, 200, 300, 3)) \
        .astype(np.float32)
    runs = {}
    for name, extra in (("ranks", ["--mesh_data", "2"]), ("one", [])):
        save = tmp / name
        pth = save / "denoising" / "Uformer_" / "models" / \
            "model_latest.pth"
        argv = _train_argv(paired_dir, save, *extra)
        eval_argv = _eval_argv("sidd", paired_dir, pth, *extra)
        gopro_argv = _eval_argv("gopro", paired_dir, pth, "--result_dir",
                                str(tmp / f"gopro_{name}"),
                                "--save_images", *extra)
        if extra:
            runs[name] = spawn_ranks(cases.train_cli, 2, argv, eval_argv,
                                     gopro_argv, image, timeout_s=120)
        else:
            runs[name] = [cases.train_cli(0, 1, argv, eval_argv,
                                          gopro_argv, image)]
    return tmp, runs


def test_train_cli_on_two_ranks_one_writer(cli_runs):
    tmp, runs = cli_runs
    r0, r1 = runs["ranks"]
    assert (r0["is_main"], r1["is_main"]) == (True, False)
    assert r0["step"] == r1["step"] == 2
    for n, p in r0["params"].items():
        np.testing.assert_array_equal(p, r1["params"][n], err_msg=n)
    log_dir = tmp / "ranks" / "denoising" / "Uformer_"
    logs = [f for f in os.listdir(log_dir) if f.endswith(".txt")]
    assert len(logs) == 1
    text = (log_dir / logs[0]).read_text()
    assert text.count("Epoch: 1\t") == 1
    assert "equal on 2 ranks" in text
    assert sorted(os.listdir(log_dir / "models")) == \
        ["model_best.pth", "model_latest.pth"]


def test_train_cli_on_two_ranks_equals_one_process(cli_runs):
    _, runs = cli_runs
    ((one,), (r0, _)) = runs["one"], runs["ranks"]
    assert one["step"] == r0["step"]
    for n, p in one["params"].items():
        _close(r0["params"][n], p, n)
    assert abs(one["best"] - r0["best"]) < 1e-3


def test_eval_cli_sharded_tiles_equal_one_process(cli_runs):
    """The eval CLI's restorer with --mesh_data 2 --tile 128 (each rank 3 of
    the 6 tiles) against the one-process tiled restorer; rank 0 alone
    wrote the GoPro harness's images and scores."""
    tmp, runs = cli_runs
    (one,), (r0, r1) = runs["one"], runs["ranks"]
    for r in (r0, r1):
        assert r["restored"].shape == (1, 200, 300, 3)
        _close(r["restored"], one["restored"], "restored")
        _close(np.asarray(r["gopro"]), np.asarray(one["gopro"]), "gopro")
    assert sorted(os.listdir(tmp / "gopro_ranks")) == \
        sorted(os.listdir(tmp / "gopro_one"))


def test_eval_cli_mesh_data_needs_tile(tmp_path):
    with pytest.raises(ValueError, match="needs --tile"):
        ecli.main(["sidd", "--input_dir", str(tmp_path), "--weights",
                   "w.pth", "--device", "cpu", "--mesh_data", "2"])


# ------------------------------------------------------------ the rest

def test_param_placements_match_jax():
    """Over a model axis of 2: JAX's (None, 'model') is a column split,
    ('model', None) a row split, P() whole; each leaf found under its
    state_dict key by filling it with its index."""
    cfg = dict(SMALL, cross_modulator=True, token_mlp="mlp")
    cfg.pop("drop_path_rate")
    jmodel = JaxUformer(attn_backend="jnp", **cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    index = jax.tree_util.tree_unflatten(tree, [
        np.full(a.shape, i, np.float32) for i, a in enumerate(leaves)])
    mesh = jax_make_mesh(jax.devices(), data=4, model=2)
    specs = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        param_shardings(mesh, index))]
    tag = {(): "replicate", (None, "model"): "column",
           ("model", None): "row"}
    want = {k: tag[specs[int(np.asarray(v).flat[0])]]
            for k, v in state_dict_from_jax(index).items()
            if not k.endswith("relative_position_index")}
    got = param_placements(Uformer(**cfg), 2)
    assert got == want
    assert set(got.values()) == {"replicate", "column", "row"}
    assert set(param_placements(Uformer(**cfg), 1).values()) == \
        {"replicate"}


def test_mesh_refuses_a_model_axis_and_a_missing_group():
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        make_mesh(model=2)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        make_mesh(data=2)
    mesh = make_mesh()
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)


def test_init_multihost_alone_starts_nothing(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_multihost(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="LOCAL_RANK 3"):
        rank_device("cuda")
    assert rank_device("cuda:1") == torch.device("cuda", 1)


def test_a_failing_or_hanging_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn_ranks(cases.fails, 2, timeout_s=120)
    with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
        spawn_ranks(cases.hangs, 2, timeout_s=8)
