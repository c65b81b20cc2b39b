"""The port's utilities against the JAX package's, on the CPU: freezing
(`utils/freeze.py`, against `uformer_tpu.utils.freeze` on one train
step), the operation count (`utils/flops.py`: the closed form of one
LeWin block, and a band around JAX's `cost_analysis()`), the debugging
guards and the trace summary (`utils/debug.py`), and `model_info` run as
a module. JAX is imported inside the tests.
"""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import load_numpy_state_dict, \
    state_dict_from_jax
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.models.layers import LeWinBlock
from uformer_tpu_torch.train import TrainState, make_optimizer, \
    make_train_step, warmup_cosine_schedule
from uformer_tpu_torch.train.checkpoints import load_checkpoint, \
    save_checkpoint
from uformer_tpu_torch.utils import debug
from uformer_tpu_torch.utils.flops import model_complexity
from uformer_tpu_torch.utils.freeze import freeze, is_frozen, path_matches, \
    trainable_parameters, unfreeze

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TINY = dict(img_size=32, embed_dim=8, depths=(1,) * 9,
            num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), win_size=2,
            modulator=True)
SCHEDULE = dict(base_lr=1e-3, nepoch=10, steps_per_epoch=1, warmup_epochs=2)
PATTERN = "encoderlayer_"


# ---- freeze ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_frozen_step():
    """One JAX train step of the tiny Uformer (drop path 0) with every
    param under `encoderlayer_` frozen (`freeze` around the AdamW), its
    trainable mask and its gradients, as port state_dicts."""
    import jax
    import jax.numpy as jnp
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.train.losses import charbonnier_loss as jloss
    from uformer_tpu.train.schedules import warmup_cosine_schedule as jsched
    from uformer_tpu.train.train_step import TrainState as JState
    from uformer_tpu.train.train_step import make_optimizer as jopt
    from uformer_tpu.train.train_step import make_train_step as jstep
    from uformer_tpu.utils.freeze import freeze as jfreeze
    from uformer_tpu.utils.freeze import freeze_mask
    from uformer_tpu.utils.freeze import path_matches as jmatches

    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
             for k in ("input", "target")}
    model = JaxUformer(attn_backend="jnp", drop_path_rate=0.0, **TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(batch["input"]))
    prng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.05 * prng.standard_normal(a.shape)
                         + (jax.tree_util.keystr(path).endswith("['scale']")))
        .astype(np.float32), shapes)

    def frozen(path):
        return jmatches(path, PATTERN)

    tx = jfreeze(jopt(jsched(**SCHEDULE)), params, frozen)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    new, loss = jax.jit(jstep(model))(JState.create(params, tx), jb, key)
    grads = jax.jit(jax.grad(lambda p: jloss(model.apply(
        p, jb["input"], deterministic=False,
        rngs={"dropout": jax.random.split(key)[1]}), jb["target"])))(params)
    mask = jax.tree_util.tree_map(
        lambda trainable, a: np.full(a.shape, trainable),
        freeze_mask(params, frozen), params)
    return SimpleNamespace(batch=batch, before=state_dict_from_jax(params),
                           after=state_dict_from_jax(new.params),
                           grads=state_dict_from_jax(grads),
                           trainable=state_dict_from_jax(mask),
                           loss=float(loss))


def _frozen_model(sd):
    model = Uformer(drop_path_rate=0.0, **TINY)
    load_numpy_state_dict(model, sd)
    return freeze(model, lambda name: path_matches(name, PATTERN))


def test_freeze_matches_jax(jax_frozen_step):
    """The same leaves frozen as JAX's mask on the same pattern; after one
    step the frozen parameters keep their bits (no update, no weight
    decay), every other one has JAX's gradient and update (the tolerances
    of tests/test_torch_port_checkpoint.py)."""
    r = jax_frozen_step
    model = _frozen_model(r.before)
    trainable = {n: p.requires_grad for n, p in model.named_parameters()}
    want = {n: bool(np.all(v)) for n, v in r.trainable.items()
            if n in trainable}
    assert trainable == want and not all(trainable.values()) \
        and any(trainable.values())
    sched = warmup_cosine_schedule(**SCHEDULE)
    state = TrainState(model, make_optimizer(model.parameters(), sched))
    batch = {k: torch.from_numpy(v) for k, v in r.batch.items()}
    loss = make_train_step(model)(state, batch,
                                  torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), r.loss, rtol=1e-5)
    lr, eps = sched(0), 1e-8
    for name, p in model.named_parameters():
        before = np.asarray(r.before[name])
        if not p.requires_grad:
            assert p.grad is None
            assert np.array_equal(p.detach().numpy(), before), name
            assert np.array_equal(np.asarray(r.after[name]), before), name
            continue
        g_ref = np.asarray(r.grads[name])
        g_tol = 1e-4 * max(1.0, float(np.abs(g_ref).max()))
        assert float(np.abs(p.grad.numpy() - g_ref).max()) <= g_tol, name
        want_upd = np.asarray(r.after[name]) - before
        err = np.abs((p.detach().numpy() - before) - want_upd)
        tol = (2e-3 * lr + 4 * np.spacing(np.abs(before))
               + lr * eps * g_tol / (np.abs(g_ref) + eps) ** 2)
        assert np.all(err <= tol), (name, float((err - tol).max()))


def test_freeze_queries_and_a_frozen_checkpoint_resumes(jax_frozen_step,
                                                        tmp_path):
    """freeze / unfreeze / is_frozen / trainable_parameters; a checkpoint
    written with frozen parameters (the optimizer holds the trainable
    ones) resumes into a model frozen the same way: its next step equals
    the uninterrupted run's next step in equal bits."""
    r = jax_frozen_step
    model = _frozen_model(r.before)
    n_train = len(trainable_parameters(model))
    assert 0 < n_train < len(list(model.parameters()))
    assert not is_frozen(model)
    assert is_frozen(freeze(Uformer(**TINY)))
    assert not is_frozen(unfreeze(freeze(Uformer(**TINY))))
    sched = warmup_cosine_schedule(**SCHEDULE)
    batch = {k: torch.from_numpy(v) for k, v in r.batch.items()}

    def step(m, state):
        make_train_step(m)(state, batch, torch.Generator().manual_seed(0))

    state = TrainState(model, make_optimizer(model.parameters(), sched))
    assert len(state.optimizer.param_groups[0]["params"]) == n_train
    step(model, state)
    path = save_checkpoint(str(tmp_path), "model_latest", 1,
                           model.state_dict(), state.optimizer.state_dict(),
                           step=state.step)
    step(model, state)

    resumed = _frozen_model(r.before)
    ckpt = load_checkpoint(path)
    resumed.load_state_dict(ckpt["state_dict"])
    state2 = TrainState(resumed, make_optimizer(resumed.parameters(), sched),
                        step=ckpt["step"])
    state2.optimizer.load_state_dict(ckpt["optimizer"])
    step(resumed, state2)
    for (n, a), b in zip(model.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), n


# ---- flops -------------------------------------------------------------------

@pytest.mark.parametrize("C, heads, shift", [(32, 1, 0), (32, 2, 4),
                                             (128, 4, 4), (16, 1, 0)])
def test_model_complexity_counts_a_lewin_blocks_products(C, heads, shift):
    """One LeWin block on (1, 16, 16, C), window 8 (N = 64 tokens), hidden
    4C: the q, kv and output projections 8 T C^2, the two attention
    products 4 N T C, LeFF's two products 4 T C Ch and its depthwise taps
    18 T Ch; nothing else (the elementwise work is not counted)."""
    T, N, Ch = 256, 64, 4 * C
    closed = 8 * T * C * C + 4 * N * T * C + 4 * T * C * Ch + 18 * T * Ch
    blk = LeWinBlock(C, heads, 8, shift)
    info = model_complexity(blk, (1, 16, 16, C))
    assert info["gflops"] * 1e9 == closed
    assert info["params_m"] * 1e6 == sum(p.numel() for p in blk.parameters())
    # x, the output and the weights at least once
    assert info["bytes_gb"] * 1e9 > 4 * 2 * T * C


def test_model_complexity_within_its_band_of_jax():
    """At tests/test_extras.py's geometry (32^2, embed 8, depths 1, window
    8), batch 1: the same parameters; the port's gflops 0.68 of JAX's
    (measured 0.682: XLA also counts the elementwise work, GELU, softmax,
    LayerNorm, bias adds and residuals), held within [0.60, 0.75]; its
    bytes above JAX's (measured 1.33x: every op apart, where XLA counts
    the fused program)."""
    from uformer_tpu.models import Uformer as JaxUformer
    from uformer_tpu.utils.flops import model_complexity as jax_complexity

    cfg = dict(img_size=32, embed_dim=8, depths=(1,) * 9,
               num_heads=(1, 2, 4, 8, 8, 8, 4, 2, 1), win_size=8)
    want = jax_complexity(JaxUformer(attn_backend="jnp", **cfg),
                          (1, 32, 32, 3))
    got = model_complexity(Uformer(**cfg), (1, 32, 32, 3))
    assert got["params_m"] == pytest.approx(want["params_m"], rel=1e-12)
    assert 0.60 <= got["gflops"] / want["gflops"] <= 0.75
    assert got["bytes_gb"] > want["bytes_gb"]


def test_model_info_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "uformer_tpu_torch.model_info", "--arch",
         "Uformer", "--embed_dim", "8", "--input_size", "32", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("Uformer(")
    info = model_complexity(get_arch({"arch": "Uformer", "embed_dim": 8,
                                      "train_ps": 32}), (1, 32, 32, 3))
    assert lines[-3:] == [
        "# model parameters: %.2f M" % info["params_m"],
        "number of GFLOPs: %.2f G" % info["gflops"],
        "bytes accessed: %.2f GB" % info["bytes_gb"]]


# ---- debug ---------------------------------------------------------------------

def test_assert_finite_over_nested_trees():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, 2), (torch.arange(3),)]}
    assert debug.assert_finite(tree) is tree
    for bad in (float("nan"), float("inf")):
        broken = {"a": torch.ones(3), "b": [torch.tensor([1.0, bad])]}
        with pytest.raises(FloatingPointError, match="grads"):
            debug.assert_finite(broken, "grads")


def test_nan_checks_name_the_first_module_and_come_off():
    model = Uformer(**TINY).eval()
    x = torch.rand(1, 32, 32, 3)
    x[0, 3, 5, 1] = float("nan")
    try:
        debug.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        with torch.no_grad():
            model(torch.full_like(x, 0.5))  # finite: no error
            with pytest.raises(FloatingPointError,
                               match=r"output of input_proj \(InputProj\)"):
                model(x)
        # a NaN born inside: the first block's LeFF parameters
        with torch.no_grad():
            model.encoderlayer_0.blocks[0].mlp.linear2[0].bias[0] = \
                float("nan")
            with pytest.raises(FloatingPointError,
                               match=r"encoderlayer_0\.blocks\.0\.mlp "
                                     r"\(LeFF\)"):
                model(torch.rand(1, 32, 32, 3))
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    with torch.no_grad():
        assert bool(torch.isnan(model(x)).any())  # the hooks are off


def _write_trace(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_summarize_trace_sums_device_kernels_per_family(tmp_path):
    """A Chrome trace written here: device kernels, copies and a
    whole-program annotation span (skipped), host ops (skipped)."""
    def ev(name, cat, dur, ph="X"):
        return {"name": name, "cat": cat, "ph": ph, "dur": dur, "pid": 0,
                "tid": 7, "ts": 0}

    events = [
        ev("void stage_kernel<128, 4, 2>(StageArgs)", "kernel", 1000.0),
        ev("void stage_kernel<256, 8, 1>(StageArgs)", "kernel", 500.0),
        ev("void leff_wide_kernel<128>(LeffArgs)", "kernel", 250.0),
        ev("attention_narrow_kernel_3", "kernel", 100.0),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 20.0),
        ev("ProfilerStep#0", "gpu_user_annotation", 5000.0),
        ev("aten::mm", "cpu_op", 9000.0),
        ev("stage_kernel", "kernel", 1.0, ph="i"),
    ]
    _write_trace(tmp_path / "trace_1.json", events)
    got = debug.summarize_trace(str(tmp_path))
    assert got == {"stage_kernel": 1.5, "leff_wide_kernel": 0.25,
                   "attention_narrow_kernel": 0.1,
                   "Memcpy HtoD": 0.02}
    assert list(got) == ["stage_kernel", "leff_wide_kernel",
                         "attention_narrow_kernel", "Memcpy HtoD"]
    assert debug.summarize_trace(str(tmp_path), top=1) == \
        {"stage_kernel": 1.5}
    per = debug.summarize_trace(str(tmp_path), instances=True)
    assert per["void stage_kernel<128, 4, 2>(StageArgs)"] == 1.0
    # the newest trace wins; gzip is read too; no device events -> {}
    newer = tmp_path / "trace_2.json.gz"
    _write_trace(newer, [ev("aten::add", "cpu_op", 3.0)], gz=True)
    os.utime(newer, (os.path.getmtime(tmp_path / "trace_1.json") + 10,) * 2)
    assert debug.summarize_trace(str(tmp_path)) == {}
    assert debug.summarize_trace(str(tmp_path / "none")) == {}


def test_profile_writes_a_trace_on_the_cpu(tmp_path):
    model = Uformer(**TINY).eval()
    with debug.profile(str(tmp_path)) as prof:
        with torch.no_grad():
            model(torch.rand(1, 32, 32, 3))
    assert prof is not None
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert debug.summarize_trace(str(tmp_path)) == {}  # no card
