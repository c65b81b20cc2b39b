#!/usr/bin/env python3
"""On-card smoke run of `uformer_tpu_torch`, the PyTorch/CUDA port.

    python3 chip_smoke.py [--json PATH]   # on a machine with one CUDA
                                          # card (H100: kernels are sm_90a)

Phases, each raising on failure (no phase is caught):
  1. device  - fails at once without CUDA; prints the card and power limit.
  2. build   - nvcc builds the three kernels of csrc/ (sm_90a).
  3. kernels - each kernel against its plain PyTorch version at every
               main-path shape of Uformer_B at 256^2 (batch 2), in fp32
               (TF32 off) and bf16.
  4. golden  - Uformer_B at 128^2, fp32, through the kernels, stage by stage
               against the recorded torch activations of
               tests/golden/uformer_b_128.npz.
  5. serve   - a bf16 Restorer for Uformer_B at 256^2 answers 4 requests of
               batch 8; launch counts per request, ms per request, MP/s,
               peak memory; the kernel path against the plain path.
  6. timing  - each kernel against its plain version at the bs8 256^2
               shapes, stage by stage, and the whole forward.
  7. train   - Uformer_B at 128^2 in training (drop path 0.1, mixup on):
               the forward kernels with residual=False and the backward
               kernels against their plain versions at every stage shape
               (shift 0 and 4, fp32 and bf16, every gradient) and one
               whole train step, kernel path against plain path (fp32 and
               bf16, loss and every parameter's gradient), at batch 2 and
               again at batch 32; bs 32 bf16 train steps: launches per
               step, loss, ms per step on both paths, peak memory; each
               kernel's time against its plain version at the bs 32
               shapes, forward and backward.

Tolerances: fp32 max-abs <= 1e-4 * (1 + max|ref|); bf16 error against the
fp32 plain result <= 1.5 x the bf16 plain version's error + 1e-3; for
gradients, per tensor, the bf16 term is 1e-3 * max(1, max|ref|), since
weight gradients are sums over every token; golden as
tests/test_golden_parity.py. --json PATH writes every check and timing
there. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH_CHECK, BATCH_SERVE, RES_SERVE, RES_GOLDEN = 2, 8, 256, 128
BATCH_TRAIN, RES_TRAIN, N_TRAIN_STEPS = 32, 128, 3
N_REQUESTS = 4
EXPECTED_LAUNCHES = {"stage": 6, "attention_image": 4, "leff": 4,
                     "attention_bwd": 0, "leff_bwd": 0}
TRAIN_LAUNCHES = {"stage": 0, "attention_image": 40, "leff": 40,
                  "attention_bwd": 40, "leff_bwd": 40}
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "stage": ("uformer_tpu_torch/csrc/stage.cu",
              "uformer_tpu/ops/pallas/stage.py:418"),
    "attention_image": ("uformer_tpu_torch/csrc/attention_image.cu",
                        "uformer_tpu/ops/pallas/attention_image.py:652"),
    "leff": ("uformer_tpu_torch/csrc/leff.cu",
             "uformer_tpu/ops/pallas/leff.py:1132"),
    "attention_bwd": ("uformer_tpu_torch/csrc/attention_bwd.cu",
                      "uformer_tpu/ops/pallas/attention_block.py:877"),
    "leff_bwd": ("uformer_tpu_torch/csrc/leff_bwd.cu",
                 "uformer_tpu/ops/pallas/leff.py:880"),
}
STAGES = (["input_proj"] + [f"encoderlayer_{k}" for k in range(4)]
          + [f"dowsample_{k}" for k in range(4)] + ["conv"]
          + [f"upsample_{k}" for k in range(4)]
          + [f"decoderlayer_{k}" for k in range(4)] + ["output_proj"])
LAYERS = ([f"encoderlayer_{k}" for k in range(4)] + ["conv"]
          + [f"decoderlayer_{k}" for k in range(4)])


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seeded_weights():
    """The golden Uformer_B state_dict, regenerated from its seed (numpy).
    tests/golden/generate.py is loaded by path: a site package named
    `tests` may shadow the repo's directory."""
    spec = importlib.util.spec_from_file_location(
        "golden_generate", REPO / "tests" / "golden" / "generate.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    data = np.load(REPO / "tests" / "golden" / "uformer_b_128.npz")
    keys_shapes = json.loads(str(data["sd_manifest"]))
    return data, gen.seeded_state_dict(keys_shapes, int(data["seed"]))


def build_model(sd, train_ps: int, device):
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_numpy_state_dict

    model = get_arch({"arch": "Uformer_B", "train_ps": train_ps})
    return load_numpy_state_dict(model, sd).to(device).eval()


class Checks:
    """Collects comparisons of one phase; prints each failure, and at the
    phase's end the worst err/bound per dtype; raises if any failed. The
    --json report keeps every row."""

    def __init__(self):
        self.rows, self.failed = [], []

    def add(self, kernel: str, what: str, err: float, bound: float,
            dtype: str) -> None:
        ok = err <= bound
        self.rows.append({"kernel": kernel, "what": what, "dtype": dtype,
                          "err": err, "bound": bound, "ok": ok})
        if not ok:
            print(f"  FAIL {kernel:16s} {dtype:5s} {what:44s} err "
                  f"{err:.3e} > {bound:.3e}", flush=True)
            self.failed.append(f"{kernel} {dtype} {what}")

    def raise_if_failed(self, phase_name: str) -> None:
        for dt in ("fp32", "bf16"):
            rows = [r for r in self.rows if r["dtype"] == dt]
            if not rows:
                continue
            worst = max(rows, key=lambda r: r["err"] / r["bound"])
            print(f"  {phase_name}: {len(rows)} {dt} checks, worst "
                  f"err/bound {worst['err'] / worst['bound']:.3f} "
                  f"({worst['kernel']} {worst['what']})", flush=True)
        if self.failed:
            raise RuntimeError(f"{phase_name}: {len(self.failed)} failed: "
                               f"{self.failed}")


def compare(checks: Checks, kernel: str, what: str, fused, plain, x32):
    """fp32: kernel vs plain; bf16: the kernel's error against the fp32
    plain result within 1.5x the bf16 plain version's + 1e-3. x32 holds
    bf16-representable values, so both dtypes see the same input."""
    ref32 = plain(x32, torch.float32)
    checks.add(kernel, what, max_err(fused(x32, torch.float32), ref32),
               1e-4 * (1.0 + float(ref32.abs().max())), "fp32")
    x16 = x32.bfloat16()
    e_plain = max_err(plain(x16, torch.bfloat16), ref32)
    checks.add(kernel, what, max_err(fused(x16, torch.bfloat16), ref32),
               1.5 * e_plain + 1e-3, "bf16")


def kernel_phase(model, device) -> Checks:
    """Every kernel against its plain version at the main-path shapes of
    Uformer_B at 256^2, batch BATCH_CHECK, with the model's own weights."""
    from uformer_tpu_torch.ops import kernels as K

    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(0)
    for name in LAYERS:
        layer = getattr(model, name)
        res = layer.resolution
        shape = (BATCH_CHECK, res, res, layer.dim)
        x32 = torch.randn(shape, generator=gen).bfloat16().float().to(device)
        if layer.stage_ok:
            prm = {dt: layer.kernel_params(dt)
                   for dt in (torch.float32, torch.bfloat16)}
            kw = dict(scale=layer.blocks[0].attn.scale,
                      num_heads=layer.num_heads, use_shift=layer.use_shift,
                      has_mod=layer.has_mod)
            compare(checks, "stage", f"{name} {shape} n={len(layer.blocks)}",
                    lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                    lambda x, dt: K.stage_reference(x, prm[dt], **kw), x32)
            continue
        for i, blk in enumerate(layer.blocks):
            prm = {dt: blk.kernel_params(dt)
                   for dt in (torch.float32, torch.bfloat16)}
            what = f"{name}.{i} {shape} shift={blk.shift_size}"

            def attn(fn):
                return lambda x, dt: fn(
                    x, prm[dt]["mod"], prm[dt]["ln1_s"], prm[dt]["ln1_b"],
                    prm[dt]["wq"], prm[dt]["bq"], prm[dt]["wkv"],
                    prm[dt]["bkv"], prm[dt]["wo"], prm[dt]["bo"],
                    prm[dt]["bias"], win=blk.win_size, shift=blk.shift_size,
                    scale=blk.attn.scale, num_heads=blk.num_heads)

            def leff(fn):
                return lambda x, dt: fn(
                    x, prm[dt]["w1"], prm[dt]["b1"], prm[dt]["wd"],
                    prm[dt]["bd"], prm[dt]["w2"], prm[dt]["b2"],
                    ln_s=prm[dt]["ln2_s"], ln_b=prm[dt]["ln2_b"],
                    residual=True)

            compare(checks, "attention_image", what,
                    attn(K.fused_attention_image),
                    attn(K.attention_image_reference), x32)
            compare(checks, "leff", what, leff(K.fused_leff),
                    leff(K.leff_reference), x32)
    torch.cuda.synchronize()
    return checks


def to_nhwc(a: np.ndarray) -> np.ndarray:
    """Torch activation -> NHWC: (B, L, C) tokens via sqrt(L), (B, C, H, W)
    maps by transpose (as tests/test_golden_parity.py)."""
    if a.ndim == 3:
        B, L, C = a.shape
        s = int(round(np.sqrt(L)))
        return a.reshape(B, s, s, C)
    return a.transpose(0, 2, 3, 1)


def golden_phase(data, sd, device) -> Checks:
    """Uformer_B at 128^2, fp32, through the kernels, against the recorded
    torch activations (budget of tests/test_golden_parity.py:114-122)."""
    from uformer_tpu_torch.ops import kernels as K

    model = build_model(sd, RES_GOLDEN, device)
    acts = {}
    hooks = [getattr(model, s).register_forward_hook(
        lambda _m, _i, out, s=s: acts.__setitem__(s, out.float().cpu()))
        for s in STAGES]
    x = torch.from_numpy(data["input"].transpose(0, 2, 3, 1).copy())
    K.reset_counts()
    with torch.no_grad():
        y = model(x.to(device)).cpu()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    launched = K.launch_counts()
    print(f"  launches {launched}", flush=True)
    if launched != EXPECTED_LAUNCHES:
        raise RuntimeError(f"golden: launches {launched}, expected "
                           f"{EXPECTED_LAUNCHES}")
    checks = Checks()
    for s in STAGES:
        want = to_nhwc(data[f"act/{s}"].astype(np.float32))
        err = float(np.abs(acts[s].numpy() - want).max())
        checks.add("model", f"golden {s}", err,
                   1e-3 + 1e-3 * float(np.abs(want).max()), "fp32")
    want = data["output"].transpose(0, 2, 3, 1)
    checks.add("model", "golden output", float(np.abs(y.numpy() - want).max()),
               1e-3, "fp32")
    return checks


def serve_phase(sd, device):
    """A bf16 Restorer at 256^2 answers N_REQUESTS requests of batch
    BATCH_SERVE; returns the summary, the per-kernel launch totals and the
    checks of kernel path against plain path."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.restore import Restorer

    restorer = Restorer(build_model(sd, RES_SERVE, device), torch.bfloat16,
                        device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    shape = (BATCH_SERVE, RES_SERVE, RES_SERVE, 3)
    requests = [torch.rand(shape, generator=gen)
                for _ in range(N_REQUESTS + 1)]
    restorer(requests[0])  # warm-up: cuDNN plans, kernel attributes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    K.reset_counts()
    per_request, ms = [], []
    for x in requests[1:]:
        before = K.launch_counts()
        t0 = time.perf_counter()
        y = restorer(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = K.launch_counts()
        per_request.append({k: after[k] - before[k] for k in after})
        if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()) \
                or float(y.min()) < 0.0 or float(y.max()) > 1.0:
            raise RuntimeError(f"serve: bad output {tuple(y.shape)}")
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    for i, c in enumerate(per_request):
        print(f"  request {i}: launches {c}  {ms[i]:.3f} ms", flush=True)
        if c != EXPECTED_LAUNCHES:
            raise RuntimeError(f"serve: request {i} launched {c}, "
                               f"expected {EXPECTED_LAUNCHES}")
    med = float(np.median(ms))
    mps = BATCH_SERVE * RES_SERVE * RES_SERVE / 1e6 / (med / 1e3)
    print(f"  median {med:.3f} ms/request  {mps:.2f} MP/s  peak "
          f"{peak / 2**20:.1f} MiB", flush=True)

    # kernel path against the plain path on the same weights (unclamped)
    x = requests[1].to(device)
    model16 = restorer.model
    model32 = build_model(sd, RES_SERVE, device)
    from uformer_tpu_torch.utils.params import prepare_serving
    prepare_serving(model32, torch.float32)
    checks = Checks()
    with torch.no_grad():
        ref32 = model32(x, plain=True)
        e_plain = max_err(model16(x, plain=True), ref32)
        checks.add("model", f"serve forward {shape}",
                   max_err(model16(x), ref32), 1.5 * e_plain + 1e-3, "bf16")
    del model32, ref32
    summary = {"ms_per_request": ms, "median_ms": med, "mp_per_s": mps,
               "max_memory_allocated_bytes": peak,
               "launches_per_request": per_request}
    return restorer, requests[1].to(device), summary, launches, checks


def timing_phase(restorer, x):
    """Device time of each kernel and of its plain version on the inputs
    the bs8 256^2 bf16 forward gives it, stage by stage, and of the whole
    forward on each path."""
    from uformer_tpu_torch.ops import kernels as K

    model = restorer.model
    inputs = {}
    hooks = [getattr(model, n).register_forward_pre_hook(
        lambda _m, args, n=n: inputs.__setitem__(n, args[0]))
        for n in LAYERS]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    rows = []
    totals = {k: [0.0, 0.0] for k in ("stage", "attention_image", "leff")}
    with torch.no_grad():
        for name in LAYERS:
            layer, xin = getattr(model, name), inputs[name]
            if layer.uses_stage(xin):
                pair = [("stage", lambda: layer(xin),
                         lambda: layer(xin, plain=True))]
            else:
                pair = []
                for blk in layer.blocks:
                    p = blk.params_for(xin.dtype, xin.device)
                    kw = dict(win=blk.win_size, shift=blk.shift_size,
                              scale=blk.attn.scale, num_heads=blk.num_heads)
                    args = (p["mod"], p["ln1_s"], p["ln1_b"], p["wq"],
                            p["bq"], p["wkv"], p["bkv"], p["wo"], p["bo"],
                            p["bias"])
                    largs = (p["w1"], p["b1"], p["wd"], p["bd"], p["w2"],
                             p["b2"])
                    lkw = dict(ln_s=p["ln2_s"], ln_b=p["ln2_b"],
                               residual=True)
                    xa = K.fused_attention_image(xin, *args, **kw)
                    pair.append(("attention_image",
                                 lambda xin=xin, args=args, kw=kw:
                                 K.fused_attention_image(xin, *args, **kw),
                                 lambda xin=xin, args=args, kw=kw:
                                 K.attention_image_reference(xin, *args,
                                                             **kw)))
                    pair.append(("leff",
                                 lambda xa=xa, largs=largs, lkw=lkw:
                                 K.fused_leff(xa, *largs, **lkw),
                                 lambda xa=xa, largs=largs, lkw=lkw:
                                 K.leff_reference(xa, *largs, **lkw)))
                    xin = K.fused_leff(xa, *largs, **lkw)
            for kernel, fused, plain in pair:
                # plain, kernel, kernel, plain: alternate the order
                p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(fused),
                                  cuda_ms(fused), cuda_ms(plain))
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                totals[kernel][0] += k_ms
                totals[kernel][1] += p_ms
                rows.append({"layer": name, "kernel": kernel,
                             "shape": list(inputs[name].shape),
                             "ms": k_ms, "plain_ms": p_ms})
                print(f"  {name:16s} {kernel:16s} "
                      f"{str(tuple(inputs[name].shape)):22s} kernel "
                      f"{k_ms:8.3f} ms  plain {p_ms:8.3f} ms", flush=True)
        p1 = cuda_ms(lambda: model(x, plain=True), reps=5)
        k1 = cuda_ms(lambda: model(x), reps=5)
        k2 = cuda_ms(lambda: model(x), reps=5)
        p2 = cuda_ms(lambda: model(x, plain=True), reps=5)
    fwd = {"kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "runs_ms": {"plain": [p1, p2], "kernel": [k1, k2]}}
    print(f"  forward bs{x.shape[0]} {x.shape[1]}^2 bf16: kernel path "
          f"{fwd['kernel_ms']:.3f} ms, plain path {fwd['plain_ms']:.3f} ms",
          flush=True)
    return rows, totals, fwd


def grad_bound(checks: Checks, kernel: str, what: str, got, ref, low,
               got16) -> None:
    """Per-gradient checks: fp32 kernel against fp32 plain within
    1e-4 (1 + max|ref|); bf16 kernel against fp32 plain within 1.5x the
    bf16 plain version's error + 1e-3 max(1, max|ref|)."""
    for name, r, k, p, k16 in zip(got.keys(), ref.values(), got.values(),
                                  low.values(), got16.values()):
        if r is None:
            if k is not None or k16 is not None:
                raise RuntimeError(f"{kernel} {what} {name}: unexpected "
                                   f"gradient")
            continue
        scale = float(r.abs().max())
        checks.add(kernel, f"{what} {name}", max_err(k, r),
                   1e-4 * (1.0 + scale), "fp32")
        checks.add(kernel, f"{what} {name}", max_err(k16, r),
                   1.5 * max_err(p, r) + 1e-3 * max(1.0, scale), "bf16")


ATTN_GRADS = ("dx", "dmod", "dln_s", "dln_b", "dwq", "dbq", "dwkv", "dbkv",
              "dwo", "dbo", "dbias")
LEFF_GRADS = ("dx", "dw1", "db1", "dwd", "dbd", "dw2", "db2", "dln_s",
              "dln_b")


def block_calls(blk, prm, residual):
    """The four kernel calls of one block and their plain versions, on the
    block's kernel weights `prm` (dtype -> kernel_params)."""
    from uformer_tpu_torch.ops import kernels as K

    akw = dict(win=blk.win_size, shift=blk.shift_size, scale=blk.attn.scale,
               num_heads=blk.num_heads, residual=residual)

    def attn(fn):
        return lambda x, dt: fn(x, *(prm[dt][k] for k in (
            "mod", "ln1_s", "ln1_b", "wq", "bq", "wkv", "bkv", "wo", "bo",
            "bias")), **akw)

    def attn_bwd(fn):
        return lambda x, g, dt: dict(zip(ATTN_GRADS, fn(x, g, *(
            prm[dt][k] for k in ("mod", "ln1_s", "ln1_b", "wq", "bq", "wkv",
                                 "bkv", "wo", "bo", "bias")), **akw)))

    def leff(fn):
        return lambda x, dt: fn(x, *(prm[dt][k] for k in (
            "w1", "b1", "wd", "bd", "w2", "b2")), ln_s=prm[dt]["ln2_s"],
            ln_b=prm[dt]["ln2_b"], residual=residual)

    def leff_bwd(fn):
        return lambda x, g, dt: dict(zip(LEFF_GRADS, fn(x, g, *(
            prm[dt][k] for k in ("w1", "b1", "wd", "bd", "w2", "ln2_s",
                                 "ln2_b")), residual=residual)))

    return {"attention_image": (attn(K.fused_attention_image),
                                attn(K.attention_image_reference)),
            "leff": (leff(K.fused_leff), leff(K.leff_reference)),
            "attention_bwd": (attn_bwd(K.fused_attention_image_bwd),
                              attn_bwd(K.attention_image_vjp_reference)),
            "leff_bwd": (leff_bwd(K.fused_leff_bwd),
                         leff_bwd(K.leff_vjp_reference))}


def train_configs(model):
    """(layer name, block, shift, residual) for every training-path
    geometry of `model`: each stage at shift 0 and, where it shifts, 4;
    residual as the block runs it in training (outside under DropPath)."""
    out = []
    for name in LAYERS:
        layer = getattr(model, name)
        shifts = (0, layer.win_size // 2) if layer.use_shift else (0,)
        for shift in shifts:
            blk = next((b for b in layer.blocks if b.shift_size == shift),
                       layer.blocks[0])
            out.append((name, blk, shift, blk.drop_path1.rate == 0.0))
    return out


def with_shift(blk, shift):
    """blk, or a view of it run at another shift (the same weights)."""
    if blk.shift_size == shift:
        return blk
    view = copy.copy(blk)
    view.shift_size = shift
    return view


def train_kernel_checks(model, device, batch: int) -> Checks:
    """Forward kernels with residual=False on every block, and backward
    kernels against their plain VJPs at every training-path geometry of
    Uformer_B at 128^2, at this batch, fp32 and bf16."""
    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad():
        for name in LAYERS:
            layer = getattr(model, name)
            shape = (batch, layer.resolution, layer.resolution, layer.dim)
            for i, blk in enumerate(layer.blocks):
                prm = {dt: blk.kernel_params(dt)
                       for dt in (torch.float32, torch.bfloat16)}
                calls = block_calls(blk, prm, residual=False)
                x32 = torch.randn(shape, generator=gen).bfloat16().float() \
                    .to(device)
                what = f"{name}.{i} {shape} shift={blk.shift_size} res=0"
                for kernel in ("attention_image", "leff"):
                    compare(checks, kernel, what, *calls[kernel], x32)
        for name, blk, shift, residual in train_configs(model):
            layer = getattr(model, name)
            shape = (batch, layer.resolution, layer.resolution, layer.dim)
            blk = with_shift(blk, shift)
            prm = {dt: blk.kernel_params(dt)
                   for dt in (torch.float32, torch.bfloat16)}
            calls = block_calls(blk, prm, residual)
            x = torch.randn(shape, generator=gen).bfloat16().float() \
                .to(device)
            g = torch.randn(shape, generator=gen).bfloat16().float() \
                .to(device)
            what = f"{name} {shape} shift={shift} res={int(residual)}"
            for kernel in ("attention_bwd", "leff_bwd"):
                fused, plain = calls[kernel]
                grad_bound(checks, kernel, what,
                           fused(x, g, torch.float32),
                           plain(x, g, torch.float32),
                           plain(x.bfloat16(), g.bfloat16(), torch.bfloat16),
                           fused(x.bfloat16(), g.bfloat16(), torch.bfloat16))
    torch.cuda.synchronize()
    return checks


def train_batch(batch: int, seed: int, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (batch, RES_TRAIN, RES_TRAIN, 3)
    target = torch.rand(shape, generator=gen)
    noisy = (target + 0.1 * torch.randn(shape, generator=gen)).clamp(0, 1)
    return {"input": noisy.to(device), "target": target.to(device)}


def run_step(model, plain: bool, dtype, batch, seed: int, lr_schedule):
    """One train step through the port's entry points, mixup active
    (epoch 6 > 5); returns the loss and the step's state."""
    from uformer_tpu_torch.train import TrainState, make_optimizer, \
        make_train_step

    model.dtype = dtype
    state = TrainState(model, make_optimizer(model.parameters(),
                                             lr_schedule), step=5)
    step = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=1,
                           plain=plain)
    loss = step(state, batch, torch.Generator(device="cpu").manual_seed(seed))
    return loss, state, step


def whole_step_checks(sd, device, batch_size: int) -> Checks:
    """One train step of batch_size, kernel path against plain path: same
    weights, batch and generator; loss and every parameter's gradient, in
    fp32 and bf16. lr 0 keeps the weights for the next step."""
    model = build_model(sd, RES_TRAIN, device)
    batch = train_batch(batch_size, 3, device)

    def grads(plain, dtype):
        loss, _, _ = run_step(model, plain, dtype, batch, 4, lambda s: 0.0)
        out = {"loss": loss.reshape(1)}
        out.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return out

    ref = grads(True, torch.float32)
    got = grads(False, torch.float32)
    low = grads(True, torch.bfloat16)
    got16 = grads(False, torch.bfloat16)
    torch.cuda.synchronize()
    checks = Checks()
    grad_bound(checks, "model", f"train step bs{batch_size}", got, ref, low,
               got16)
    for n, v in got16.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"train step: non-finite {n}")
    return checks


def train_timing(sd, device):
    """BATCH_TRAIN x RES_TRAIN^2 bf16 train steps: launches per step and
    loss on the kernel path; ms per step (CUDA events) and peak memory on
    both paths, in the order plain, kernel, kernel..., plain."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.train import warmup_cosine_schedule

    model = build_model(sd, RES_TRAIN, device)
    batch = train_batch(BATCH_TRAIN, 5, device)
    sched = warmup_cosine_schedule(2e-4, 250, 100)
    out = {"kernel_ms": [], "plain_ms": [], "loss": [], "launches": []}

    def steps(plain, n, seed):
        model.dtype = torch.bfloat16
        _, state, step = run_step(model, plain, torch.bfloat16, batch, seed,
                                  sched)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for i in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            K.reset_counts()
            start.record()
            loss = step(state, batch, torch.Generator(device="cpu")
                        .manual_seed(seed + 1 + i))
            end.record()
            torch.cuda.synchronize()
            counts = K.launch_counts()
            key = "plain" if plain else "kernel"
            out[f"{key}_ms"].append(start.elapsed_time(end))
            if not plain:
                out["loss"].append(float(loss))
                out["launches"].append(counts)
                print(f"  step {i}: loss {float(loss):.6f}  "
                      f"{out['kernel_ms'][-1]:.3f} ms  launches {counts}",
                      flush=True)
                if counts != TRAIN_LAUNCHES:
                    raise RuntimeError(f"train: step {i} launched {counts}, "
                                       f"expected {TRAIN_LAUNCHES}")
                if not np.isfinite(float(loss)):
                    raise RuntimeError(f"train: step {i} loss {float(loss)}")
        return torch.cuda.max_memory_allocated(device)

    steps(True, 1, 100)
    out["peak_bytes"] = steps(False, N_TRAIN_STEPS, 200)
    plain_peak = steps(True, 1, 300)
    out["plain_peak_bytes"] = plain_peak
    out["kernel_ms_median"] = float(np.median(out["kernel_ms"]))
    out["plain_ms_median"] = float(np.median(out["plain_ms"]))
    print(f"  bs{BATCH_TRAIN} {RES_TRAIN}^2 bf16 step: kernel path "
          f"{out['kernel_ms_median']:.3f} ms (peak "
          f"{out['peak_bytes'] / 2**20:.1f} MiB), plain path "
          f"{out['plain_ms_median']:.3f} ms (peak "
          f"{plain_peak / 2**20:.1f} MiB)", flush=True)
    return model, out


def train_kernel_timing(model, device):
    """Device time of each kernel against its plain version at the bs
    BATCH_TRAIN bf16 shapes of one train step. One block per (stage,
    shift) is timed on random inputs and counted once per block of the
    stage with that shift; totals are per step."""
    gen = torch.Generator(device="cpu").manual_seed(6)
    rows, totals = [], {k: [0.0, 0.0] for k in
                        ("attention_image", "leff", "attention_bwd",
                         "leff_bwd")}
    with torch.no_grad():
        for name, blk, shift, residual in train_configs(model):
            layer = getattr(model, name)
            n = sum(b.shift_size == shift for b in layer.blocks)
            if n == 0:  # a geometry checked above but not on the step
                continue
            shape = (BATCH_TRAIN, layer.resolution, layer.resolution,
                     layer.dim)
            prm = {torch.bfloat16: blk.kernel_params(torch.bfloat16)}
            calls = block_calls(blk, prm, residual)
            x = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
            g = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
            for kernel, (fused, plain) in calls.items():
                args = (x, g) if kernel.endswith("bwd") else (x,)
                k_fn = (lambda f=fused, a=args: f(*a, torch.bfloat16))
                p_fn = (lambda f=plain, a=args: f(*a, torch.bfloat16))
                p1, k1, k2, p2 = (cuda_ms(p_fn, reps=5), cuda_ms(k_fn, reps=5),
                                  cuda_ms(k_fn, reps=5), cuda_ms(p_fn, reps=5))
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                totals[kernel][0] += n * k_ms
                totals[kernel][1] += n * p_ms
                rows.append({"layer": name, "shift": shift, "blocks": n,
                             "kernel": kernel, "shape": list(shape),
                             "ms": k_ms, "plain_ms": p_ms})
                print(f"  {name:16s} s{shift} x{n} {kernel:16s} "
                      f"{str(shape):22s} kernel {k_ms:8.3f} ms  plain "
                      f"{p_ms:8.3f} ms", flush=True)
    return rows, totals


def train_checks(sd, device, batch: int):
    """Kernel checks and one whole step against the plain path at this
    batch, with cuDNN's deterministic algorithms, so that the plain
    references repeat bit for bit."""
    torch.backends.cudnn.deterministic = True
    model = build_model(sd, RES_TRAIN, device)
    kchecks = train_kernel_checks(model, device, batch)
    kchecks.raise_if_failed(f"train kernels bs{batch}")
    del model
    schecks = whole_step_checks(sd, device, batch)
    schecks.raise_if_failed(f"train step bs{batch}")
    torch.backends.cudnn.deterministic = False
    return kchecks, schecks


def train_phase(sd, device):
    """The train path: the checks at bs BATCH_CHECK; timed bs BATCH_TRAIN
    steps and per-kernel times (cuDNN's defaults); then the checks again
    at bs BATCH_TRAIN, the shapes the timed steps run. Those come last:
    their fp32 plain references take tens of GB, which the timings then
    need not share the allocator with."""
    kchecks, schecks = train_checks(sd, device, BATCH_CHECK)
    model, timing = train_timing(sd, device)
    rows, totals = train_kernel_timing(model, device)
    del model
    torch.cuda.empty_cache()
    kbig, sbig = train_checks(sd, device, BATCH_TRAIN)
    kchecks.rows += kbig.rows
    schecks.rows += sbig.rows
    return kchecks, schecks, timing, rows, totals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, help="write the full report here")
    args = ap.parse_args()
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    card = card_line()
    device = torch.device("cuda", 0)
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.kernels import _build

    phase("build")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "build.log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line.lower():
            print(f"  {line.strip()}")
    print(f"  built {_build.library_path().name} in {build_s:.1f} s",
          flush=True)

    phase("kernels vs plain")
    data, sd = seeded_weights()
    model256 = build_model(sd, RES_SERVE, device)
    kchecks = kernel_phase(model256, device)
    kchecks.raise_if_failed("kernels")
    del model256

    phase("golden")
    gchecks = golden_phase(data, sd, device)
    gchecks.raise_if_failed("golden")

    phase("serve")
    restorer, x, serve, launches, schecks = serve_phase(sd, device)
    schecks.raise_if_failed("serve")

    phase("timing")
    rows, totals, fwd = timing_phase(restorer, x)

    phase("train")
    tkchecks, tschecks, train, trows, ttotals = train_phase(sd, device)

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "kernel_checks": kchecks.rows, "golden_checks": gchecks.rows,
              "serve_checks": schecks.rows, "serve": serve,
              "timing": rows, "forward": fwd,
              "train_kernel_checks": tkchecks.rows,
              "train_step_checks": tschecks.rows, "train": train,
              "train_timing": trows, "train_totals": ttotals}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))

    kernels = []
    train_launches = {k: sum(c[k] for c in train["launches"])
                      for k in KERNELS}
    for name, (source, replaces) in KERNELS.items():
        rows_of = [r for r in kchecks.rows + tkchecks.rows
                   if r["kernel"] == name]
        errs = [r["err"] for r in rows_of if r["dtype"] == "fp32"]
        errs16 = [r["err"] for r in rows_of if r["dtype"] == "bf16"]
        # serve timings for the forward kernels, train ones for the rest
        ms, plain_ms = totals.get(name, ttotals.get(name))
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": launches[name] + train_launches[name],
                 "launches_serve": launches[name],
                 "launches_train": train_launches[name],
                 "max_abs_err": max(errs),
                 "bf16_max_abs_err_vs_fp32": max(errs16),
                 "ms": ms, "plain_ms": plain_ms}
        if name in ttotals and name in totals:
            entry["train_ms"], entry["train_plain_ms"] = ttotals[name]
        kernels.append(entry)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
