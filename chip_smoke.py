#!/usr/bin/env python3
"""On-card smoke run of `uformer_tpu_torch`, the PyTorch/CUDA port.

    python3 chip_smoke.py [--json PATH]   # on a machine with one CUDA
                                          # card (H100: kernels are sm_90a)

Phases, each raising on failure (no phase is caught):
  1. device  - fails at once without CUDA; prints the card and power limit.
  2. build   - nvcc builds the kernels of csrc/ (sm_90a), one process per
               source, in parallel.
  3. kernels - each kernel against its plain PyTorch version at every
               main-path shape of Uformer_B and of Uformer_T at 256^2
               (batch 2), in fp32 (TF32 off) and bf16: for Uformer_T the
               stage and attention-image kernels at head dim 16, the
               attention-block kernel at enc0 (LN and modulator each way,
               the windows at place 0 and 37, batch 1, 2 and 3), LeFF at
               C 16-64, and the window-attention core at every stage's
               heads and shifts, also on 37 windows more; kernels 4 and 5
               also at one Uformer_B (head dim 32) geometry; the
               attention-image
               kernel (its narrow and wide bf16 bodies) at every shape it
               runs at in serve B, serve T, train and train T, residual on
               and off; the depthwise kernel, per call and in its fused
               q/k/v form (also equal bits to three launches and a ReLU),
               at every serve B-conv stage's (Bw, 8, 8, C) windows, 4 x 4
               windows, a whole image, an odd C without bias and C = 8;
               then the tensor-core tiles' own shapes: the building block
               (mma.sync, cp.async ring) against torch.matmul, LeFF at
               every C 16-512 on an 8 x 8 image, non-square and
               partial-tile images and 64 x 64 at C = 32, the stage at
               C = 512 with 16 heads on 8 x 8 and at C = 256 with shift
               on 16 x 16.
  4. golden  - Uformer_B at 128^2, fp32, through the kernels, stage by stage
               against the recorded torch activations of
               tests/golden/uformer_b_128.npz; then the conv-projection,
               Mlp, cross-modulator Uformer of
               tests/golden/uformer_convproj_crossmod.npz (64^2) through
               the depthwise kernel (9 fused q/k/v launches), output within
               1e-4.
  5. serve   - a bf16 Restorer for Uformer_B at 256^2 answers 4 requests of
               batch 8; launch counts per request, ms per request, MP/s,
               peak memory; the kernel path against the plain path.
  6. timing  - each kernel against its plain version at the bs8 256^2
               shapes, stage by stage (ms, plain ms, bound, TFLOP/s and
               share of the bound), and the whole forward.
  7. serve T - the same for Uformer_T (seeded numpy weights over the port's
               own parameter names): 4 requests of batch 8 at 256^2.
  8. timing T - as 6 for Uformer_T, and the window-attention core alone at
               its enc0 shape, at head dim 32 there and at four heads of
               512 windows, against its plain version and against
               F.scaled_dot_product_attention (a yardstick the port never
               calls).
  9. serve B-conv - Uformer_B's widths and depths with the conv token
               projection (seeded numpy weights over the port's parameter
               names): 4 bf16 requests of batch 8 at 256^2, 40 fused q/k/v
               depthwise and 40 LeFF launches each; host enqueue and
               device time.
 10. timing B-conv - per stage the depthwise kernel in both forms (the
               fused q/k/v launch the model runs, and three per-call
               launches) against its plain version, its bound and cuDNN
               (one grouped F.conv2d for the three convs; the depthwise
               F.conv2d per call: yardsticks the port never calls),
               eagerly and from CUDA graphs (device time alone), and how
               the forward splits
               between the depthwise kernel, the pointwise products, the
               plain attention, LeFF and the glue.
 11. train   - Uformer_B at 128^2 in training (drop path 0.1, mixup on):
               the forward kernels with residual=False and the backward
               kernels against their plain versions at every stage shape
               (shift 0 and 4, fp32 and bf16, every gradient) and one
               whole train step, kernel path against plain path (fp32 and
               bf16, loss and every parameter's gradient), at batch 2 and
               again at batch 32; bs 32 bf16 train steps: launches per
               step, loss, ms per step on both paths, peak memory; each
               kernel's time against its plain version at the bs 32
               shapes, forward and backward, and each backward's parts
               timed alone on the same buffers (kernel 7's A and B,
               kernel 6's body, the weight-gradient reductions beside
               torch.matmul(a.T, b), a yardstick the port never calls,
               and colsum); each backward kernel run twice on the same
               inputs must give equal bits.
 12. train T - the same for Uformer_T (its seeded weights): enc0's two
               blocks take the windowed branch, whose forward and backward
               kernels (attention_block, attention_block_bwd) are checked
               on its (Bw, 64, 16) windows, the other 16 blocks the image
               route at head dim 16; 16/2/18 forward and 16/2/18 backward
               launches (attention_image/attention_block/leff and
               attention_bwd/attention_block_bwd/leff_bwd) per step.
 13. train Mlp + cross-modulator - one bs 2 step of a linear-projection
               model with Mlp blocks and the cross-modulator (embed 16,
               Uformer_T's heads, depth 1), kernel path against plain
               path: its attention through kernels 1, 5 and 6, the Mlp and
               the cross-attention plain.

Tolerances: fp32 max-abs <= 1e-4 * (1 + max|ref|); bf16 error against the
fp32 plain result <= 1.5 x the bf16 plain version's error + 1e-3; for
gradients, per tensor, the bf16 term is 1e-3 * max(1, max|ref|), since
weight gradients are sums over every token; golden as
tests/test_golden_parity.py. --json PATH writes every check and timing
there. Each kernel's bound is the larger of its operations at the bf16
tensor-core peak and its bytes (inputs read once, outputs written once) at
the HBM rate of an H100 SXM (the depthwise kernel's operations at the
float32 rate outside the tensor cores). The line before the last lists
every kernel; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
BATCH_CHECK, BATCH_SERVE, RES_SERVE, RES_GOLDEN = 2, 8, 256, 128
BATCH_TRAIN, RES_TRAIN, N_TRAIN_STEPS = 32, 128, 3
N_REQUESTS = 4
SEED_T = 1235  # Uformer_T's seeded weights
SEED_BCONV = 1236  # serve B-conv's seeded weights
EXPECTED_LAUNCHES = {"stage": 6, "attention_image": 4, "leff": 4,
                     "attention_bwd": 0, "attention_block_bwd": 0,
                     "leff_bwd": 0, "window_attention": 0,
                     "attention_block": 0, "dwconv3x3": 0,
                     "dwconv3x3_qkv": 0}
T_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0), stage=4,
                  attention_image=8, leff=10, attention_block=2)
TRAIN_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0), attention_image=40,
                      leff=40, attention_bwd=40, leff_bwd=40)
# a Uformer_T train step at 128^2: enc0's two blocks take the windowed
# branch (kernels 5 and 6 on windows), the other 16 the image route
T_TRAIN_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0),
                        attention_image=16, attention_block=2, leff=18,
                        attention_bwd=16, attention_block_bwd=2,
                        leff_bwd=18)
# the Mlp and cross-modulator model (embed 16, Uformer_T's heads, depth 1
# per stage, 128^2): attention through the kernels, Mlp and the
# cross-attention plain
MLP_CROSS = dict(img_size=RES_TRAIN, embed_dim=16, depths=(1,) * 9,
                 num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), win_size=8,
                 token_mlp="mlp", cross_modulator=True, modulator=True)
MLP_CROSS_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0),
                          attention_image=8, attention_bwd=8,
                          attention_block=1, attention_block_bwd=1)
SEED_MLP_CROSS = 1237
# serve B-conv: Uformer_B's widths and depths with the conv token
# projection (per block one launch of kernel 8 for the q, k and v
# depthwise convs: 40 launches)
BCONV = dict(img_size=RES_SERVE, embed_dim=32, depths=(1, 2, 8, 8, 2, 8, 8,
                                                       2, 1),
             num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), win_size=8,
             mlp_ratio=4.0, token_projection="conv", token_mlp="leff",
             modulator=True, shift_flag=True)
BCONV_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0), leff=40,
                      dwconv3x3_qkv=40)
GOLDEN_CONV_LAUNCHES = dict(dict.fromkeys(EXPECTED_LAUNCHES, 0),
                            dwconv3x3_qkv=9)
# H100 SXM (NVIDIA data sheet): dense bf16 tensor-core FLOP/s, float32
# FLOP/s outside the tensor cores, HBM bytes/s
PEAK_BF16, PEAK_FP32, PEAK_HBM = 989e12, 67e12, 3.35e12
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "stage": ("uformer_tpu_torch/csrc/stage.cu",
              "uformer_tpu/ops/pallas/stage.py:418"),
    "attention_image": ("uformer_tpu_torch/csrc/attention_image.cu",
                        "uformer_tpu/ops/pallas/attention_image.py:652"),
    "leff": ("uformer_tpu_torch/csrc/leff.cu",
             "uformer_tpu/ops/pallas/leff.py:1132"),
    "attention_bwd": ("uformer_tpu_torch/csrc/attention_bwd.cu",
                      "uformer_tpu/ops/pallas/attention_block.py:877"),
    "attention_block_bwd": ("uformer_tpu_torch/csrc/attention_block_bwd.cu",
                            "uformer_tpu/ops/pallas/attention_block.py:877"),
    "leff_bwd": ("uformer_tpu_torch/csrc/leff_bwd.cu",
                 "uformer_tpu/ops/pallas/leff.py:880"),
    "window_attention": ("uformer_tpu_torch/csrc/window_attention.cu",
                         "uformer_tpu/ops/pallas/window_attention.py:97"),
    "attention_block": ("uformer_tpu_torch/csrc/attention_block.cu",
                        "uformer_tpu/ops/pallas/attention_block.py:1152"),
    "dwconv3x3": ("uformer_tpu_torch/csrc/dwconv.cu",
                  "uformer_tpu/ops/pallas/dwconv.py:52"),
}
# the tensor-core tiles' own shapes (csrc/leff_mma.cuh): (M, N, K, n8
# tiles a warp takes) of the building block; LeFF images (B, H, W, C);
# stages (B, C, nH, res, n, use_shift, has_mod): the conv stage's 8 x 8
# at C = 512, shift at C = 256, then batches at which the host picks
# 16-row LeFF tiles and 2 or 4 windows per attention item
TILE_BLOCK_SHAPES = [(112, 64, 512, 4), (64, 512, 64, 4), (192, 64, 64, 4),
                     (128, 32, 64, 2), (128, 16, 64, 1), (100, 32, 128, 2)]
TILE_LEFF_SHAPES = ([(2, 8, 8, C) for C in (16, 32, 64, 128, 256, 512)]
                    + [(1, 16, 24, C) for C in (16, 32, 64, 128, 256, 512)]
                    + [(1, 24, 40, C) for C in (16, 32, 64, 128, 256, 512)]
                    + [(2, 64, 64, 32), (4, 64, 64, 128), (4, 64, 64, 256)])
TILE_STAGE_SHAPES = [(BATCH_CHECK, 512, 16, 8, 2, False, True),
                     (BATCH_CHECK, 256, 8, 16, 2, True, True),
                     (4, 256, 8, 64, 2, True, True),
                     (4, 128, 4, 64, 2, True, False),
                     (8, 128, 8, 64, 2, True, True)]
# kernel 1 on the main paths (cell, stage, B, res, C, heads, modulator):
# serve B and serve T at bs8 256^2, the train and train T steps at bs32
# 128^2 (train T's enc0 takes the windowed branch, kernel 5)
ATTN_IMAGE_SHAPES = (
    [("serve B", "enc0", 8, 256, 32, 1, False),
     ("serve B", "enc1", 8, 128, 64, 2, False),
     ("serve B", "dec3", 8, 256, 64, 2, True),
     ("serve T", "enc1", 8, 128, 32, 2, False),
     ("serve T", "enc2", 8, 64, 64, 4, False),
     ("serve T", "dec2", 8, 128, 64, 4, True),
     ("serve T", "dec3", 8, 256, 32, 2, True)]
    + [("train", f"enc{k}", 32, 128 >> k, 32 << k, 1 << k, False)
       for k in range(4)]
    + [("train", "conv", 32, 8, 512, 16, False),
       ("train", "dec0", 32, 16, 512, 16, True),
       ("train", "dec1", 32, 32, 256, 8, True),
       ("train", "dec2", 32, 64, 128, 4, True),
       ("train", "dec3", 32, 128, 64, 2, True)]
    + [("train T", f"enc{k + 1}", 32, 64 >> k, 32 << k, 2 << k, False)
       for k in range(3)]
    + [("train T", "conv", 32, 8, 256, 16, False),
       ("train T", "dec0", 32, 16, 256, 16, True),
       ("train T", "dec1", 32, 32, 128, 8, True),
       ("train T", "dec2", 32, 64, 64, 4, True),
       ("train T", "dec3", 32, 128, 32, 2, True)])
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


def graph_ms(fn, n: int = 20) -> float:
    """Device time of one fn() from a CUDA graph of n calls, replayed 10
    times: the kernels alone, without the host's cost of launching them."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay) / n


def attn_cost(tokens, C, nH, s=2, mod=True, ln=True):
    """(operations, bytes) of an attention sub-block (kernels 1 and 5) over
    `tokens` tokens of width C: the q, kv and output projections and two
    64 x 64 x D products per head and window; x read and y written once,
    the weights, biases, bias table [, modulator, LN] read once."""
    weights = (4 * C * C * s + 4 * C * 4 + nH * 4096 * 4
               + (64 * C * s if mod else 0) + (2 * C * 4 if ln else 0))
    return 2 * tokens * C * (4 * C + 128), 2 * tokens * C * s + weights


def leff_cost(tokens, C, Ch, s=2):
    """(operations, bytes) of a LeFF sub-block: two C x Ch products and
    the 3 x 3 depthwise taps per token; x, y and the weights once."""
    return (tokens * (4 * C * Ch + 18 * Ch),
            2 * tokens * C * s + (2 * C * Ch + 9 * Ch) * s
            + (2 * Ch + 3 * C) * 4)


def stage_cost(tokens, C, nH, Ch, n, s=2, mod=True):
    """n blocks of a stage: the stage image in and out once, every
    block's weights once."""
    fa, ba = attn_cost(tokens, C, nH, s, mod)
    fl, bl = leff_cost(tokens, C, Ch, s)
    act = 2 * tokens * C * s
    return n * (fa + fl), act + n * (ba + bl - 2 * act)


def core_cost(nH, Bw, D, s=2):
    """The window-attention core: q, k, v read and the output written."""
    return (4 * nH * Bw * 64 * 64 * D,
            4 * nH * Bw * 64 * D * s + nH * 4096 * 4)


def dwconv_cost(pixels, C, s=2, ws=2, nq=1):
    """nq depthwise 3x3 convs of one input (nq = 3: the fused q/k/v form):
    nine multiply-adds and the bias per output value; x read once and each
    output written once, each weight set (ws bytes) and float32 bias
    once."""
    return (19 * nq * pixels * C,
            (1 + nq) * pixels * C * s + nq * (9 * C * ws + 4 * C))


def bwd_cost(fwd, tokens, C, s=2):
    """A backward kernel of a sub-block of cost `fwd`: twice its products
    (input and weight gradients); x and the output gradient read, dx
    written, the weights read and their float32 gradients written."""
    flops, nbytes = fwd
    weights = nbytes - 2 * tokens * C * s
    return 2 * flops, 3 * tokens * C * s + 3 * weights


def ptxas_report(text: str) -> list:
    """[name, registers (None for a device function), spill store bytes,
    spill load bytes] of each function in `nvcc -Xptxas -v` output."""
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            rows.append([name, None, int(m[1]), int(m[2])])
            name = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][1] is None:
            rows[-1][1] = int(m[1])
    return rows


def rate(cost, k_ms: float, b_ms: float) -> str:
    """TFLOP/s of a call of `cost` = (operations, bytes) taking k_ms, and
    its bound b_ms as a share of k_ms."""
    return (f"{cost[0] / (k_ms * 1e-3) / 1e12:7.2f} TFLOP/s, "
            f"{100.0 * b_ms / k_ms:5.1f}% of bound")


def tally(totals: dict, kernel: str, k_ms: float, p_ms: float, cost,
          n: int = 1, peak: float = PEAK_BF16) -> float:
    """Add n calls of `kernel` (its time, its plain version's, and the
    bound of `cost` = (operations, bytes), the operations at `peak`) to
    totals; returns the bound of the n calls in ms."""
    t = totals.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0,
                                   "launches": 0, "bound_ms": 0.0,
                                   "op_ms": 0.0, "byte_ms": 0.0})
    op, byte = cost[0] / peak * 1e3, cost[1] / PEAK_HBM * 1e3
    t["ms"] += n * k_ms
    t["plain_ms"] += n * p_ms
    t["launches"] += n
    t["bound_ms"] += n * max(op, byte)
    t["op_ms"] += n * op
    t["byte_ms"] += n * byte
    return n * max(op, byte)


def bound_by(t: dict) -> str:
    return "operations" if t["op_ms"] >= t["byte_ms"] else "bytes"


def kernel_count(counts: dict, name: str) -> int:
    """Launches of the TPU kernel `name` in a launch_counts() dict: kernel
    8 in either of its forms (dwconv3x3, dwconv3x3_qkv)."""
    return counts[name] + (counts["dwconv3x3_qkv"] if name == "dwconv3x3"
                           else 0)


def golden_module():
    """tests/golden/generate.py, loaded by path: a site package named
    `tests` may shadow the repo's directory."""
    spec = importlib.util.spec_from_file_location(
        "golden_generate", REPO / "tests" / "golden" / "generate.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def seeded_weights():
    """The golden Uformer_B state_dict, regenerated from its seed (numpy)."""
    data = np.load(REPO / "tests" / "golden" / "uformer_b_128.npz")
    keys_shapes = json.loads(str(data["sd_manifest"]))
    return data, golden_module().seeded_state_dict(keys_shapes,
                                                   int(data["seed"]))


def bconv_weights():
    """serve B-conv's weights drawn with numpy from SEED_BCONV over the
    port's own parameter names, by the golden weights' rule."""
    from uformer_tpu_torch.models import Uformer

    model = Uformer(**BCONV)
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    return golden_module().seeded_state_dict(keys_shapes, SEED_BCONV)


def build_bconv(sd, device):
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models import Uformer

    return load_numpy_state_dict(Uformer(**BCONV), sd).to(device).eval()


def build_model(sd, train_ps: int, device, arch: str = "Uformer_B"):
    from uformer_tpu_torch import get_arch
    from uformer_tpu_torch.convert import load_numpy_state_dict

    model = get_arch({"arch": arch, "train_ps": train_ps})
    return load_numpy_state_dict(model, sd).to(device).eval()


def t_weights():
    """Uformer_T's weights drawn with numpy from SEED_T over the port's own
    parameter names, by the golden weights' rule (N(0, 1/fan_in) matrices,
    LayerNorm scales near 1, small biases)."""
    from uformer_tpu_torch import get_arch

    model = get_arch({"arch": "Uformer_T"})
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    return golden_module().seeded_state_dict(keys_shapes, SEED_T)


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


@torch.no_grad()
def kernel_phase(model, device) -> Checks:
    """Every kernel against its plain version at the main-path shapes of
    `model` at 256^2, batch BATCH_CHECK, with the model's own weights: the
    stage kernel, or per block the attention-image kernel or, off the
    image route, the attention-block kernel (block_checks), and LeFF."""
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
            compare(checks, "stage", f"{name} {shape} n={len(layer.blocks)} "
                    f"nH={layer.num_heads}",
                    lambda x, dt: K.fused_stage(x, prm[dt], **kw),
                    lambda x, dt: K.stage_reference(x, prm[dt], **kw), x32)
            continue
        for i, blk in enumerate(layer.blocks):
            prm = {dt: blk.kernel_params(dt)
                   for dt in (torch.float32, torch.bfloat16)}
            what = (f"{name}.{i} {shape} nH={blk.num_heads} "
                    f"shift={blk.shift_size}")

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

            if blk.image_route:
                compare(checks, "attention_image", what,
                        attn(K.fused_attention_image),
                        attn(K.attention_image_reference), x32)
            else:
                block_checks(checks, blk, prm, shape, gen, device, what)
            compare(checks, "leff", what, leff(K.fused_leff),
                    leff(K.leff_reference), x32)
    torch.cuda.synchronize()
    return checks


def block_checks(checks: Checks, blk, prm, shape, gen, device,
                 what: str) -> None:
    """The attention-block kernel at blk's geometry on random windows of
    `shape` images at batch 1, B and 3 (tails of the persistent grid),
    with LN and a modulator each on and off (the model runs it with LN
    outside, and with the block's own modulator), the windows at place 0
    and at place 37 of the image's (wrapping past the last)."""
    from uformer_tpu_torch.ops import kernels as K

    B, H, W, C = shape
    mod = torch.randn((64, C), generator=gen).bfloat16().float().to(device)
    for batch in (1, B, 3):
        wnd = torch.randn((batch * H * W // 64, 64, C), generator=gen) \
            .bfloat16().float().to(device)
        for w_off, has_ln, with_mod in itertools.product(
                (0, 37), (False, True), (False, True)):
            def run(fn, has_ln=has_ln, with_mod=with_mod, w_off=w_off):
                return lambda x, dt: fn(
                    x, mod.to(dt) if with_mod else None, prm[dt]["ln1_s"],
                    prm[dt]["ln1_b"], *(prm[dt][k] for k in (
                        "wq", "bq", "wkv", "bkv", "wo", "bo", "bias")),
                    win=blk.win_size, shift=blk.shift_size, H=H, W=W,
                    scale=blk.attn.scale, num_heads=blk.num_heads,
                    has_ln=has_ln, w_off=w_off)

            compare(checks, "attention_block",
                    f"{what} Bw={wnd.shape[0]} w_off={w_off} "
                    f"ln={int(has_ln)} mod={int(with_mod)}",
                    run(K.fused_attention_block),
                    run(K.attention_block_reference), wnd)


def core_checks(checks: Checks, model, names, device, gen) -> None:
    """The window-attention core at the (resolution, heads) of each named
    stage of `model` at 256^2, batch BATCH_CHECK, and on 37 windows more
    (a range of work items that no grid divides), with the bias of the
    stage's first block, at each shift the stage runs."""
    from uformer_tpu_torch.ops import kernels as K

    for name in names:
        layer = getattr(model, name)
        res, nH = layer.resolution, layer.num_heads
        D = layer.dim // nH
        bias = layer.blocks[0].kernel_params(torch.float32)["bias"]
        for Bw in (BATCH_CHECK * (res // 8) ** 2,
                   BATCH_CHECK * (res // 8) ** 2 + 37):
            q, k, v = (torch.randn((nH, Bw, 64, D), generator=gen)
                       .bfloat16().float().to(device) for _ in range(3))
            for shift in ((0, 4) if layer.use_shift else (0,)):
                kw = dict(win=8, shift=shift, H=res, W=res, scale=D ** -0.5)

                def run(fn, kw=kw, k=k, v=v, bias=bias):
                    return lambda x, dt: fn(x, k.to(dt), v.to(dt), bias,
                                            **kw)

                compare(checks, "window_attention",
                        f"{name} (nH, Bw, 64, D)=({nH}, {Bw}, 64, {D}) "
                        f"shift={shift}", run(K.fused_window_attention),
                        run(K.window_attention_reference), q)


@torch.no_grad()
def kernel_phase_t(model_t, model_b, device) -> Checks:
    """Uformer_T's main-path shapes at 256^2 (head dim 16 throughout), the
    core at every stage, and kernels 4 and 5 at Uformer_B's enc1 (C 64,
    two heads of 32, shift 4)."""
    checks = kernel_phase(model_t, device)
    gen = torch.Generator(device="cpu").manual_seed(7)
    core_checks(checks, model_t, LAYERS, device, gen)
    core_checks(checks, model_b, ["encoderlayer_1"], device, gen)
    layer = model_b.encoderlayer_1
    blk = layer.blocks[1]
    prm = {dt: blk.kernel_params(dt) for dt in (torch.float32, torch.bfloat16)}
    block_checks(checks, blk, prm, (BATCH_CHECK, layer.resolution,
                                    layer.resolution, layer.dim), gen,
                 device, f"Uformer_B encoderlayer_1.1 shift={blk.shift_size}")
    torch.cuda.synchronize()
    return checks


@torch.no_grad()
def attention_image_phase(device) -> Checks:
    """Kernel 1 against its plain version at every ATTN_IMAGE_SHAPES shape
    (bf16: the narrow body at C 16-64, the wide one at C 128-512, windows
    per work item as the host plans them; fp32: a window per block),
    residual on and off (training runs both), shift 4 where the image is
    wider than a window, on random weights (matrices N(0, 1 / C))."""
    from uformer_tpu_torch.ops import kernels as K

    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(12)
    low = ("mod", "wq", "wkv", "wo")

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    for cell, stage, B, R, C, nH, with_mod in ATTN_IMAGE_SHAPES:
        s = C ** -0.5
        w = dict(mod=rnd(64, C, scale=0.1) if with_mod else None,
                 ln_s=1.0 + rnd(C, scale=0.1), ln_b=rnd(C, scale=0.1),
                 wq=rnd(C, C, scale=s), bq=rnd(C, scale=0.1),
                 wkv=rnd(C, 2 * C, scale=s), bkv=rnd(2 * C, scale=0.1),
                 wo=rnd(C, C, scale=s), bo=rnd(C, scale=0.1),
                 bias=rnd(nH, 64, 64, scale=0.5))
        w = {k: v.bfloat16().float() if v is not None and k in low else v
             for k, v in w.items()}
        prm = {dt: [v.to(dt) if v is not None and k in low else v
                    for k, v in w.items()]
               for dt in (torch.float32, torch.bfloat16)}
        x32 = rnd(B, R, R, C).bfloat16().float()
        for residual in (True, False):
            kw = dict(win=8, shift=4 if R > 8 else 0, scale=(C // nH) ** -0.5,
                      num_heads=nH, residual=residual)

            def run(fn, kw=kw, prm=prm):
                return lambda x, dt: fn(x, *prm[dt], **kw)

            compare(checks, "attention_image",
                    f"{cell} {stage} ({B}, {R}, {R}, {C}) nH={nH} "
                    f"res={int(residual)}", run(K.fused_attention_image),
                    run(K.attention_image_reference), x32)
        del x32, prm, w
    torch.cuda.synchronize()
    return checks


@torch.no_grad()
def dwconv_phase(model, device) -> Checks:
    """The depthwise kernel against its plain version in fp32 and bf16 (bf16
    weights, fp32 bias): at every serve B-conv stage's (Bw, 8, 8, C)
    windows at 256^2, batch BATCH_CHECK, with the stage's first to_q
    weights and bias; then on random weights at the 64^2 golden's 4 x 4
    bottleneck windows, a whole image, an odd C without bias (the scalar
    path) and C = 8. The fused q/k/v form (dwconv3x3_qkv, ReLU on) at
    every stage's windows with the block's three weight sets, and at the
    other shapes on three random ones: against its plain version, and
    equal bits to three dwconv3x3 launches and F.relu (a check with bound
    0)."""
    from uformer_tpu_torch.ops import kernels as K

    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(9)
    cases = []
    for name in LAYERS:
        layer = getattr(model, name)
        qkv = layer.blocks[0].attn.qkv
        w3 = torch.stack([getattr(qkv, n).depthwise.weight[:, 0]
                          .permute(1, 2, 0) for n in ("to_q", "to_k",
                                                      "to_v")])
        b3 = torch.stack([getattr(qkv, n).depthwise.bias
                          for n in ("to_q", "to_k", "to_v")])
        cases.append((f"{name} windows", (BATCH_CHECK * (layer.resolution
                                                         // 8) ** 2, 8, 8,
                                          layer.dim), w3, b3))
    for what, shape, with_bias in (("4x4 windows", (2, 4, 4, 128), True),
                                   ("image", (2, 64, 64, 128), True),
                                   ("odd C, no bias", (2, 24, 40, 12), False),
                                   ("C 8", (128, 8, 8, 8), True)):
        C = shape[-1]
        w3 = torch.randn((3, 3, 3, C), generator=gen) / 3
        b3 = torch.randn(3, C, generator=gen) * 0.1 if with_bias else None
        cases.append((what, shape, w3, b3))
    for what, shape, w3, b3 in cases:
        w3 = w3.detach().float().bfloat16().float().to(device).contiguous()
        b3 = None if b3 is None else b3.detach().float().to(device)
        ws = {torch.float32: w3, torch.bfloat16: w3.bfloat16()}
        b = None if b3 is None else b3[0]
        x32 = torch.randn(shape, generator=gen).bfloat16().float().to(device)
        compare(checks, "dwconv3x3", f"{what} {shape}",
                lambda x, dt, ws=ws, b=b: K.dwconv3x3(x, ws[dt][0], b),
                lambda x, dt, ws=ws, b=b: K.dwconv3x3_reference(
                    x, ws[dt][0], b), x32)
        compare(checks, "dwconv3x3", f"qkv {what} {shape}",
                lambda x, dt, ws=ws, b3=b3: torch.stack(K.dwconv3x3_qkv(
                    x, ws[dt], b3)),
                lambda x, dt, ws=ws, b3=b3: torch.stack(
                    K.dwconv3x3_qkv_reference(x, ws[dt], b3)), x32)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            fused = K.dwconv3x3_qkv(x, ws[dt], b3)
            # clones: a slice of the stacked weights need not be aligned
            differ = sum(not torch.equal(y, F.relu(K.dwconv3x3(
                x, ws[dt][i].clone(), None if b3 is None else b3[i].clone())))
                for i, y in enumerate(fused))
            checks.add("dwconv3x3", f"qkv = 3 launches + ReLU {what} {shape} "
                       f"{str(dt)[6:]}", float(differ), 0.0, "bits")
    torch.cuda.synchronize()
    return checks


@torch.no_grad()
def tile_phase(device) -> Checks:
    """The tensor-core tiles at their own shapes (TILE_*_SHAPES) on random
    weights (matrices N(0, 1 / fan-in)): the building block against
    torch.matmul on the same bf16 values (fp32, TF32 off: the products are
    exact, only the order of the sums differs); LeFF and the stage kernel
    against their plain versions in fp32 and bf16."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.kernels.mma import block_product

    checks = Checks()
    gen = torch.Generator(device="cpu").manual_seed(11)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

    for M, N, Kd, nt in TILE_BLOCK_SHAPES:
        a = rnd(M, Kd, dtype=torch.bfloat16)
        b = rnd(Kd, N, dtype=torch.bfloat16)
        ref = torch.matmul(a.float(), b.float())
        checks.add("block_product", f"({M}, {Kd}) @ ({Kd}, {N}) nt={nt}",
                   max_err(block_product(a, b, nt), ref),
                   1e-4 * (1.0 + float(ref.abs().max())), "fp32")
    for shape in TILE_LEFF_SHAPES:
        C = shape[-1]
        Ch = 4 * C
        w = dict(w1=rnd(C, Ch, scale=C ** -0.5), b1=rnd(Ch, scale=0.1),
                 wd=rnd(3, 3, Ch, scale=1 / 3), bd=rnd(Ch, scale=0.1),
                 w2=rnd(Ch, C, scale=Ch ** -0.5), b2=rnd(C, scale=0.1))
        w = {k: v.bfloat16().float() for k, v in w.items()}
        ln = dict(ln_s=1.0 + rnd(C, scale=0.1), ln_b=rnd(C, scale=0.1))
        ws = {dt: {k: v.to(dt) if k in ("w1", "wd", "w2") else v
                   for k, v in w.items()}
              for dt in (torch.float32, torch.bfloat16)}
        x32 = rnd(*shape).bfloat16().float()

        def leff(fn, ws=ws, ln=ln):
            return lambda x, dt: fn(x, *(ws[dt][k] for k in (
                "w1", "b1", "wd", "bd", "w2", "b2")), residual=True, **ln)

        compare(checks, "leff", f"tile {shape}", leff(K.fused_leff),
                leff(K.leff_reference), x32)
    for B, C, nH, res, n, use_shift, has_mod in TILE_STAGE_SHAPES:
        Ch = 4 * C
        p = dict(ln1_s=1.0 + rnd(n, C, scale=0.1), ln1_b=rnd(n, C, scale=0.1),
                 wq=rnd(n, C, C, scale=C ** -0.5), bq=rnd(n, C, scale=0.1),
                 wk=rnd(n, C, C, scale=C ** -0.5), bk=rnd(n, C, scale=0.1),
                 wv=rnd(n, C, C, scale=C ** -0.5), bv=rnd(n, C, scale=0.1),
                 wo=rnd(n, C, C, scale=C ** -0.5), bo=rnd(n, C, scale=0.1),
                 bias=rnd(n, nH, 64, 64, scale=0.5),
                 mod=rnd(n, 64, C, scale=0.1),
                 ln2_s=1.0 + rnd(n, C, scale=0.1), ln2_b=rnd(n, C, scale=0.1),
                 w1=rnd(n, C, Ch, scale=C ** -0.5), b1=rnd(n, Ch, scale=0.1),
                 wd=rnd(n, 3, 3, Ch, scale=1 / 3), bd=rnd(n, Ch, scale=0.1),
                 w2=rnd(n, Ch, C, scale=Ch ** -0.5), b2=rnd(n, C, scale=0.1))
        low = ("wq", "wk", "wv", "wo", "mod", "w1", "wd", "w2")
        p = {k: v.bfloat16().float() if k in low else v for k, v in p.items()}
        prm = {dt: {k: v.to(dt) if k in low else v for k, v in p.items()}
               for dt in (torch.float32, torch.bfloat16)}
        kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=use_shift,
                  has_mod=has_mod)
        x32 = rnd(B, res, res, C).bfloat16().float()
        compare(checks, "stage", f"tile B={B} C={C} nH={nH} {res}^2 n={n} "
                f"shift={int(use_shift)}",
                lambda x, dt, prm=prm, kw=kw: K.fused_stage(x, prm[dt], **kw),
                lambda x, dt, prm=prm, kw=kw: K.stage_reference(x, prm[dt],
                                                                **kw), x32)
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


def golden_conv_phase(device) -> Checks:
    """The recorded torch golden of the conv-projection Uformer (64^2,
    embed 8, depths 1, Mlp, modulator, cross-modulator, shift) in fp32 on
    the card through the depthwise kernel: the output within 1e-4
    (tests/test_golden_parity.py:25)."""
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models import Uformer
    from uformer_tpu_torch.ops import kernels as K

    kw = golden_module().CONVPROJ
    kw = dict(kw, depths=tuple(kw["depths"]), num_heads=tuple(kw["num_heads"]))
    data = np.load(REPO / "tests" / "golden" / "uformer_convproj_crossmod.npz")
    sd = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
    model = load_numpy_state_dict(Uformer(**kw), sd).to(device).eval()
    x = torch.from_numpy(data["input"].transpose(0, 2, 3, 1).copy())
    K.reset_counts()
    with torch.no_grad():
        y = model(x.to(device)).cpu()
    torch.cuda.synchronize()
    launched = K.launch_counts()
    print(f"  launches {launched}", flush=True)
    if launched != GOLDEN_CONV_LAUNCHES:
        raise RuntimeError(f"golden conv: launches {launched}, expected "
                           f"{GOLDEN_CONV_LAUNCHES}")
    checks = Checks()
    want = data["output"].transpose(0, 2, 3, 1)
    checks.add("model", "golden conv output",
               float(np.abs(y.numpy() - want).max()), 1e-4, "fp32")
    return checks


def serve_phase(make_model, device, expected: dict, label: str):
    """A bf16 Restorer of make_model() (a float32 model at 256^2 on the
    card) answers N_REQUESTS requests of batch BATCH_SERVE, each launching
    `expected`; returns the summary, the per-kernel launch totals and the
    checks of kernel path against plain path."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.restore import Restorer

    restorer = Restorer(make_model(), torch.bfloat16, device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    shape = (BATCH_SERVE, RES_SERVE, RES_SERVE, 3)
    requests = [torch.rand(shape, generator=gen)
                for _ in range(N_REQUESTS + 1)]
    restorer(requests[0])  # warm-up: cuDNN plans, kernel attributes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    K.reset_counts()
    per_request, ms, enqueue_ms, device_ms = [], [], [], []
    for x in requests[1:]:
        before = K.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        y = restorer(x)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
        after = K.launch_counts()
        per_request.append({k: after[k] - before[k] for k in after})
        if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()) \
                or float(y.min()) < 0.0 or float(y.max()) > 1.0:
            raise RuntimeError(f"{label}: bad output {tuple(y.shape)}")
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    for i, c in enumerate(per_request):
        print(f"  request {i}: launches {c}  {ms[i]:.3f} ms (host enqueue "
              f"{enqueue_ms[i]:.3f}, device {device_ms[i]:.3f})", flush=True)
        if c != expected:
            raise RuntimeError(f"{label}: request {i} launched {c}, "
                               f"expected {expected}")
    med = float(np.median(ms))
    mps = BATCH_SERVE * RES_SERVE * RES_SERVE / 1e6 / (med / 1e3)
    print(f"  median {med:.3f} ms/request  {mps:.2f} MP/s  peak "
          f"{peak / 2**20:.1f} MiB", flush=True)

    # kernel path against the plain path on the same weights (unclamped)
    x = requests[1].to(device)
    model16 = restorer.model
    model32 = make_model()
    from uformer_tpu_torch.utils.params import prepare_serving
    prepare_serving(model32, torch.float32)
    checks = Checks()
    with torch.no_grad():
        ref32 = model32(x, plain=True)
        e_plain = max_err(model16(x, plain=True), ref32)
        checks.add("model", f"{label} forward {shape}",
                   max_err(model16(x), ref32), 1.5 * e_plain + 1e-3, "bf16")
    del model32, ref32
    summary = {"ms_per_request": ms, "median_ms": med, "mp_per_s": mps,
               "host_enqueue_ms": enqueue_ms, "device_ms": device_ms,
               "max_memory_allocated_bytes": peak,
               "launches_per_request": per_request}
    return restorer, requests[1].to(device), summary, launches, checks


def timing_phase(restorer, x):
    """Device time of each kernel and of its plain version on the inputs
    the bs8 256^2 bf16 forward gives it, stage by stage, with each call's
    bound, and of the whole forward on each path. Returns the rows, the
    per-kernel totals over one forward (ms, plain ms, launches, bound) and
    the forward's times."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.norm import layer_norm
    from uformer_tpu_torch.ops.window import cyclic_shift, window_partition

    model = restorer.model
    inputs = {}
    hooks = [getattr(model, n).register_forward_pre_hook(
        lambda _m, args, n=n: inputs.__setitem__(n, args[0]))
        for n in LAYERS]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    rows, totals = [], {}
    with torch.no_grad():
        for name in LAYERS:
            layer, xin = getattr(model, name), inputs[name]
            B, H, W, C = xin.shape
            tokens, nH = B * H * W, layer.num_heads
            if layer.uses_stage(xin):
                pair = [("stage", lambda: layer(xin),
                         lambda: layer(xin, plain=True),
                         stage_cost(tokens, C, nH, 4 * C, len(layer.blocks),
                                    mod=layer.has_mod))]
            else:
                pair = []
                for blk in layer.blocks:
                    p = blk.params_for(xin.dtype, xin.device)
                    args = (p["mod"], p["ln1_s"], p["ln1_b"], p["wq"],
                            p["bq"], p["wkv"], p["bkv"], p["wo"], p["bo"],
                            p["bias"])
                    largs = (p["w1"], p["b1"], p["wd"], p["bd"], p["w2"],
                             p["b2"])
                    lkw = dict(ln_s=p["ln2_s"], ln_b=p["ln2_b"],
                               residual=True)
                    has_mod = p["mod"] is not None
                    if blk.image_route:
                        kw = dict(win=blk.win_size, shift=blk.shift_size,
                                  scale=blk.attn.scale, num_heads=nH)
                        xa = K.fused_attention_image(xin, *args, **kw)
                        pair.append((
                            "attention_image",
                            lambda xin=xin, args=args, kw=kw:
                            K.fused_attention_image(xin, *args, **kw),
                            lambda xin=xin, args=args, kw=kw:
                            K.attention_image_reference(xin, *args, **kw),
                            attn_cost(tokens, C, nH, mod=has_mod)))
                    else:
                        # the windowed branch's kernel input: LN1, shift,
                        # partition (the model's own glue)
                        wnd = window_partition(cyclic_shift(
                            layer_norm(xin, p["ln1_s"], p["ln1_b"]),
                            blk.shift_size), blk.win_size)
                        bargs = (p["mod"], None, None) + args[3:]
                        kw = dict(win=blk.win_size, shift=blk.shift_size,
                                  H=H, W=W, scale=blk.attn.scale,
                                  num_heads=nH, has_ln=False)
                        xa = xin + blk.windowed_attention(xin, p)
                        pair.append((
                            "attention_block",
                            lambda wnd=wnd, bargs=bargs, kw=kw:
                            K.fused_attention_block(wnd, *bargs, **kw),
                            lambda wnd=wnd, bargs=bargs, kw=kw:
                            K.attention_block_reference(wnd, *bargs, **kw),
                            attn_cost(tokens, C, nH, mod=has_mod, ln=False)))
                    pair.append(("leff",
                                 lambda xa=xa, largs=largs, lkw=lkw:
                                 K.fused_leff(xa, *largs, **lkw),
                                 lambda xa=xa, largs=largs, lkw=lkw:
                                 K.leff_reference(xa, *largs, **lkw),
                                 leff_cost(tokens, C, 4 * C)))
                    xin = K.fused_leff(xa, *largs, **lkw)
            for kernel, fused, plain, cost in pair:
                # plain, kernel, kernel, plain: alternate the order
                p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(fused),
                                  cuda_ms(fused), cuda_ms(plain))
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                b_ms = tally(totals, kernel, k_ms, p_ms, cost)
                rows.append({"layer": name, "kernel": kernel,
                             "shape": list(inputs[name].shape),
                             "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                             "tflops": cost[0] / (k_ms * 1e-3) / 1e12})
                print(f"  {name:16s} {kernel:16s} "
                      f"{str(tuple(inputs[name].shape)):22s} kernel "
                      f"{k_ms:8.3f} ms  plain {p_ms:8.3f} ms  bound "
                      f"{b_ms:7.4f} ms  {rate(cost, k_ms, b_ms)}",
                      flush=True)
        p1 = cuda_ms(lambda: model(x, plain=True), reps=5)
        k1 = cuda_ms(lambda: model(x), reps=5)
        k2 = cuda_ms(lambda: model(x), reps=5)
        p2 = cuda_ms(lambda: model(x, plain=True), reps=5)
    fwd = {"kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "runs_ms": {"plain": [p1, p2], "kernel": [k1, k2]}}
    for kernel, t in totals.items():
        print(f"  {kernel:16s} per forward: {t['launches']} launches, "
              f"kernel {t['ms']:8.3f} ms, plain {t['plain_ms']:8.3f} ms, "
              f"bound {t['bound_ms']:7.4f} ms ({bound_by(t)})", flush=True)
    print(f"  forward bs{x.shape[0]} {x.shape[1]}^2 bf16: kernel path "
          f"{fwd['kernel_ms']:.3f} ms, plain path {fwd['plain_ms']:.3f} ms",
          flush=True)
    return rows, totals, fwd


@torch.no_grad()
def bconv_timing(restorer, x):
    """serve B-conv's bs8 256^2 bf16 forward, block by block: for each
    stage and each shift it runs, one block timed on the stage's input and
    counted once per block of that shift. Kernel 8 in both forms on the
    same channels-last bf16 windows with bf16 weights: the fused q/k/v form
    (one launch a block, the model's; totals "dwconv3x3") against its
    plain version and against one grouped cuDNN F.conv2d computing the
    three convs (3C outputs, no ReLU), and the per-call form (three
    launches a block; totals "dwconv3x3 per call") against its plain
    version and cuDNN's depthwise F.conv2d (yardsticks the port never
    calls), each in the order plain, kernel, library, library, kernel,
    plain, and the kernels and cuDNN again from CUDA graphs (device time
    without the host's launch cost); the pointwise products (the three 1x1
    products and the output projection), the plain window attention, LeFF
    kernel and plain, and the whole block, whose remainder is the glue
    (LN1, roll, partition, modulator, reverse, residual). Then the whole
    forward on each path. Returns rows, per-kernel totals and the
    forward's split."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.attention import window_attention
    from uformer_tpu_torch.ops.norm import layer_norm
    from uformer_tpu_torch.ops.window import cyclic_shift, window_partition

    model = restorer.model
    inputs = {}
    hooks = [getattr(model, n).register_forward_pre_hook(
        lambda _m, args, n=n: inputs.__setitem__(n, args[0]))
        for n in LAYERS]
    model(x)
    for h in hooks:
        h.remove()
    rows, totals = [], {}
    split = dict.fromkeys(("dwconv3x3", "pointwise", "attention", "leff",
                           "glue"), 0.0)
    for name in LAYERS:
        layer, xin = getattr(model, name), inputs[name]
        B, H, W, C = xin.shape
        for shift in sorted({b.shift_size for b in layer.blocks}):
            blk = next(b for b in layer.blocks if b.shift_size == shift)
            n = sum(b.shift_size == shift for b in layer.blocks)
            p = blk.params_for(xin.dtype, xin.device)
            wnd = window_partition(cyclic_shift(
                layer_norm(xin, p["ln1_s"], p["ln1_b"]), shift), 8)
            if p["mod"] is not None:
                wnd = wnd + p["mod"]
            Bw = wnd.shape[0]
            xs = wnd.reshape(Bw, 8, 8, C)
            q = p["to_q"]
            wlib = q["wd"].permute(2, 0, 1).unsqueeze(1).contiguous()
            blib = q["bd"].to(xs.dtype)
            # the three weight sets as one grouped conv: output 3 c + i is
            # conv i of channel c
            wlib3 = p["wd3"].permute(3, 0, 1, 2).reshape(3 * C, 1, 3, 3) \
                .contiguous()
            blib3 = p["bd3"].t().reshape(3 * C).to(xs.dtype)
            xs_nchw = xs.permute(0, 3, 1, 2)  # a channels-last view

            def kern(q=q, xs=xs):
                return K.dwconv3x3(xs, q["wd"], q["bd"])

            def plain(q=q, xs=xs):
                return K.dwconv3x3_reference(xs, q["wd"], q["bd"])

            def library(xs_nchw=xs_nchw, wlib=wlib, blib=blib, C=C):
                return F.conv2d(xs_nchw, wlib, blib, padding=1, groups=C)

            def fused(p=p, xs=xs):
                return K.dwconv3x3_qkv(xs, p["wd3"], p["bd3"])

            def fused_plain(p=p, xs=xs):
                return K.dwconv3x3_qkv_reference(xs, p["wd3"], p["bd3"])

            def library3(xs_nchw=xs_nchw, wlib3=wlib3, blib3=blib3, C=C):
                return F.conv2d(xs_nchw, wlib3, blib3, padding=1, groups=C)

            times = {}
            for key, fn in (("plain", fused_plain), ("kernel", fused),
                            ("library", library3), ("library", library3),
                            ("kernel", fused), ("plain", fused_plain),
                            ("plain1", plain), ("kernel1", kern),
                            ("library1", library), ("library1", library),
                            ("kernel1", kern), ("plain1", plain)):
                times[key] = times.get(key, 0.0) + cuda_ms(fn) / 2
            dev = {"kernel": graph_ms(fused), "library": graph_ms(library3),
                   "kernel1": graph_ms(kern), "library1": graph_ms(library)}
            for kernel, sfx, nq, calls in (("dwconv3x3", "", 3, n),
                                           ("dwconv3x3 per call", "1", 1,
                                            3 * n)):
                tally(totals, kernel, times["kernel" + sfx],
                      times["plain" + sfx], dwconv_cost(Bw * 64, C, nq=nq),
                      calls, PEAK_FP32)
                t = totals[kernel]
                for key, v in (("library_ms", times["library" + sfx]),
                               ("device_ms", dev["kernel" + sfx]),
                               ("library_device_ms", dev["library" + sfx])):
                    t[key] = t.get(key, 0.0) + calls * v
            dw = [times["kernel"], times["plain"], times["library"]]
            ys = fused()

            def pointwise(p=p, ys=ys, nm=("to_q", "to_k", "to_v")):
                outs = [y @ p[k]["wp"] + p[k]["bp"].to(y.dtype)
                        for k, y in zip(nm, ys)]
                return outs[0].reshape(Bw, 64, C) @ p["wo"] + p["bo"].to(
                    outs[0].dtype)

            qkv = blk.attn.qkv(wnd, p, blk.num_heads)
            mask = blk.attention_mask(B, H, W, xin.device)

            def attention(qkv=qkv, mask=mask, p=p, blk=blk):
                return window_attention(*qkv, p["bias"], mask,
                                        scale=blk.attn.scale)

            xa = xin + blk.unfused_attention(xin, p)
            largs = (xa, p["w1"], p["b1"], p["wd"], p["bd"], p["w2"],
                     p["b2"])
            lkw = dict(ln_s=p["ln2_s"], ln_b=p["ln2_b"], residual=True)
            lp1, lk1 = (cuda_ms(lambda: K.leff_reference(*largs, **lkw)),
                        cuda_ms(lambda: K.fused_leff(*largs, **lkw)))
            lk2, lp2 = (cuda_ms(lambda: K.fused_leff(*largs, **lkw)),
                        cuda_ms(lambda: K.leff_reference(*largs, **lkw)))
            tally(totals, "leff", (lk1 + lk2) / 2, (lp1 + lp2) / 2,
                  leff_cost(B * H * W, C, 4 * C), n)
            pw_ms, at_ms = cuda_ms(pointwise), cuda_ms(attention)
            blk_ms = cuda_ms(lambda: blk(xin))
            leff_ms = (lk1 + lk2) / 2
            parts = {"dwconv3x3": dw[0], "pointwise": pw_ms,
                     "attention": at_ms, "leff": leff_ms,
                     "glue": blk_ms - dw[0] - pw_ms - at_ms - leff_ms}
            for k, v in parts.items():
                split[k] += n * v
            rows.append({"layer": name, "shift": shift, "blocks": n,
                         "windows": [Bw, 8, 8, C], "dwconv_qkv_ms": dw[0],
                         "dwconv_qkv_plain_ms": dw[1],
                         "dwconv_qkv_library_ms": dw[2],
                         "dwconv_qkv_device_ms": dev["kernel"],
                         "dwconv_qkv_library_device_ms": dev["library"],
                         "dwconv_qkv_bound_ms": max(
                             dwconv_cost(Bw * 64, C, nq=3)[0] / PEAK_FP32,
                             dwconv_cost(Bw * 64, C, nq=3)[1] / PEAK_HBM)
                         * 1e3,
                         "dwconv_ms": times["kernel1"],
                         "dwconv_plain_ms": times["plain1"],
                         "dwconv_library_ms": times["library1"],
                         "dwconv_device_ms": dev["kernel1"],
                         "dwconv_library_device_ms": dev["library1"],
                         "dwconv_bound_ms": max(
                             dwconv_cost(Bw * 64, C)[0] / PEAK_FP32,
                             dwconv_cost(Bw * 64, C)[1] / PEAK_HBM) * 1e3,
                         "leff_ms": leff_ms, "leff_plain_ms": (lp1 + lp2) / 2,
                         "pointwise_ms": pw_ms, "attention_ms": at_ms,
                         "block_ms": blk_ms})
            r = rows[-1]
            print(f"  {name:16s} s{shift} x{n} ({Bw}, 8, 8, {C}) dwconv "
                  f"q/k/v {dw[0]:.4f} ms (plain {dw[1]:.4f}, cuDNN "
                  f"{dw[2]:.4f}; graphed {dev['kernel']:.4f}, cuDNN "
                  f"{dev['library']:.4f}; bound "
                  f"{r['dwconv_qkv_bound_ms']:.4f}); per call "
                  f"{times['kernel1']:.4f} (cuDNN {times['library1']:.4f}; "
                  f"graphed {dev['kernel1']:.4f}, cuDNN "
                  f"{dev['library1']:.4f}; bound "
                  f"{r['dwconv_bound_ms']:.4f}); pointwise "
                  f"{pw_ms:.3f}, attention {at_ms:.3f}, leff {leff_ms:.3f}, "
                  f"block {blk_ms:.3f} ms", flush=True)
    p1 = cuda_ms(lambda: model(x, plain=True), reps=5)
    k1 = cuda_ms(lambda: model(x), reps=5)
    k2 = cuda_ms(lambda: model(x), reps=5)
    p2 = cuda_ms(lambda: model(x, plain=True), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(x)
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    fwd = {"kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
           "runs_ms": {"plain": [p1, p2], "kernel": [k1, k2]},
           "host_enqueue_ms": enqueue, "split_ms": split}
    split["outside blocks"] = fwd["kernel_ms"] - sum(split.values())
    for kernel, t in totals.items():
        print(f"  {kernel:16s} per forward: {t['launches']} launches, "
              f"kernel {t['ms']:8.3f} ms, plain {t['plain_ms']:8.3f} ms, "
              f"bound {t['bound_ms']:7.4f} ms ({bound_by(t)})"
              + (f", cuDNN {t['library_ms']:.3f} ms; graphed: kernel "
                 f"{t['device_ms']:.3f} ms, cuDNN "
                 f"{t['library_device_ms']:.3f} ms" if "library_ms" in t
                 else ""), flush=True)
    print(f"  forward bs{x.shape[0]} {x.shape[1]}^2 bf16: kernel path "
          f"{fwd['kernel_ms']:.3f} ms, plain path {fwd['plain_ms']:.3f} ms, "
          f"host enqueue {enqueue:.3f} ms; split "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    return rows, totals, fwd


# kernel 4 timed alone (nH, Bw, D, image side): Uformer_T's enc0 at bs8
# 256^2 (with its bias), head dim 32 there, four heads of 512 windows
CORE_TIMING_SHAPES = [(1, 8192, 16, 256), (1, 8192, 32, 256),
                      (4, 512, 16, 64)]


@torch.no_grad()
def core_timing(model_t, device) -> dict:
    """The window-attention core alone, bf16, shift 4, at each
    CORE_TIMING_SHAPES shape (the first with the bias of Uformer_T's enc0,
    the others random): the kernel, its plain version and
    F.scaled_dot_product_attention with the bias and shift mask as one
    additive mask (a yardstick; the port never calls it), in the order
    plain, kernel, library, library, kernel, plain. Returns the first
    shape's timing, the others under "more"."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.ops.kernels.window_attention import window_mask

    gen = torch.Generator(device="cpu").manual_seed(8)
    shift, outs = 4, []
    for nH, Bw, D, res in CORE_TIMING_SHAPES:
        q, k, v = (torch.randn((nH, Bw, 64, D), generator=gen)
                   .to(device, torch.bfloat16) for _ in range(3))
        bias = (model_t.encoderlayer_0.blocks[1].kernel_params(
            torch.float32)["bias"] if not outs else
            (0.5 * torch.randn((nH, 64, 64), generator=gen)).to(device))
        kw = dict(win=8, shift=shift, H=res, W=res, scale=D ** -0.5)
        mask = window_mask(res, res, 8, shift, Bw, 0, device)  # (nW, 64, 64)
        full = (bias[:, None, None] + mask[None, None]) \
            .expand(nH, Bw // mask.shape[0], *mask.shape) \
            .reshape(nH, Bw, 64, 64).to(torch.bfloat16).contiguous()

        def fused():
            return K.fused_window_attention(q, k, v, bias, **kw)

        def plain():
            return K.window_attention_reference(q, k, v, bias, **kw)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=full,
                                                  scale=D ** -0.5)

        p1, k1, l1 = cuda_ms(plain), cuda_ms(fused), cuda_ms(library)
        l2, k2, p2 = cuda_ms(library), cuda_ms(fused), cuda_ms(plain)
        t = {}
        tally(t, "window_attention", (k1 + k2) / 2, (p1 + p2) / 2,
              core_cost(nH, Bw, D))
        out = dict(t["window_attention"], library_ms=(l1 + l2) / 2,
                   graph_ms=graph_ms(fused), shape=[nH, Bw, 64, D],
                   shift=shift,
                   library_max_abs_err_vs_plain=max_err(library(), plain()))
        print(f"  window_attention {tuple(out['shape'])} shift {shift}: "
              f"kernel {out['ms']:.4f} ms ({out['graph_ms']:.4f} graphed), "
              f"plain {out['plain_ms']:.4f} ms, SDPA "
              f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
              f"({bound_by(out)})", flush=True)
        outs.append(out)
        del q, k, v, full
    return dict(outs[0], more=outs[1:])


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


def block_calls(layer, blk, residual, dtypes):
    """The four kernel calls of blk (a block of `layer`) and their plain
    versions, on its kernel weights in each of `dtypes`, each taking an
    image x (and g) of the block's input shape: attention_image and
    attention_bwd on the image route; off it the windowed branch's
    attention_block and attention_block_bwd on x's (Bw, 64, C) windows,
    LN outside (has_ln False) and the block's modulator, as the model runs
    them. Then leff and leff_bwd. Returns ({kernel: (fused, plain)},
    {backward kernel: parts(x, g, dt)}), parts giving the backward's
    launches unrun (`leff_bwd_parts` and its attention counterparts)."""
    from uformer_tpu_torch.ops import kernels as K

    prm = {dt: blk.kernel_params(dt) for dt in dtypes}
    akw = dict(win=blk.win_size, shift=blk.shift_size, scale=blk.attn.scale,
               num_heads=blk.num_heads)
    keys = ("mod", "ln1_s", "ln1_b", "wq", "bq", "wkv", "bkv", "wo", "bo",
            "bias")
    if blk.image_route:
        akw["residual"] = residual

        def args(dt):
            return tuple(prm[dt][k] for k in keys)

        def tok(t):
            return t
    else:
        akw.update(H=layer.resolution, W=layer.resolution, has_ln=False)

        def args(dt):
            return (prm[dt]["mod"], None, None) + tuple(
                prm[dt][k] for k in keys[3:])

        def tok(t):
            return t.reshape(-1, 64, t.shape[-1])

    def attn(fn):
        return lambda x, dt: fn(tok(x), *args(dt), **akw)

    def attn_bwd(fn):
        return lambda x, g, dt: dict(zip(ATTN_GRADS, fn(
            tok(x), tok(g), *args(dt), **akw)))

    def leff(fn):
        return lambda x, dt: fn(x, *(prm[dt][k] for k in (
            "w1", "b1", "wd", "bd", "w2", "b2")), ln_s=prm[dt]["ln2_s"],
            ln_b=prm[dt]["ln2_b"], residual=residual)

    def leff_bwd(fn):
        return lambda x, g, dt: dict(zip(LEFF_GRADS, fn(x, g, *(
            prm[dt][k] for k in ("w1", "b1", "wd", "bd", "w2", "ln2_s",
                                 "ln2_b")), residual=residual)))

    def parts_of(fn):
        return lambda x, g, dt: fn(tok(x), tok(g), *args(dt), **akw)

    from uformer_tpu_torch.ops.kernels.attention_block import \
        attention_block_bwd_parts
    from uformer_tpu_torch.ops.kernels.attention_image import \
        attention_image_bwd_parts
    from uformer_tpu_torch.ops.kernels.leff import leff_bwd_parts

    parts = {"leff_bwd": lambda x, g, dt: leff_bwd_parts(x, g, *(
        prm[dt][k] for k in ("w1", "b1", "wd", "bd", "w2", "ln2_s",
                             "ln2_b")), residual=residual)}
    if blk.image_route:
        parts["attention_bwd"] = parts_of(attention_image_bwd_parts)
    else:
        parts["attention_block_bwd"] = parts_of(attention_block_bwd_parts)

    if blk.image_route:
        calls = {"attention_image": (attn(K.fused_attention_image),
                                     attn(K.attention_image_reference)),
                 "attention_bwd": (attn_bwd(K.fused_attention_image_bwd),
                                   attn_bwd(
                                       K.attention_image_vjp_reference))}
    else:
        calls = {"attention_block": (attn(K.fused_attention_block),
                                     attn(K.attention_block_reference)),
                 "attention_block_bwd": (
                     attn_bwd(K.fused_attention_block_bwd),
                     attn_bwd(K.attention_block_vjp_reference))}
    calls.update({"leff": (leff(K.fused_leff), leff(K.leff_reference)),
                  "leff_bwd": (leff_bwd(K.fused_leff_bwd),
                               leff_bwd(K.leff_vjp_reference))})
    return calls, parts


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
    `model` at RES_TRAIN^2, at this batch, fp32 and bf16."""
    checks = Checks()
    dtypes = (torch.float32, torch.bfloat16)
    gen = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad():
        for name in LAYERS:
            layer = getattr(model, name)
            shape = (batch, layer.resolution, layer.resolution, layer.dim)
            for i, blk in enumerate(layer.blocks):
                calls, _ = block_calls(layer, blk, False, dtypes)
                x32 = torch.randn(shape, generator=gen).bfloat16().float() \
                    .to(device)
                what = f"{name}.{i} {shape} shift={blk.shift_size} res=0"
                for kernel, pair in calls.items():
                    if not kernel.endswith("bwd"):
                        compare(checks, kernel, what, *pair, x32)
        for name, blk, shift, residual in train_configs(model):
            layer = getattr(model, name)
            shape = (batch, layer.resolution, layer.resolution, layer.dim)
            calls, _ = block_calls(layer, with_shift(blk, shift), residual,
                                   dtypes)
            x = torch.randn(shape, generator=gen).bfloat16().float() \
                .to(device)
            g = torch.randn(shape, generator=gen).bfloat16().float() \
                .to(device)
            what = f"{name} {shape} shift={shift} res={int(residual)}"
            for kernel, (fused, plain) in calls.items():
                if kernel.endswith("bwd"):
                    got16 = fused(x.bfloat16(), g.bfloat16(), torch.bfloat16)
                    grad_bound(checks, kernel, what,
                               fused(x, g, torch.float32),
                               plain(x, g, torch.float32),
                               plain(x.bfloat16(), g.bfloat16(),
                                     torch.bfloat16), got16)
                    # a second run on the same inputs: equal bits (fixed
                    # summation orders, no atomics)
                    again = fused(x.bfloat16(), g.bfloat16(), torch.bfloat16)
                    differ = sum(a is not None and not torch.equal(a, again[n])
                                 for n, a in got16.items())
                    checks.add(kernel, f"{what} repeat", float(differ), 0.0,
                               "bits")
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


def whole_step_checks(make_model, device, batch_size: int, label: str,
                      expected: dict) -> Checks:
    """One train step of batch_size, kernel path against plain path: same
    weights, batch and generator; loss and every parameter's gradient
    (norm_cross, built and never applied, has none), in fp32 and bf16. lr
    0 keeps the weights for the next step. Each kernel path step must
    launch exactly `expected`."""
    from uformer_tpu_torch.ops import kernels as K

    model = make_model()
    batch = train_batch(batch_size, 3, device)

    def grads(plain, dtype):
        K.reset_counts()
        loss, _, _ = run_step(model, plain, dtype, batch, 4, lambda s: 0.0)
        torch.cuda.synchronize()
        launched = K.launch_counts()
        if not plain and launched != expected:
            raise RuntimeError(f"{label}: launched {launched}, expected "
                               f"{expected}")
        out = {"loss": loss.reshape(1)}
        out.update({n: p.grad.clone() for n, p in model.named_parameters()
                    if p.grad is not None})
        return out

    ref = grads(True, torch.float32)
    got = grads(False, torch.float32)
    low = grads(True, torch.bfloat16)
    got16 = grads(False, torch.bfloat16)
    torch.cuda.synchronize()
    checks = Checks()
    grad_bound(checks, "model", f"{label} bs{batch_size}", got, ref, low,
               got16)
    for n, v in got16.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"{label}: non-finite {n}")
    return checks


def train_timing(make_model, device, expected: dict, label: str):
    """BATCH_TRAIN x RES_TRAIN^2 bf16 train steps: launches per step
    (`expected` on every kernel path step) and loss on the kernel path;
    ms per step (CUDA events) and peak memory on both paths, in the order
    plain, kernel, kernel..., plain."""
    from uformer_tpu_torch.ops import kernels as K
    from uformer_tpu_torch.train import warmup_cosine_schedule

    model = make_model()
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
                if counts != expected:
                    raise RuntimeError(f"{label}: step {i} launched "
                                       f"{counts}, expected {expected}")
                if not np.isfinite(float(loss)):
                    raise RuntimeError(f"{label}: step {i} loss "
                                       f"{float(loss)}")
        return torch.cuda.max_memory_allocated(device)

    steps(True, 1, 100)
    out["peak_bytes"] = steps(False, N_TRAIN_STEPS, 200)
    plain_peak = steps(True, 1, 300)
    out["plain_peak_bytes"] = plain_peak
    out["kernel_ms_median"] = float(np.median(out["kernel_ms"]))
    out["plain_ms_median"] = float(np.median(out["plain_ms"]))
    print(f"  {label} bs{BATCH_TRAIN} {RES_TRAIN}^2 bf16 step: kernel path "
          f"{out['kernel_ms_median']:.3f} ms (peak "
          f"{out['peak_bytes'] / 2**20:.1f} MiB), plain path "
          f"{out['plain_ms_median']:.3f} ms (peak "
          f"{plain_peak / 2**20:.1f} MiB)", flush=True)
    return model, out


def wgrad_cost(a, b):
    """(operations, bytes) of a^T b over the rows of a and b and the
    column sums of b: a and b read once, the fp32 product written once."""
    M, K1 = a.shape
    N = b.shape[1]
    return 2 * M * K1 * N, (M * (K1 + N)) * a.element_size() + 4 * K1 * N


def part_times(parts_fn, x, g, n: int, totals: dict, kernel: str) -> dict:
    """Each launch of one backward call (its parts, `*_bwd_parts`) timed
    alone on the same buffers after one run of all of them, and each
    weight-gradient part's yardstick, torch.matmul(a.T, b) on its operands
    (the port never calls it). Adds n calls to totals[kernel]["parts"]."""
    parts, _ = parts_fn(x, g, torch.bfloat16)
    for _, run in parts:
        run()
    out = {}
    for name, run in parts:
        out[name] = cuda_ms(run, reps=5)
        ops = getattr(run, "operands", ())
        if name.startswith("wgrad"):
            a, b = ops
            out[f"{name} matmul"] = cuda_ms(lambda: torch.matmul(a.T, b),
                                            reps=5)
            cost = wgrad_cost(a, b)
            out[f"{name} bound"] = max(cost[0] / PEAK_BF16,
                                       cost[1] / PEAK_HBM) * 1e3
    acc = totals[kernel].setdefault("parts", {})
    for name, ms in out.items():
        acc[name] = acc.get(name, 0.0) + n * ms
    del parts
    return out


def train_kernel_timing(model, device):
    """Device time of each kernel against its plain version at the bs
    BATCH_TRAIN bf16 shapes of one train step, and of each backward's
    parts (kernel 7's A and B, kernel 6's body, the weight-gradient
    reductions beside torch.matmul, colsum). One block per (stage, shift)
    is timed on random inputs and counted once per block of the stage
    with that shift; totals (ms, plain ms, launches, bound, parts) are per
    step."""
    gen = torch.Generator(device="cpu").manual_seed(6)
    rows, totals = [], {}
    with torch.no_grad():
        for name, blk, shift, residual in train_configs(model):
            layer = getattr(model, name)
            n = sum(b.shift_size == shift for b in layer.blocks)
            if n == 0:  # a geometry checked above but not on the step
                continue
            shape = (BATCH_TRAIN, layer.resolution, layer.resolution,
                     layer.dim)
            tokens, C = BATCH_TRAIN * layer.resolution ** 2, layer.dim
            attn = attn_cost(tokens, C, blk.num_heads,
                             mod=blk.modulator is not None,
                             ln=blk.image_route)
            leff = leff_cost(tokens, C, 4 * C)
            costs = {"attention_image": attn, "attention_block": attn,
                     "leff": leff,
                     "attention_bwd": bwd_cost(attn, tokens, C),
                     "attention_block_bwd": bwd_cost(attn, tokens, C),
                     "leff_bwd": bwd_cost(leff, tokens, C)}
            calls, parts = block_calls(layer, blk, residual,
                                       (torch.bfloat16,))
            x = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
            g = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
            for kernel, (fused, plain) in calls.items():
                args = (x, g) if kernel.endswith("bwd") else (x,)
                k_fn = (lambda f=fused, a=args: f(*a, torch.bfloat16))
                p_fn = (lambda f=plain, a=args: f(*a, torch.bfloat16))
                p1, k1, k2, p2 = (cuda_ms(p_fn, reps=5), cuda_ms(k_fn, reps=5),
                                  cuda_ms(k_fn, reps=5), cuda_ms(p_fn, reps=5))
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                b_ms = tally(totals, kernel, k_ms, p_ms, costs[kernel], n)
                row = {"layer": name, "shift": shift, "blocks": n,
                       "kernel": kernel, "shape": list(shape), "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms / n,
                       "tflops": costs[kernel][0] / (k_ms * 1e-3) / 1e12}
                print(f"  {name:16s} s{shift} x{n} {kernel:19s} "
                      f"{str(shape):22s} kernel {k_ms:8.3f} ms  plain "
                      f"{p_ms:8.3f} ms  bound {b_ms / n:7.4f} ms  "
                      f"{rate(costs[kernel], k_ms, b_ms / n)}", flush=True)
                if kernel in parts:
                    row["parts"] = part_times(parts[kernel], x, g, n, totals,
                                              kernel)
                    print("      parts: " + ", ".join(
                        f"{k} {v:.3f}" for k, v in row["parts"].items()),
                        flush=True)
                rows.append(row)
    for kernel, t in totals.items():
        print(f"  {kernel:19s} per step: {t['launches']} launches, kernel "
              f"{t['ms']:8.3f} ms, plain {t['plain_ms']:8.3f} ms, bound "
              f"{t['bound_ms']:7.4f} ms ({bound_by(t)})", flush=True)
        if "parts" in t:
            print("      parts per step: " + ", ".join(
                f"{k} {v:.3f}" for k, v in t["parts"].items()), flush=True)
    return rows, totals


def train_checks(make_model, device, batch: int, label: str,
                 expected: dict):
    """Kernel checks and one whole step against the plain path at this
    batch, with cuDNN's deterministic algorithms, so that the plain
    references repeat bit for bit."""
    torch.backends.cudnn.deterministic = True
    model = make_model()
    kchecks = train_kernel_checks(model, device, batch)
    kchecks.raise_if_failed(f"{label} kernels bs{batch}")
    del model
    schecks = whole_step_checks(make_model, device, batch, label, expected)
    schecks.raise_if_failed(f"{label} step bs{batch}")
    torch.backends.cudnn.deterministic = False
    return kchecks, schecks


def train_phase(make_model, device, expected: dict, label: str):
    """The train path of make_model() (a float32 model at RES_TRAIN^2 on
    the card): the checks at bs BATCH_CHECK; timed bs BATCH_TRAIN steps
    launching `expected` and per-kernel times (cuDNN's defaults); then the
    checks again at bs BATCH_TRAIN, the shapes the timed steps run. Those
    come last: their fp32 plain references take tens of GB, which the
    timings then need not share the allocator with."""
    kchecks, schecks = train_checks(make_model, device, BATCH_CHECK, label,
                                    expected)
    model, timing = train_timing(make_model, device, expected, label)
    rows, totals = train_kernel_timing(model, device)
    del model
    torch.cuda.empty_cache()
    kbig, sbig = train_checks(make_model, device, BATCH_TRAIN, label,
                              expected)
    kchecks.rows += kbig.rows
    schecks.rows += sbig.rows
    torch.cuda.empty_cache()
    return kchecks, schecks, timing, rows, totals


def mlp_cross_model(device):
    """The MLP_CROSS model on weights drawn with numpy from SEED_MLP_CROSS
    over the port's own parameter names, by the golden weights' rule."""
    from uformer_tpu_torch.convert import load_numpy_state_dict
    from uformer_tpu_torch.models import Uformer

    model = Uformer(**MLP_CROSS)
    keys_shapes = [[k, list(v.shape)] for k, v in model.named_parameters()]
    sd = golden_module().seeded_state_dict(keys_shapes, SEED_MLP_CROSS)
    return load_numpy_state_dict(model, sd).to(device)


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
    kernels = run(device, card, args.json)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(device, card: str, json_path) -> list:
    """Every phase after `device`, on `device`; writes the full report to
    json_path (if given) and returns the kernels line's entries."""
    from uformer_tpu_torch.ops.kernels import _build

    phase("build")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "build.log")
    ptxas = ptxas_report(log.read_text() if log.exists() else "")
    for name, regs, stores, loads in ptxas:
        print(f"  {regs if regs is not None else '-':>3} registers, "
              f"{stores:4d} B spill stores, {loads:4d} B spill loads  "
              f"{name[:90]}")
    print(f"  built {_build.library_path().name} in {build_s:.1f} s",
          flush=True)

    phase("kernels vs plain")
    data, sd = seeded_weights()
    sd_t = t_weights()
    model256 = build_model(sd, RES_SERVE, device)
    kchecks = kernel_phase(model256, device)
    kchecks.raise_if_failed("kernels")
    model_t = build_model(sd_t, RES_SERVE, device, "Uformer_T")
    t_kchecks = kernel_phase_t(model_t, model256, device)
    t_kchecks.raise_if_failed("kernels Uformer_T")
    del model256, model_t
    ai_checks = attention_image_phase(device)
    ai_checks.raise_if_failed("kernels attention_image")
    torch.cuda.empty_cache()
    sd_bc = bconv_weights()
    model_bc = build_bconv(sd_bc, device)
    dw_checks = dwconv_phase(model_bc, device)
    dw_checks.raise_if_failed("kernels dwconv3x3")
    del model_bc
    tile_checks = tile_phase(device)
    tile_checks.raise_if_failed("kernels tensor-core tiles")

    phase("golden")
    gchecks = golden_phase(data, sd, device)
    gchecks.raise_if_failed("golden")

    phase("golden conv")
    gcchecks = golden_conv_phase(device)
    gcchecks.raise_if_failed("golden conv")

    phase("serve")
    restorer, x, serve, launches, schecks = serve_phase(
        lambda: build_model(sd, RES_SERVE, device), device,
        EXPECTED_LAUNCHES, "serve")
    schecks.raise_if_failed("serve")

    phase("timing")
    rows, totals, fwd = timing_phase(restorer, x)
    del restorer, x

    phase("serve Uformer_T")
    restorer, x, serve_t, t_launches, t_schecks = serve_phase(
        lambda: build_model(sd_t, RES_SERVE, device, "Uformer_T"), device,
        T_LAUNCHES, "serve Uformer_T")
    t_schecks.raise_if_failed("serve Uformer_T")

    phase("timing Uformer_T")
    t_rows, t_totals, t_fwd = timing_phase(restorer, x)
    core = core_timing(restorer.model, device)
    del restorer, x
    torch.cuda.empty_cache()

    phase("serve B-conv")
    restorer, x, serve_bc, bc_launches, bc_schecks = serve_phase(
        lambda: build_bconv(sd_bc, device), device, BCONV_LAUNCHES,
        "serve B-conv")
    bc_schecks.raise_if_failed("serve B-conv")

    phase("timing B-conv")
    bc_rows, bc_totals, bc_fwd = bconv_timing(restorer, x)
    del restorer, x
    torch.cuda.empty_cache()

    phase("train")
    tkchecks, tschecks, train, trows, ttotals = train_phase(
        lambda: build_model(sd, RES_TRAIN, device), device, TRAIN_LAUNCHES,
        "train")

    phase("train Uformer_T")
    ttkchecks, ttschecks, train_t, ttrows, tttotals = train_phase(
        lambda: build_model(sd_t, RES_TRAIN, device, "Uformer_T"), device,
        T_TRAIN_LAUNCHES, "train Uformer_T")

    phase("train Mlp + cross-modulator")
    torch.backends.cudnn.deterministic = True
    mcchecks = whole_step_checks(lambda: mlp_cross_model(device), device,
                                 BATCH_CHECK, "train Mlp + cross",
                                 MLP_CROSS_LAUNCHES)
    torch.backends.cudnn.deterministic = False
    mcchecks.raise_if_failed("train Mlp + cross")

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas,
              "kernel_checks": (kchecks.rows + t_kchecks.rows
                                + ai_checks.rows + dw_checks.rows
                                + tile_checks.rows),
              "golden_checks": gchecks.rows + gcchecks.rows,
              "serve_checks": schecks.rows + t_schecks.rows + bc_schecks.rows,
              "serve": serve,
              "timing": rows, "forward": fwd, "timing_totals": totals,
              "serve_t": serve_t, "timing_t": t_rows, "forward_t": t_fwd,
              "timing_totals_t": t_totals, "core_timing": core,
              "serve_bconv": serve_bc, "timing_bconv": bc_rows,
              "forward_bconv": bc_fwd, "timing_totals_bconv": bc_totals,
              "train_kernel_checks": tkchecks.rows,
              "train_step_checks": tschecks.rows, "train": train,
              "train_timing": trows, "train_totals": ttotals,
              "train_t_kernel_checks": ttkchecks.rows,
              "train_t_step_checks": ttschecks.rows, "train_t": train_t,
              "train_t_timing": ttrows, "train_t_totals": tttotals,
              "train_mlp_cross_checks": mcchecks.rows}
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(report, indent=1))

    kernels = []
    train_launches = {k: sum(kernel_count(c, k) for c in train["launches"])
                      for k in KERNELS}
    train_t_launches = {k: sum(kernel_count(c, k)
                               for c in train_t["launches"])
                        for k in KERNELS}
    timed = [("serve Uformer_B bs8 256^2 forward", totals),
             ("serve Uformer_T bs8 256^2 forward", t_totals),
             ("train Uformer_B bs32 128^2 step", ttotals),
             ("train Uformer_T bs32 128^2 step", tttotals),
             ("serve B-conv bs8 256^2 forward", bc_totals),
             ("alone at Uformer_T enc0 bs8 256^2",
              {"window_attention": core})]
    for name, (source, replaces) in KERNELS.items():
        rows_of = [r for r in kchecks.rows + t_kchecks.rows + ai_checks.rows
                   + tkchecks.rows + ttkchecks.rows + dw_checks.rows
                   + tile_checks.rows if r["kernel"] == name]
        errs = [r["err"] for r in rows_of if r["dtype"] == "fp32"]
        errs16 = [r["err"] for r in rows_of if r["dtype"] == "bf16"]
        # the first timing that has the kernel gives ms and its bound
        where, t = next((w, tt[name]) for w, tt in timed if name in tt)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": (kernel_count(launches, name)
                              + kernel_count(t_launches, name)
                              + train_launches[name]
                              + kernel_count(bc_launches, name)
                              + train_t_launches[name]),
                 "launches_serve": kernel_count(launches, name),
                 "launches_serve_t": kernel_count(t_launches, name),
                 "launches_train": train_launches[name],
                 "launches_train_t": train_t_launches[name],
                 "launches_serve_bconv": kernel_count(
                     serve_bc["launches_per_request"][0], name),
                 "max_abs_err": max(errs),
                 "bf16_max_abs_err_vs_fp32": max(errs16),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": bound_by(t),
                 "library_ms": t.get("library_ms"), "timed": where}
        if "device_ms" in t:
            entry.update(device_ms=t["device_ms"],
                         library_device_ms=t["library_device_ms"])
        if name == "dwconv3x3":
            # the main path runs the fused q/k/v form (a launch a block);
            # the per-call form (three a block) beside it
            one = bc_totals["dwconv3x3 per call"]
            entry.update(form="fused q/k/v (dwconv3x3_qkv)",
                         library="one grouped cuDNN F.conv2d, 3C outputs, "
                                 "no ReLU",
                         per_call={k: one[k] for k in (
                             "ms", "plain_ms", "bound_ms", "launches",
                             "library_ms", "device_ms",
                             "library_device_ms")})
        if name == "window_attention":
            entry["on_path"] = ("no model path calls it (nor in the JAX "
                                "package); its bf16 register core "
                                "(window_core_mma.cuh) runs inside "
                                "attention_image's and attention_block's "
                                "narrow bodies")
            entry["more_shapes"] = [
                {k: c[k] for k in ("shape", "ms", "graph_ms", "plain_ms",
                                   "bound_ms", "library_ms")}
                for c in core["more"]]
        for label, key, tt in (("serve Uformer_T", "serve_t", t_totals),
                               ("train Uformer_B", "train", ttotals),
                               ("train Uformer_T", "train_t", tttotals),
                               ("serve B-conv", "serve_bconv", bc_totals)):
            if name in tt and label not in where:
                entry.update({f"ms_{key}": tt[name]["ms"],
                              f"plain_ms_{key}": tt[name]["plain_ms"],
                              f"bound_ms_{key}": tt[name]["bound_ms"]})
        kernels.append(entry)
    return kernels


if __name__ == "__main__":
    sys.exit(main())
