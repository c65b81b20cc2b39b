"""Time the Uformer_B bf16 serving forward (batch 8, 256^2), or one
kernel, of two or more checkouts of this repo on one CUDA card, in turns,
to compare them within one run:

    python -m uformer_tpu_torch.forward_ab --roots OLD NEW NEW OLD
    python -m uformer_tpu_torch.forward_ab --what forward_t --roots ...
    python -m uformer_tpu_torch.forward_ab --what forward_bconv --roots ...
    python -m uformer_tpu_torch.forward_ab --what attention_image --roots ...
    python -m uformer_tpu_torch.forward_ab --what dwconv3x3 --roots ...
    python -m uformer_tpu_torch.forward_ab --what leff --roots ...
    python -m uformer_tpu_torch.forward_ab --what stage --roots ...
    python -m uformer_tpu_torch.forward_ab --what stage --fp32 --roots ...
    python -m uformer_tpu_torch.forward_ab --what leff --fp32 --roots ...
    python -m uformer_tpu_torch.forward_ab --what train --roots ...
    python -m uformer_tpu_torch.forward_ab --what train_t --roots ...
    python -m uformer_tpu_torch.forward_ab --what leff_bwd --roots ...
    python -m uformer_tpu_torch.forward_ab --what attention_bwd --roots ...
    python -m uformer_tpu_torch.forward_ab --what attention_block --roots ...
    python -m uformer_tpu_torch.forward_ab --what window_attention --roots ...
    python -m uformer_tpu_torch.forward_ab --what wide --roots ...

Each root runs in its own process (its own `uformer_tpu_torch`, its own
kernel build, made during the warm-up and not timed). `forward`: a bf16
`Restorer` over `get_arch({"arch": "Uformer_B", "train_ps": 256})` with
torch's default weights, then 20 forwards of a (8, 256, 256, 3) input,
each timed with CUDA events; `forward_t` the same for Uformer_T,
`forward_bconv` for serve B-conv (Uformer_B's widths with the conv token
projection). `attention_image`: `fused_attention_image` in bf16
(matrices N(0, 1 / C)) at every call of the serve B and serve T forwards
(bs8 256^2) and the train and train T steps (bs32 128^2), per stage and
(shift, residual) as the model's blocks run it, counted once per such
block; each timed as launches in a CUDA graph, with its largest
difference from the plain version and a digest of its output bits.
`attention_block`: `fused_attention_block` in bf16 at every call of the
serve T forward and the train T step (Uformer_T's windowed enc0 blocks,
LN outside, as the model runs them), graphed and eager, with a digest
of each output's bits.
`window_attention`: `fused_window_attention` in bf16 at (1, 8192, 64,
16), (1, 8192, 64, 32) and (4, 512, 64, 16), shift 0 and 4, graphed and
as chip_smoke.py's mean of 10 eager calls, with a digest of each
output's bits, beside
F.scaled_dot_product_attention with the bias and mask as one bf16 mask
(graphed; a yardstick the port never calls). `dwconv3x3`: `dwconv3x3` in bf16
(bf16 weights, fp32 bias) at the (Bw, 8, 8, C) windows of the serve
B-conv stages at bs8 256^2 and one (8, 256, 256, 64) image, each timed as
20 launches in a CUDA graph (device time, without the host's launch cost)
and as 20 eager calls, with its largest difference from the plain
version; where the root has it, the fused q/k/v form (`dwconv3x3_qkv`,
ReLU on) the same way. `leff`: `fused_leff` in bf16 (bf16 matrices N(0, 1 / fan-in),
Ch = 4C, LN, residual) at every (B, H, W, C) it runs at in serve B, serve
T, serve B-conv (bs8 256^2) and the train and train T steps (bs32 128^2);
`stage`: `fused_stage` at every stage of serve B and serve T (bs8 256^2,
shift, the decoder's modulator), with a digest of its output bits (equal
digests in two roots: equal outputs); each timed as launches in a CUDA graph
(device time), with its largest difference from the plain version;
`train`: the Uformer_B bf16 train step (bs32 128^2, mixup on, AdamW),
the median of 10 steps after 3 warm-up ones (CUDA events), `train_t` the
same for Uformer_T; `leff_bwd`:
`fused_leff_bwd` in bf16 (as `leff`, LN, residual at C = 512) at every
(B, H, W, C) of the train and train T steps (bs32 128^2);
`attention_bwd`: `fused_attention_image_bwd` in bf16 at every image-route
stage of those steps (shift 4 where the image is wider than a window, the
decoder's modulator) and `fused_attention_block_bwd` at train T's
windowed enc0; both timed as launches in a CUDA graph (device time), with
their largest difference from the plain VJP; `bwd_split`: both backward
kernels at the train and train T stages where the host splits a tile's
hidden chunks or a window's heads over blocks, the host's plan against
no split, in turns (CUDA graphs). `leff_bwd`, `attention_bwd` and
`bwd_split` print a digest of the bits of every output of each call
(`sha256`; `bwd_split` one for each plan): equal in two roots, equal
gradients. `wide`: kernels 5 and 6 above window 8 in bf16 at every
windowed (stage, shift) of the win-16 models' steps (`--arch Uformer
--win_size 16` at embed 32 and 64, bs8 128^2, LN1 outside, the decoder's
modulator) and at the 1024-token windows of the win-32 one, each timed
eagerly (the mean of 3 calls after one), with a digest of the forward's output and of every gradient (at window 16
one dS group: the parent's digests there mean the grouped backward left
those bits as they were). With `--fp32` (stage and leff only, TF32 off
for matmul and cuDNN): `stage` runs `fused_stage` in fp32 at every stage
of Uformer_B's fp32 eval request (the SIDD CLI's bs32 256^2 at train_ps
128: the bottleneck unshifted, the decoder's modulator; matrices N(0, 1 /
fan-in)), each the mean of 3 calls after one (CUDA events), beside its
plain version, and splits it into its halves: the LeFF half is `blocks`
launches of `fused_leff` at the stage's shape on its first block's LeFF
weights, the attention half the rest; with the fp32 bodies each ran
(`K.core_counts`, where the root counts them) and a digest of the
output's bits. `leff` runs `fused_leff` in fp32 at the request's kernel-2
calls (C 32 and 64) and at every stage's LeFF shape, the same way. Prints
one JSON line per root (ms), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_CHILD = """
import json, statistics, torch
from uformer_tpu_torch import get_arch
from uformer_tpu_torch.models import Uformer
from uformer_tpu_torch.restore import Restorer
torch.manual_seed(0)
restorer = Restorer(MODEL, torch.bfloat16, "cuda")
x = torch.rand(8, 256, 256, 3, device="cuda")
runs = []
with torch.no_grad():
    for _ in range(3):
        restorer.model(x)
    torch.cuda.synchronize()
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        restorer.model(x)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
print(json.dumps({"median_ms": statistics.median(runs), "runs_ms": runs}))
"""

# serve B-conv: Uformer_B's widths and depths, conv token projection
_BCONV = ('Uformer(img_size=256, embed_dim=32, depths=(1, 2, 8, 8, 2, 8, '
          '8, 2, 1), num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), win_size=8, '
          'token_projection="conv", modulator=True)')

_DWCONV = """
import json, torch
from uformer_tpu_torch.ops import kernels as K
shapes = [(8192, 8, 8, 32), (2048, 8, 8, 64), (512, 8, 8, 128),
          (128, 8, 8, 256), (32, 8, 8, 512), (128, 8, 8, 512),
          (512, 8, 8, 256), (2048, 8, 8, 128), (8192, 8, 8, 64),
          (8, 256, 256, 64)]

def ms(fn, reps=20):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

gen = torch.Generator().manual_seed(0)
rows = []
for shape in shapes:
    C = shape[-1]
    x = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn(3, 3, C, generator=gen) / 3).to("cuda", torch.bfloat16)
    b = (0.1 * torch.randn(C, generator=gen)).to("cuda")
    w3 = (torch.randn(3, 3, 3, C, generator=gen) / 3).to("cuda",
                                                        torch.bfloat16)
    b3 = (0.1 * torch.randn(3, C, generator=gen)).to("cuda")
    row = {"shape": shape}
    runs = {"": (lambda: (K.dwconv3x3(x, w, b),),
                 lambda: (K.dwconv3x3_reference(x, w, b),))}
    if hasattr(K, "dwconv3x3_qkv"):
        runs["qkv_"] = (lambda: K.dwconv3x3_qkv(x, w3, b3),
                        lambda: K.dwconv3x3_qkv_reference(x, w3, b3))
    for key, (run, plain) in runs.items():
        err = max(float((got.float() - want.float()).abs().max())
                  for got, want in zip(run(), plain()))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                run()
        graph.replay()
        row.update({key + "graph_ms": ms(graph.replay, 10) / 20,
                    key + "eager_ms": ms(run), key + "max_abs_err": err})
    rows.append(row)
print(json.dumps({"rows": rows}))
"""

_KERNEL_COMMON = """
import hashlib, json, torch
from uformer_tpu_torch.ops import kernels as K
gen = torch.Generator().manual_seed(0)

def digest(y):
    # a digest of a bf16 output's bits: equal in two roots, equal outputs
    return hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes()) \\
        .hexdigest()[:16]

def digests(outs):
    # one digest of the bits of every tensor of a call's outputs (a
    # backward's tuple): equal in two roots, equal outputs
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]

def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

def ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

def graph_ms(fn, n=10):
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    return ms(graph.replay, 5) / n
"""

_LEFF = _KERNEL_COMMON + """
f32 = torch.float32
cells = {
    "serve B": [(8, 256, 256, 32), (8, 128, 128, 64), (8, 256, 256, 64)],
    "serve T": [(8, 256, 256, 16), (8, 128, 128, 32), (8, 64, 64, 64),
                (8, 128, 128, 64), (8, 256, 256, 32)],
    "serve B-conv": [(8, 256 >> k, 256 >> k, 32 << k) for k in range(5)]
                    + [(8, 32, 32, 512), (8, 64, 64, 256), (8, 128, 128, 128),
                       (8, 256, 256, 64)],
    "train": [(32, 128 >> k, 128 >> k, 32 << k) for k in range(5)]
             + [(32, 16, 16, 512), (32, 32, 32, 256), (32, 64, 64, 128),
                (32, 128, 128, 64)],
    "train T": [(32, 128 >> k, 128 >> k, 16 << k) for k in range(5)]
               + [(32, 16, 16, 256), (32, 32, 32, 128), (32, 64, 64, 64),
                  (32, 128, 128, 32)],
}
shapes = {}
for cell, lst in cells.items():
    for shape in lst:
        shapes.setdefault(shape, []).append(cell)
rows = []
for shape, where in shapes.items():
    C = shape[-1]
    Ch = 4 * C
    w = (rnd(C, Ch, scale=C ** -0.5), rnd(Ch, scale=0.1, dtype=f32),
         rnd(3, 3, Ch, scale=1 / 3), rnd(Ch, scale=0.1, dtype=f32),
         rnd(Ch, C, scale=Ch ** -0.5), rnd(C, scale=0.1, dtype=f32))
    kw = dict(ln_s=1.0 + rnd(C, scale=0.1, dtype=f32),
              ln_b=rnd(C, scale=0.1, dtype=f32), residual=True)
    x = rnd(*shape)
    run = lambda: K.fused_leff(x, *w, **kw)
    err = float((run().float() - K.leff_reference(x, *w, **kw).float())
                .abs().max())
    rows.append({"shape": shape, "cells": where, "graph_ms": graph_ms(run),
                 "max_abs_err": err})
print(json.dumps({"rows": rows}))
"""

_STAGE = _KERNEL_COMMON + """
import hashlib
f32 = torch.float32
# (cell, stage, B, res, C, heads, blocks, modulator)
stages = [("serve B", "enc2", 8, 64, 128, 4, 8, False),
          ("serve B", "enc3", 8, 32, 256, 8, 8, False),
          ("serve B", "conv", 8, 16, 512, 16, 2, False),
          ("serve B", "dec0", 8, 32, 512, 16, 8, True),
          ("serve B", "dec1", 8, 64, 256, 8, 8, True),
          ("serve B", "dec2", 8, 128, 128, 4, 2, True),
          ("serve T", "enc3", 8, 32, 128, 8, 2, False),
          ("serve T", "conv", 8, 16, 256, 16, 2, False),
          ("serve T", "dec0", 8, 32, 256, 16, 2, True),
          ("serve T", "dec1", 8, 64, 128, 8, 2, True)]
rows = []
for cell, name, B, res, C, nH, n, mod in stages:
    Ch = 4 * C
    s = C ** -0.5
    p = dict(ln1_s=1.0 + rnd(n, C, scale=0.1, dtype=f32),
             ln1_b=rnd(n, C, scale=0.1, dtype=f32), wq=rnd(n, C, C, scale=s),
             bq=rnd(n, C, scale=0.1, dtype=f32), wk=rnd(n, C, C, scale=s),
             bk=rnd(n, C, scale=0.1, dtype=f32), wv=rnd(n, C, C, scale=s),
             bv=rnd(n, C, scale=0.1, dtype=f32), wo=rnd(n, C, C, scale=s),
             bo=rnd(n, C, scale=0.1, dtype=f32),
             bias=rnd(n, nH, 64, 64, scale=0.5, dtype=f32),
             mod=rnd(n, 64, C, scale=0.1),
             ln2_s=1.0 + rnd(n, C, scale=0.1, dtype=f32),
             ln2_b=rnd(n, C, scale=0.1, dtype=f32), w1=rnd(n, C, Ch, scale=s),
             b1=rnd(n, Ch, scale=0.1, dtype=f32),
             wd=rnd(n, 3, 3, Ch, scale=1 / 3),
             bd=rnd(n, Ch, scale=0.1, dtype=f32),
             w2=rnd(n, Ch, C, scale=Ch ** -0.5),
             b2=rnd(n, C, scale=0.1, dtype=f32))
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=True,
              has_mod=mod)
    x = rnd(B, res, res, C)
    run = lambda: K.fused_stage(x, p, **kw)
    y = run()
    err = float((y.float() - K.stage_reference(x, p, **kw).float())
                .abs().max())
    digest = hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes())
    rows.append({"cell": cell, "stage": name, "shape": [B, res, res, C],
                 "blocks": n, "graph_ms": graph_ms(run), "max_abs_err": err,
                 "sha256": digest.hexdigest()[:16]})
print(json.dumps({"rows": rows}))
"""
_F32_COMMON = _KERNEL_COMMON + """
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
f32 = torch.float32
# (stage, B, res, C, heads, blocks, modulator, shift) of the fp32 eval
# request: Uformer_B, bs32 256^2, train_ps 128 (the bottleneck unshifted)
STAGES = [("enc2", 32, 64, 128, 4, 8, False, True),
          ("enc3", 32, 32, 256, 8, 8, False, True),
          ("conv", 32, 16, 512, 16, 2, False, False),
          ("dec0", 32, 32, 512, 16, 8, True, True),
          ("dec1", 32, 64, 256, 8, 8, True, True),
          ("dec2", 32, 128, 128, 4, 2, True, True)]
# the request's kernel-2 calls: enc0, enc1 (2 blocks), dec3
LEFF_CALLS = [("enc0", 32, 256, 32, 1), ("enc1", 32, 128, 64, 2),
              ("dec3", 32, 256, 64, 1)]

def digest32(y):
    # a digest of an fp32 output's bits: equal in two roots, equal outputs
    return hashlib.sha256(y.contiguous().view(torch.int32).cpu().numpy()
                          .tobytes()).hexdigest()[:16]

def bodies(name):
    # the fp32 launches by body since the last reset, where the root
    # counts them
    counts = K.core_counts() if hasattr(K, "core_counts") else {}
    return counts.get(name)

def timed(fn):
    fn()
    return ms(fn, 3)

def leff_weights(C, n=1):
    Ch = 4 * C
    return (rnd(C, Ch, scale=C ** -0.5, dtype=f32),
            rnd(Ch, scale=0.1, dtype=f32), rnd(3, 3, Ch, scale=1 / 3, dtype=f32),
            rnd(Ch, scale=0.1, dtype=f32), rnd(Ch, C, scale=Ch ** -0.5, dtype=f32),
            rnd(C, scale=0.1, dtype=f32))

def leff_row(where, x, w, ln, blocks):
    run = lambda: K.fused_leff(x, *w, residual=True, **ln)
    K.reset_counts()
    y = run()
    body = bodies("leff")
    ref = K.leff_reference(x, *w, residual=True, **ln)
    return {"where": where, "shape": list(x.shape), "blocks": blocks,
            "ms": timed(run),
            "plain_ms": timed(lambda: K.leff_reference(x, *w, residual=True,
                                                       **ln)),
            "max_abs_err": float((y - ref).abs().max()),
            "sha256": digest32(y), "bodies": body}
"""

_STAGE_F32 = _F32_COMMON + """
rows = []
for name, B, res, C, nH, n, mod, shift in STAGES:
    Ch = 4 * C
    s = C ** -0.5
    w = [leff_weights(C) for _ in range(n)]
    p = dict(ln1_s=1.0 + rnd(n, C, scale=0.1, dtype=f32),
             ln1_b=rnd(n, C, scale=0.1, dtype=f32),
             wq=rnd(n, C, C, scale=s, dtype=f32),
             bq=rnd(n, C, scale=0.1, dtype=f32),
             wk=rnd(n, C, C, scale=s, dtype=f32),
             bk=rnd(n, C, scale=0.1, dtype=f32),
             wv=rnd(n, C, C, scale=s, dtype=f32),
             bv=rnd(n, C, scale=0.1, dtype=f32),
             wo=rnd(n, C, C, scale=s, dtype=f32),
             bo=rnd(n, C, scale=0.1, dtype=f32),
             bias=rnd(n, nH, 64, 64, scale=0.5, dtype=f32),
             mod=rnd(n, 64, C, scale=0.1, dtype=f32),
             ln2_s=1.0 + rnd(n, C, scale=0.1, dtype=f32),
             ln2_b=rnd(n, C, scale=0.1, dtype=f32))
    for i, k in enumerate(("w1", "b1", "wd", "bd", "w2", "b2")):
        p[k] = torch.stack([wj[i] for wj in w]).contiguous()
    kw = dict(scale=(C // nH) ** -0.5, num_heads=nH, use_shift=shift,
              has_mod=mod)
    x = rnd(B, res, res, C, dtype=f32)
    run = lambda: K.fused_stage(x, p, **kw)
    K.reset_counts()
    y = run()
    body = bodies("stage")
    ref = K.stage_reference(x, p, **kw)
    stage_ms = timed(run)
    ln = dict(ln_s=p["ln2_s"][0], ln_b=p["ln2_b"][0])
    leff_ms = timed(lambda: K.fused_leff(x, *w[0], residual=True, **ln))
    rows.append({"stage": name, "shape": [B, res, res, C], "blocks": n,
                 "ms": stage_ms, "leff_half_ms": n * leff_ms,
                 "attention_half_ms": stage_ms - n * leff_ms,
                 "plain_ms": timed(lambda: K.stage_reference(x, p, **kw)),
                 "max_abs_err": float((y - ref).abs().max()),
                 "sha256": digest32(y), "bodies": body})
    del x, y, ref, p, w
    torch.cuda.empty_cache()
print(json.dumps({"rows": rows,
                  "ms": sum(r["ms"] for r in rows),
                  "attention_half_ms": sum(r["attention_half_ms"]
                                           for r in rows),
                  "leff_half_ms": sum(r["leff_half_ms"] for r in rows),
                  "plain_ms": sum(r["plain_ms"] for r in rows)}))
"""

_LEFF_F32 = _F32_COMMON + """
rows = []
for where, B, res, C, n in LEFF_CALLS + [(s[0] + " half", s[1], s[2], s[3],
                                          s[5]) for s in STAGES]:
    ln = dict(ln_s=1.0 + rnd(C, scale=0.1, dtype=f32),
              ln_b=rnd(C, scale=0.1, dtype=f32))
    rows.append(leff_row(where, rnd(B, res, res, C, dtype=f32),
                         leff_weights(C), ln, n))
    torch.cuda.empty_cache()
request = [r for r in rows if not r["where"].endswith("half")]
print(json.dumps({"rows": rows,
                  "request_ms": sum(r["blocks"] * r["ms"] for r in request),
                  "request_plain_ms": sum(r["blocks"] * r["plain_ms"]
                                          for r in request)}))
"""

_TRAIN = """
import json, statistics, torch
from uformer_tpu_torch import get_arch
from uformer_tpu_torch.train import TrainState, make_optimizer, make_train_step
torch.manual_seed(0)
model = get_arch({"arch": ARCH, "train_ps": 128,
                  "dtype": torch.bfloat16}).cuda()
gen = torch.Generator().manual_seed(5)
target = torch.rand(32, 128, 128, 3, generator=gen)
noise = torch.randn(32, 128, 128, 3, generator=gen)
noisy = (target + 0.1 * noise).clamp(0, 1)
batch = {"input": noisy.cuda(), "target": target.cuda()}
state = TrainState(model, make_optimizer(model.parameters(), lambda s: 2e-4),
                   step=5)
step = make_train_step(model, mixup_after_epoch=5, steps_per_epoch=1)
runs = []
for i in range(13):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step(state, batch, torch.Generator().manual_seed(i))
    end.record()
    torch.cuda.synchronize()
    if i >= 3:
        runs.append(start.elapsed_time(end))
print(json.dumps({"median_ms": statistics.median(runs), "runs_ms": runs}))
"""
_TRAIN_SHAPES = """
train = ([(32, 128 >> k, 128 >> k, 32 << k) for k in range(5)]
         + [(32, 16, 16, 512), (32, 32, 32, 256), (32, 64, 64, 128),
            (32, 128, 128, 64)])
train_t = ([(32, 128 >> k, 128 >> k, 16 << k) for k in range(5)]
           + [(32, 16, 16, 256), (32, 32, 32, 128), (32, 64, 64, 64),
              (32, 128, 128, 32)])
cells = {}
for cell, lst in (("train", train), ("train T", train_t)):
    for i, shape in enumerate(lst):
        cells.setdefault(shape, []).append((cell, i))

def worst(got, ref):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, ref) if a is not None)
"""

_LEFF_BWD = _KERNEL_COMMON + _TRAIN_SHAPES + """
f32 = torch.float32
rows = []
for shape, where in cells.items():
    C = shape[-1]
    Ch = 4 * C
    w = (rnd(C, Ch, scale=C ** -0.5), rnd(Ch, scale=0.1, dtype=f32),
         rnd(3, 3, Ch, scale=1 / 3), rnd(Ch, scale=0.1, dtype=f32),
         rnd(Ch, C, scale=Ch ** -0.5))
    ln = (1.0 + rnd(C, scale=0.1, dtype=f32), rnd(C, scale=0.1, dtype=f32))
    x, g = rnd(*shape), rnd(*shape)
    kw = dict(residual=C == 512)
    run = lambda: K.fused_leff_bwd(x, g, *w, *ln, **kw)
    out = run()
    err = worst(out, K.leff_vjp_reference(x, g, *w, *ln, **kw))
    rows.append({"shape": shape, "cells": [c for c, _ in where],
                 "graph_ms": graph_ms(run), "max_abs_err": err,
                 "sha256": digests(out)})
print(json.dumps({"rows": rows}))
"""

_ATTN_BWD = _KERNEL_COMMON + _TRAIN_SHAPES + """
f32 = torch.float32
rows = []
for cell, i, shape in ([("train", i, t) for i, t in enumerate(train)]
                       + [("train T", i, t) for i, t in enumerate(train_t)]):
    B, R, _, C = shape
    D = 32 if cell == "train" else 16  # Uformer_B's head dim, Uformer_T's
    nH = C // D
    decoder = i >= 5
    s = C ** -0.5
    w = dict(mod=rnd(64, C, scale=0.1) if decoder else None,
             ln_s=1.0 + rnd(C, scale=0.1, dtype=f32),
             ln_b=rnd(C, scale=0.1, dtype=f32), wq=rnd(C, C, scale=s),
             bq=rnd(C, scale=0.1, dtype=f32), wkv=rnd(C, 2 * C, scale=s),
             bkv=rnd(2 * C, scale=0.1, dtype=f32), wo=rnd(C, C, scale=s),
             bo=rnd(C, scale=0.1, dtype=f32),
             bias=rnd(nH, 64, 64, scale=0.5, dtype=f32))
    shift = 4 if R > 8 else 0
    x, g = rnd(*shape), rnd(*shape)
    if C == 16:  # train T's enc0: the windowed branch, LN outside
        x, g = x.reshape(-1, 64, C), g.reshape(-1, 64, C)
        args = (w["mod"], None, None) + tuple(w.values())[3:]
        kw = dict(win=8, shift=shift, H=R, W=R, scale=D ** -0.5,
                  num_heads=nH, has_ln=False)
        fn, ref = K.fused_attention_block_bwd, K.attention_block_vjp_reference
    else:
        args = tuple(w.values())
        kw = dict(win=8, shift=shift, scale=D ** -0.5, num_heads=nH,
                  residual=False)
        fn, ref = K.fused_attention_image_bwd, K.attention_image_vjp_reference
    run = lambda: fn(x, g, *args, **kw)
    out = run()
    err = worst(out, ref(x, g, *args, **kw))
    rows.append({"cell": cell, "stage": i, "shape": shape, "head_dim": D,
                 "graph_ms": graph_ms(run), "max_abs_err": err,
                 "sha256": digests(out)})
print(json.dumps({"rows": rows}))
"""

_BWD_SPLIT = _KERNEL_COMMON + """
from uformer_tpu_torch.ops.kernels import attention_block as A, leff as L
f32 = torch.float32
plans = {"leff": L.chunks_per_block, "attention": A.heads_per_block}
rows = []
# (cell, stage, B, res, C, heads): where the host splits a tile's hidden
# chunks (C >= 256) or a window's heads over blocks
for cell, stage, B, R, C, nH in (("train", "enc3", 32, 16, 256, 8),
                                 ("train", "conv", 32, 8, 512, 16),
                                 ("train", "dec0", 32, 16, 512, 16),
                                 ("train T", "conv", 32, 8, 256, 16),
                                 ("train T", "dec0", 32, 16, 256, 16)):
    x, g = rnd(B, R, R, C), rnd(B, R, R, C)
    Ch, s = 4 * C, C ** -0.5
    lw = (rnd(C, Ch, scale=s), rnd(Ch, scale=0.1, dtype=f32),
          rnd(3, 3, Ch, scale=1 / 3), rnd(Ch, scale=0.1, dtype=f32),
          rnd(Ch, C, scale=Ch ** -0.5), 1.0 + rnd(C, scale=0.1, dtype=f32),
          rnd(C, scale=0.1, dtype=f32))
    aw = (rnd(64, C, scale=0.1), 1.0 + rnd(C, scale=0.1, dtype=f32),
          rnd(C, scale=0.1, dtype=f32), rnd(C, C, scale=s),
          rnd(C, scale=0.1, dtype=f32), rnd(C, 2 * C, scale=s),
          rnd(2 * C, scale=0.1, dtype=f32), rnd(C, C, scale=s),
          rnd(C, scale=0.1, dtype=f32), rnd(nH, 64, 64, scale=0.5, dtype=f32))
    akw = dict(win=8, shift=4 if R > 8 else 0, scale=(C // nH) ** -0.5,
               num_heads=nH, residual=False)
    row = {"cell": cell, "stage": stage, "shape": [B, R, R, C]}
    for split in (True, False, True, False):
        L.chunks_per_block = (plans["leff"] if split
                              else lambda tiles, chunks, C, sms: chunks)
        A.heads_per_block = (plans["attention"] if split
                             else lambda windows, C, nH, sms: nH)
        key = "split" if split else "unsplit"
        row.setdefault("leff_bwd_" + key, []).append(
            graph_ms(lambda: K.fused_leff_bwd(x, g, *lw, residual=C == 512)))
        row.setdefault("attention_bwd_" + key, []).append(
            graph_ms(lambda: K.fused_attention_image_bwd(x, g, *aw, **akw)))
        row["sha256_" + key] = digests(
            K.fused_leff_bwd(x, g, *lw, residual=C == 512)
            + K.fused_attention_image_bwd(x, g, *aw, **akw))
    rows.append(row)
print(json.dumps({"rows": rows}))
"""

_ATTN_IMAGE = _KERNEL_COMMON + """
import hashlib
from uformer_tpu_torch import get_arch
f32 = torch.float32
LAYERS = (["encoderlayer_%d" % k for k in range(4)] + ["conv"]
          + ["decoderlayer_%d" % k for k in range(4)])

def calls(cell, arch, train):
    # (stage, B, res, C, heads, modulator, shift, residual, blocks) of
    # every kernel-1 call of the cell's forward or step
    model = get_arch({"arch": arch, "train_ps": 128 if train else 256})
    model.train(train)
    B = 32 if train else 8
    out = []
    for name in LAYERS:
        layer = getattr(model, name)
        if not train and layer.stage_ok:
            continue
        count = {}
        for b in layer.blocks:
            if b.image_route:
                key = (b.shift_size, not (train and b.drop_path1.rate > 0))
                count[key] = count.get(key, 0) + 1
        for (shift, res), n in count.items():
            out.append((cell, name, B, layer.resolution, layer.dim,
                        layer.num_heads, layer.has_mod, shift, res, n))
    return out

rows = []
for cell, arch, train in (("serve B", "Uformer_B", False),
                          ("serve T", "Uformer_T", False),
                          ("train", "Uformer_B", True),
                          ("train T", "Uformer_T", True)):
    for cell, name, B, R, C, nH, mod, shift, res, n in calls(cell, arch,
                                                             train):
        s = C ** -0.5
        args = (rnd(64, C, scale=0.1) if mod else None,
                1.0 + rnd(C, scale=0.1, dtype=f32), rnd(C, scale=0.1, dtype=f32),
                rnd(C, C, scale=s), rnd(C, scale=0.1, dtype=f32),
                rnd(C, 2 * C, scale=s), rnd(2 * C, scale=0.1, dtype=f32),
                rnd(C, C, scale=s), rnd(C, scale=0.1, dtype=f32),
                rnd(nH, 64, 64, scale=0.5, dtype=f32))
        kw = dict(win=8, shift=shift, scale=(C // nH) ** -0.5, num_heads=nH,
                  residual=res)
        x = rnd(B, R, R, C)
        run = lambda: K.fused_attention_image(x, *args, **kw)
        y = run()
        err = float((y.float()
                     - K.attention_image_reference(x, *args, **kw).float())
                    .abs().max())
        digest = hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes())
        rows.append({"cell": cell, "stage": name, "shape": [B, R, R, C],
                     "heads": nH, "shift": shift, "residual": res,
                     "blocks": n, "graph_ms": graph_ms(run),
                     "max_abs_err": err, "sha256": digest.hexdigest()[:16]})
totals = {}
for r in rows:
    totals[r["cell"]] = totals.get(r["cell"], 0.0) + r["blocks"] * r["graph_ms"]
print(json.dumps({"rows": rows, "per_cell_ms": totals}))
"""

_ATTN_BLOCK = _KERNEL_COMMON + """
from uformer_tpu_torch import get_arch
f32 = torch.float32
LAYERS = (["encoderlayer_%d" % k for k in range(4)] + ["conv"]
          + ["decoderlayer_%d" % k for k in range(4)])
rows = []
# every kernel-5 call of the serve T forward (bs8 256^2) and the train T
# step (bs32 128^2): the windowed blocks, LN1 outside, as the model runs
for cell, B, train in (("serve T", 8, False), ("train T", 32, True)):
    model = get_arch({"arch": "Uformer_T", "train_ps": 128 if train else 256})
    for lname in LAYERS:
        layer = getattr(model, lname)
        if not train and layer.stage_ok:
            continue
        R, C, nH = layer.resolution, layer.dim, layer.num_heads
        for b in layer.blocks:
            if b.image_route:
                continue
            s = C ** -0.5
            args = (rnd(64, C, scale=0.1) if layer.has_mod else None, None,
                    None, rnd(C, C, scale=s), rnd(C, scale=0.1, dtype=f32),
                    rnd(C, 2 * C, scale=s), rnd(2 * C, scale=0.1, dtype=f32),
                    rnd(C, C, scale=s), rnd(C, scale=0.1, dtype=f32),
                    rnd(nH, 64, 64, scale=0.5, dtype=f32))
            kw = dict(win=8, shift=b.shift_size, H=R, W=R,
                      scale=(C // nH) ** -0.5, num_heads=nH, has_ln=False)
            x = rnd(B * (R // 8) ** 2, 64, C)
            run = lambda: K.fused_attention_block(x, *args, **kw)
            y = run()
            err = float((y.float() - K.attention_block_reference(
                x, *args, **kw).float()).abs().max())
            rows.append({"cell": cell, "stage": lname, "windows": x.shape[0],
                         "C": C, "heads": nH, "shift": b.shift_size,
                         "graph_ms": graph_ms(run), "eager_ms": ms(run, 20),
                         "max_abs_err": err, "sha256": digest(y)})
totals = {}
for r in rows:
    totals[r["cell"]] = totals.get(r["cell"], 0.0) + r["graph_ms"]
print(json.dumps({"rows": rows, "per_cell_ms": totals}))
"""

_WINDOW_ATTN = _KERNEL_COMMON + """
import torch.nn.functional as F
from uformer_tpu_torch.ops.kernels import window_attention as WA
f32 = torch.float32
rows = []
# (nH, Bw, D, res): Uformer_T's enc0 at bs8 256^2, head dim 32 there, and
# four heads of 512 windows (bs8 64^2)
for nH, Bw, D, R in ((1, 8192, 16, 256), (1, 8192, 32, 256),
                     (4, 512, 16, 64)):
    q, k, v = (rnd(nH, Bw, 64, D) for _ in range(3))
    bias = rnd(nH, 64, 64, scale=0.5, dtype=f32)
    for shift in (0, 4):
        kw = dict(win=8, shift=shift, H=R, W=R, scale=D ** -0.5)
        ref = K.window_attention_reference(q, k, v, bias, **kw).float()
        run = lambda: K.fused_window_attention(q, k, v, bias, **kw)
        y = run()
        row = {"shape": [nH, Bw, 64, D], "shift": shift,
               "max_abs_err": float((y.float() - ref).abs().max()),
               "graph_ms": graph_ms(run), "sha256": digest(y)}
        # as chip_smoke.py's core timing: the mean of 10 eager calls after
        # 2 warm-up ones
        run(), run()
        row["eager_ms"] = ms(run, 10)
        # the bias [and the shift mask] as one additive bf16 mask
        add = bias[:, None, None]
        if shift:
            add = add + WA.window_mask(R, R, 8, shift, Bw, 0, q.device)
        full = (add.expand(nH, Bw // (R // 8) ** 2, (R // 8) ** 2, 64, 64)
                .reshape(nH, Bw, 64, 64).to(torch.bfloat16).contiguous())
        sdpa = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=full, scale=D ** -0.5)
        row["sdpa_graph_ms"] = graph_ms(sdpa)
        rows.append(row)
print(json.dumps({"rows": rows}))
"""

_WIDE = _KERNEL_COMMON + """
from uformer_tpu_torch import get_arch
f32 = torch.float32
rows = []
for embed, win in ((32, 16), (64, 16), (32, 32)):
    model = get_arch({"arch": "Uformer", "embed_dim": embed,
                      "win_size": win, "train_ps": 128})
    for lname in (["encoderlayer_%d" % k for k in range(4)] + ["conv"]
                  + ["decoderlayer_%d" % k for k in range(4)]):
        layer = getattr(model, lname)
        R, C, nH = layer.resolution, layer.dim, layer.num_heads
        for b in {b.shift_size: b for b in layer.blocks}.values():
            w = b.win_size
            if b.image_route or w <= 8:
                continue
            N, s = w * w, C ** -0.5
            args = (rnd(N, C, scale=0.1) if layer.has_mod else None, None,
                    None, rnd(C, C, scale=s), rnd(C, scale=0.1, dtype=f32),
                    rnd(C, 2 * C, scale=s), rnd(2 * C, scale=0.1, dtype=f32),
                    rnd(C, C, scale=s), rnd(C, scale=0.1, dtype=f32),
                    rnd(nH, N, N, scale=0.5, dtype=f32))
            kw = dict(win=w, shift=b.shift_size, H=R, W=R,
                      scale=(C // nH) ** -0.5, num_heads=nH, has_ln=False)
            x = rnd(8 * (R // w) ** 2, N, C)
            g = rnd(*x.shape)
            fwd = lambda: K.fused_attention_block(x, *args, **kw)
            bwd = lambda: K.fused_attention_block_bwd(x, g, *args, **kw)
            row = {"model": "e%d win%d" % (embed, win), "stage": lname,
                   "windows": x.shape[0], "N": N, "C": C, "heads": nH,
                   "shift": b.shift_size}
            try:  # a root without windows above 16 refuses those
                sha = digest(fwd()), digests(bwd())
            except ValueError as exc:
                rows.append(dict(row, refused=str(exc)))
                continue
            rows.append(dict(row, fwd_ms=ms(fwd, 3), bwd_ms=ms(bwd, 3),
                             fwd_sha256=sha[0], bwd_sha256=sha[1]))
print(json.dumps({"rows": rows}))
"""

_CHILDREN = {"forward": _CHILD.replace(
                 "MODEL", 'get_arch({"arch": "Uformer_B", "train_ps": 256})'),
             "forward_t": _CHILD.replace(
                 "MODEL", 'get_arch({"arch": "Uformer_T", "train_ps": 256})'),
             "forward_bconv": _CHILD.replace("MODEL", _BCONV),
             "attention_image": _ATTN_IMAGE, "dwconv3x3": _DWCONV,
             "leff": _LEFF,
             "stage": _STAGE, "train": 'ARCH = "Uformer_B"' + _TRAIN,
             "train_t": 'ARCH = "Uformer_T"' + _TRAIN, "leff_bwd": _LEFF_BWD,
             "attention_bwd": _ATTN_BWD, "bwd_split": _BWD_SPLIT,
             "attention_block": _ATTN_BLOCK,
             "window_attention": _WINDOW_ATTN, "wide": _WIDE}
_CHILDREN_F32 = {"stage": _STAGE_F32, "leff": _LEFF_F32}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--what", choices=tuple(_CHILDREN), default="forward")
    ap.add_argument("--fp32", action="store_true",
                    help="stage and leff in fp32 at the fp32 eval request's "
                    "shapes (TF32 off)")
    args = ap.parse_args()
    if args.fp32 and args.what not in _CHILDREN_F32:
        ap.error(f"--fp32 takes --what {' or '.join(_CHILDREN_F32)}")
    child = (_CHILDREN_F32 if args.fp32 else _CHILDREN)[args.what]
    for root in args.roots:
        out = subprocess.run([sys.executable, "-c", child], cwd=root,
                             capture_output=True, text=True, check=True)
        result = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, **result}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
