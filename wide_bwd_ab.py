#!/usr/bin/env python3
"""Kernel 6's call above window 8 split into its parts on the card, for one
tree of the repo, at train win32's shapes (`--arch Uformer --embed_dim 32
--win_size 32`, batch 8 at 128², bf16): enc0 (128 windows of 1024 tokens,
C 32, one head) at shift 16 and 0, and dec3 (C 64, two heads) at shift 16.

    python3 wide_bwd_ab.py --tree DIR [--label NAME] [--step] [--json PATH]

DIR is the root of a checkout (it holds `uformer_tpu_torch/` and
`chip_smoke.py`); its kernels build there at first use. Each part of
`attention_block_bwd_parts` (recompute, core, dxm, wgrad dWqkv, wgrad
dWo, colsum) is timed alone by CUDA events on the buffers of one run of
all of them, the whole call beside them, the call's peak memory above
its inputs, and the core part's device time by kernel (torch.profiler).
With --step, also STEPS bf16 train steps of the win-32
Uformer at batch 8, 128² (the tree's `chip_smoke.py`: its seeded weights,
batch and `run_step`): each step's device time between CUDA events, the
host's time to enqueue it (the call's return, before a synchronize), and
its peak memory, absolute and above the memory before it. To compare two
trees, run each in its own process within one machine, in turns: parent,
change, change, parent. Prints one line a shape and, last, a JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# (label, windows, tokens a window, C, heads, shift, image side)
SHAPES = (("enc0 s16", 128, 1024, 32, 1, 16, 128),
          ("enc0 s0", 128, 1024, 32, 1, 0, 128),
          ("dec3 s16", 128, 1024, 64, 2, 16, 128))
WIN = 32
REPS = 5
STEPS = 5  # train steps timed with --step, after one untimed


def cuda_ms(torch, fn, reps: int = REPS, warmup: int = 1) -> float:
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


def kernel_ms(torch, fn, n: int = 3) -> dict:
    """Device ms a call of fn by kernel name (torch.profiler over n calls
    after one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if t > 0:
            out[e.key[:70]] = t / n / 1e3
    return out


def time_steps(torch, root: Path, dev, label: str, card: str) -> dict:
    """STEPS bf16 train win32 steps by the tree's chip_smoke.py: device
    ms (CUDA events), host enqueue ms, peak MiB (absolute, above the step's
    start), medians and each."""
    import numpy as np

    import chip_smoke as cs

    if Path(cs.__file__).resolve().parent != root:
        raise RuntimeError(f"imported {cs.__file__}, not the tree's")
    opt = dict(cs.WIN32_ARCH, train_ps=cs.RES_TRAIN)
    model = cs.build_arch(opt, cs.seeded_for(opt, cs.SEED_WIN32), dev)
    batch = cs.train_batch(cs.WIDE_TRAIN_BATCH, 7, dev, cs.RES_TRAIN)
    _, state, step = cs.run_step(model, False, torch.bfloat16, batch, 50,
                                 lambda s: 0.0)
    out = {"device_ms": [], "host_ms": [], "peak_mib": [],
           "peak_above_start_mib": []}
    for i in range(STEPS + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step(state, batch, torch.Generator(device="cpu").manual_seed(51))
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if i == 0:
            continue
        peak = torch.cuda.max_memory_allocated(dev)
        out["device_ms"].append(start.elapsed_time(end))
        out["host_ms"].append(host)
        out["peak_mib"].append(peak / 2 ** 20)
        out["peak_above_start_mib"].append((peak - base) / 2 ** 20)
    med = {k: float(np.median(v)) for k, v in out.items()}
    print(f"  {label} train win32 bs8 128^2 bf16 step: {med['device_ms']:.3f}"
          f" ms between events, host enqueue {med['host_ms']:.3f} ms, peak "
          f"{med['peak_mib']:.1f} MiB ({med['peak_above_start_mib']:.1f} "
          f"above its start)  [{card}]", flush=True)
    return dict(out, median=med)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    root = args.tree.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("wide_bwd_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import uformer_tpu_torch
    from uformer_tpu_torch.ops.kernels import _build
    from uformer_tpu_torch.ops.kernels.attention_block import \
        attention_block_bwd_parts

    if Path(uformer_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {uformer_tpu_torch.__file__}, not "
                           f"the tree {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape, scale=1.0, dt=bf):
        return (scale * torch.randn(shape, generator=gen)).to(dev, dt)

    rows = []
    for name, Bw, N, C, nH, shift, side in SHAPES:
        f32 = torch.float32
        prm = (rnd(N, C, scale=C ** -0.5), None, None,
               rnd(C, C, scale=C ** -0.5), rnd(C, scale=0.02, dt=f32),
               rnd(C, 2 * C, scale=C ** -0.5),
               rnd(2 * C, scale=0.02, dt=f32), rnd(C, C, scale=C ** -0.5),
               rnd(C, scale=0.02, dt=f32), rnd(nH, N, N, scale=0.5, dt=f32))
        x, g = rnd(Bw, N, C), rnd(Bw, N, C)
        kw = dict(win=WIN, shift=shift, H=side, W=side,
                  scale=(C // nH) ** -0.5, num_heads=nH, has_ln=False)
        parts, result = attention_block_bwd_parts(x, g, *prm, **kw)
        for _, run in parts:
            run()
        torch.cuda.synchronize()
        out = {"shape": name, "Bw": Bw, "N": N, "C": C, "heads": nH,
               "shift": shift}
        for part, run in parts:
            out[part] = cuda_ms(torch, run)

        def call():
            ps, res = attention_block_bwd_parts(x, g, *prm, **kw)
            for _, run in ps:
                run()
            return res()

        out["call"] = cuda_ms(torch, call)
        out["core_kernels"] = kernel_ms(torch, dict(parts)["core"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        call()
        torch.cuda.synchronize()
        out["peak_mib_above_inputs"] = (torch.cuda.max_memory_allocated(dev)
                                        - base) / 2 ** 20
        print(f"  {args.label} {name} (Bw {Bw}, N {N}, C {C}, {nH} heads): "
              f"call {out['call']:.4f} ms; "
              + ", ".join(f"{p} {out[p]:.4f}" for p, _ in parts)
              + f"; peak {out['peak_mib_above_inputs']:.1f} MiB above its "
              f"inputs; core by kernel: "
              + ", ".join(f"{k} {v:.4f}"
                          for k, v in out["core_kernels"].items())
              + f"  [{card}]", flush=True)
        rows.append(out)
        del parts, result, x, g, prm
        torch.cuda.empty_cache()
    report = {"label": args.label, "tree": str(root), "card": card,
              "build_s": build_s, "rows": rows}
    if args.step:
        report["step"] = time_steps(torch, root, dev, args.label, card)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
