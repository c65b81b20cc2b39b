#!/usr/bin/env python3
"""bf16 readings of one or more checkouts across seeds, on one card, each
root in its own process, in the order given:

    python3 bf16_seed_scan.py --roots _archive/parent . --dx 19-30 \\
        --steps 3-8 --json seed_scan.json

This checkout's `chip_smoke.py` drives each root's `uformer_tpu_torch`
(built once per root), on the card's first device:

--dx FIRST-LAST   kernels 6 and 7 at C = 8 with LN (phase 19's `c8_ln`
                  cases of `geometry_bwd_checks`, their operands drawn from
                  each seed): the kernel's bf16 dx, max and rms error
                  against the fp32 plain VJP over the GEOM_DRAWS draws
                  pooled, each over its gate (1.5x the plain bf16 VJP's +
                  1e-3 max(1, max|ref|)), and the plain bf16 VJP's own.
--steps FIRST-LAST  phase 11's Uformer_B bs2 whole step
                  (`whole_step_checks`) on the batch drawn from each seed:
                  the worst bf16 err/bound with the step's own loss and
                  from the fp32 step's gradient at the output, and the
                  gradients over their bound each way.

One JSON line per root; with --json, all of them in that file.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def seeds(text):
    first, last = map(int, text.split("-"))
    return list(range(first, last + 1))


def dx_scan(C, device, dx_seeds) -> list:
    """The bf16 dx readings of the c8_ln cases at each seed."""
    import torch

    rows, seen = [], {}
    pooled = C.pooled_grad_bound

    def capture(checks, kernel, what, runs):
        def pool(j):
            return torch.cat([run[j]["dx"].float().reshape(-1)
                              for run in runs])

        _, ref, low, got16 = (pool(j) for j in range(4))
        floor = 1e-3 * max(1.0, float(ref.abs().max()))
        seen[kernel, what] = {
            "max": C.max_err(got16, ref), "rms": C.rms_err(got16, ref),
            "plain_max": C.max_err(low, ref),
            "plain_rms": C.rms_err(low, ref), "floor": floor}
        pooled(checks, kernel, what, runs)

    C.pooled_grad_bound = capture
    try:
        for seed in dx_seeds:
            seen.clear()
            C.geometry_bwd_checks(C.Checks(), device, seed=seed,
                                  select=C.c8_ln)
            for (kernel, what), r in seen.items():
                gate = {k: 1.5 * r[f"plain_{k}"] + r["floor"]
                        for k in ("max", "rms")}
                rows.append(dict(seed=seed, kernel=kernel, what=what, **r,
                                 max_ratio=r["max"] / gate["max"],
                                 rms_ratio=r["rms"] / gate["rms"]))
    finally:
        C.pooled_grad_bound = pooled
    return rows


def step_scan(C, device, step_seeds) -> list:
    """Phase 11's bs2 step at each batch seed, own loss and fp32
    cotangent."""
    import torch

    _, sd = C.seeded_weights()
    torch.backends.cudnn.deterministic = True
    rows = []
    for seed in step_seeds:
        row = {"seed": seed}
        for key, cot in (("own", False), ("fp32_cotangent", True)):
            checks, info = C.whole_step_checks(
                lambda: C.build_model(sd, C.RES_TRAIN, device), device,
                C.BATCH_CHECK, "train", C.TRAIN_LAUNCHES,
                fp32_cotangent=cot, batch_seed=seed)
            bf = [r for r in checks.rows if r["dtype"] == "bf16"]
            worst = max(bf, key=lambda r: r["err"] / r["bound"])
            row[key] = {"worst": worst["err"] / worst["bound"],
                        "worst_what": worst["what"],
                        "over_bound": [r["what"] for r in bf
                                       if not r["ok"]]}
            if not cot:
                row["cotangent"] = info["cotangent"]
        rows.append(row)
    torch.backends.cudnn.deterministic = False
    return rows


def one(root: Path, dx_seeds, step_seeds) -> dict:
    import torch

    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    C = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    from uformer_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    device = torch.device("cuda", 0)
    out = {"root": str(root), "card": C.card_line()}
    if dx_seeds:
        out["dx"] = dx_scan(C, device, dx_seeds)
    if step_seeds:
        out["steps"] = step_scan(C, device, step_seeds)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", type=Path, default=[HERE])
    ap.add_argument("--dx", type=seeds, default=[])
    ap.add_argument("--steps", type=seeds, default=[])
    ap.add_argument("--json", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print("RESULT " + json.dumps(one(args.one.resolve(), args.dx,
                                         args.steps)), flush=True)
        return 0
    results = []
    for root in args.roots:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
               str(root)]
        for flag, values in (("--dx", args.dx), ("--steps", args.steps)):
            if values:
                cmd += [flag, f"{values[0]}-{values[-1]}"]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             check=False, timeout=1200)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return 1
        results.append(json.loads(lines[-1][len("RESULT "):]))
        print(json.dumps(results[-1]), flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
