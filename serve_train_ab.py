#!/usr/bin/env python3
"""Serve B and the bs32 train step of two or more checkouts on one card,
each root in its own process, in the order given:

    python3 serve_train_ab.py --roots _archive/parent . . _archive/parent

Each root's `chip_smoke.py` builds that root's kernels (once per root),
answers serve B's 4 bf16 requests of batch 8 at 256^2 (MP/s, ms a
request; checked against the plain path), times the bf16 forward by CUDA
events, and times 10 bf16 train steps of Uformer_B at bs32 128^2 (lr 0,
CUDA events). One JSON line per root. Compare roots only within one call,
in turns (parent, change, change, parent): the bs32 step is host-bound
and the shared host spreads it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def one(root: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    import chip_smoke as C
    from uformer_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    device = torch.device("cuda", 0)
    _, sd = C.seeded_weights()
    restorer, x, serve, _, checks = C.serve_phase(
        lambda: C.build_model(sd, C.RES_SERVE, device), device,
        C.EXPECTED_LAUNCHES, "serve")
    checks.raise_if_failed("serve")
    forward_ms = C.cuda_ms(lambda: restorer(x), reps=20)
    del restorer
    torch.cuda.empty_cache()
    model = C.build_model(sd, C.RES_TRAIN, device)
    batch = C.train_batch(C.BATCH_TRAIN, 3, device)
    ms, _, _ = C.timed_steps(model, batch, 10)
    return {"root": str(root), "card": C.card_line(),
            "serve_mp_s": serve["mp_per_s"],
            "serve_median_ms": serve["median_ms"], "forward_ms": forward_ms,
            "train_ms_median": float(np.median(ms)), "train_ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print("RESULT " + json.dumps(one(args.one.resolve())), flush=True)
        return 0
    for root in args.roots:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             str(root)], capture_output=True, text=True, check=False,
            timeout=900)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-3000:], out.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[-1][len("RESULT "):], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
