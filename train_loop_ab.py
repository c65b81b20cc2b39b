#!/usr/bin/env python3
"""The train loop against the bare train step on one card, with the
checkpoints written behind the loop (the trainer's best/latest saves) and
in line:

    python3 train_loop_ab.py [--rounds 1] [--json PATH]

Each round runs, for each way of saving, `chip_smoke.py`'s train phase
timing (three bare bs32 128^2 bf16 steps of Uformer_B through
make_train_step) and then its train loop phase (the train CLI's denoise
recipe on seeded PNG pairs, every check of that phase), and prints the
loop's median step, its host enqueue time, the bare steps beside it and
the loop's steps over 1.5x its median.
The card's host is shared and its step host-bound, so only numbers from
one call compare.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def in_line(base):
    """The phase's probed trainer with every save written in line."""
    cls = base()

    class InLine(cls):
        def _save(self, name, epoch, state, async_save=False):
            super()._save(name, epoch, state, async_save=False)

    return InLine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_loop_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    _, sd = cs.seeded_weights()
    base = cs.loop_trainer_class
    ways = {"behind": base, "in line": lambda: in_line(base)}
    runs = []
    for r in range(args.rounds):
        for way, factory in ways.items():
            _, bare = cs.train_timing(
                lambda: cs.build_model(sd, cs.RES_TRAIN, device), device,
                cs.TRAIN_LAUNCHES, "train")
            torch.cuda.empty_cache()
            cs.loop_trainer_class = factory
            try:
                with tempfile.TemporaryDirectory() as tmp:
                    checks, loop, _ = cs.train_loop_phase(
                        Path(tmp), device, card, bare["kernel_ms_median"])
            finally:
                cs.loop_trainer_class = base
            checks.raise_if_failed(f"train loop, saves {way}")
            torch.cuda.empty_cache()
            run = {"round": r, "saves": way, "bare_ms": bare["kernel_ms"],
                   "loop_ms_median": loop["step_ms_median"],
                   "enqueue_ms_median": float(np.median(loop["enqueue_ms"])),
                   "idle_share": loop["idle_share"],
                   "saves_s": [s["s"] for s in loop["saves"]],
                   "step_ms": loop["step_ms"],
                   "enqueue_ms": loop["enqueue_ms"],
                   "save_writing": loop["save_writing"]}
            runs.append(run)
            slow = [round(m, 1) for m in loop["step_ms"]
                    if m > 1.5 * run["loop_ms_median"]]
            print(f"round {r}, saves {way}: loop {run['loop_ms_median']:.3f}"
                  f" ms/step (enqueue {run['enqueue_ms_median']:.3f}), bare "
                  f"steps {[round(b, 3) for b in bare['kernel_ms']]} ms, "
                  f"idle share {100 * run['idle_share']:.2f}%; steps over "
                  f"1.5x the median: {slow}  [{card}]", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "runs": runs},
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
