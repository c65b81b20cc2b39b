"""Time the Uformer_B bf16 serving forward (batch 8, 256^2) of two or more
checkouts of this repo on one CUDA card, in turns, to compare them within
one run:

    python -m uformer_tpu_torch.forward_ab --roots OLD NEW NEW OLD

Each root runs in its own process (its own `uformer_tpu_torch`, its own
kernel build, made during the warm-up and not timed): a bf16 `Restorer`
over `get_arch({"arch": "Uformer_B", "train_ps": 256})` with torch's
default weights, then 20 forwards of a (8, 256, 256, 3) input, each timed
with CUDA events. Prints one JSON line per root (median and every run, in
ms), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_CHILD = """
import json, statistics, torch
from uformer_tpu_torch import get_arch
from uformer_tpu_torch.restore import Restorer
torch.manual_seed(0)
restorer = Restorer(get_arch({"arch": "Uformer_B", "train_ps": 256}),
                    torch.bfloat16, "cuda")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    for root in ap.parse_args().roots:
        out = subprocess.run([sys.executable, "-c", _CHILD], cwd=root,
                             capture_output=True, text=True, check=True)
        result = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, **result}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
