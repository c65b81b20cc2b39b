"""Time the Uformer_B bf16 serving forward (batch 8, 256^2), or the
depthwise kernel, of two or more checkouts of this repo on one CUDA card,
in turns, to compare them within one run:

    python -m uformer_tpu_torch.forward_ab --roots OLD NEW NEW OLD
    python -m uformer_tpu_torch.forward_ab --what dwconv3x3 --roots ...

Each root runs in its own process (its own `uformer_tpu_torch`, its own
kernel build, made during the warm-up and not timed). `forward`: a bf16
`Restorer` over `get_arch({"arch": "Uformer_B", "train_ps": 256})` with
torch's default weights, then 20 forwards of a (8, 256, 256, 3) input,
each timed with CUDA events. `dwconv3x3`: `dwconv3x3` in bf16 (bf16
weights, fp32 bias) at the (Bw, 8, 8, C) windows of the serve B-conv
stages at bs8 256^2 and one (8, 256, 256, 64) image, each timed as 20
launches in a CUDA graph (device time, without the host's launch cost)
and as 20 eager calls, with its largest difference from the plain
version. Prints one JSON line per root (ms), then the card's name and
power limit.
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
    run = lambda: K.dwconv3x3(x, w, b)
    err = float((run().float() - K.dwconv3x3_reference(x, w, b).float())
                .abs().max())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            run()
    graph.replay()
    rows.append({"shape": shape, "graph_ms": ms(graph.replay, 10) / 20,
                 "eager_ms": ms(run), "max_abs_err": err})
print(json.dumps({"rows": rows}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--what", choices=("forward", "dwconv3x3"),
                    default="forward")
    args = ap.parse_args()
    child = _CHILD if args.what == "forward" else _DWCONV
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
