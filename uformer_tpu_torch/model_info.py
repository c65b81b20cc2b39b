"""Parameters, GFLOPs and bytes of one forward, counterpart of
`scripts/model_info.py` (reference model.py:1331-1344, the README's GMacs
section):

    python -m uformer_tpu_torch.model_info [--arch Uformer_T]
        [--embed_dim 16] [--input_size 256] [--device cuda]

Builds the arch at train_ps = input_size and counts one batch-1 forward of
its plain path (`utils.flops.model_complexity`, whose docstring says how
the count differs from the JAX package's). `--device cpu` counts on the
CPU; the default is the card, which fails without one.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from uformer_tpu_torch.models.registry import get_arch
from uformer_tpu_torch.utils.flops import model_complexity


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="Uformer_T")
    p.add_argument("--embed_dim", type=int, default=16)
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available()"
                           f" is false (--device cpu counts on the CPU)")
    model = get_arch({"arch": args.arch, "embed_dim": args.embed_dim,
                      "train_ps": args.input_size}).to(device)
    info = model_complexity(model, (1, args.input_size, args.input_size, 3))
    print(model)
    print("# model parameters: %.2f M" % info["params_m"])
    print("number of GFLOPs: %.2f G" % info["gflops"])
    print("bytes accessed: %.2f GB" % info["bytes_gb"])
    return info


if __name__ == "__main__":
    main()
