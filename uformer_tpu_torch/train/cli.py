"""The trainer from the command line, counterpart of `scripts/train.py`
(reference `train/train_denoise.py`, `train_motiondeblur.py` and their
`script/train_*.sh` launchers):

    python -m uformer_tpu_torch.train.cli --arch Uformer_B --batch_size 32 \\
        --train_ps 128 --mode denoising --warmup            # denoise recipe
    python -m uformer_tpu_torch.train.cli --arch Uformer_B --batch_size 8 \\
        --train_ps 256 --mode deblurring --nepoch 3000 --checkpoint 500 \\
        --warmup                                            # deblur recipe

Every flag of `config.Options` (the reference's, with its defaults), plus
`--device` (default cuda; with no card it fails, it never falls back to
the CPU). Logs and checkpoints go to <save_dir>/<mode>/<arch><env>/;
`--resume` continues from its models/model_latest.pth.

Data-parallel over N cards, one process each:

    torchrun --nproc_per_node N -m uformer_tpu_torch.train.cli \
        --mesh_data N --batch_size 32 ...

`--mesh_data N` starts the process group from torchrun's environment
(NCCL, each rank on cuda:LOCAL_RANK) and raises where WORLD_SIZE is not
N; `--batch_size` is the global batch. Ranks that share one card name it
and gloo: `--device cuda:0 --dist_backend gloo`.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from uformer_tpu_torch.config import add_options_to_parser, \
    options_from_args
from uformer_tpu_torch.parallel.multihost import init_multihost
from uformer_tpu_torch.train.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None):
    """Train with the options of argv; returns (trainer, final train
    state, best validation PSNR). The Trainer raises, before anything is
    built, for what is not ported and for a missing card."""
    parser = argparse.ArgumentParser(description="uformer_tpu_torch trainer")
    add_options_to_parser(parser)
    parser.add_argument("--dist_backend", default=None,
                        help="the process group's backend with --mesh_data "
                             "(default nccl on cards, gloo on the CPU; gloo "
                             "for ranks that share one card)")
    args = parser.parse_args(argv)
    opt = options_from_args(args)
    if (opt.mesh_data or 1) > 1:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if not dist.is_initialized() and world != opt.mesh_data:
            raise ValueError(
                f"--mesh_data {opt.mesh_data} needs a process group of "
                f"{opt.mesh_data} ranks; WORLD_SIZE is {world} (launch with "
                f"torchrun --nproc_per_node {opt.mesh_data})")
        init_multihost(args.dist_backend, opt.device,
                       world_size=opt.mesh_data)
    if torch.device(opt.device).type == "cuda":
        # the reference trainer's setting: cuDNN picks its conv algorithms
        # by timing them once per shape
        torch.backends.cudnn.benchmark = True
    trainer = Trainer(opt)
    state, best = trainer.fit()
    if trainer.is_main:
        print(f"done; best PSNR {best:.4f}")
    return trainer, state, best


if __name__ == "__main__":
    main()
