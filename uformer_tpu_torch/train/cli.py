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
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from uformer_tpu_torch.config import add_options_to_parser, \
    options_from_args
from uformer_tpu_torch.train.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None):
    """Train with the options of argv; returns (trainer, final train
    state, best validation PSNR). The Trainer raises, before anything is
    built, for what is not ported and for a missing card."""
    parser = argparse.ArgumentParser(description="uformer_tpu_torch trainer")
    add_options_to_parser(parser)
    opt = options_from_args(parser.parse_args(argv))
    if torch.device(opt.device).type == "cuda":
        # the reference trainer's setting: cuDNN picks its conv algorithms
        # by timing them once per shape
        torch.backends.cudnn.benchmark = True
    trainer = Trainer(opt)
    state, best = trainer.fit()
    print(f"done; best PSNR {best:.4f}")
    return trainer, state, best


if __name__ == "__main__":
    main()
