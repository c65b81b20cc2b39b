"""Configuration and flags, counterpart of `uformer_tpu/config.py`
(reference `options.py`).

`Options` holds every reference flag with the JAX package's names and
defaults (batch_size 32, nepoch 250, AdamW lr 2e-4 wd 0.02, train_ps 128,
win_size 8, embed_dim 32, ...) and one more, `device` ("cuda" by default,
as the eval CLI's `--device`). The vestigial reference flags (the ViT
group, `gpu`) are accepted and unused. `add_options_to_parser` and
`options_from_args` bridge it to argparse.

`check_supported` says what the port runs of the JAX-only options:
`attn_backend` "auto" or "pallas" runs the kernels on a card tensor,
"jnp" the kernels' plain versions; `use_checkpoint` recomputes each
block in the backward; `mesh_data` N > 1 runs data-parallel over a
process group of N ranks, which must be up; `mesh_model` > 1 raises.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Options:
    # global settings (options.py:10-23)
    batch_size: int = 32
    nepoch: int = 250
    workers: int = 4
    dataset: str = "SIDD"
    pretrain_weights: str = "./log/Uformer_B/models/model_best.pth"
    optimizer: str = "adamw"
    lr_initial: float = 2e-4
    step_lr: int = 50
    weight_decay: float = 0.02
    gpu: str = ""  # accepted, ignored (`device` picks the card)
    arch: str = "Uformer_B"
    mode: str = "denoising"
    dd_in: int = 3

    # saving (options.py:26-29)
    save_dir: str = "./logs/"
    save_images: bool = False
    env: str = "_"
    checkpoint: int = 50

    # Uformer arch (options.py:32-38)
    norm_layer: str = "nn.LayerNorm"
    embed_dim: int = 32
    win_size: int = 8
    token_projection: str = "linear"
    token_mlp: str = "leff"
    att_se: bool = False
    modulator: bool = False

    # vestigial ViT flags (options.py:41-48): parsed, unused, as upstream
    vit_dim: int = 256
    vit_depth: int = 12
    vit_nheads: int = 8
    vit_mlp_dim: int = 512
    vit_patch_size: int = 16
    global_skip: bool = False
    local_skip: bool = False
    vit_share: bool = False

    # training (options.py:51-57)
    train_ps: int = 128
    val_ps: int = 128
    resume: bool = False
    train_dir: str = "./datasets/SIDD/train"
    val_dir: str = "./datasets/SIDD/val"
    warmup: bool = False  # options.py:56; the recipes pass --warmup
    warmup_epochs: int = 3

    # distributed (the JAX package's mesh): data ranks, one process each;
    # a 'model' axis is not ported (check_supported)
    mesh_data: Optional[int] = None
    mesh_model: int = 1

    # the JAX package's extras
    dtype: str = "bfloat16"           # compute dtype for training
    attn_backend: str = "auto"
    use_checkpoint: bool = False      # gradient checkpointing per block
    grad_clip: Optional[float] = None
    seed: int = 1234

    # the port's own
    device: str = "cuda"


ATTN_BACKENDS = ("auto", "pallas", "jnp")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(opt: Options) -> torch.dtype:
    """The torch dtype of `opt.dtype` (bfloat16 or float32)."""
    if opt.dtype not in DTYPES:
        raise ValueError(f"dtype {opt.dtype!r}: expected one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[opt.dtype]


def runs_plain(opt: Options) -> bool:
    """True where `attn_backend` asks for the kernels' plain versions
    ("jnp"); "auto" and "pallas" run the kernels on a card tensor."""
    if opt.attn_backend not in ATTN_BACKENDS:
        raise ValueError(f"attn_backend {opt.attn_backend!r}: expected one "
                         f"of {ATTN_BACKENDS}")
    return opt.attn_backend == "jnp"


def check_supported(opt: Options) -> None:
    """Raise NotImplementedError for the options the port does not run
    yet, before anything is built; ValueError for an unknown dtype or
    attn_backend."""
    if opt.mesh_model > 1:
        raise NotImplementedError(
            f"mesh_model {opt.mesh_model}: tensor-parallel training is not "
            f"ported (ROADMAP.md, port queue 1 item 4; JAX's trainer never "
            f"shards over 'model' either)")
    if (opt.mesh_data or 1) > 1:
        from uformer_tpu_torch.parallel.multihost import group_size

        if group_size() != opt.mesh_data:
            raise ValueError(
                f"mesh_data {opt.mesh_data} needs a process group of "
                f"{opt.mesh_data} ranks; {group_size()} are up (launch "
                f"with torchrun --nproc_per_node {opt.mesh_data})")
        if opt.batch_size % opt.mesh_data:
            raise ValueError(f"batch_size {opt.batch_size} does not split "
                             f"over mesh_data {opt.mesh_data} ranks")
    torch_dtype(opt)
    runs_plain(opt)


def add_options_to_parser(parser: argparse.ArgumentParser,
                          defaults: Optional[Options] = None):
    d = defaults or Options()
    for f in dataclasses.fields(Options):
        v = getattr(d, f.name)
        name = "--" + f.name
        if f.type == "bool" or isinstance(v, bool):
            # BooleanOptionalAction gives --flag / --no-flag so every bool
            # is settable both ways from the CLI regardless of its default
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=v)
        elif v is None:
            parser.add_argument(name, type=int, default=None)
        else:
            parser.add_argument(name, type=type(v), default=v)
    return parser


def options_from_args(args: argparse.Namespace) -> Options:
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(Options)
          if hasattr(args, f.name)}
    return Options(**kw)
