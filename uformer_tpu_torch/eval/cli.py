"""The eval harnesses from the command line, on the port's restorer:

    python -m uformer_tpu_torch.eval.cli sidd --input_dir DIR --weights W.pth
    python -m uformer_tpu_torch.eval.cli dnd --input_dir DIR --weights W.pth
    python -m uformer_tpu_torch.eval.cli gopro --input_dir DIR --weights W.pth
    python -m uformer_tpu_torch.eval.cli realblur --input_dir ROOT \\
        --list_file LIST --weights W.pth

The counterpart of `scripts/_common.py` and the four
`scripts/test_{sidd,dnd,gopro_hide,realblur}.py`: the same flags, plus
`--device` (default cuda; with no card it fails, it never falls back to the
CPU). `--dtype float32` (the default, for checkpoint parity) runs each
restorer call with TF32 off for matmuls and cuDNN, as the JAX scripts ask
for "highest" matmul precision; the process's own TF32 flags are put back
after each call. The fp32 stage and LeFF kernels of the named archs (C
16-512, head dims 16 and 32) take their products as three TF32 passes on
the tensor cores (`csrc/mma_tf32.cuh`: each operand split into two TF32
parts), about fp32's accuracy, whatever the TF32 flags say; the flags
govern the plain PyTorch ops around them. `--token_projection` and `--token_mlp` take only the
named archs' linear / leff (the reference's `get_arch` fixes them; the
JAX scripts accept the flags and ignore them): any other value raises.

Sharded over N cards, one process each (`scripts/_common.py:74-90`):

    torchrun --nproc_per_node N -m uformer_tpu_torch.eval.cli gopro \
        --input_dir DIR --weights W.pth --tile 256 --mesh_data N

`--mesh_data N` needs `--tile` and a process group of N ranks (started
from torchrun's environment, NCCL, each rank on cuda:LOCAL_RANK; ranks
that share one card name it and gloo: `--device cuda:0 --dist_backend
gloo`). Each image's tiles are split over the ranks
(`parallel.spatial.tiled_inference_sharded`); every rank runs the
harness, rank 0 alone writes results and prints scores.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import os
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from uformer_tpu_torch import get_arch
from uformer_tpu_torch.convert import ORBAX_ROUTE, load_checkpoint
from uformer_tpu_torch.eval.padding import tiled_inference
from uformer_tpu_torch.parallel.multihost import init_multihost, rank_device
from uformer_tpu_torch.parallel.spatial import tiled_inference_sharded
from uformer_tpu_torch.restore import Restorer


def eval_argparser() -> argparse.ArgumentParser:
    """The flags of `scripts/_common.py:eval_argparser`, each harness a
    subcommand with its own flags."""
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--input_dir", required=True)
    common.add_argument("--result_dir", default="./results")
    common.add_argument("--weights", required=True,
                        help="a reference .pth checkpoint")
    common.add_argument("--arch", default="Uformer_B")
    common.add_argument("--embed_dim", type=int, default=32)
    common.add_argument("--dd_in", type=int, default=3)
    common.add_argument("--train_ps", type=int, default=128)
    common.add_argument("--win_size", type=int, default=8)
    common.add_argument("--token_projection", default="linear")
    common.add_argument("--token_mlp", default="leff")
    common.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="float32 for exact checkpoint-parity eval; "
                             "bfloat16 for the fastest inference")
    common.add_argument("--device", default="cuda")
    common.add_argument("--save_images", action="store_true")
    common.add_argument("--tile", type=int, default=0,
                        help="if >0, use overlapping-crop tiled inference "
                             "with this tile size")
    common.add_argument("--tile_overlap", type=int, default=32)
    common.add_argument("--tile_batch", type=int, default=8,
                        help="tile positions batched per call in tiled "
                             "inference")
    common.add_argument("--mesh_data", type=int, default=0,
                        help="split each image's tiles over this many "
                             "ranks (needs --tile and torchrun)")
    common.add_argument("--dist_backend", default=None,
                        help="the process group's backend with --mesh_data "
                             "(default nccl on cards, gloo on the CPU)")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="harness", required=True)
    sub.add_parser("sidd", parents=[common], help="SIDD denoising eval")
    sub.add_parser("dnd", parents=[common], help="DND denoising eval")
    gopro = sub.add_parser("gopro", parents=[common],
                           help="GoPro/HIDE deblurring eval")
    gopro.add_argument("--square_pad", action="store_true",
                       help="reproduce the reference expand2square padding "
                            "exactly (slower; default pads per-side only)")
    realblur = sub.add_parser("realblur", parents=[common],
                              help="RealBlur deblurring eval")
    realblur.add_argument("--list_file", required=True,
                          help="RealBlur list file: lines of "
                               "'<gt_rel> <blur_rel>'")
    realblur.add_argument("--workers", type=int, default=10)
    return p


def build_restorer(args) -> Callable:
    """The NHWC [0,1]-clipped restorer of the CLI args: numpy in and out,
    tiled when --tile is given, its tiles split over the ranks with
    --mesh_data (`scripts/_common.py:build_restorer`)."""
    group = _mesh_group(args) if args.mesh_data else None
    if not args.weights.endswith((".pth", ".pt")):
        raise ValueError(f"--weights {args.weights}: {ORBAX_ROUTE}")
    device = (rank_device(args.device) if group is not None
              else torch.device(args.device))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch.cuda.is_available() is false "
            f"(the eval path never falls back to the CPU; --device cpu "
            f"runs the kernels' plain versions)")
    if (args.token_projection, args.token_mlp) != ("linear", "leff"):
        raise ValueError(
            f"--token_projection {args.token_projection} --token_mlp "
            f"{args.token_mlp}: every named arch fixes linear / leff, as "
            f"the reference's get_arch does; build other variants through "
            f"uformer_tpu_torch.Uformer")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = get_arch({"arch": args.arch, "embed_dim": args.embed_dim,
                      "train_ps": args.train_ps, "dd_in": args.dd_in,
                      "win_size": args.win_size})
    fn = Restorer(load_checkpoint(model, args.weights), dtype, device).numpy
    if dtype == torch.float32:
        fn = _without_tf32(fn)
    if group is not None:
        def sharded_fn(x):
            return np.concatenate([tiled_inference_sharded(
                fn, np.asarray(x[i:i + 1]), group, tile=args.tile,
                overlap=args.tile_overlap, tile_batch=args.tile_batch)
                for i in range(len(x))])

        return sharded_fn
    if not args.tile:
        return fn

    def tiled_fn(x):
        return tiled_inference(fn, x, tile=args.tile,
                               overlap=args.tile_overlap,
                               tile_batch=args.tile_batch)

    return tiled_fn


def _mesh_group(args):
    """The process group of --mesh_data ranks, started where it is not up
    (SystemExit in JAX's scripts; ValueError here)."""
    if not args.tile:
        raise ValueError("--mesh_data splits an image's tiles over the "
                         "ranks: it needs --tile")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != args.mesh_data:
        raise ValueError(
            f"--mesh_data {args.mesh_data} needs a process group of "
            f"{args.mesh_data} ranks; {world} are up (launch with torchrun "
            f"--nproc_per_node {args.mesh_data})")
    init_multihost(args.dist_backend, args.device, world_size=world)
    return dist.group.WORLD


def _without_tf32(fn: Callable) -> Callable:
    """fn with TF32 off for matmuls and cuDNN while it runs (checkpoint-
    parity eval needs true fp32 products; cuDNN's TF32 default is on), the
    caller's flags put back after."""
    @functools.wraps(fn)
    def wrapped(x):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(x)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    return wrapped


def main(argv: Optional[Sequence[str]] = None):
    """Run one harness; returns its result: (PSNR, SSIM) for sidd (None
    without ground truth), gopro and realblur, the crop count for dnd."""
    args = eval_argparser().parse_args(argv)
    fn = build_restorer(args)
    if args.mesh_data and dist.is_initialized() and dist.get_rank() != 0:
        # every rank restores its share of each image; rank 0 writes
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(io.StringIO()):
            args.result_dir = tmp
            return _run_harness(args, fn)
    return _run_harness(args, fn)


def _run_harness(args, fn: Callable):
    if args.harness == "sidd":
        from uformer_tpu_torch.eval.sidd import run_sidd_eval

        return run_sidd_eval(fn, args.input_dir, args.result_dir)
    if args.harness == "dnd":
        from uformer_tpu_torch.eval.dnd import run_dnd_eval

        n = run_dnd_eval(fn, args.input_dir, args.result_dir,
                         save_images=args.save_images)
        print(f"restored {n} crops; bundled under "
              f"{args.result_dir}/matfile/bundled")
        return n
    if args.harness == "gopro":
        from uformer_tpu_torch.eval.gopro_hide import run_gopro_eval

        return run_gopro_eval(fn, args.input_dir, args.result_dir,
                              save_images=args.save_images,
                              square_pad=args.square_pad)
    from uformer_tpu_torch.eval.realblur import restore_realblur, \
        score_realblur

    pairs = restore_realblur(fn, args.list_file, args.input_dir,
                             args.result_dir)
    psnr, ssim = score_realblur(pairs, workers=args.workers)
    print(f"RealBlur PSNR: {psnr:.4f} SSIM: {ssim:.4f}")
    with open(os.path.join(args.result_dir, "psnr_ssim.txt"), "a") as f:
        f.write(f"PSNR: {psnr:.4f} SSIM: {ssim:.4f}\n")
    return psnr, ssim


if __name__ == "__main__":
    main()
