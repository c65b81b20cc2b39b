"""SIDD patch generation, counterpart of `uformer_tpu/data/patches.py`
(reference `generate_patches_SIDD.py`).

Scans SIDD-Medium scene directories for GT/NOISY PNG pairs and writes
`num_patches` random `ps` x `ps` crops per image to <tar>/groundtruth and
<tar>/input, over a pool of processes; crop i of image j comes from
numpy's default_rng(seed + j), so the files are those the JAX package
writes:

    python -m uformer_tpu_torch.data.patches --src_dir SRC --tar_dir TAR
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from glob import glob
from typing import Optional, Sequence

import numpy as np


def _save_patches(args):
    (i, gt_path, noisy_path, gt_dir, input_dir, ps, num_patches, seed) = args
    import cv2

    gt = cv2.imread(gt_path)
    noisy = cv2.imread(noisy_path)
    H, W = gt.shape[:2]
    rng = np.random.default_rng(seed + i)
    for j in range(num_patches):
        rr = int(rng.integers(0, H - ps + 1))
        cc = int(rng.integers(0, W - ps + 1))
        cv2.imwrite(os.path.join(gt_dir, f"{i+1}_{j+1}.png"),
                    gt[rr:rr + ps, cc:cc + ps])
        cv2.imwrite(os.path.join(input_dir, f"{i+1}_{j+1}.png"),
                    noisy[rr:rr + ps, cc:cc + ps])


def generate_patches_sidd(src_dir: str, tar_dir: str, ps: int = 256,
                          num_patches: int = 300, num_cores: int = 10,
                          seed: int = 0) -> int:
    """The reference CLI's defaults (--ps 256 --num_patches 300
    --num_cores 10, generate_patches_SIDD.py:18-26) and name filters
    (:36-44). Replaces tar_dir; returns the number of pairs written."""
    files = sorted(glob(os.path.join(src_dir, "*", "*.PNG")))
    gt_files = [f for f in files if "GT" in os.path.basename(f)]
    noisy_files = [f for f in files if "NOISY" in os.path.basename(f)]
    if len(gt_files) != len(noisy_files) or not gt_files:
        raise ValueError(f"no GT/NOISY pairs under {src_dir}: "
                         f"{len(gt_files)} GT, {len(noisy_files)} NOISY")
    if os.path.exists(tar_dir):
        shutil.rmtree(tar_dir)
    gt_dir = os.path.join(tar_dir, "groundtruth")
    input_dir = os.path.join(tar_dir, "input")
    os.makedirs(gt_dir)
    os.makedirs(input_dir)

    jobs = [(i, g, n, gt_dir, input_dir, ps, num_patches, seed)
            for i, (g, n) in enumerate(zip(gt_files, noisy_files))]
    with ProcessPoolExecutor(
            max_workers=num_cores,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        list(ex.map(_save_patches, jobs))
    return len(jobs) * num_patches


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The flags of `scripts/generate_patches_sidd.py`."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src_dir", default="../SIDD_Medium_Srgb/Data")
    p.add_argument("--tar_dir", default="../datasets/denoising/sidd/train")
    p.add_argument("--ps", type=int, default=256)
    p.add_argument("--num_patches", type=int, default=300)
    p.add_argument("--num_cores", type=int, default=10)
    args = p.parse_args(argv)
    n = generate_patches_sidd(args.src_dir, args.tar_dir, args.ps,
                              args.num_patches, args.num_cores)
    print(f"wrote {n} patch pairs to {args.tar_dir}")
    return n


if __name__ == "__main__":
    main()
