"""SIDD validation harness (reference `test/test_sidd.py`)
and the official scorer (`test/eval_sidd.m`) in Python.

The reference loops 40x32 blocks one forward at a time; here the 32
blocks of each image run as one batch (256² blocks are already multiples
of 128, so no padding at all — the reference pays expand2square on every
block). A copy of `uformer_tpu/eval/sidd.py`, but for the blocks'
layout: loadmat returns MATLAB's column-major arrays, in which every
image's blocks are strided across the whole set, so each batch gathered
for the restorer (and each result scattered back) walks all of it. The
loaders hand over row-major blocks and the submission is written
column-major again, each in two cache-friendly copies.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import scipy.io as sio

from uformer_tpu_torch.eval.metrics import sidd_psnr, sidd_ssim


def _row_major(a: np.ndarray) -> np.ndarray:
    """(n, b, H, W, C) in row-major order, from loadmat's column-major
    array: the image and block axes to the front, then each block's
    (C, W, H) to (H, W, C). One reversed-axes copy is ~4x slower."""
    t = np.ascontiguousarray(a.T.transpose(4, 3, 0, 1, 2))  # n, b, C, W, H
    return np.ascontiguousarray(t.transpose(0, 1, 4, 3, 2))


def _column_major(a: np.ndarray) -> np.ndarray:
    """The inverse of _row_major: (n, b, H, W, C) in the column-major order
    savemat writes."""
    t = np.ascontiguousarray(a.transpose(0, 1, 4, 3, 2))  # n, b, C, W, H
    return np.ascontiguousarray(t.transpose(2, 3, 4, 1, 0)).T


def load_sidd_val_noisy(input_dir: str) -> np.ndarray:
    """(40, 32, 256, 256, 3) float32 in [0,1] from
    ValidationNoisyBlocksSrgb.mat (test_sidd.py:95-99)."""
    path = os.path.join(input_dir, "ValidationNoisyBlocksSrgb.mat")
    mat = sio.loadmat(path)
    x = mat["ValidationNoisyBlocksSrgb"]
    return np.float32(_row_major(x)) / 255.0


def load_sidd_val_gt(input_dir: str) -> np.ndarray:
    path = os.path.join(input_dir, "ValidationGtBlocksSrgb.mat")
    mat = sio.loadmat(path)
    return np.float32(_row_major(mat["ValidationGtBlocksSrgb"])) / 255.0


def restore_sidd(fn: Callable, noisy: np.ndarray,
                 batch_blocks: int = 32) -> np.ndarray:
    """Run the restorer over all (n_img, n_blk, 256, 256, 3) blocks.

    fn: NHWC restorer, numpy in and out (`Restorer.numpy`).
    """
    n_img, n_blk = noisy.shape[:2]
    out = np.empty_like(noisy)
    for i in range(n_img):
        for b0 in range(0, n_blk, batch_blocks):
            blk = noisy[i, b0:b0 + batch_blocks]
            out[i, b0:b0 + batch_blocks] = np.clip(np.asarray(fn(blk)), 0, 1)
    return out


def save_sidd_submission(restored: np.ndarray, result_dir: str):
    """Idenoised.mat in the layout eval_sidd.m expects (test_sidd.py:115)."""
    os.makedirs(result_dir, exist_ok=True)
    sio.savemat(os.path.join(result_dir, "Idenoised.mat"),
                {"Idenoised": _column_major(np.float32(restored))})


def score_sidd(restored: np.ndarray, gt: np.ndarray):
    """Python equivalent of eval_sidd.m: mean MATLAB psnr/ssim over
    40 images x 32 blocks."""
    n_img, n_blk = restored.shape[:2]
    psnrs, ssims = [], []
    for i in range(n_img):
        for k in range(n_blk):
            psnrs.append(sidd_psnr(restored[i, k], gt[i, k]))
            ssims.append(sidd_ssim(restored[i, k], gt[i, k]))
    return float(np.mean(psnrs)), float(np.mean(ssims))


def run_sidd_eval(fn: Callable, input_dir: str, result_dir: str,
                  gt_available: bool = True):
    noisy = load_sidd_val_noisy(input_dir)
    restored = restore_sidd(fn, noisy)
    save_sidd_submission(restored, result_dir)
    if gt_available and os.path.exists(
            os.path.join(input_dir, "ValidationGtBlocksSrgb.mat")):
        gt = load_sidd_val_gt(input_dir)
        psnr, ssim = score_sidd(restored, gt)
        print(f"SIDD PSNR: {psnr:.4f} SSIM: {ssim:.4f}")
        with open(os.path.join(result_dir, "psnr_ssim.txt"), "a") as f:
            f.write(f"SIDD PSNR: {psnr:.4f} SSIM: {ssim:.4f}\n")
        return psnr, ssim
    return None
