"""GoPro / HIDE motion-deblurring eval
(reference `test/test_gopro_hide.py`).

Full-resolution paired eval: pad to a multiple of 128 (the reference pads
1280x720 to a 1280² square; the NHWC core only needs per-side multiples —
1280x768 — ~2x fewer padded FLOPs), forward, unpad, skimage-protocol
PSNR/SSIM, per-image and mean lines to psnr_ssim.txt. A copy of
`uformer_tpu/eval/gopro_hide.py`, with the per-image body in
`restore_image`.
"""

from __future__ import annotations

import glob
import os
from typing import Callable

import numpy as np

from uformer_tpu_torch.eval.image_io import load_img, save_img
from uformer_tpu_torch.eval.metrics import ssim_uniform
from uformer_tpu_torch.eval.padding import (expand2square, pad_to_multiple,
                                            unexpand, unpad)


def skimage_psnr(gt: np.ndarray, pred: np.ndarray,
                 data_range: float = 1.0) -> float:
    mse = np.mean((np.asarray(gt, np.float64)
                   - np.asarray(pred, np.float64)) ** 2)
    return 10.0 * np.log10(data_range ** 2 / mse)


def iter_pairs(input_dir: str):
    """Paired <dir>/groundtruth + <dir>/input layout (reference
    DataLoaderVal, dataset_motiondeblur.py:114-152)."""
    gt_files = sorted(
        glob.glob(os.path.join(input_dir, "groundtruth", "*")))
    in_files = sorted(glob.glob(os.path.join(input_dir, "input", "*")))
    if len(gt_files) != len(in_files):
        raise ValueError(f"{input_dir}: {len(gt_files)} groundtruth but "
                         f"{len(in_files)} input images")
    for g, n in zip(gt_files, in_files):
        name = os.path.splitext(os.path.basename(n))[0]
        yield name, load_img(g), load_img(n)


def restore_image(fn: Callable, img: np.ndarray, factor: int = 128,
                  square_pad: bool = False) -> np.ndarray:
    """One (H, W, 3) image through `fn`: padded per side to multiples of
    `factor` (or, with square_pad, to the reference's centred square),
    restored, clipped to [0, 1] and cropped back to (H, W, 3)."""
    x = img[None]
    if square_pad:
        padded, _ = expand2square(x, factor)
        restored = np.clip(np.asarray(fn(padded)), 0, 1)
        return unexpand(restored, img.shape[:2], factor)[0]
    padded, orig = pad_to_multiple(x, factor)
    restored = np.clip(np.asarray(fn(padded)), 0, 1)
    return unpad(restored, orig)[0]


def run_gopro_eval(fn: Callable, input_dir: str, result_dir: str,
                   save_images: bool = True, factor: int = 128,
                   square_pad: bool = False, ssim_data_range: float = 2.0):
    """square_pad=True reproduces the reference's expand2square exactly;
    False (default) pads per-side only (identical outputs on the unpadded
    region for pad-invariant models, ~2x faster on 16:9 frames).

    ssim_data_range defaults to 2.0: the reference script calls legacy
    skimage structural_similarity on float input with no data_range
    (test_gopro_hide.py:106), which uses the dtype range = 2.0 — the
    default here reproduces the reference-produced numbers exactly. Pass
    1.0 for the physically-correct [0,1]-image SSIM."""
    os.makedirs(result_dir, exist_ok=True)
    log = os.path.join(result_dir, "psnr_ssim.txt")
    psnrs, ssims, count = [], [], 0
    for name, gt, noisy in iter_pairs(input_dir):
        restored = restore_image(fn, noisy, factor, square_pad)
        p = skimage_psnr(gt, restored)
        s = ssim_uniform(restored, gt, multichannel=True,
                         data_range=ssim_data_range)
        psnrs.append(p)
        ssims.append(s)
        count += 1
        if save_images:
            save_img(os.path.join(result_dir, name + ".png"), restored)
        with open(log, "a") as f:
            f.write(f"{name}.PNG ---->PSNR: {p:.4f}, SSIM: {s:.4f}]\n")
    mp, ms = float(np.mean(psnrs)), float(np.mean(ssims))
    print(f"PSNR: {mp:f}, SSIM: {ms:f}")
    with open(log, "a") as f:
        f.write(f"PSNR: {mp:.4f}, SSIM: {ms:.4f}]\n")
    return mp, ms
