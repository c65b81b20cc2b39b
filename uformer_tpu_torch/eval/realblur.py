"""RealBlur-J / RealBlur-R eval with ECC-aligned scoring
(reference `test/test_realblur.py`).

Two phases, matching the reference: (1) restore + save; (2) score each
(gt, restored) pair with intensity matching + ECC homography alignment
(cv2.findTransformECC), masked PSNR, and mask-weighted Gaussian SSIM,
parallelized over a process pool (test_realblur.py:207-208). A copy of
`uformer_tpu/eval/realblur.py`; its pool spawns its workers, since the
restoring process may hold a CUDA context, which a forked child must not
use.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Tuple

import numpy as np

from uformer_tpu_torch.eval.image_io import load_img, save_img
from uformer_tpu_torch.eval.metrics import ssim_gaussian_map
from uformer_tpu_torch.eval.padding import pad_to_multiple, unpad


def image_align(deblurred: np.ndarray, gt: np.ndarray):
    """Intensity-match then ECC-homography-align `deblurred` onto `gt`
    (test_realblur.py:81-124, Köhler protocol). Returns (aligned,
    gt*coverage, coverage_mask, warp)."""
    import cv2

    z, x = deblurred, gt
    zs = (np.sum(x * z) / np.sum(z * z)) * z  # intensity matching

    warp_matrix = np.eye(3, 3, dtype=np.float32)
    criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 100, 0)
    _, warp_matrix = cv2.findTransformECC(
        cv2.cvtColor(x, cv2.COLOR_RGB2GRAY),
        cv2.cvtColor(zs, cv2.COLOR_RGB2GRAY),
        warp_matrix, cv2.MOTION_HOMOGRAPHY, criteria, inputMask=None,
        gaussFiltSize=5)

    h, w = x.shape[:2]
    zr = cv2.warpPerspective(
        zs, warp_matrix, (w, h),
        flags=cv2.INTER_CUBIC + cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_REFLECT)
    cr = cv2.warpPerspective(
        np.ones_like(zs, dtype="float32"), warp_matrix, (w, h),
        flags=cv2.INTER_NEAREST + cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    return zr * cr, x * cr, cr, warp_matrix


def masked_psnr(image_true: np.ndarray, image_test: np.ndarray,
                image_mask: np.ndarray, data_range: float = 1.0) -> float:
    """PSNR with MSE normalized by covered pixels (test_realblur.py:126-129)."""
    err = np.sum((image_true - image_test) ** 2, dtype=np.float64) \
        / np.sum(image_mask)
    return 10 * np.log10(data_range ** 2 / err)


def masked_ssim(tar_img: np.ndarray, prd_img: np.ndarray,
                cr1: np.ndarray) -> float:
    """Mask-weighted Gaussian SSIM (test_realblur.py:132-142): skimage
    gaussian_weights=True / sigma 1.5 / population covariance, SSIM map
    weighted by the coverage mask and border-cropped by the filter radius."""
    _, ssim_map = ssim_gaussian_map(tar_img, prd_img, data_range=1.0)
    ssim_map = ssim_map * cr1
    r = int(3.5 * 1.5 + 0.5)
    pad = (2 * r + 1 - 1) // 2
    m = ssim_map[pad:-pad, pad:-pad, :]
    c = cr1[pad:-pad, pad:-pad, :]
    per_ch = m.sum(axis=(0, 1)) / c.sum(axis=(0, 1))
    return float(np.mean(per_ch))


def score_pair(pair: Tuple[str, str]):
    """(gt_path, restored_path) -> (psnr, ssim) with ECC alignment
    (test_realblur.py:144-157 'proc')."""
    tar_path, prd_path = pair
    tar = load_img(tar_path)
    prd = load_img(prd_path)
    prd_aligned, tar_masked, cr, _ = image_align(prd, tar)
    p = masked_psnr(tar_masked, prd_aligned, cr, data_range=1.0)
    s = masked_ssim(tar_masked, prd_aligned, cr)
    return p, s


def restore_realblur(fn: Callable, list_file: str, data_root: str,
                     result_dir: str, factor: int = 128):
    """Phase 1: restore every blurred image in the RealBlur list file
    (lines: '<gt_rel> <blur_rel>', test_realblur.py:169-190)."""
    os.makedirs(result_dir, exist_ok=True)
    pairs = []
    with open(list_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            gt_rel, blur_rel = parts[0], parts[1]
            blur = load_img(os.path.join(data_root, blur_rel))[None]
            padded, orig = pad_to_multiple(blur, factor)
            restored = np.clip(np.asarray(fn(padded)), 0, 1)
            restored = unpad(restored, orig)[0]
            out_name = blur_rel.replace("/", "_") + ".png"
            out_path = os.path.join(result_dir, out_name)
            save_img(out_path, restored)
            pairs.append((os.path.join(data_root, gt_rel), out_path))
    return pairs


def score_realblur(pairs, workers: int = 10):
    """Phase 2: parallel ECC-aligned scoring (test_realblur.py:207-208)."""
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context(
                                 "spawn")) as ex:
        results = list(ex.map(score_pair, pairs))
    psnrs = [r[0] for r in results]
    ssims = [r[1] for r in results]
    return float(np.mean(psnrs)), float(np.mean(ssims))
