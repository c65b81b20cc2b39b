"""DND benchmark harness (reference `test/test_dnd.py`).

Per 512² crop: pad (none needed — 512 is a multiple of 128), forward,
save PNG + per-crop .mat, then bundle for the DND server.
"""

from __future__ import annotations

import glob
import os
from typing import Callable

import numpy as np
import scipy.io as sio

from uformer_tpu_torch.eval.bundle import bundle_submissions_srgb_v1
from uformer_tpu_torch.eval.padding import pad_to_multiple, unpad
from uformer_tpu_torch.eval.image_io import save_img


def run_dnd_eval(fn: Callable, input_dir: str, result_dir: str,
                 save_images: bool = True, factor: int = 128):
    """input_dir holds the DND input crops as PNGs (the reference's
    DataLoaderTest loads input-only PNGs, dataset_denoise.py:116-136)."""
    png_dir = os.path.join(result_dir, "png")
    mat_dir = os.path.join(result_dir, "matfile")
    os.makedirs(png_dir, exist_ok=True)
    os.makedirs(mat_dir, exist_ok=True)

    files = sorted(glob.glob(os.path.join(input_dir, "*.png"))
                   + glob.glob(os.path.join(input_dir, "*.PNG")))
    from uformer_tpu_torch.eval.image_io import load_img
    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        img = load_img(path)[None]  # (1, H, W, 3) [0,1]
        padded, orig = pad_to_multiple(img, factor)
        restored = np.clip(np.asarray(fn(padded)), 0, 1)
        restored = unpad(restored, orig)[0]
        if save_images:
            save_img(os.path.join(png_dir, name + ".png"),
                     np.uint8(np.round(restored * 255)))
        sio.savemat(os.path.join(mat_dir, name + ".mat"),
                    {"Idenoised_crop": np.float32(restored)})
    bundle_submissions_srgb_v1(mat_dir)
    return len(files)
