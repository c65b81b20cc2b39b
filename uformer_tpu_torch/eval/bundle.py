"""DND submission bundling (reference `utils/bundle_submissions.py`).

Packages per-crop result .mat files (named <image>_<crop>.mat, 50 images x
20 crops) into per-image submission .mat files with the metadata fields the
DND server expects ('israw', 'eval_version').
"""

from __future__ import annotations

import os

import numpy as np
import scipy.io as sio


def _bundle(folder: str, transform, israw: bool, eval_version: str = "1.0"):
    out_folder = os.path.join(folder, "bundled")
    os.makedirs(out_folder, exist_ok=True)
    for i in range(50):
        Idenoised = np.zeros((20,), dtype=object)
        for bb in range(20):
            filename = "%04d_%02d.mat" % (i + 1, bb + 1)
            s = sio.loadmat(os.path.join(folder, filename))
            Idenoised[bb] = transform(s["Idenoised_crop"])
        filename = "%04d.mat" % (i + 1)
        sio.savemat(
            os.path.join(out_folder, filename),
            {"Idenoised": Idenoised, "israw": israw,
             "eval_version": eval_version},
        )


def bundle_submissions_raw(folder: str):
    """Raw-domain results: float32 crops (bundle_submissions.py:6-33)."""
    _bundle(folder, lambda x: np.float32(np.squeeze(x)), israw=True)


def bundle_submissions_srgb(folder: str):
    """sRGB results as uint8 (bundle_submissions.py:36-64)."""
    _bundle(folder, lambda x: np.uint8(np.squeeze(x)), israw=False)


def bundle_submissions_srgb_v1(folder: str, fn_suffix: str = ""):
    """sRGB results kept float32 (bundle_submissions.py:67-97) — the variant
    the DND test harness calls (test/test_dnd.py:113)."""
    out_folder = os.path.join(folder, "bundled")
    os.makedirs(out_folder, exist_ok=True)
    for i in range(50):
        Idenoised = np.zeros((20,), dtype=object)
        for bb in range(20):
            filename = "%04d_%02d%s.mat" % (i + 1, bb + 1, fn_suffix)
            s = sio.loadmat(os.path.join(folder, filename))
            Idenoised[bb] = np.float32(np.squeeze(s["Idenoised_crop"]))
        filename = "%04d%s.mat" % (i + 1, fn_suffix)
        sio.savemat(
            os.path.join(out_folder, filename),
            {"Idenoised": Idenoised, "israw": False, "eval_version": "1.0"},
        )
