"""Host-side image IO (reference `utils/image_utils.py:31-38`):
cv2 BGR<->RGB, float32 [0,1]."""

from __future__ import annotations

import numpy as np


def load_img(filepath: str) -> np.ndarray:
    import cv2

    img = cv2.cvtColor(cv2.imread(filepath), cv2.COLOR_BGR2RGB)
    return img.astype(np.float32) / 255.0


def save_img(filepath: str, img: np.ndarray) -> None:
    import cv2

    if img.dtype != np.uint8:
        img = np.uint8(np.round(np.clip(img, 0, 1) * 255))
    cv2.imwrite(filepath, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
