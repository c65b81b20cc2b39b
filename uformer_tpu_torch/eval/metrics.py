"""Image-quality metrics matching the reference's several protocols.

The reference uses three different metric stacks; all are reproduced:
  * train-time PSNR: clamped-[0,1] RMSE PSNR, with batch_PSNR's sum
    quirk (`utils/image_utils.py:40-51` — average=False
    returns the SUM; the trainer divides by dataset length,
    train_denoise.py:150-153).
  * eval scripts: skimage psnr + SSIM (uniform 7x7 window, multichannel)
    (`test/test_gopro_hide.py:105-106`).
  * metric library: 255-scale PSNR and Gaussian-window SSIM on
    uint8-rounded inputs + PSNR-B + RGB->YCbCr
    (`utils/caculate_psnr_ssim.py`).
  * official SIDD scorer: MATLAB psnr/ssim on [0,1] singles
    (`test/eval_sidd.m`) — see `sidd_psnr` / `sidd_ssim`; note MATLAB's
    ssim on an RGB array filters volumetrically (11^3 Gaussian), which
    `sidd_ssim` reproduces.

A copy of `uformer_tpu/eval/metrics.py`: `psnr_clamped` and `batch_psnr`
take torch tensors (on any device) where the JAX package's take jnp arrays;
numpy versions match reference numerics.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------- train PSNR

def psnr_clamped(pred, target):
    """20*log10(1/rmse) on [0,1]-clamped images (reference myPSNR)."""
    if isinstance(pred, torch.Tensor):
        diff = pred.clamp(0, 1) - torch.as_tensor(
            target, device=pred.device).clamp(0, 1)
        rmse = (diff ** 2).mean().sqrt()
        return 20.0 * torch.log10(1.0 / rmse)
    diff = np.clip(pred, 0, 1) - np.clip(target, 0, 1)
    rmse = np.sqrt((diff ** 2).mean())
    return 20.0 * np.log10(1.0 / rmse)


def batch_psnr(pred, target, average: bool = True):
    """Per-image PSNR, summed; divided by N only when average=True
    (reference batch_PSNR quirk)."""
    vals = [psnr_clamped(p, t) for p, t in zip(pred, target)]
    s = sum(vals)
    return s / len(vals) if average else s


# ----------------------------------------------------------- 255-scale PSNR

def psnr_255(img1: np.ndarray, img2: np.ndarray, crop_border: int = 0,
             test_y_channel: bool = False) -> float:
    """20*log10(255/sqrt(mse)) on 0-255 inputs (caculate_psnr_ssim.py:12-32)."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img1 = rgb2ycbcr(img1 / 255.0, y_only=True) * 255.0
        img2 = rgb2ycbcr(img2 / 255.0, y_only=True) * 255.0
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


# ----------------------------------------------------------- Gaussian SSIM

def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_valid(img: np.ndarray, k1d: np.ndarray) -> np.ndarray:
    """Separable 2-D correlation, then crop to 'valid' like the reference's
    cv2.filter2D(...)[5:-5, 5:-5]."""
    from scipy.ndimage import correlate1d

    out = correlate1d(img, k1d, axis=0, mode="reflect")
    out = correlate1d(out, k1d, axis=1, mode="reflect")
    r = (len(k1d) - 1) // 2
    return out[r:-r, r:-r]


def _ssim_channel_255(img1: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM on 0-255 doubles with 11/1.5 Gaussian window
    (caculate_psnr_ssim.py:_ssim)."""
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    k = _gaussian_window()
    mu1 = _filter2d_valid(img1, k)
    mu2 = _filter2d_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter2d_valid(img1 ** 2, k) - mu1_sq
    s2 = _filter2d_valid(img2 ** 2, k) - mu2_sq
    s12 = _filter2d_valid(img1 * img2, k) - mu1_mu2
    m = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return float(m.mean())


def ssim_255(img1: np.ndarray, img2: np.ndarray, crop_border: int = 0) -> float:
    """Multi-channel SSIM on uint8-rounded images (calculate_ssim semantics:
    floats are rounded to uint8 first)."""
    def to_u8(x):
        x = np.asarray(x)
        if x.dtype != np.uint8:
            x = np.round(x * 255.0).astype(np.uint8) if x.max() <= 1.5 \
                else np.round(x).astype(np.uint8)
        return x

    img1 = to_u8(img1).astype(np.float64)
    img2 = to_u8(img2).astype(np.float64)
    if crop_border:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    if img1.ndim == 2:
        return _ssim_channel_255(img1, img2)
    return float(np.mean([
        _ssim_channel_255(img1[..., c], img2[..., c])
        for c in range(img1.shape[2])]))


# ------------------------------------------- skimage-style uniform SSIM

def ssim_uniform(img1: np.ndarray, img2: np.ndarray, win_size: int = 7,
                 data_range: float = 1.0, multichannel: bool = True) -> float:
    """skimage.metrics.structural_similarity defaults: uniform win_size=7
    filter, sample covariance (N/(N-1)), border crop — the metric the
    reference eval scripts call (test_gopro_hide.py:106). skimage's
    float default data_range is dtype-range (2.0); pass data_range=2.0 to
    reproduce legacy skimage numbers, 1.0 for [0,1] images."""
    from scipy.ndimage import uniform_filter

    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if multichannel and img1.ndim == 3:
        return float(np.mean([
            ssim_uniform(img1[..., c], img2[..., c], win_size, data_range,
                         multichannel=False)
            for c in range(img1.shape[2])]))
    filt = lambda x: uniform_filter(x, size=win_size)  # noqa: E731
    NP = win_size ** img1.ndim
    cov_norm = NP / (NP - 1)
    ux, uy = filt(img1), filt(img2)
    uxx, uyy, uxy = filt(img1 ** 2), filt(img2 ** 2), filt(img1 * img2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def ssim_gaussian_map(img1: np.ndarray, img2: np.ndarray,
                      data_range: float = 1.0, sigma: float = 1.5):
    """skimage structural_similarity(gaussian_weights=True, sigma=1.5,
    use_sample_covariance=False, full=True) equivalent: returns
    (mean over the radius-cropped map, full per-channel SSIM map).
    Used by the RealBlur masked-SSIM protocol (test_realblur.py:132-142).
    """
    from scipy.ndimage import gaussian_filter

    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    truncate = 3.5
    r = int(truncate * sigma + 0.5)
    win_size = 2 * r + 1
    filt = lambda x: gaussian_filter(x, sigma, truncate=truncate)  # noqa: E731

    def channel(a, b):
        ux, uy = filt(a), filt(b)
        uxx, uyy, uxy = filt(a * a), filt(b * b), filt(a * b)
        vx = uxx - ux * ux   # population covariance
        vy = uyy - uy * uy
        vxy = uxy - ux * uy
        C1 = (0.01 * data_range) ** 2
        C2 = (0.03 * data_range) ** 2
        return ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
            (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))

    if img1.ndim == 2:
        smap = channel(img1, img2)[..., None]
    else:
        smap = np.stack([channel(img1[..., c], img2[..., c])
                         for c in range(img1.shape[2])], axis=-1)
    pad = (win_size - 1) // 2
    mean = float(smap[pad:-pad, pad:-pad].mean())
    return mean, smap


# ------------------------------------------------- official SIDD protocol

def sidd_psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """MATLAB psnr() on [0,1]: 10*log10(1/mse) (eval_sidd.m:18)."""
    mse = np.mean((np.asarray(pred, np.float64)
                   - np.asarray(gt, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(1.0 / mse)


def sidd_ssim(pred: np.ndarray, gt: np.ndarray) -> float:
    """MATLAB ssim() on a [0,1] RGB array (eval_sidd.m:17): MATLAB treats
    the HxWx3 input as a 3-D volume and filters with an 11^3 Gaussian
    (sigma 1.5), exponents all 1, C3=C2/2 folded in."""
    from scipy.ndimage import correlate1d

    p = np.asarray(pred, np.float64)
    g = np.asarray(gt, np.float64)
    k = _gaussian_window(11, 1.5)

    def filt(x):
        # MATLAB ssim/imgaussfilt pads with 'replicate' = scipy 'nearest'
        for ax in range(x.ndim):
            x = correlate1d(x, k, axis=ax, mode="nearest")
        return x

    C1, C2 = (0.01) ** 2, (0.03) ** 2
    mu1, mu2 = filt(p), filt(g)
    s1 = filt(p * p) - mu1 ** 2
    s2 = filt(g * g) - mu2 ** 2
    s12 = filt(p * g) - mu1 * mu2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / (
        (mu1 ** 2 + mu2 ** 2 + C1) * (s1 + s2 + C2))
    return float(m.mean())


# ------------------------------------------------------------------ PSNR-B

def _blocking_effect_factor(im: np.ndarray, block_size: int = 8) -> float:
    """Blocking-effect factor of PSNR-B (caculate_psnr_ssim.py:84-118
    semantics, numpy re-derivation)."""
    h, w = im.shape[:2]
    num_h = w // block_size
    num_v = h // block_size

    h_b = im[:, block_size - 1:w - 1:block_size] - \
        im[:, block_size:w:block_size]
    h_bc = np.delete(im[:, :-1] - im[:, 1:],
                     np.arange(block_size - 1, w - 1, block_size), axis=1)
    v_b = im[block_size - 1:h - 1:block_size, :] - im[block_size:h:block_size, :]
    v_bc = np.delete(im[:-1] - im[1:],
                     np.arange(block_size - 1, h - 1, block_size), axis=0)

    n_hb = h * num_h
    n_hbc = h * (w - 1) - n_hb
    n_vb = w * num_v
    n_vbc = w * (h - 1) - n_vb
    d_b = (h_b ** 2).sum() / n_hb + (v_b ** 2).sum() / n_vb
    d_bc = (h_bc ** 2).sum() / n_hbc + (v_bc ** 2).sum() / n_vbc
    t = np.log2(block_size) / np.log2(min(h, w))
    return t * max(0.0, float(d_b - d_bc))


def psnr_b(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR-B: 255-scale PSNR with the blocking-effect penalty added to the
    MSE of the degraded image (caculate_psnr_ssim.py:121-152)."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 3:
        return float(np.mean([psnr_b(img1[..., c], img2[..., c])
                              for c in range(img1.shape[2])]))
    mse = np.mean((img1 - img2) ** 2)
    bef = _blocking_effect_factor(img2 / 255.0) * 255.0 ** 2
    return 10.0 * np.log10(255.0 ** 2 / (mse + bef))


# ----------------------------------------------------------------- YCbCr

def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """ITU-R BT.601 full-swing-input -> studio-swing conversion on [0,1]
    floats (caculate_psnr_ssim.py:197-206 semantics)."""
    img = np.asarray(img, np.float64)
    m = np.array([[65.481, -37.797, 112.0],
                  [128.553, -74.203, -93.786],
                  [24.966, 112.0, -18.214]])
    if y_only:
        return (img @ m[:, 0] + 16.0) / 255.0
    out = img @ m + np.array([16.0, 128.0, 128.0])
    return out / 255.0
