"""The evaluation layer of the port: metrics, padding and tiled
inference, image IO, and the SIDD, DND, GoPro/HIDE and RealBlur harnesses
(copies of `uformer_tpu/eval/`, which imports jax), driven by a callable
that answers numpy NHWC batches (`Restorer.numpy`); `cli` runs them."""

from uformer_tpu_torch.eval.metrics import (  # noqa: F401
    batch_psnr,
    psnr_255,
    psnr_b,
    psnr_clamped,
    rgb2ycbcr,
    sidd_psnr,
    sidd_ssim,
    ssim_255,
    ssim_gaussian_map,
    ssim_uniform,
)
from uformer_tpu_torch.eval.padding import (  # noqa: F401
    expand2square,
    pad_to_multiple,
    tiled_inference,
    unexpand,
    unpad,
)
from uformer_tpu_torch.eval.image_io import load_img, save_img  # noqa: F401
