"""uformer_tpu_torch — the Uformer eval and train paths in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `uformer_tpu` (JAX/Pallas on TPU), which stays the reference:
the same NHWC activations, the reference state_dict key names, and one
Hopper kernel for each of its eight Pallas kernels (whole-stage, image
and windowed attention, the window-attention core, LeFF and the
depthwise 3x3 conv forward; attention and LeFF backward). Imports torch
only, never jax.
"""

__version__ = "0.1.0"

from uformer_tpu_torch.models.registry import ARCHS, get_arch  # noqa: F401,E402
