"""Utilities: serving preparation (`params`), freezing (`freeze`), the
model's operation count (`flops`) and debugging (`debug`)."""

from uformer_tpu_torch.utils.params import prepare_serving  # noqa: F401
