from uformer_tpu_torch.models.registry import ARCHS, get_arch  # noqa: F401
from uformer_tpu_torch.models.uformer import Uformer  # noqa: F401
from uformer_tpu_torch.models.unet import UNet  # noqa: F401
