"""Tensor ops of the port (NHWC), counterparts of `uformer_tpu/ops/`."""

from uformer_tpu_torch.ops.attention import window_attention  # noqa: F401
from uformer_tpu_torch.ops.dwconv import depthwise_conv2d  # noqa: F401
from uformer_tpu_torch.ops.masks import (  # noqa: F401
    NEG_BIAS,
    input_mask_bias,
    shift_mask_on,
    shift_window_mask,
)
from uformer_tpu_torch.ops.norm import layer_norm  # noqa: F401
from uformer_tpu_torch.ops.relpos import (  # noqa: F401
    gather_bias,
    relative_position_index,
)
from uformer_tpu_torch.ops.window import (  # noqa: F401
    cyclic_shift,
    cyclic_unshift,
    window_partition,
    window_reverse,
)
