"""Hand-written Hopper kernels of the eval and train paths, each beside
its plain PyTorch version.

Every wrapper counts its kernel launches (`wrapper.launches`) and, apart,
the calls it answered with the plain version (`wrapper.plain_calls`),
which it takes for a CPU tensor only; kernels 4, 5 and 6 also count
their core's launches above window 8 by body (`core_counts`); `reset_counts`
zeroes every count. Importing this package builds nothing: the CUDA
library is built at the first launch (`_build.load`).
The `*_ad` functions are the differentiable forms: their backward is the
backward kernel (`*_bwd`).
"""

from uformer_tpu_torch.ops.kernels.attention_block import (  # noqa: F401
    attention_block_ad,
    attention_block_reference,
    attention_block_vjp_reference,
    fused_attention_block,
    fused_attention_block_bwd,
)
from uformer_tpu_torch.ops.kernels.dwconv import (  # noqa: F401
    DWCONV_BACKWARD_NOT_PORTED,
    dwconv3x3,
    dwconv3x3_qkv,
    dwconv3x3_qkv_reference,
    dwconv3x3_reference,
)
from uformer_tpu_torch.ops.kernels.attention_image import (  # noqa: F401
    attention_image_ad,
    attention_image_reference,
    attention_image_vjp_reference,
    fused_attention_image,
    fused_attention_image_bwd,
)
from uformer_tpu_torch.ops.kernels.leff import (  # noqa: F401
    fused_leff,
    fused_leff_bwd,
    leff_ad,
    leff_reference,
    leff_vjp_reference,
)
from uformer_tpu_torch.ops.kernels.stage import (  # noqa: F401
    STAGE_KEYS,
    fused_stage,
    stage_reference,
)
from uformer_tpu_torch.ops.kernels.window_attention import (  # noqa: F401
    fused_window_attention,
    window_attention_reference,
)

WRAPPERS = {"stage": fused_stage, "attention_image": fused_attention_image,
            "leff": fused_leff, "attention_bwd": fused_attention_image_bwd,
            "attention_block_bwd": fused_attention_block_bwd,
            "leff_bwd": fused_leff_bwd,
            "window_attention": fused_window_attention,
            "attention_block": fused_attention_block,
            "dwconv3x3": dwconv3x3, "dwconv3x3_qkv": dwconv3x3_qkv}
# the wrappers whose wide core (above window 8) has two bodies
CORE_WRAPPERS = ("window_attention", "attention_block",
                 "attention_block_bwd")
CORE_BODIES = ("core_mma_launches", "core_fma_launches")


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.plain_calls = 0
    for name in CORE_WRAPPERS:
        for body in CORE_BODIES:
            setattr(WRAPPERS[name], body, 0)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def plain_counts() -> dict:
    return {name: fn.plain_calls for name, fn in WRAPPERS.items()}


def core_counts() -> dict:
    """{kernel: {body: launches}} of kernels 4, 5 and 6's core above
    window 8: `core_mma_launches` (bf16, tensor cores) and
    `core_fma_launches` (fp32, CUDA cores)."""
    return {name: {body: getattr(WRAPPERS[name], body)
                   for body in CORE_BODIES} for name in CORE_WRAPPERS}
