"""JAX (flax) Uformer params -> the port's state_dict, in numpy.

A mirror of `uformer_tpu/convert/torch_exporter.py:export_uformer` for the
blocks this port has (linear or conv projection, LeFF or Mlp, modulator,
cross-modulator; not Eca1d), written again because importing the JAX
package imports jax. Layouts: flax Dense (in, out) -> Linear (out, in);
flax Conv (kh, kw, in, out) -> Conv2d (out, in, kh, kw), so a 1x1
pointwise (1, 1, C, inner) -> (inner, C, 1, 1); flax ConvTranspose with
transpose_kernel (kh, kw, out, in) -> ConvTranspose2d (in, out, kh, kw);
depthwise (3, 3, C) -> (C, 1, 3, 3).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from uformer_tpu_torch.ops.relpos import relative_position_index

StateDict = Dict[str, np.ndarray]


def _linear(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _conv(sd: StateDict, prefix: str, p) -> None:
    # Conv (kh, kw, in, out) and transposed (kh, kw, out, in) both map by
    # the same axis order to torch's (out, in, .) / (in, out, .)
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _layernorm(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _depthwise(sd: StateDict, prefix: str, kernel, bias) -> None:
    sd[f"{prefix}.weight"] = np.asarray(kernel).transpose(2, 0, 1)[:, None]
    sd[f"{prefix}.bias"] = np.asarray(bias)


def _qkv(sd: StateDict, prefix: str, p) -> None:
    if "to_kv" in p:
        _linear(sd, f"{prefix}.to_q", p["to_q"])
        _linear(sd, f"{prefix}.to_kv", p["to_kv"])
        return
    for name in ("to_q", "to_k", "to_v"):  # SepConv2d
        _depthwise(sd, f"{prefix}.{name}.depthwise",
                   p[name]["depthwise_kernel"], p[name]["depthwise_bias"])
        _conv(sd, f"{prefix}.{name}.pointwise", p[name]["pointwise"])


def _block(sd: StateDict, prefix: str, p) -> None:
    if "eca" in p["mlp"]:
        raise NotImplementedError(
            f"{prefix}: Eca1d is not ported yet (ROADMAP.md, port queue 1 "
            f"item 8)")
    _layernorm(sd, f"{prefix}.norm1", p["norm1"])
    _layernorm(sd, f"{prefix}.norm2", p["norm2"])
    table = np.asarray(p["attn"]["relative_position_bias_table"])
    sd[f"{prefix}.attn.relative_position_bias_table"] = table
    win = int(round((table.shape[0] ** 0.5 + 1) / 2))
    sd[f"{prefix}.attn.relative_position_index"] = \
        relative_position_index(win, win).astype(np.int64)
    _qkv(sd, f"{prefix}.attn.qkv", p["attn"]["qkv"])
    _linear(sd, f"{prefix}.attn.proj", p["attn"]["proj"])
    if "modulator" in p:
        sd[f"{prefix}.modulator.weight"] = np.asarray(p["modulator"])
    if "cross_modulator" in p:
        sd[f"{prefix}.cross_modulator.weight"] = \
            np.asarray(p["cross_modulator"])
        _layernorm(sd, f"{prefix}.norm_cross", p["norm_cross"])
        _qkv(sd, f"{prefix}.cross_attn.qkv", p["cross_attn"]["qkv"])
        _linear(sd, f"{prefix}.cross_attn.proj", p["cross_attn"]["proj"])
    m = p["mlp"]
    if "fc1" in m:
        _linear(sd, f"{prefix}.mlp.fc1", m["fc1"])
        _linear(sd, f"{prefix}.mlp.fc2", m["fc2"])
        return
    sd[f"{prefix}.mlp.linear1.0.weight"] = np.asarray(m["linear1_kernel"]).T
    sd[f"{prefix}.mlp.linear1.0.bias"] = np.asarray(m["linear1_bias"])
    sd[f"{prefix}.mlp.linear2.0.weight"] = np.asarray(m["linear2_kernel"]).T
    sd[f"{prefix}.mlp.linear2.0.bias"] = np.asarray(m["linear2_bias"])
    _depthwise(sd, f"{prefix}.mlp.dwconv.0", m["dwconv_kernel"],
               m["dwconv_bias"])


def state_dict_from_jax(params: Dict[str, Any]) -> StateDict:
    """flax params of `uformer_tpu.models.Uformer` (arrays or numpy) ->
    state_dict of `uformer_tpu_torch.models.Uformer`, reference names."""
    p = params.get("params", params)
    sd: StateDict = {}
    _conv(sd, "input_proj.proj.0", p["input_proj"]["proj"])
    _conv(sd, "output_proj.proj.0", p["output_proj"]["proj"])
    for name, sub in p.items():
        if re.match(r"(encoderlayer_\d|decoderlayer_\d|conv)$", name):
            for bname, bp in sub.items():
                _block(sd, f"{name}.blocks.{bname.split('_')[1]}", bp)
        elif name.startswith("dowsample_"):
            _conv(sd, f"{name}.conv.0", sub["conv"])
        elif name.startswith("upsample_"):
            _conv(sd, f"{name}.deconv.0", sub["deconv"])
    return sd


def load_numpy_state_dict(model: nn.Module, sd: StateDict) -> nn.Module:
    """Load a numpy state_dict with reference names into `model`. A dict of
    parameters only (the golden manifests hold `named_parameters`) may lack
    the `relative_position_index` buffers, which the model computes; any
    other missing or unexpected key raises."""
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing
               if not k.endswith(".attn.relative_position_index")]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model
