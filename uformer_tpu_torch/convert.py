"""Checkpoints into the port: reference `.pth` files (`load_pth`,
`load_checkpoint`) and JAX (flax) Uformer and UNet params
(`state_dict_from_jax`), each as a numpy state_dict with the reference key
names; `block_state_dict_from_jax` maps the param tree of one block (LeFF,
Eca1d and the auxiliary blocks of `models/extras.py`).

`state_dict_from_jax`:

A mirror of `uformer_tpu/convert/torch_exporter.py:export_uformer` (linear
or conv projection, LeFF with or without Eca1d, or Mlp, modulator,
cross-modulator) and the inverse of `torch_converter.py:convert_unet`,
written again because importing the JAX package imports jax. Layouts:
flax Dense (in, out) -> Linear (out, in);
flax Conv (kh, kw, in, out) -> Conv2d (out, in, kh, kw), so a 1x1
pointwise (1, 1, C, inner) -> (inner, C, 1, 1); flax ConvTranspose with
transpose_kernel (kh, kw, out, in) -> ConvTranspose2d (in, out, kh, kw);
depthwise (3, 3, C) -> (C, 1, 3, 3); Eca1d's 1-D conv (k, 1, 1) -> Conv1d
(1, 1, k).

Orbax checkpoint directories (what the JAX package's trainer saves) do
not load here: `ORBAX_ROUTE` says how to turn one into a `.pth`.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from uformer_tpu_torch.ops.relpos import relative_position_index

StateDict = Dict[str, np.ndarray]
ORBAX_ROUTE = (
    "an orbax checkpoint directory does not load into the port; in the JAX "
    "environment, read it with uformer_tpu.train.checkpoints.load_params "
    "and write a reference .pth with "
    "uformer_tpu/convert/torch_exporter.py:save_torch_checkpoint "
    "(export_uformer's state_dict), then load that file")


def _linear(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _conv(sd: StateDict, prefix: str, p) -> None:
    # Conv (kh, kw, in, out) and transposed (kh, kw, out, in) both map by
    # the same axis order to torch's (out, in, .) / (in, out, .)
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
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


def _eca(sd: StateDict, prefix: str, p) -> None:
    # Eca1d's conv: HIO (k, 1, 1) -> Conv1d (out, in, k) (torch_converter.py
    # :82-84)
    sd[f"{prefix}.conv.weight"] = np.asarray(p["conv"]).transpose(2, 1, 0)


def _leff(sd: StateDict, prefix: str, m) -> None:
    sd[f"{prefix}.linear1.0.weight"] = np.asarray(m["linear1_kernel"]).T
    sd[f"{prefix}.linear1.0.bias"] = np.asarray(m["linear1_bias"])
    sd[f"{prefix}.linear2.0.weight"] = np.asarray(m["linear2_kernel"]).T
    sd[f"{prefix}.linear2.0.bias"] = np.asarray(m["linear2_bias"])
    _depthwise(sd, f"{prefix}.dwconv.0", m["dwconv_kernel"],
               m["dwconv_bias"])
    if "eca" in m:
        _eca(sd, f"{prefix}.eca", m["eca"])


def _block(sd: StateDict, prefix: str, p) -> None:
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
    _leff(sd, f"{prefix}.mlp", m)


def _unet(p) -> StateDict:
    """The inverse of `torch_converter.py:convert_unet`."""
    sd: StateDict = {}
    for name, sub in p.items():
        if name.startswith("ConvBlock"):
            _conv(sd, f"{name}.block.0", sub["conv1"])
            _conv(sd, f"{name}.block.2", sub["conv2"])
            _conv(sd, f"{name}.conv11", sub["conv11"])
        else:  # pool{i}, upv{i} (transposed), conv10
            _conv(sd, name, sub)
    return sd


def state_dict_from_jax(params: Dict[str, Any]) -> StateDict:
    """flax params of `uformer_tpu.models.Uformer` or `UNet` (arrays or
    numpy) -> state_dict of the port's model, reference names."""
    p = params.get("params", params)
    if "ConvBlock1" in p:
        return _unet(p)
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


def _sam(sd: StateDict, p) -> None:
    for name in ("conv1", "conv2", "conv3"):
        _conv(sd, name, p[name])


def _lpu(sd: StateDict, p) -> None:
    _depthwise(sd, "depthwise.0", p["kernel"], p["bias"])


def _poscnn(sd: StateDict, p) -> None:
    # HWIO (3, 3, 1, C), depthwise -> (C, 1, 3, 3); no bias, as in JAX
    sd["proj.0.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)


def _selayer(sd: StateDict, p) -> None:
    _linear(sd, "fc.0", p["fc1"])
    _linear(sd, "fc.2", p["fc2"])


BLOCKS = {
    "LeWinBlock": lambda sd, p: _block(sd, "", p),
    "LeFF": lambda sd, p: _leff(sd, "", p),
    "Eca1d": lambda sd, p: _eca(sd, "", p),
    "EcaLayer": lambda sd, p: _eca(sd, "", p["eca"]),
    "SAM": _sam, "LPU": _lpu, "PosCNN": _poscnn, "SELayer": _selayer,
    "BlurPool2D": lambda sd, p: None, "BlurPool1D": lambda sd, p: None,
}


def block_state_dict_from_jax(block: str, params: Dict[str, Any]
                              ) -> StateDict:
    """The flax params of one JAX block (`uformer_tpu.models.layers.LeFF`,
    `LeWinBlock`, `Eca1d`, or a block of `uformer_tpu.models.extras`, named
    by its class) -> the state_dict of the port's block of that name."""
    sd: StateDict = {}
    BLOCKS[block](sd, params.get("params", params))
    return {k.lstrip("."): v for k, v in sd.items()}


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


def load_pth(path: str) -> StateDict:
    """A reference `.pth` checkpoint, `{'epoch', 'state_dict', 'optimizer'}`
    (reference train_denoise.py:207-210) or a bare state_dict, as numpy
    arrays under the reference key names, the DataParallel `module.`
    prefix stripped (a copy of
    `uformer_tpu/convert/torch_converter.py:load_state_dict`, which
    unpickles any object; this loads tensors and plain containers only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "numpy"):
            out[k] = v.detach().cpu().numpy()
    return out


def load_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load the reference `.pth` at `path` into `model`: the port keeps the
    reference's key names, so nothing is remapped."""
    return load_numpy_state_dict(model, load_pth(path))
