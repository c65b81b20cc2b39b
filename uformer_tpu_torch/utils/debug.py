"""Debugging guards and profiling, counterpart of
`uformer_tpu/utils/debug.py`.

- `enable_nan_checks`: a global module forward hook that raises
  FloatingPointError naming the first module whose output holds a NaN or
  an Inf (its path in the outermost module running, e.g.
  `encoderlayer_0.blocks.0.mlp`), and `torch.autograd.set_detect_anomaly`
  for the backward. Each check reads the card from the host: for
  debugging only. Off by default.
- `assert_finite`: raises FloatingPointError if any tensor of a nested
  dict, list or tuple holds a NaN or an Inf, with one host read.
- `profile` / `summarize_trace`: a `torch.profiler` trace (with the card's
  activity where there is a card) exported as a Chrome trace, and its
  device time per kernel family in ms.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Any, Dict, List

import torch
from torch import nn
from torch.utils._pytree import tree_leaves

_HOOKS: List[Any] = []
_STACK: List[nn.Module] = []  # the modules whose forward is running


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _all_finite(tensors: List[torch.Tensor]) -> bool:
    floats = [t for t in tensors if t.is_floating_point()]
    if not floats:
        return True
    return bool(torch.stack([torch.isfinite(t).all().to(floats[0].device)
                             for t in floats]).all())


def _path(stack: List[nn.Module]) -> str:
    """The dotted name of the innermost module under the outermost one."""
    names = []
    for parent, child in zip(stack, stack[1:]):
        # a descendant: a ModuleList between them runs no forward
        names.append(next((n for n, m in parent.named_modules()
                           if m is child), type(child).__name__))
    return ".".join(names) or type(stack[-1]).__name__


def _push(module, _inputs):
    _STACK.append(module)


def _check(module, _inputs, output):
    while _STACK and _STACK[-1] is not module:  # an earlier forward raised
        _STACK.pop()
    if not _all_finite(_tensors(output)):
        where = f"{_path(_STACK)} ({type(module).__name__})"
        _STACK.clear()
        raise FloatingPointError(f"non-finite values (NaN or Inf) in the "
                                 f"output of {where}")
    if _STACK:
        _STACK.pop()


def enable_nan_checks(enable: bool = True) -> None:
    """Turn the NaN/Inf checks on or off (module note); off removes the
    hooks."""
    while _HOOKS:
        _HOOKS.pop().remove()
    _STACK.clear()
    torch.autograd.set_detect_anomaly(enable)
    if enable:
        _HOOKS.append(nn.modules.module.register_module_forward_pre_hook(
            _push))
        _HOOKS.append(nn.modules.module.register_module_forward_hook(_check))


def assert_finite(tree, name: str = "tree"):
    """tree, after one host read that checks every tensor in it; raises
    FloatingPointError if any holds a NaN or an Inf."""
    if not _all_finite(_tensors(tree)):
        raise FloatingPointError(f"non-finite values in {name}")
    return tree


@contextlib.contextmanager
def profile(trace_dir: str = "uformer_trace"):
    """`with profile(dir) as prof: run(...)` traces the host and, where
    there is a card, the card; on exit the trace is written to
    dir/trace_<time>.json (Chrome format)."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{time.time_ns()}.json"))


# device events of a torch.profiler Chrome trace: kernels and copies;
# `gpu_user_annotation` spans (record_function ranges, ProfilerStep#N)
# cover whole programs and are skipped, as JAX skips its jit_ events
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _family(name: str) -> str:
    """A kernel's family: its name without `void`, template arguments,
    argument list and numeric suffix ("void uf::leff_kernel<128, 4>(Args)"
    -> "uf::leff_kernel")."""
    name = re.sub(r"^void\s+", "", name).replace("->", "")
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    return re.sub(r"[_.]?\d+$", "", "".join(out).strip())


def summarize_trace(trace_dir: str, top: int = 20,
                    instances: bool = False) -> Dict[str, float]:
    """Device time per kernel family in ms, largest first (`top` of them),
    from the newest Chrome trace in trace_dir (`profile`'s, or any
    `*.json` / `*.json.gz` torch.profiler trace); `instances=True` keeps
    each kernel's full name. {} without a trace or device events."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.json"))
                   + glob.glob(os.path.join(trace_dir, "*.json.gz")),
                   key=os.path.getmtime)
    if not paths:
        return {}
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    groups: Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = e.get("name", "")
        fam = name if instances else _family(name)
        if fam:
            groups[fam] += float(e.get("dur", 0)) / 1e3
    return dict(sorted(groups.items(), key=lambda kv: -kv[1])[:top])
