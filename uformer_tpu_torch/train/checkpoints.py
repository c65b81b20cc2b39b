"""Checkpoint save and restore, counterpart of
`uformer_tpu/train/checkpoints.py` (reference `utils/model_utils.py:18-54`
and the trainers' best/latest/epoch-N protocol, train_denoise.py:207-235).

The format is the reference's own `.pth`: `torch.save({"epoch",
"state_dict", "optimizer", "step"})` to `<model_dir>/<name>.pth`, the
state_dict under the reference key names, which the JAX package's
`load_params` reads too. `step` is the optimizer step count, saved as the
JAX package saves it, so that resume continues the MixUp gate and the LR
from the true position. Loads use `torch.load(weights_only=True)`: tensors
and plain containers only (the AdamW state_dict is such).

Divergence: the JAX package saves orbax directories, which do not load
here; `convert.ORBAX_ROUTE` says how to turn one into a `.pth` in the JAX
environment.
"""

from __future__ import annotations

import io
import os
import threading
from concurrent.futures import Future
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from uformer_tpu_torch.convert import ORBAX_ROUTE, StateDict, load_pth

_PENDING: Optional[Future] = None
_PENDING_LOCK = threading.Lock()


def checkpoint_path(model_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(model_dir, name + ".pth"))


def to_host(obj: Any) -> Any:
    """obj with every tensor copied to the CPU (nested dicts, lists and
    tuples kept), so that a later update on the card cannot change it.
    Card tensors go through pinned memory without a wait each; the host
    waits once, at the end."""
    on_card = []

    def copy(o):
        if isinstance(o, torch.Tensor):
            if o.device.type != "cuda":
                return o.detach().clone()
            out = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            out.copy_(o.detach(), non_blocking=True)
            on_card.append(o.device)
            return out
        if isinstance(o, Mapping):
            return {k: copy(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(copy(v) for v in o)
        return o

    out = copy(obj)
    for device in set(on_card):
        torch.cuda.current_stream(device).synchronize()
    return out


def _serialize(ckpt: Dict[str, Any]) -> io.BytesIO:
    """The checkpoint's `.pth` bytes. torch.save holds the interpreter
    lock while it serialises, so it runs on the caller's thread: on a
    writer thread it slowed the train loop's steps, whose launches need
    the lock."""
    buf = io.BytesIO()
    torch.save(ckpt, buf)
    return buf


def _write(path: str, buf: io.BytesIO) -> None:
    # a rename makes the new file appear whole: a resume never reads a
    # checkpoint cut off by a crash during the write
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getbuffer())
    os.replace(tmp, path)


def wait_for_saves() -> None:
    """Block until the save in flight (if any) is on disk; raise its
    error."""
    global _PENDING
    with _PENDING_LOCK:
        pending, _PENDING = _PENDING, None
    if pending is not None:
        pending.result()


def save_checkpoint(model_dir: str, name: str, epoch: int,
                    state_dict: Mapping[str, torch.Tensor],
                    optimizer: Optional[Mapping[str, Any]] = None,
                    step: Optional[int] = None,
                    async_save: bool = False) -> str:
    """Save {epoch, state_dict, optimizer, step} to <model_dir>/<name>.pth
    and return its path. `state_dict` is a model's state_dict, `optimizer`
    an optimizer's.

    The tensors are copied to the CPU and serialised here, on the
    caller's thread. With async_save=True the write to disk then runs on a
    thread and this returns; a save still in flight is waited for first,
    and `wait_for_saves` waits for this one (the loads here wait by
    themselves)."""
    global _PENDING
    path = checkpoint_path(model_dir, name)
    ckpt = {"epoch": int(epoch), "state_dict": to_host(state_dict),
            "optimizer": to_host(optimizer) if optimizer is not None
            else {}}
    if step is not None:
        ckpt["step"] = int(step)
    buf = _serialize(ckpt)
    del ckpt
    wait_for_saves()
    if not async_save:
        _write(path, buf)
        return path
    done: Future = Future()

    def run():
        try:
            _write(path, buf)
        except BaseException as exc:  # raised by wait_for_saves
            done.set_exception(exc)
        else:
            done.set_result(path)

    with _PENDING_LOCK:
        _PENDING = done
    threading.Thread(target=run, name=f"save {name}", daemon=False).start()
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's dict, its tensors on the CPU; waits for a save in
    flight first."""
    wait_for_saves()
    return torch.load(path, map_location="cpu", weights_only=True)


def load_start_epoch(path: str) -> int:
    """Reference load_start_epoch (model_utils.py:40-44)."""
    return int(load_checkpoint(path)["epoch"])


def load_params(path: str, arch: str = "Uformer_B") -> StateDict:
    """The weights of a reference `.pth` (the port's, or a released one,
    the DataParallel `module.` prefix stripped) as a numpy state_dict
    under the reference names (`convert.load_pth`); `arch` is accepted
    for the JAX package's signature. An orbax directory raises ValueError
    naming the route to a `.pth` (`convert.ORBAX_ROUTE`)."""
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: {ORBAX_ROUTE}")
    wait_for_saves()
    return load_pth(path)


def load_optim(path: str) -> Tuple[Dict[str, Any], int]:
    """(optimizer state_dict, epoch) for resume (reference load_optim,
    model_utils.py:47-54)."""
    ckpt = load_checkpoint(path)
    return ckpt.get("optimizer"), int(ckpt["epoch"])
