"""ctypes binding of the native (C++) data plane, counterpart of
`uformer_tpu/data/native.py`.

The library is `native/augment.cpp`: crop + dihedral + uint8 -> float32
normalisation, fused and threaded over a batch. At first use it is built
with `native/build.sh`'s g++ flags into `uformer_tpu_torch/_build/`, under
a name that carries the hash of the source and flags; nothing is written
under `native/`, where the JAX package builds its own copy. Where no
toolchain builds it, `native_available()` is False and the datasets'
`native="auto"` takes the numpy plane, as in the JAX package.

The C++ normalises by multiplying by the float32 reciprocal of 255, where
the numpy plane divides by 255: the two agree within one float32 ulp
(126 of the 256 byte values round differently), and the crop and dihedral
are the same.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "augment.cpp"
BUILD_DIR = _PKG / "_build"
# native/build.sh's flags
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_U8PP = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.c_int32


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libuformer_augment_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/augment.cpp unless the library for this source and
    these flags exists; a temporary name and a rename keep other
    processes from reading a half-written file."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{so.name}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.augment_pair_batch.argtypes = [
        _U8PP, _U8PP, _I32P, _I32P, _I32, _I32, _I32, _I32P, _I32P, _I32P,
        _F32P, _F32P, _I32]
    lib.augment_pair_batch.restype = None
    _LIB = lib
    return _LIB


def native_available() -> bool:
    """True where the library builds and loads (the datasets'
    native="auto")."""
    return _load() is not None


def augment_pair_batch(gt_imgs: Sequence[np.ndarray],
                       noisy_imgs: Sequence[np.ndarray],
                       ps: int, rows: np.ndarray, cols: np.ndarray,
                       ks: np.ndarray, num_threads: int = 4
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Fused crop + dihedral + normalise over a batch of uint8 HWC pairs:
    pair i is cropped at (rows[i], cols[i]) to ps x ps and takes dihedral
    op ks[i]. Returns float32 (B, ps, ps, C) gt and noisy batches in
    [0, 1]."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native data plane did not build "
                           f"(g++ {' '.join(GXX_FLAGS)} {SOURCE})")
    B = len(gt_imgs)
    gts = [np.ascontiguousarray(g, np.uint8) for g in gt_imgs]
    nys = [np.ascontiguousarray(n, np.uint8) for n in noisy_imgs]
    C = gts[0].shape[2]
    rows, cols, ks = (np.ascontiguousarray(a, np.int32)
                      for a in (rows, cols, ks))
    if not len(nys) == len(rows) == len(cols) == len(ks) == B:
        raise ValueError("one crop and one op per pair")
    for i, (g, n) in enumerate(zip(gts, nys)):
        H, W = g.shape[:2]
        if n.shape != g.shape or g.ndim != 3 or g.shape[2] != C:
            raise ValueError(f"pair {i}: gt {g.shape}, noisy {n.shape}")
        if not (0 <= rows[i] <= H - ps and 0 <= cols[i] <= W - ps
                and 0 <= ks[i] < 8):
            raise ValueError(f"pair {i}: crop ({rows[i]}, {cols[i]}) op "
                             f"{ks[i]} outside a {H} x {W} image at ps {ps}")
    ptrs = ctypes.POINTER(ctypes.c_uint8) * B
    gt_ptrs = ptrs(*[g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                     for g in gts])
    ny_ptrs = ptrs(*[n.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                     for n in nys])
    heights = np.asarray([g.shape[0] for g in gts], np.int32)
    widths = np.asarray([g.shape[1] for g in gts], np.int32)
    gt_out = np.empty((B, ps, ps, C), np.float32)
    ny_out = np.empty((B, ps, ps, C), np.float32)
    lib.augment_pair_batch(
        gt_ptrs, ny_ptrs, heights.ctypes.data_as(_I32P),
        widths.ctypes.data_as(_I32P), C, B, ps,
        rows.ctypes.data_as(_I32P), cols.ctypes.data_as(_I32P),
        ks.ctypes.data_as(_I32P), gt_out.ctypes.data_as(_F32P),
        ny_out.ctypes.data_as(_F32P), num_threads)
    return gt_out, ny_out
