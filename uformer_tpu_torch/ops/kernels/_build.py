"""Build and load the CUDA kernels of `uformer_tpu_torch/csrc/`.

`nvcc` compiles every `csrc/*.cu` for `sm_90a`, one process per source,
all started together, and links the objects into one shared library with
a plain C interface, which `ctypes` loads; no PyTorch header is compiled,
so a build takes seconds to a minute. The library lands in
`uformer_tpu_torch/_build/` under a name that carries the hash of the
sources and flags, so an edited source rebuilds on next use. Nothing is
built when this module is imported: `load()` builds at first use.

Every C entry returns a `cudaError_t`; `_launch.check()` raises when it is
not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "uf_attention_needs_scratch": [_I, _I, _I],
    "uf_attention_image": [_I] + [_P] * 13 + [_I] * 6 + [_F] + [_I] * 4
                          + [_P],
    "uf_attention_image_slots": [_I] * 4,
    "uf_attention_block": [_I] + [_P] * 13 + [_I] * 8 + [_F] + [_I] * 3
                          + [_P],
    "uf_attention_block_slots": [_I] * 5,
    "uf_window_attention": [_I] + [_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
    "uf_window_attention_slots": [_I] * 3,
    "uf_leff_tile_rows": [_I, _I, _I],
    "uf_leff": [_I] + [_P] * 10 + [_I] * 7 + [_P],
    "uf_stage": [_I] + [_P] * 24 + [_I] * 8 + [_F, _P],
    "uf_attention_bwd_scratch": [_I, _I, _I],
    "uf_attention_bwd": [_I] + [_P] * 21 + [_I] * 6 + [_F] + [_I] * 4
                        + [_P],
    "uf_attention_block_bwd": [_I] + [_P] * 21 + [_I] * 7 + [_F] + [_I] * 3
                              + [_P],
    "uf_leff_bwd_tile_rows": [_I, _I, _I],
    "uf_leff_bwd": [_I, _I] + [_P] * 17 + [_I] * 8 + [_P],
    "uf_leff_dln_b": [_I] + [_P] * 3 + [_I] * 2 + [_P],
    "uf_wgrad": [_I, _P, _I, _P, _I] + [_P] * 4 + [_I] * 4 + [_P],
    "uf_colsum": [_I, _P, _I, _P, _P, _I, _I, _I, _P],
    "uf_dwconv3x3": [_I, _I] + [_P] * 4 + [_I] * 12 + [_P],
    "uf_dwconv3x3_slots": [_I] * 5,
    "uf_mma_check": [_P, _P, _P, _I, _I, _I, _I, _P],
    "uf_tf32_check": [_P, _P, _P, _I, _I, _I, _P],
    "uf_wide_xm": [_I] + [_P] * 5 + [_I] * 4 + [_P],
    "uf_wide_gemm": [_I] * 3 + [_P] * 3 + [_I] + [_P] * 3 + [_I] * 3
                    + [_P],
    "uf_wide_core": [_I] + [_P] * 3 + [_I] * 3 + [_P] * 2 + [_I] * 12
                    + [_F, _I, _I, _P],
    "uf_wide_core_bwd": [_P] * 7 + [_I] * 10 + [_F, _P],
    "uf_wide_core_bwd_mma": [_P] * 7 + [_I] * 10 + [_F, _I, _I, _P],
    "uf_wide_ln_bwd": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    "uf_error_string": [_I],
}

_lib = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libuformer_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source in parallel, then one link. build.log keeps every
    command and its output (the -Xptxas -v register report)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    cu, _ = _sources()
    stem = f"{so.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{f.stem}.o" for f in cu]
    jobs = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
            for f, o in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in jobs]
    tmp = BUILD_DIR / f"{stem}.tmp"
    link = [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    log, failed = [], []
    for cmd, proc in zip(jobs, procs):
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr)
    for o in objs:
        o.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-6000:])
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = _I
        lib.uf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib

