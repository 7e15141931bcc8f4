"""Build the port's CUDA kernels into one shared library and load it.

One ``nvcc`` call compiles every ``csrc/*.cu`` for Hopper (``sm_90a``)
into ``dsac_tpu_torch/_build/libdsac_kernels_<hash>.so``; the hash covers
the sources, so an edit rebuilds.  The library has a plain C interface
(each launcher takes device pointers, sizes, scalars and the stream, and
returns ``cudaGetLastError()``) and is loaded with ``ctypes``: no PyTorch
headers are compiled, which keeps the build to seconds.

Nothing is built when this module is imported; the first kernel launch
builds (or finds) the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# launcher name -> argument types (pointers and the stream are c_void_p)
SIGNATURES = {
    "dsac_p3p_solve": [_P, _P, _I, _F, _F, _F, _P, _P, _P, _P, _P],
    "dsac_soft_inlier_scores": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                                _F, _F, _P, _P],
    "dsac_refine_pose": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                         _F, _F, _F, _P, _P, _P, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdsac_kernels_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def build() -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent
    compiling, 0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call a launcher; raise on a non-zero CUDA error code."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, x: torch.Tensor, shape: tuple,
          device: torch.device) -> None:
    """Raise unless x is a contiguous float32 tensor of `shape` on
    `device` (None in `shape` matches any size)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
    if x.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, x.shape)):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
