"""Build the port's CUDA kernels into one shared library and load it.

One ``nvcc`` call compiles every ``csrc/*.cu`` for Hopper (``sm_90a``)
into ``dsac_tpu_torch/_build/libdsac_kernels_<hash>.so``; the hash covers
the sources and the headers they include (``csrc/*.cuh``), so an edit
rebuilds.  ptxas's report (registers, shared memory, spills per kernel)
is kept beside the library (``ptxas_report``).  The library has a plain C
interface (each launcher takes device pointers, sizes, scalars and the
stream, and returns a CUDA error code) and is loaded with ``ctypes``: no
PyTorch headers are compiled, which keeps the build to seconds.

Nothing is built when this module is imported; the first kernel launch
builds (or finds) the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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
    "dsac_p3p_solve": [_P, _P, _I, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P],
    "dsac_soft_inlier_scores": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _F, _F, _F, _F, _F, _F, _P, _P],
    "dsac_refine_pose": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                         _F, _F, _F, _I, _I, _I, _P, _P, _P, _P],
    "dsac_diffmaps": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                      _F, _P, _P],
    "dsac_irls_stats": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                        _I, _I, _I, _P, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
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
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
           str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_NUMBERS = {
    "stack_bytes": re.compile(r"(\d+) bytes stack frame"),
    "spill_store_bytes": re.compile(r"(\d+) bytes spill stores"),
    "spill_load_bytes": re.compile(r"(\d+) bytes spill loads"),
    "registers": re.compile(r"Used (\d+) registers"),
    "static_smem_bytes": re.compile(r"(\d+) bytes smem"),
}


def kernel_name(mangled: str) -> str:
    """``refine_kernel``, ``p3p_kernel<4>`` or ``irls_stats_kernel<true>``
    of a mangled kernel name."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while m := re.match(r"\d+", mangled[pos:]):  # <length><identifier>
        pos += m.end() + int(m.group())
        name = mangled[pos - int(m.group()):pos]
        if name.endswith("_kernel"):
            arg = re.match(r"IL([ib])(\d+)E", mangled[pos:])
            if arg is None:
                return name
            value = (arg.group(2) if arg.group(1) == "i"
                     else ("false", "true")[int(arg.group(2))])
            return f"{name}<{value}>"
    return mangled


def ptxas_report(library: Path) -> dict[str, dict[str, int]]:
    """Per kernel of a library that ``build`` made: registers a thread,
    static shared memory, stack frame and spill bytes, as ``nvcc -Xptxas
    -v`` reported them."""
    report: dict[str, dict[str, int]] = {}
    kernel = None
    for line in library.with_suffix(".ptxas.txt").read_text().splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            kernel = kernel_name(m.group(1))
            report[kernel] = {}
            continue
        if kernel is None:
            continue
        for key, pattern in _PTXAS_NUMBERS.items():
            m = pattern.search(line)
            if m:
                report[kernel][key] = int(m.group(1))
    return report


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


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(name: str, device: torch.device, *args) -> None:
    """Call a launcher on ``device``, the device of its tensors, and on
    that device's current stream (appended as the last argument); raise on
    a non-zero CUDA error code.  The launcher runs with ``device`` current,
    whichever device the calling thread had current."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


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


def check_poses(R: torch.Tensor, t: torch.Tensor, coords: torch.Tensor,
                pix: torch.Tensor) -> tuple[int, int, int, torch.device]:
    """(B, P, N, device) of poses R (B, P, 3, 3), t (B, P, 3) against
    coords (B, N, 3) at pixels pix (B, N, 2), the inputs of the score,
    diff-map, refine and IRLS-stats kernels; raises on anything else."""
    B, P = t.shape[:2]
    N = coords.shape[1]
    dev = t.device
    check("R", R, (B, P, 3, 3), dev)
    check("t", t, (B, P, 3), dev)
    check("coords", coords, (B, N, 3), dev)
    check("pix", pix, (B, N, 2), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu, not {dev}")
    return B, P, N, dev
