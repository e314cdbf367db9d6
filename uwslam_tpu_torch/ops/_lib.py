"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All sources under `uwslam_tpu_torch/csrc/` go through ONE nvcc call into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds, not minutes). The library lands in `uwslam_tpu_torch/_build/`
(listed in .gitignore) under a name that hashes the sources and flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing is built or
loaded at import: the first kernel launch builds. The build needs the CUDA
toolkit and no network.

Every C entry point launches on the stream it is given, returns
`cudaGetLastError()`, and `check` raises if that is not 0.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("scharr.cu", "warp_sample.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # img, gx, gy, gm, B, H, W, stream
    "uws_scharr": (_P, _P, _P, _P, _I, _I, _I, _P),
    # img, p3d, T, out, valid, B, C, H, W, N, fx, fy, cx, cy, stream
    "uws_warp_sample": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _P),
    # img, uv, out, valid, B, C, H, W, N, stream
    "uws_bilinear_sample": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's kernels need the CUDA toolkit"
        )
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libuwslam_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the kernels unless this exact build exists.

    Returns (library path, seconds spent compiling, compiler output: the
    per-kernel register and shared-memory report of `-Xptxas -v`)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.uws_error_string.argtypes = (_I,)
    lib.uws_error_string.restype = ctypes.c_char_p
    return lib


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of the tensor's device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, kernel: str) -> None:
    if err != 0:
        msg = library().uws_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def require(
    t: torch.Tensor, name: str, shape: tuple, device: torch.device,
    dtype=torch.float32,
):
    """Validate a kernel argument: on `device` (a CUDA device), dtype,
    shape (None = any size), contiguous."""
    if device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA or CPU tensors, got {device}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
