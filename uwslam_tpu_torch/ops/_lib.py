"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

All sources under `uwslam_tpu_torch/csrc/` go through ONE nvcc call (which
compiles them in parallel, `--threads 0`) into a shared library with a plain
C interface (no PyTorch headers, so the build takes seconds, not minutes).
The library lands in `uwslam_tpu_torch/_build/` (listed in .gitignore), or,
where the package directory cannot be written (a read-only install), in a
per-user cache directory (`$XDG_CACHE_HOME/uwslam_tpu_torch`, else
`~/.cache/uwslam_tpu_torch`), under a name that hashes the sources and
flags, so an edited source is rebuilt and an unchanged one is reused. Nothing is built or
loaded at import: the first kernel launch builds. The build needs the CUDA
toolkit and no network.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` calls one on the current stream of a tensor's
device and raises if that is not 0. Argument types are set once, when the
library is loaded.
"""
from __future__ import annotations

import contextlib
import contextvars
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
BUILD_DIR = _PKG / "_build"          # the build directory of a writable install
SOURCES = ("pyramid.cu", "warp_sample.cu", "lm_evaluate.cu", "stamp.cu")
HEADERS = ("sampling.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v", "--threads", "0",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # img, out_img, gx, gy, gm, B, H, W, levels, tile, stream
    "uws_pyramid": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # img, p3d, T, out, valid, B, C, H, W, N, fx, fy, cx, cy, texels, stream
    "uws_warp_sample": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _I, _P),
    # img, uv, out, valid, B, C, H, W, N, texels, stream
    "uws_bilinear_sample": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # img, p3d, T, ab, ref_int, pts_valid, J_ref, sigma, out, B, H, W, N,
    # ref_stride, fx, fy, cx, cy, fc, affine, kind, threads, blocks, stream
    "uws_lm_evaluate": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _I, _I, _I, _I, _I, _P),
    # clock, ms (or NULL), slot, stream
    "uws_stamp": (_P, _P, _I, _P),
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


def _writable(path: Path) -> bool:
    return os.access(path, os.W_OK | os.X_OK)


def build_dir() -> Path:
    """`BUILD_DIR` where it (or, before the first build, the package
    directory) can be written; else the per-user cache directory."""
    if _writable(BUILD_DIR if BUILD_DIR.exists() else _PKG):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "uwslam_tpu_torch"


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return build_dir() / f"libuwslam_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the kernels unless this exact build exists.

    Returns (library path, seconds spent compiling, compiler output: the
    per-kernel register and shared-memory report of `-Xptxas -v`)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
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


_RANGES = contextvars.ContextVar("uwslam_launch_ranges", default=False)


@contextlib.contextmanager
def launch_ranges():
    """Within the block every launch runs inside a `torch.profiler`
    `record_function` range named after its C entry point (`uws_...`). A
    ctypes call is no operator: without the range the profiler links the
    kernel to none, with it the kernel belongs to the range, which lies in
    the wrapper's Python call (`attribute_trace` reads both). Off by default: a range
    costs microseconds of host time per launch even with no profiler on,
    and the profiler also records it on the device as an annotation that
    spans the kernel, which a sum of all device events would count twice."""
    token = _RANGES.set(True)
    try:
        yield
    finally:
        _RANGES.reset(token)


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point `name` with `args` and, last, the current
    stream of `device`; raise if the launch was refused. The device guard is
    entered only when `device` is not already the current one.

    Inside `launch_ranges()` the call runs in a `record_function` range
    named `name`."""
    fn = getattr(library(), name)
    with torch.profiler.record_function(name) if _RANGES.get() else contextlib.nullcontext():
        if torch.cuda.current_device() == device.index:
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        else:
            with torch.cuda.device(device):
                err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = library().uws_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def require(
    t: torch.Tensor, name: str, shape: tuple, device: torch.device,
    dtype=torch.float32, rows: bool = False,
):
    """Validate a kernel argument: on `device` (a CUDA device), dtype,
    shape (None = any size), contiguous; with rows=True a 2-D tensor needs
    only contiguous rows (the kernel is given their stride)."""
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
    if rows and t.stride(1) == 1 and t.stride(0) >= t.shape[1]:
        return
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
