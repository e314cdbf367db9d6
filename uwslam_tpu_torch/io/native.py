"""ctypes binding of the repository's native image decoder.

Counterpart of `uwslam_tpu.io.native` (`available`, `decode`,
`NativeLoader`): the same `native/libuwslam_native.so` (built from
`native/loader.cpp` with `make -C native`; PNG through libpng16, JPEG
through libjpeg, PGM). The
library is looked up beside the repository's `native/` directory and
loaded at the first decode, never at import; where it is missing or its
shared libraries are not installed, `available()` is False and
`io.dataset` decodes another way.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libuwslam_native.so"
MAX_PIXELS = 4096 * 4096


@functools.cache
def _load() -> ctypes.CDLL | None:
    if not LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:          # e.g. libpng16 or libjpeg not installed
        return None
    lib.uws_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.uws_decode.restype = ctypes.c_int
    lib.uws_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.uws_loader_create.restype = ctypes.c_void_p
    lib.uws_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.uws_loader_next.restype = ctypes.c_int
    lib.uws_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.uws_loader_destroy.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def decode(path: str) -> np.ndarray:
    """Decode one image to (H, W) float32 gray; raises IOError on failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder not loadable: {LIB_PATH}")
    buf = np.empty(MAX_PIXELS, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.uws_decode(
        str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        MAX_PIXELS, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class NativeLoader:
    """In-order, multithreaded, prefetching decoder over `paths`: iterating
    yields (index, (H, W) float32 gray image) in the order of `paths`, while
    `threads` workers decode up to `lookahead` frames ahead. `close()` (or
    the end of the object) stops the workers."""

    def __init__(self, paths: list[str], lookahead: int = 8, threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native decoder not loadable: {LIB_PATH}")
        self._lib = lib
        self._paths = [str(p).encode() for p in paths]
        names = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.uws_loader_create(names, len(self._paths), lookahead, threads)
        self._buf = np.empty(MAX_PIXELS, np.float32)

    def __iter__(self):
        idx, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        while True:
            rc = self._lib.uws_loader_next(
                self._handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                MAX_PIXELS, ctypes.byref(idx), ctypes.byref(w), ctypes.byref(h),
            )
            if rc == 1:          # every frame delivered
                return
            if rc < 0:
                raise IOError(f"native loader error {rc} at frame {idx.value}")
            yield idx.value, self._buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self) -> None:
        if self._handle:
            self._lib.uws_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
