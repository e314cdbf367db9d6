"""Session checkpoints: a flat dict of arrays and scalars as one .npz file.

Counterpart of `uwslam_tpu.utils.checkpoint.save_session` / `load_session`,
with the same file format, so a session saved by either package loads in
the other. The file is written beside its destination and renamed over it,
so a reader never sees a partial file. The orbax variants of the JAX
package are not ported (they hold JAX device arrays).
"""
from __future__ import annotations

import os

import numpy as np


def save_session(path: str, state: dict) -> None:
    """Write `state` (name -> array or scalar) to `path`, with ".npz"
    appended when it is missing, atomically."""
    arrays = {k: np.asarray(v) for k, v in state.items()}
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def load_session(path: str) -> dict:
    """The arrays of a file written by `save_session` (".npz" optional)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}
