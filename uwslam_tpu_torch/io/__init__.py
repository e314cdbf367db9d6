"""Dataset readers, trajectory I/O and evaluation."""
from .dataset import (
    DeviceFramePrefetcher,
    FramePrefetcher,
    Sequence,
    list_images,
    open_directory,
    open_euroc,
    open_tum,
    read_pgm,
)
from .trajectory import (
    associate,
    ate_rmse,
    poses_from_euroc_rows,
    poses_from_tum_rows,
    read_groundtruth_euroc,
    read_groundtruth_tum,
    read_trajectory_tum,
    rpe,
    umeyama_alignment,
    write_trajectory_tum,
)

__all__ = [
    "DeviceFramePrefetcher",
    "FramePrefetcher",
    "Sequence",
    "associate",
    "ate_rmse",
    "list_images",
    "open_directory",
    "open_euroc",
    "open_tum",
    "poses_from_euroc_rows",
    "poses_from_tum_rows",
    "read_groundtruth_euroc",
    "read_groundtruth_tum",
    "read_pgm",
    "read_trajectory_tum",
    "rpe",
    "umeyama_alignment",
    "write_trajectory_tum",
]
