"""The yardstick of the kernels: the card's peaks and the bytes each kernel
must move, counted from the shapes of its inputs and outputs (each read
once, each written once), whatever the kernel does to move them. A frozen
copy of the arithmetic of `uwslam_tpu_torch/micro.py` (`bound_pyramid`,
`bound_lm_evaluate`), so that the count stays what it is when the program
changes."""
from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"


def peak(kind: str) -> dict:
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])


def pyramid_bytes(height: int, width: int, levels: int, frames: int = 1) -> int:
    """Level 0 read once (f32); every level's gx, gy and |g| and the images
    of levels 1 .. levels-1 written once (f32)."""
    pix = [frames * (height >> lvl) * (width >> lvl) for lvl in range(levels)]
    return 4 * (pix[0] + 3 * sum(pix) + sum(pix[1:]))


def lm_evaluate_bytes(points: int, valid: int, fc: bool, affine: bool,
                      pairs: int = 1) -> int:
    """One evaluation: per point its 3D point (12 B) and validity byte; per
    valid point the reference intensity (4 B), the taps (FC 48 B of the
    texels' three channels, IC 16 B) and in IC the Jacobian row (24 B); per
    pair the pose (64 B), sigma (4 B) and the sums written (45 floats; with
    affine brightness the pair's (a, b), 8 B, and 75 floats)."""
    per_pair = 64 + 4 + (8 + 75 * 4 if affine else 45 * 4)
    return pairs * points * 13 + valid * (4 + (48 if fc else 16 + 24)) + pairs * per_pair
