"""Hand-written CUDA kernels of the tracking path, each beside its plain
PyTorch version. K1 `scharr_gradients_batched`, K2 `warp_and_sample`,
K3 `cuda_bilinear_sample`: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel (built from `csrc/` at first use). Each wrapper
counts its kernel launches in its `launches` attribute."""
from .cuda_pyramid import scharr_gradients_batched, scharr_plain
from .cuda_sample import bilinear_sample_plain, cuda_bilinear_sample
from .cuda_track import warp_and_sample, warp_and_sample_plain

__all__ = [
    "bilinear_sample_plain",
    "cuda_bilinear_sample",
    "scharr_gradients_batched",
    "scharr_plain",
    "warp_and_sample",
    "warp_and_sample_plain",
]
