"""Hand-written CUDA kernels of the tracking path, each beside its plain
PyTorch version. `cuda_build_pyramid` (K1 redesigned: every level of a frame
batch's pyramid in one launch; `scharr_gradients_batched` is the same
kernel at one level), K2 `warp_and_sample`, its
fused redesign `lm_evaluate` (one launch per LM evaluation), K3
`cuda_bilinear_sample`: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel (built from `csrc/` at first use). `lm_step` (one launch
per LM update after an evaluation, `ops.cuda_lm`) runs on a card only: its
plain version is `tracking.photometric.lm_step`. Each wrapper counts
its kernel launches in its `launches` attribute. K2 and K3 take the three
tracking channels as planes or as texels (`pack_texels`)."""
from .cuda_lm import LMLoop, lm_step, lm_step_init
from .cuda_pyramid import (
    cuda_build_pyramid,
    downsample2x,
    pyramid_plain,
    scharr_gradients_batched,
    scharr_plain,
)
from .cuda_sample import (
    bilinear_sample_plain,
    bilinear_sample_texels_plain,
    cuda_bilinear_sample,
    pack_texels,
    unpack_texels,
)
from .cuda_track import (
    LMEvaluator,
    WarpSampler,
    lm_evaluate,
    lm_evaluate_plain,
    warp_and_sample,
    warp_and_sample_plain,
)

__all__ = [
    "LMEvaluator",
    "LMLoop",
    "WarpSampler",
    "bilinear_sample_plain",
    "bilinear_sample_texels_plain",
    "cuda_bilinear_sample",
    "cuda_build_pyramid",
    "downsample2x",
    "lm_evaluate",
    "lm_evaluate_plain",
    "lm_step",
    "lm_step_init",
    "pack_texels",
    "pyramid_plain",
    "scharr_gradients_batched",
    "scharr_plain",
    "unpack_texels",
    "warp_and_sample",
    "warp_and_sample_plain",
]
