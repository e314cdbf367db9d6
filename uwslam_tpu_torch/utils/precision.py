"""Float32 precision for geometry math.

Counterpart of `uwslam_tpu.utils.precision`, which pins HIGHEST precision
because the TPU's default matmul rounds to bf16. On an NVIDIA card the
equivalent silent drop is TF32: `torch.backends.cuda.matmul.allow_tf32`
defaults to off, but `torch.backends.cudnn.allow_tf32` defaults to ON and
would round any f32 convolution to ~3 decimal digits. With both off,
`torch.matmul` and `torch.einsum` are full f32, so the port calls them
directly. The tracking package calls `disable_tf32()` when imported.
"""
from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Keep every f32 matmul and convolution in full f32 on CUDA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
