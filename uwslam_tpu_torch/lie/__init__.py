"""SO(3) and SE(3) in PyTorch."""
from . import se3, so3

__all__ = ["so3", "se3"]
