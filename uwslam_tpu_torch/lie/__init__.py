"""SO(3), SE(3) and Sim(3) in PyTorch."""
from . import se3, sim3, so3

__all__ = ["so3", "se3", "sim3"]
