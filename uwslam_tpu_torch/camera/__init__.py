"""Pinhole camera model."""
from .model import PinholeCamera

__all__ = ["PinholeCamera"]
