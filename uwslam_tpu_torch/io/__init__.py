"""Trajectory evaluation."""
from .trajectory import ate_rmse, umeyama_alignment

__all__ = ["ate_rmse", "umeyama_alignment"]
