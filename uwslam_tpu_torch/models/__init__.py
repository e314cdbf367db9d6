"""Front ends that are whole odometers by themselves."""
from .feature_vo import FeatureVO, FeatureVOState

__all__ = ["FeatureVO", "FeatureVOState"]
