"""Front ends that are whole odometers by themselves, and the pipeline
presets of `uwslam_tpu.models`: one `SlamConfig` per README configuration
family, each taking the config's other fields as overrides."""
from ..config import BAConfig, FeatureConfig, KeyframeConfig, SlamConfig, TrackerConfig
from .feature_vo import FeatureVO, FeatureVOState


def direct_odometry_config(**overrides) -> SlamConfig:
    """README config 1: direct tracking, no features, no BA."""
    return SlamConfig(**overrides)


def feature_slam_config(**overrides) -> SlamConfig:
    """README config 2: feature detection and patch matching, keyframes."""
    return SlamConfig(use_features=True, **overrides)


def windowed_ba_config(**overrides) -> SlamConfig:
    """README config 4: sliding-window Schur BA on the keyframes."""
    return SlamConfig(use_features=True, use_ba=True, **overrides)


def full_slam_config(**overrides) -> SlamConfig:
    """Everything on: features, window BA, relocalization, loop closure."""
    return SlamConfig(use_features=True, use_ba=True, use_reloc=True,
                      use_loop_closure=True, **overrides)


__all__ = [
    "BAConfig",
    "FeatureConfig",
    "FeatureVO",
    "FeatureVOState",
    "KeyframeConfig",
    "SlamConfig",
    "TrackerConfig",
    "direct_odometry_config",
    "feature_slam_config",
    "full_slam_config",
    "windowed_ba_config",
]
