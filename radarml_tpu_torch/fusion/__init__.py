from radarml_tpu_torch.fusion.camera import MountConfig, convert_coordinates, pair_distances
from radarml_tpu_torch.fusion.capture import (
    CaptureConfig,
    CapturedSample,
    associate,
    capture_samples,
)

__all__ = [
    "MountConfig",
    "convert_coordinates",
    "pair_distances",
    "CaptureConfig",
    "CapturedSample",
    "associate",
    "capture_samples",
]
