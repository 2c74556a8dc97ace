from radarml_tpu_torch.serving.reload import ModelReloader
from radarml_tpu_torch.serving.stream import (
    Detection,
    Scan,
    StreamConfig,
    StreamingClassifier,
    driver_scan_source,
    native_scan_source,
)

__all__ = [
    "Detection",
    "ModelReloader",
    "Scan",
    "StreamConfig",
    "StreamingClassifier",
    "driver_scan_source",
    "native_scan_source",
]
