from radarml_tpu_torch.serving.export import (
    ServingArtifact,
    export_predictor,
    load_serving_artifact,
)
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
    "ServingArtifact",
    "StreamConfig",
    "StreamingClassifier",
    "driver_scan_source",
    "export_predictor",
    "load_serving_artifact",
    "native_scan_source",
]
