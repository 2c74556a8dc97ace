from radarml_tpu_torch.serving.stream import (
    Detection,
    Scan,
    StreamConfig,
    StreamingClassifier,
)

__all__ = ["Detection", "Scan", "StreamConfig", "StreamingClassifier"]
