"""The port's gRPC links: the radar classification endpoint
(radar_server.py) and the camera detection server's client and an
in-process fake of it (client.py, fake_server.py), which ground-truth
capture uses. Importing this package imports grpc and protobuf; nothing
else of the port does (apps/serve.py and apps/ground_truth_samples.py
import it only where they use it)."""

from radarml_tpu_torch.rpc.client import (
    SERVICE_NAME,
    BBox,
    CameraInfo,
    Centroid,
    Detection,
    DetectionClient,
    DetectionServerError,
)
from radarml_tpu_torch.rpc.fake_server import DEFAULT_CAMERA, FakeDetectionServer
from radarml_tpu_torch.rpc.radar_server import (
    RadarServingClient,
    RadarServingError,
    RadarServingServer,
)

__all__ = [
    "BBox",
    "CameraInfo",
    "Centroid",
    "DEFAULT_CAMERA",
    "Detection",
    "DetectionClient",
    "DetectionServerError",
    "FakeDetectionServer",
    "RadarServingClient",
    "RadarServingError",
    "RadarServingServer",
    "SERVICE_NAME",
]
