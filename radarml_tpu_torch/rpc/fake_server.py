"""In-process fake DetectionServer for hardware-free capture loops.

Port of radarml_tpu/rpc/fake_server.py (a copy: it has no JAX in it).
The reference's ground-truth pipeline needs a live Coral-TPU camera
server on the network (README.md:29); CI has neither camera nor
network, so this serves the same proto from a scriptable in-process
gRPC server (SURVEY.md §4's fake-server seam). Detections are fed from
a user script: each GetDetectedObjects call pops the next scripted
frame (repeating the last one, or cycling, as configured), emitting the
empty-label flow-control sentinel when the script is drained — the
behavior the real server exhibits with an empty stack.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent import futures
from typing import List, Optional, Sequence

import grpc

from radarml_tpu_torch.rpc import detection_server_pb2 as pb
from radarml_tpu_torch.rpc.client import CameraInfo, Detection, SERVICE_NAME

__all__ = ["FakeDetectionServer", "DEFAULT_CAMERA"]

# A plausible 640x480 camera with square pixels (the proto carries
# whatever the real server was calibrated to).
DEFAULT_CAMERA = CameraInfo(
    width=640, height=480, fx=580.0, fy=580.0, cx=320.0, cy=240.0
)


def _to_pb(d: Detection) -> pb.DetectedObject:
    obj = pb.DetectedObject(label=d.label, score=d.score, area=d.area)
    obj.centroid.x = d.centroid[0]
    obj.centroid.y = d.centroid[1]
    if d.bbox is not None:
        obj.bbox.xmin, obj.bbox.ymin, obj.bbox.xmax, obj.bbox.ymax = d.bbox
    return obj


@dataclasses.dataclass
class FakeDetectionServer:
    """Scriptable fake camera server.

    script: list of detection frames; each GetDetectedObjects pops one.
    cycle=False repeats the final frame forever; drained+sentinel=True
    answers with the empty-label sentinel instead. A *callable* script
    is invoked per request with the desired labels — the hook that lets
    a synthetic radar driver feed "camera" detections of its own
    planted targets through the real gRPC loopback.
    """

    camera: CameraInfo = DEFAULT_CAMERA
    script: object = ()
    cycle: bool = False
    sentinel_when_drained: bool = True

    def __post_init__(self):
        self._lock = threading.Lock()
        self._pos = 0
        self._server: Optional[grpc.Server] = None
        self.port: Optional[int] = None
        self.calls = 0

    # -- scripted behavior -------------------------------------------------
    def _next_frame(self, desired: Sequence[str]) -> List[Detection]:
        if callable(self.script):
            with self._lock:
                self.calls += 1
            frame = self.script(desired)
            if desired:
                frame = [
                    d for d in frame if d.label in desired or d.label == ""
                ]
            return frame
        with self._lock:
            self.calls += 1
            script = list(self.script)
            if not script:
                return []
            if self._pos >= len(script):
                if self.cycle:
                    self._pos = 0
                elif self.sentinel_when_drained:
                    return [
                        Detection("", 0.0, 0.0, (0.0, 0.0))
                    ]  # flow-control sentinel
                else:
                    return script[-1]
            frame = script[self._pos]
            self._pos += 1
        if desired:
            frame = [d for d in frame if d.label in desired or d.label == ""]
        return frame

    # -- grpc plumbing -----------------------------------------------------
    def _handlers(self):
        def get_objects(request, context):
            frame = self._next_frame(list(request.labels))
            return pb.DetectedObjectData(data=[_to_pb(d) for d in frame])

        def get_resolution(request, context):
            return pb.CameraResolution(
                width=self.camera.width, height=self.camera.height
            )

        def get_intrinsics(request, context):
            return pb.CameraIntrinsicParameters(
                fx=self.camera.fx, fy=self.camera.fy,
                cx=self.camera.cx, cy=self.camera.cy,
            )

        rpcs = {
            "GetDetectedObjects": grpc.unary_unary_rpc_method_handler(
                get_objects,
                request_deserializer=pb.DesiredLabels.FromString,
                response_serializer=pb.DetectedObjectData.SerializeToString,
            ),
            "GetCameraResolution": grpc.unary_unary_rpc_method_handler(
                get_resolution,
                request_deserializer=pb.Empty.FromString,
                response_serializer=pb.CameraResolution.SerializeToString,
            ),
            "GetCameraIntrinsicParameters": grpc.unary_unary_rpc_method_handler(
                get_intrinsics,
                request_deserializer=pb.Empty.FromString,
                response_serializer=(
                    pb.CameraIntrinsicParameters.SerializeToString
                ),
            ),
        }
        return grpc.method_handlers_generic_handler(SERVICE_NAME, rpcs)

    def start(self, port: int = 0) -> str:
        """Start serving on localhost; returns the address to dial."""
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((self._handlers(),))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")
        self._server.start()
        return f"127.0.0.1:{self.port}"

    def stop(self, grace: float = 0.2):
        if self._server:
            self._server.stop(grace)
            self._server = None

    def __enter__(self) -> str:
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
