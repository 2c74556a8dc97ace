"""gRPC client for the camera detection server.

Port of radarml_tpu/rpc/client.py (it has no JAX in it, so this is a
copy against the port's copy of detection_server_pb2). Re-design of the
reference's stub wrappers (ground_truth_samples.py:
111-158) without generated service stubs: the three unary RPCs are
built directly on `grpc.Channel.unary_unary` against the preserved
wire contract (detection_server.proto), so the client stays
plugin-free while remaining byte-compatible with the real Coral-TPU
server.

Client-side semantics carried over: detections with an empty label are
flow-control sentinels the server emits when its stack is empty and
are dropped (reference ground_truth_samples.py:143-158); RPC errors
raise DetectionServerError instead of killing the process (the
reference exits, ground_truth_samples.py:117-120 — a library must not).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import grpc

from radarml_tpu_torch.rpc import detection_server_pb2 as pb

__all__ = [
    "Centroid",
    "BBox",
    "Detection",
    "CameraInfo",
    "DetectionServerError",
    "DetectionClient",
    "SERVICE_NAME",
]

SERVICE_NAME = "detection_server.DetectionServer"


class Centroid(NamedTuple):
    x: float
    y: float


class BBox(NamedTuple):
    xmin: float
    ymin: float
    xmax: float
    ymax: float


class Detection(NamedTuple):
    """Camera detection (normalized [0,1] centroid coords, as served)."""

    label: str
    score: float
    area: float
    centroid: Centroid
    bbox: Optional[BBox] = None


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class DetectionServerError(RuntimeError):
    def __init__(self, err: grpc.RpcError):
        super().__init__(f"{err.code().name}: {err.details()}")
        self.code = err.code()


class DetectionClient:
    """Camera RPC client over an insecure channel (the reference's
    transport, ground_truth_samples.py:317-318)."""

    def __init__(self, address: str, channel: Optional[grpc.Channel] = None):
        self.address = address
        self._channel = channel or grpc.insecure_channel(address)
        u = self._channel.unary_unary
        self._get_objects = u(
            f"/{SERVICE_NAME}/GetDetectedObjects",
            request_serializer=pb.DesiredLabels.SerializeToString,
            response_deserializer=pb.DetectedObjectData.FromString,
        )
        self._get_resolution = u(
            f"/{SERVICE_NAME}/GetCameraResolution",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.CameraResolution.FromString,
        )
        self._get_intrinsics = u(
            f"/{SERVICE_NAME}/GetCameraIntrinsicParameters",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.CameraIntrinsicParameters.FromString,
        )

    def close(self):
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- RPCs --------------------------------------------------------------
    def get_camera_info(self) -> CameraInfo:
        """Resolution + intrinsics in one call pair."""
        try:
            res = self._get_resolution(pb.Empty())
            intr = self._get_intrinsics(pb.Empty())
        except grpc.RpcError as err:
            raise DetectionServerError(err) from err
        return CameraInfo(
            width=res.width, height=res.height,
            fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
        )

    def get_detected_objects(
        self, desired_labels: Sequence[str]
    ) -> List[Detection]:
        try:
            resp = self._get_objects(pb.DesiredLabels(labels=desired_labels))
        except grpc.RpcError as err:
            raise DetectionServerError(err) from err
        out = []
        for obj in resp.data:
            if obj.label == "":
                continue  # flow-control sentinel
            out.append(
                Detection(
                    label=obj.label,
                    score=obj.score,
                    area=obj.area,
                    centroid=Centroid(obj.centroid.x, obj.centroid.y),
                    bbox=BBox(
                        obj.bbox.xmin, obj.bbox.ymin,
                        obj.bbox.xmax, obj.bbox.ymax,
                    ),
                )
            )
        return out
