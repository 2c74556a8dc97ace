"""The radar gRPC endpoint. Importing this package imports grpc and
protobuf; nothing else of the port does."""

from radarml_tpu_torch.rpc.radar_server import (
    RadarServingClient,
    RadarServingError,
    RadarServingServer,
)

__all__ = ["RadarServingClient", "RadarServingError", "RadarServingServer"]
