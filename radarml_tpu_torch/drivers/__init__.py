from radarml_tpu_torch.drivers.base import (
    DEFAULT_THRESHOLD,
    DriverState,
    RadarDriver,
    RadarSession,
    RadarTarget,
    StateError,
    Status,
    calibrate,
)
from radarml_tpu_torch.drivers.synthetic import ReplayRadar, SyntheticRadar
from radarml_tpu_torch.drivers.walabot import WalabotRadar, walabot_available
from radarml_tpu_torch.drivers.native import (
    NativeRadar,
    NativeScanSource,
    build_library,
)

__all__ = [
    "DEFAULT_THRESHOLD",
    "DriverState",
    "RadarDriver",
    "RadarSession",
    "RadarTarget",
    "StateError",
    "Status",
    "calibrate",
    "ReplayRadar",
    "SyntheticRadar",
    "WalabotRadar",
    "walabot_available",
    "NativeRadar",
    "NativeScanSource",
    "build_library",
]
