"""Radar driver protocol: the Walabot session state machine, typed.

The reference drives its sensor through the vendor's flat C API in a
fixed order — Init → SetSettingsFolder → ConnectAny → SetProfile →
SetArena{R,Phi,Theta} → SetThreshold → SetDynamicImageFilter → Start →
[calibrate] → Trigger/GetRawImage/GetSensorTargets loop → Stop →
Disconnect (reference predict.py:168-216, ground_truth_samples.py:
510-551). This module re-designs that as a small typed session
protocol every backend (synthetic, replay, native C++, real hardware)
implements, with the state machine enforced once here instead of by
call-site discipline.

Copy of radarml_tpu/drivers/base.py on the port's own arena.
"""

from __future__ import annotations

import abc
import dataclasses
import enum
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena

__all__ = [
    "RadarTarget",
    "DriverState",
    "Status",
    "RadarDriver",
    "RadarSession",
    "StateError",
    "calibrate",
    "DEFAULT_THRESHOLD",
]

DEFAULT_THRESHOLD = 5.0  # reference predict.py:203 SetThreshold(5)


class RadarTarget(NamedTuple):
    """Sensor target report in radar cartesian cm (GetSensorTargets)."""

    x: float
    y: float
    z: float
    amplitude: float


class DriverState(enum.Enum):
    CREATED = "created"
    CONNECTED = "connected"
    CONFIGURED = "configured"
    RUNNING = "running"
    STOPPED = "stopped"


class Status(enum.Enum):
    """Scan status (the subset the reference consults, common.py:82-91)."""

    CLEAN = 0
    CALIBRATING = 1


class StateError(RuntimeError):
    pass


@dataclasses.dataclass
class RadarDriver(abc.ABC):
    """Base driver: state machine + abstract sensor hooks.

    Subclasses implement the _do_* hooks; the public methods enforce
    legal ordering so misuse fails loudly instead of reading stale
    hardware state.
    """

    arena: Arena = DEFAULT_ARENA
    threshold: float = DEFAULT_THRESHOLD
    mti: bool = True
    state: DriverState = dataclasses.field(
        default=DriverState.CREATED, init=False
    )

    # -- session -----------------------------------------------------------
    def connect(self) -> None:
        self._expect(DriverState.CREATED)
        self._do_connect()
        self.state = DriverState.CONNECTED

    def configure(
        self,
        arena: Optional[Arena] = None,
        threshold: Optional[float] = None,
        mti: Optional[bool] = None,
    ) -> None:
        self._expect(DriverState.CONNECTED, DriverState.CONFIGURED)
        if arena is not None:
            self.arena = arena
        if threshold is not None:
            self.threshold = threshold
        if mti is not None:
            self.mti = mti
        self._do_configure()
        self.state = DriverState.CONFIGURED

    def start(self) -> None:
        self._expect(DriverState.CONFIGURED)
        self._do_start()
        self.state = DriverState.RUNNING

    def stop(self) -> None:
        self._expect(DriverState.RUNNING)
        self._do_stop()
        self.state = DriverState.STOPPED

    def disconnect(self) -> None:
        self._expect(
            DriverState.CONNECTED, DriverState.CONFIGURED,
            DriverState.RUNNING, DriverState.STOPPED,
        )
        if self.state == DriverState.RUNNING:
            self._do_stop()
        self._do_disconnect()
        self.state = DriverState.CREATED

    # -- scan loop ---------------------------------------------------------
    def trigger(self) -> None:
        self._expect(DriverState.RUNNING)
        self._do_trigger()

    def get_raw_image(self) -> np.ndarray:
        """(size_x, size_y, size_z) float32 cube in [0, 255]."""
        self._expect(DriverState.RUNNING)
        return self._do_get_raw_image()

    def get_sensor_targets(self) -> List[RadarTarget]:
        self._expect(DriverState.RUNNING)
        return self._do_get_sensor_targets()

    def get_status(self) -> Tuple[Status, float]:
        return Status.CLEAN, 0.0

    def get_version(self) -> str:
        return type(self).__name__

    # -- hooks -------------------------------------------------------------
    @abc.abstractmethod
    def _do_connect(self): ...

    @abc.abstractmethod
    def _do_configure(self): ...

    @abc.abstractmethod
    def _do_start(self): ...

    @abc.abstractmethod
    def _do_trigger(self): ...

    @abc.abstractmethod
    def _do_get_raw_image(self) -> np.ndarray: ...

    @abc.abstractmethod
    def _do_get_sensor_targets(self) -> List[RadarTarget]: ...

    def _do_stop(self):
        pass

    def _do_disconnect(self):
        pass

    def _expect(self, *states: DriverState):
        if self.state not in states:
            raise StateError(
                f"{type(self).__name__} in {self.state.value}, "
                f"needs {'/'.join(s.value for s in states)}"
            )


def calibrate(driver: RadarDriver, max_triggers: int = 100) -> int:
    """Trigger until the sensor reports clean status.

    Reference common.calibrate (common.py:82-91), used when the MTI
    dynamic filter is off (predict.py:211-213). Returns trigger count.
    """
    n = 0
    status, _ = driver.get_status()
    while status == Status.CALIBRATING and n < max_triggers:
        driver.trigger()
        n += 1
        status, _ = driver.get_status()
    return n


class RadarSession:
    """Context manager running the reference bootstrap order."""

    def __init__(
        self,
        driver: RadarDriver,
        arena: Optional[Arena] = None,
        threshold: Optional[float] = None,
        mti: Optional[bool] = None,
    ):
        self.driver = driver
        self._cfg = dict(arena=arena, threshold=threshold, mti=mti)

    def __enter__(self) -> RadarDriver:
        d = self.driver
        d.connect()
        d.configure(**self._cfg)
        d.start()
        if not d.mti:
            calibrate(d)
        return d

    def __exit__(self, *exc):
        d = self.driver
        if d.state == DriverState.RUNNING:
            d.stop()
        d.disconnect()
        return False
