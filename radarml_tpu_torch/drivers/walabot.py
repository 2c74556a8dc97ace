"""Real-hardware backend over the Vayyar Walabot SDK (optional).

Thin adapter mapping the RadarDriver session protocol onto the vendor
`WalabotAPI` Python package the reference uses directly
(reference predict.py:168-216, ground_truth_samples.py:510-551). The
SDK (and the radar it drives) is absent in CI, so the import is
deferred to connect time and `walabot_available()` gates call sites.
Everything above the driver boundary — capture, fusion, predict — is
identical between this backend and the synthetic/replay/native ones.

Copy of radarml_tpu/drivers/walabot.py.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np

from radarml_tpu_torch.drivers.base import RadarDriver, RadarTarget, Status

logger = logging.getLogger(__name__)

__all__ = ["WalabotRadar", "walabot_available"]


def _import_api():
    import WalabotAPI  # vendor package, requirements.txt:73 in reference

    WalabotAPI.Init()
    return WalabotAPI


def walabot_available() -> bool:
    try:
        _import_api()
        return True
    except Exception:
        return False


@dataclasses.dataclass
class WalabotRadar(RadarDriver):
    """Session driver for the physical sensor.

    The reference's bootstrap order is preserved exactly: Init →
    SetSettingsFolder → ConnectAny → SetProfile(sensor) →
    SetArena{R,Phi,Theta} → SetThreshold → SetDynamicImageFilter(MTI) →
    Start; Stop/Disconnect/Clean on teardown.
    """

    settings_folder: Optional[str] = None

    def __post_init__(self):
        self._api = None
        self._cube: Optional[np.ndarray] = None

    def _do_connect(self):
        api = _import_api()
        api.SetSettingsFolder(
            *( [self.settings_folder] if self.settings_folder else [] )
        )
        try:
            api.ConnectAny()
        except api.WalabotError as err:
            logger.error("Failed to connect to Walabot: %s", err)
            raise
        self._api = api
        logger.info("Walabot API version: %s", api.GetVersion())

    def _do_configure(self):
        api = self._api
        a = self.arena
        api.SetProfile(api.PROF_SENSOR)
        api.SetArenaR(a.r_min, a.r_max, a.r_res)
        api.SetArenaPhi(a.phi_min, a.phi_max, a.phi_res)
        api.SetArenaTheta(a.theta_min, a.theta_max, a.theta_res)
        api.SetThreshold(self.threshold)
        api.SetDynamicImageFilter(
            api.FILTER_TYPE_MTI if self.mti else api.FILTER_TYPE_NONE
        )

    def _do_start(self):
        self._api.Start()

    def _do_trigger(self):
        self._api.Trigger()
        self._cube = None

    def _do_get_raw_image(self) -> np.ndarray:
        raw, size_x, size_y, size_z, _power = self._api.GetRawImage()
        cube = np.asarray(raw, dtype=np.float32)
        if cube.shape != (size_x, size_y, size_z):
            cube = cube.reshape(size_x, size_y, size_z)
        self._cube = cube
        return cube

    def _do_get_sensor_targets(self) -> List[RadarTarget]:
        return [
            RadarTarget(t.xPosCm, t.yPosCm, t.zPosCm, t.amplitude)
            for t in self._api.GetSensorTargets()
        ]

    def get_status(self) -> Tuple[Status, float]:
        code, progress = self._api.GetStatus()
        status = (
            Status.CALIBRATING
            if code == self._api.STATUS_CALIBRATING
            else Status.CLEAN
        )
        return status, float(progress)

    def _do_stop(self):
        self._api.Stop()

    def _do_disconnect(self):
        try:
            self._api.Disconnect()
        finally:
            self._api.Clean()
            self._api = None
