"""Synthetic and replay radar backends (no hardware in CI).

The synthetic driver plants class-signature targets with the same
generator as data/synthetic.py, so the full predict pipeline runs
hardware-free with known ground truth; the replay driver re-serves
recorded scans (cube + target reports), which is how bit-parity checks
against reference-captured data run (SURVEY.md §2.2 "simulated/
replayable radar driver").

Copy of radarml_tpu/drivers/synthetic.py on the port's own generator
(data/synthetic.synth_cube): the same seed gives the same cubes and
targets as the JAX package's driver.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from radarml_tpu_torch.data.synthetic import DEFAULT_CLASSES, synth_cube
from radarml_tpu_torch.drivers.base import (
    RadarDriver,
    RadarTarget,
    Status,
)

__all__ = ["SyntheticRadar", "ReplayRadar"]


@dataclasses.dataclass
class SyntheticRadar(RadarDriver):
    """Deterministic synthetic sensor.

    Each trigger synthesizes a scan cube with 1..max_targets planted
    targets. With mti=False the first `calibration_triggers` triggers
    report CALIBRATING (exercising the reference's calibrate loop).
    """

    classes: Sequence[str] = DEFAULT_CLASSES
    seed: int = 1234
    max_targets: int = 1
    scan_period_s: float = 0.0  # simulate sensor cadence if > 0
    calibration_triggers: int = 3
    empty_scan_rate: float = 0.0  # fraction of scans with no targets

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._cube: Optional[np.ndarray] = None
        self._targets: List[RadarTarget] = []
        self._truth_labels: List[str] = []
        self._remaining_cal = 0
        self._scans = 0

    # hooks ---------------------------------------------------------------
    def _do_connect(self):
        pass

    def _do_configure(self):
        self._remaining_cal = 0 if self.mti else self.calibration_triggers

    def _do_start(self):
        pass

    def _do_trigger(self):
        if self.scan_period_s > 0:
            time.sleep(self.scan_period_s)
        if self._remaining_cal > 0:
            self._remaining_cal -= 1
        self._scans += 1
        if (
            self.empty_scan_rate > 0
            and self._rng.random() < self.empty_scan_rate
        ):
            self._cube = np.zeros(self.arena.grid_shape, np.float32)
            self._targets, self._truth_labels = [], []
            return
        n = int(self._rng.integers(1, self.max_targets + 1))
        cube = np.zeros(self.arena.grid_shape, np.float32)
        targets, labels = [], []
        for _ in range(n):
            label = str(self._rng.choice(np.asarray(self.classes)))
            c, t = synth_cube(self._rng, label, self.arena)
            cube = np.maximum(cube, c)
            targets.append(RadarTarget(t.x, t.y, t.z, t.amplitude))
            labels.append(label)
        self._cube = cube
        self._targets, self._truth_labels = targets, labels

    def _do_get_raw_image(self) -> np.ndarray:
        if self._cube is None:
            raise RuntimeError("trigger() before get_raw_image()")
        return self._cube

    def _do_get_sensor_targets(self) -> List[RadarTarget]:
        if self._cube is None:
            raise RuntimeError("trigger() before get_sensor_targets()")
        return list(self._targets)

    def get_status(self) -> Tuple[Status, float]:
        if self._remaining_cal > 0:
            done = self.calibration_triggers - self._remaining_cal
            return Status.CALIBRATING, 100.0 * done / self.calibration_triggers
        return Status.CLEAN, 100.0

    @property
    def truth_labels(self) -> List[str]:
        """Ground-truth labels of the current scan's targets (test aid)."""
        return list(self._truth_labels)


@dataclasses.dataclass
class ReplayRadar(RadarDriver):
    """Replay recorded scans: list of (cube, [RadarTarget, ...])."""

    scans: Sequence[Tuple[np.ndarray, Sequence[RadarTarget]]] = ()
    loop: bool = True
    scan_period_s: float = 0.0

    def __post_init__(self):
        self._pos = -1

    def _do_connect(self):
        if not self.scans:
            raise RuntimeError("no scans to replay")

    def _do_configure(self):
        pass

    def _do_start(self):
        self._pos = -1

    def _do_trigger(self):
        if self.scan_period_s > 0:
            time.sleep(self.scan_period_s)
        nxt = self._pos + 1
        if nxt >= len(self.scans):
            if not self.loop:
                raise StopIteration("replay exhausted")
            nxt = 0
        self._pos = nxt

    def _current(self):
        if self._pos < 0:
            raise RuntimeError("trigger() before reads")
        return self.scans[self._pos]

    def _do_get_raw_image(self) -> np.ndarray:
        return np.asarray(self._current()[0], np.float32)

    def _do_get_sensor_targets(self) -> List[RadarTarget]:
        return [RadarTarget(*t) for t in self._current()[1]]
