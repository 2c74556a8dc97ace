"""Ground-truth capture: radar/camera association loop.

Port of radarml_tpu/fusion/capture.py. It runs on the host, as the JAX
package's does: the cube indices of a target are the port's float32
`Arena.matrix_indices` (a card's trig may truncate a value within 2e-6
of an integer to the neighbouring cell), clipped into the cube, and the
projections are slices of the driver's host cube.

Re-design of the reference's `get_samples` generator
(ground_truth_samples.py:333-448): per scan — trigger the radar, poll
the detection server, read targets + raw cube, and for each radar
target find the closest camera detection within a depth-proportional
gate; on a match, slice the three projections at the target's cube
indices and yield a labeled sample.

The per-(target × detection) conversion/distance math runs as one
broadcast batch per scan instead of nested Python loops; thresholds
and slicing reproduce the reference exactly:

* gate = DETECTION_THRESHOLD_PERCENT (0.25) × target z
  (ground_truth_samples.py:42-45, 373-376);
* detections below MIN_DETECTED_OBJECT_SCORE (0.5) are skipped
  (ground_truth_samples.py:47-49, 380-382);
* detection centroids arrive normalized and are scaled by the camera
  resolution before conversion (ground_truth_samples.py:385-388);
* projections slice as yz=cube[i,:,:], xz=cube[:,j,:], xy=cube[:,:,k]
  at the target's matrix indices (ground_truth_samples.py:413-419).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radarml_tpu_torch.core.arena import Arena
from radarml_tpu_torch.drivers.base import RadarDriver, RadarTarget
from radarml_tpu_torch.fusion.camera import MountConfig, convert_coordinates
from radarml_tpu_torch.rpc.client import CameraInfo, Detection

logger = logging.getLogger(__name__)

__all__ = ["CaptureConfig", "CapturedSample", "capture_samples", "associate"]

DETECTION_THRESHOLD_PERCENT = 0.25  # ground_truth_samples.py:44
MIN_DETECTED_OBJECT_SCORE = 0.50  # ground_truth_samples.py:49


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    num_samples: int = 100
    desired_labels: Sequence[str] = ("person", "dog", "cat")
    threshold_percent: float = DETECTION_THRESHOLD_PERCENT
    min_score: float = MIN_DETECTED_OBJECT_SCORE
    mount: MountConfig = MountConfig()
    max_scans: Optional[int] = None  # safety bound for tests/CI
    # Transient detection-server failures retry with backoff instead of
    # killing the session (the reference exits on any gRPC error,
    # ground_truth_samples.py:138-141 — a capture session should not
    # lose its progress to one dropped RPC).
    rpc_retries: int = 3
    rpc_backoff_s: float = 0.5


@dataclasses.dataclass(frozen=True)
class CapturedSample:
    projections: Tuple[np.ndarray, np.ndarray, np.ndarray]  # (xz, yz, xy)
    label: str
    target_position: Tuple[float, float, float]
    centroid_position: Tuple[float, float]
    score: float
    distance_cm: float


def associate(
    targets: Sequence[RadarTarget],
    detections: Sequence[Detection],
    camera: CameraInfo,
    cfg: CaptureConfig,
) -> List[Optional[Tuple[int, float, Tuple[float, float]]]]:
    """Per target: (detection index, distance, centroid radar xy) or None.

    One broadcast over the (T, D) pair grid replaces the reference's
    nested loop; the acceptance rule is identical (closest detection
    under 25% of the target's depth, score-gated).
    """
    if not targets or not detections:
        return [None] * len(targets)
    tz = np.array([t.z for t in targets])
    txy = np.array([[t.x, t.y] for t in targets])
    scores = np.array([d.score for d in detections])
    pixels = np.array(
        [
            [camera.width * d.centroid[0], camera.height * d.centroid[1]]
            for d in detections
        ]
    )
    # Convert every detection at every target's depth: (T, D, 2).
    radar_xy = convert_coordinates(
        pixels[None, :, :], tz[:, None],
        camera.fx, camera.fy, camera.cx, camera.cy, cfg.mount,
    )
    dist = np.linalg.norm(radar_xy - txy[:, None, :], axis=-1)  # (T, D)
    gate = cfg.threshold_percent * tz  # (T,)
    ok = (scores[None, :] >= cfg.min_score) & (dist < gate[:, None])
    dist_masked = np.where(ok, dist, np.inf)
    best = np.argmin(dist_masked, axis=1)
    out = []
    for t in range(len(targets)):
        d = int(best[t])
        if not np.isfinite(dist_masked[t, d]):
            out.append(None)
        else:
            out.append((d, float(dist[t, d]), tuple(radar_xy[t, d])))
    return out


def _detections_with_retry(get_detections, cfg: CaptureConfig):
    """Poll the detection source, retrying transient RPC failures."""
    import time as _time

    from radarml_tpu_torch.rpc.client import DetectionServerError

    for attempt in range(cfg.rpc_retries + 1):
        try:
            return get_detections(cfg.desired_labels)
        except DetectionServerError as err:
            if attempt >= cfg.rpc_retries:
                raise
            wait = cfg.rpc_backoff_s * (2**attempt)
            logger.warning(
                "detection server error (%s); retry %d/%d in %.1fs",
                err, attempt + 1, cfg.rpc_retries, wait,
            )
            _time.sleep(wait)


def capture_samples(
    driver: RadarDriver,
    get_detections: Callable[[Sequence[str]], List[Detection]],
    camera: CameraInfo,
    cfg: CaptureConfig = CaptureConfig(),
) -> Iterator[CapturedSample]:
    """Generator over associated (projections, label) samples.

    `get_detections` is typically DetectionClient.get_detected_objects
    bound to a channel, or a fake server's method — the capture loop is
    transport-agnostic.
    """
    arena: Arena = driver.arena
    produced = 0
    scans = 0
    while produced < cfg.num_samples:
        if cfg.max_scans is not None and scans >= cfg.max_scans:
            logger.info("capture stopping: max_scans=%d reached", scans)
            return
        scans += 1
        driver.trigger()
        detections = _detections_with_retry(get_detections, cfg)
        if not detections:
            continue
        targets = driver.get_sensor_targets()
        if not targets:
            continue
        cube = np.asarray(driver.get_raw_image(), np.float32)
        matches = associate(targets, detections, camera, cfg)
        for t_i, (target, match) in enumerate(zip(targets, matches)):
            if match is None:
                continue
            d_i, dist, centroid_xy = match
            det = detections[d_i]
            i, j, k = (
                int(v)
                for v in arena.matrix_indices(
                    *(torch.tensor(c, dtype=torch.float32)
                      for c in (target.x, target.y, target.z))
                )
            )
            i = int(np.clip(i, 0, arena.size_x - 1))
            j = int(np.clip(j, 0, arena.size_y - 1))
            k = int(np.clip(k, 0, arena.size_z - 1))
            yz = cube[i, :, :]
            xz = cube[:, j, :]
            xy = cube[:, :, k]
            produced += 1
            logger.info(
                'Stored "%s" with score %.1f at %.1f (cm) from target '
                "at z %.1f (cm).",
                det.label, det.score, dist, target.z,
            )
            yield CapturedSample(
                projections=(xz, yz, xy),
                label=det.label,
                target_position=(target.x, target.y, target.z),
                centroid_position=centroid_xy,
                score=det.score,
                distance_cm=dist,
            )
            if produced >= cfg.num_samples:
                return
