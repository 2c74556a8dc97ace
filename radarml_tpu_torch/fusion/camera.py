"""Camera→radar coordinate fusion, vectorized.

Port of radarml_tpu/fusion/camera.py (a copy: it is numpy only).
Re-design of the reference's pixel→radar conversion
(ground_truth_samples.py:66-109): back-project a camera pixel to world
coordinates via the pinhole intrinsics at the radar target's depth,
then rotate/translate by the fixed mounting extrinsics. The reference
converts one detection at a time in Python; here the transform is a
single numpy broadcast over (targets × detections).
"""

from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["MountConfig", "convert_coordinates", "pair_distances"]


@dataclasses.dataclass(frozen=True)
class MountConfig:
    """Physical camera/radar mounting (reference constants,
    ground_truth_samples.py:28-40)."""

    horizontal: bool = True  # RADAR_HORIZONTAL: usb facing right
    x_offset_cm: float = 1.13  # CAMERA_X_OFFSET
    y_offset_cm: float = 5.08  # CAMERA_Y_OFFSET
    z_offset_cm: float = -1.2  # CAMERA_Z_OFFSET


def convert_coordinates(
    pixels: np.ndarray,
    target_z: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    mount: MountConfig = MountConfig(),
) -> np.ndarray:
    """Camera pixels → radar-frame (x, y) cm at the targets' depths.

    Args:
        pixels: (..., 2) pixel coordinates (OpenCV origin top-left).
        target_z: broadcastable depth(s) in cm from the radar.

    Returns:
        (..., 2) radar-frame coordinates in cm.
    """
    pixels = np.asarray(pixels, np.float64)
    target_z = np.asarray(target_z, np.float64)
    depth = target_z - mount.z_offset_cm
    world_x = (pixels[..., 0] - cx) * depth / fx
    world_y = (pixels[..., 1] - cy) * depth / fy
    if mount.horizontal:
        radar_x = world_y - mount.y_offset_cm
        radar_y = world_x - mount.x_offset_cm
    else:
        radar_x = world_x - mount.x_offset_cm
        radar_y = -world_y - mount.y_offset_cm
    return np.stack([radar_x, radar_y], axis=-1)


def pair_distances(
    target_xy: np.ndarray, detection_xy: np.ndarray
) -> np.ndarray:
    """(T, D) Euclidean distances between radar targets and converted
    camera detections (reference compute_distance, vectorized)."""
    t = np.asarray(target_xy, np.float64)[:, None, :]
    d = np.asarray(detection_xy, np.float64)[None, :, :]
    return np.sqrt(np.sum((t - d) ** 2, axis=-1))
