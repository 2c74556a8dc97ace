"""Radar scan-arena geometry and coordinate transforms.

Port of radarml_tpu/core/arena.py. The arena is a spherical
(r, theta, phi) grid scanned from the radar origin: radial distance R
along +Z (cm), theta measured from the Z axis (deg), phi the angle from
X to the projection on the XY plane (deg). The raw return-signal cube is
indexed (i, j, k) = (theta, phi, r), so the default arena yields a
(22, 31, 176) cube.

The index transforms take torch tensors (or anything `torch.as_tensor`
accepts) and compute in float32, the JAX package's precision, so the
truncated cube indices agree with it; host-side helpers stay numpy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

# Min and max of radar return signal strengths (reference common.py:30-31).
RADAR_MIN = 0.0
RADAR_MAX = 255.0


class ProjMask(NamedTuple):
    """Which 2-D projections participate in the feature vector."""

    xz: bool = True
    yz: bool = True
    xy: bool = True


class ProjZoom(NamedTuple):
    """Per-projection (row, col) zoom factors."""

    xz: Tuple[float, float] = (1.0, 1.0)
    yz: Tuple[float, float] = (1.0, 1.0)
    xy: Tuple[float, float] = (1.0, 1.0)


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Arena:
    """Spherical scan arena (units: cm for r, degrees for angles).

    (max - min) / res must be an integer for every axis, mirroring the
    radar hardware constraint noted in the reference (common.py:23).
    """

    r_min: float = 10.0
    r_max: float = 360.0
    r_res: float = 2.0
    theta_min: float = -42.0
    theta_max: float = 42.0
    theta_res: float = 4.0
    phi_min: float = -30.0
    phi_max: float = 30.0
    phi_res: float = 2.0

    def __post_init__(self):
        for lo, hi, res, name in (
            (self.r_min, self.r_max, self.r_res, "r"),
            (self.theta_min, self.theta_max, self.theta_res, "theta"),
            (self.phi_min, self.phi_max, self.phi_res, "phi"),
        ):
            span = hi - lo
            if span <= 0:
                raise ValueError(f"{name}: max must exceed min")
            if abs(span / res - round(span / res)) > 1e-9:
                raise ValueError(f"{name}: (max - min) / res must be integral")

    # -- grid sizes (reference predict.py:74-76) ---------------------------
    @property
    def size_x(self) -> int:
        """Theta axis length (cube axis 0)."""
        return int((self.theta_max - self.theta_min) / self.theta_res) + 1

    @property
    def size_y(self) -> int:
        """Phi axis length (cube axis 1)."""
        return int((self.phi_max - self.phi_min) / self.phi_res) + 1

    @property
    def size_z(self) -> int:
        """Range axis length (cube axis 2)."""
        return int((self.r_max - self.r_min) / self.r_res) + 1

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.size_x, self.size_y, self.size_z)

    # -- projection plane shapes -------------------------------------------
    @property
    def yz_shape(self) -> Tuple[int, int]:
        """Slice cube[i, :, :] → (phi, r)."""
        return (self.size_y, self.size_z)

    @property
    def xz_shape(self) -> Tuple[int, int]:
        """Slice cube[:, j, :] → (theta, r)."""
        return (self.size_x, self.size_z)

    @property
    def xy_shape(self) -> Tuple[int, int]:
        """Slice cube[:, :, k] → (theta, phi)."""
        return (self.size_x, self.size_y)

    @property
    def feature_length(self) -> int:
        """Flattened xz+yz+xy feature length (10010 for the default arena)."""
        return (
            self.size_x * self.size_z
            + self.size_y * self.size_z
            + self.size_x * self.size_y
        )

    # -- axis coordinate vectors (host-side, static) ------------------------
    def theta_axis(self) -> np.ndarray:
        return np.linspace(self.theta_min, self.theta_max, self.size_x)

    def phi_axis(self) -> np.ndarray:
        return np.linspace(self.phi_min, self.phi_max, self.size_y)

    def r_axis(self) -> np.ndarray:
        return np.linspace(self.r_min, self.r_max, self.size_z)

    # -- coordinate transforms ---------------------------------------------
    def matrix_indices(self, x, y, z):
        """(x, y, z) cm → int32 cube indices (i, j, k), in float32.

        Same mapping as the reference (common.py:106-121): spherical
        conversion followed by linear index scaling with truncation
        toward zero, each step in the JAX package's float32 order.
        """
        return tuple(torch.trunc(v).to(torch.int32) for v in self.index_values(x, y, z))

    def index_values(self, x, y, z):
        """The float32 (i, j, k) that :meth:`matrix_indices` truncates:
        the spherical coordinates in index units, nudged by 1e-3. Where
        one of them lies within float32 rounding of an integer, another
        device's trig may truncate it to the neighbouring cell."""
        r, theta, phi = cartesian_to_spherical(x, y, z)
        i = (theta - self.theta_min) * (self.size_x - 1) / (
            self.theta_max - self.theta_min
        )
        j = (phi - self.phi_min) * (self.size_y - 1) / (self.phi_max - self.phi_min)
        k = (r - self.r_min) * (self.size_z - 1) / (self.r_max - self.r_min)
        # Nudge before truncation: targets that sit exactly on a grid
        # node land a few float32 ulps below the integer, which
        # truncation would send to the neighboring cell. 1e-3
        # index-units dwarfs f32 rounding error (~1e-5 at index scale)
        # while being far below any physically meaningful sub-cell
        # offset.
        eps = 1e-3
        return i + eps, j + eps, k + eps

    def clamped_matrix_indices(self, x, y, z):
        """Like :meth:`matrix_indices` but clamped into the cube, so a
        padded targets array carrying out-of-arena sentinels still gives
        in-range gather indices."""
        i, j, k = self.matrix_indices(x, y, z)
        return (
            torch.clamp(i, 0, self.size_x - 1),
            torch.clamp(j, 0, self.size_y - 1),
            torch.clamp(k, 0, self.size_z - 1),
        )

    def grid_to_cartesian(self, i, j, k):
        """Cube indices → float32 (x, y, z) cm at the grid node centers
        (reference common.py:62-70)."""
        theta = self.theta_min + _f32(i) * (self.theta_max - self.theta_min) / (
            self.size_x - 1
        )
        phi = self.phi_min + _f32(j) * (self.phi_max - self.phi_min) / (
            self.size_y - 1
        )
        r = self.r_min + _f32(k) * (self.r_max - self.r_min) / (self.size_z - 1)
        return spherical_to_cartesian(r, theta, phi)

    def grid_to_cartesian_np(self, i, j, k):
        """Host-side float64 numpy twin of :meth:`grid_to_cartesian`,
        for host loops at sensor rate."""
        theta = self.theta_min + i * (self.theta_max - self.theta_min) / (
            self.size_x - 1
        )
        phi = self.phi_min + j * (self.phi_max - self.phi_min) / (self.size_y - 1)
        r = self.r_min + k * (self.r_max - self.r_min) / (self.size_z - 1)
        t, p = np.deg2rad(theta), np.deg2rad(phi)
        x = r * np.sin(t)
        y = r * np.cos(t) * np.sin(p)
        z = r * np.cos(t) * np.cos(p)
        return x, y, z


DEFAULT_ARENA = Arena()


def cartesian_to_spherical(x, y, z):
    """Cartesian cm → float32 (r cm, theta deg, phi deg).

    Matches the reference convention (common.py:93-97): phi =
    atan2(y, z), theta = asin(x / r).
    """
    x, y, z = _f32(x), _f32(y), _f32(z)
    r = torch.sqrt(x * x + y * y + z * z)
    phi = torch.atan2(y, z)
    pos = r > 0
    theta = torch.asin(
        torch.where(pos, x / torch.where(pos, r, torch.ones_like(r)), 0.0)
    )
    return r, torch.rad2deg(theta), torch.rad2deg(phi)


def spherical_to_cartesian(r, theta, phi):
    """(r cm, theta deg, phi deg) → float32 cartesian cm (common.py:99-104)."""
    r = _f32(r)
    theta = torch.deg2rad(_f32(theta))
    phi = torch.deg2rad(_f32(phi))
    x = r * torch.sin(theta)
    y = r * torch.cos(theta) * torch.sin(phi)
    z = r * torch.cos(theta) * torch.cos(phi)
    return x, y, z


def derive_targets(cube, arena: Arena, num_targets: int = 1):
    """Derive the strongest targets from a raw scan cube, on the device
    the cube lies on.

    Software replacement for the radar SDK's target extraction, in the
    spirit of the reference's DerivedTarget path (common.py:45-80): sum
    the cube down to per-axis profiles, take the top-`num_targets`
    indices per axis, and map grid nodes back to cartesian coordinates.

    The profiles are summed in float64, so the card and the CPU rank
    them alike (a float32 sum's rounding depends on its order), and
    ranked by a stable descending sort: among equal sums the lower index
    counts as stronger, as `jax.lax.top_k` orders them (`torch.topk`
    promises no order for ties).

    Args:
        cube: (size_x, size_y, size_z) array or tensor.
        arena: scan arena describing the cube geometry.
        num_targets: number of targets to emit.

    Returns:
        float32 (x, y, z, amplitude) tensors of shape (num_targets,),
        weakest to strongest, matching the reference's argsort ordering.
    """
    cube = torch.as_tensor(cube).to(torch.float64)

    def top(profile):
        idx = torch.sort(profile, descending=True, stable=True).indices[:num_targets]
        # descending; the reference emits ascending-by-strength
        idx = idx.flip(0)
        return idx, profile[idx].to(torch.float32)

    i, amp = top(cube.sum(dim=(1, 2)))
    j, _ = top(cube.sum(dim=(0, 2)))
    k, _ = top(cube.sum(dim=(0, 1)))
    x, y, z = arena.grid_to_cartesian(i, j, k)
    return x, y, z, amp


def slice_projections(
    cube: torch.Tensor, i, j, k
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slice the three 2-D projections of a target out of a scan cube.

    Matches the reference slicing (predict.py:103-107): yz = cube[i],
    xz = cube[:, j], xy = cube[..., k].

    Returns:
        (xz, yz, xy) with shapes (size_x, size_z), (size_y, size_z),
        (size_x, size_y).
    """
    return cube[:, int(j), :], cube[int(i)], cube[:, :, int(k)]
