"""The reference's scan arena (goruck/radar-ml common.py:23-121), in float64.

A scan is a (theta, phi, r) grid of return signals scanned from the radar
origin: r along +Z in cm, theta from the Z axis and phi from X to the
projection on the XY plane, both in degrees. The cube is indexed
(i, j, k) = (theta, phi, r). A target at (x, y, z) cm reads the planes
yz = cube[i], xz = cube[:, j] and xy = cube[:, :, k] of its cell.

Written for the benchmark alone: it imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

#: Index units added before truncation, so that a target on a grid node
#: does not fall into the cell below it by rounding (the program and the
#: JAX package nudge by the same amount).
NUDGE = 1e-3


@dataclasses.dataclass(frozen=True)
class Arena:
    r_min: float = 10.0
    r_max: float = 360.0
    r_res: float = 2.0
    theta_min: float = -42.0
    theta_max: float = 42.0
    theta_res: float = 4.0
    phi_min: float = -30.0
    phi_max: float = 30.0
    phi_res: float = 2.0

    @classmethod
    def from_dict(cls, d: dict) -> "Arena":
        return cls(**{k: float(v) for k, v in d.items()})

    @property
    def shape(self) -> Tuple[int, int, int]:
        """(X, Y, Z): the theta, phi and r axis lengths."""
        return (round((self.theta_max - self.theta_min) / self.theta_res) + 1,
                round((self.phi_max - self.phi_min) / self.phi_res) + 1,
                round((self.r_max - self.r_min) / self.r_res) + 1)

    @property
    def planes(self) -> Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]:
        """The (rows, cols) of the xz, yz and xy planes."""
        X, Y, Z = self.shape
        return (X, Z), (Y, Z), (X, Y)

    @property
    def plane_voxels(self) -> int:
        """Voxels of one target's three planes."""
        return sum(h * w for h, w in self.planes)

    def node_xyz(self, i, j, k) -> torch.Tensor:
        """Cartesian cm (..., 3) float64 of the grid nodes (i, j, k)."""
        X, Y, Z = self.shape
        theta = self.theta_min + i.double() * (self.theta_max - self.theta_min) / (X - 1)
        phi = self.phi_min + j.double() * (self.phi_max - self.phi_min) / (Y - 1)
        r = self.r_min + k.double() * (self.r_max - self.r_min) / (Z - 1)
        t, p = torch.deg2rad(theta), torch.deg2rad(phi)
        return torch.stack((r * torch.sin(t), r * torch.cos(t) * torch.sin(p),
                            r * torch.cos(t) * torch.cos(p)), -1)

    def indices(self, xyz: torch.Tensor):
        """(..., 3) cm → int64 (i, j, k), truncated after the nudge and
        clamped into the cube, from float64 spherical coordinates."""
        X, Y, Z = self.shape
        x, y, z = xyz.double().unbind(-1)
        r = torch.sqrt(x * x + y * y + z * z)
        theta = torch.rad2deg(torch.asin(torch.where(r > 0, x / torch.where(r > 0, r, 1.0), 0.0)))
        phi = torch.rad2deg(torch.atan2(y, z))
        vals = ((theta - self.theta_min) * (X - 1) / (self.theta_max - self.theta_min),
                (phi - self.phi_min) * (Y - 1) / (self.phi_max - self.phi_min),
                (r - self.r_min) * (Z - 1) / (self.r_max - self.r_min))
        return tuple(torch.clamp(torch.trunc(v + NUDGE), 0, n - 1).long()
                     for v, n in zip(vals, (X, Y, Z)))
