"""The reference's feature vector of a target (common.py:123-150,
predict.py:90-131): its three planes sliced from the raw 0..255 cube,
each zoomed into the training arena, flattened, concatenated xz | yz | xy
and scaled by 1/255."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference.arena import Arena
from portbench.reference.zoom import zoom_matrix

RADAR_MAX = 255.0


def plane_ops(scan: Arena, train: Arena, dtype, device):
    """Per plane, the (rows, cols) zoom operators from the scan arena's
    plane into the training arena's, or None for an axis left as it is."""
    ops = []
    for (h, w), (oh, ow) in zip(scan.planes, train.planes):
        ops.append(tuple(None if n == o else torch.as_tensor(zoom_matrix(n, o), dtype=dtype,
                                                              device=device)
                         for n, o in ((h, oh), (w, ow))))
    return ops


def features(cubes: torch.Tensor, b: torch.Tensor, ijk, scan: Arena, train: Arena,
             dtype=torch.float64, rounding: Optional[Callable] = None) -> torch.Tensor:
    """(N, F) features of the targets at cube cells ijk = (i, j, k), each
    (N,), of scans b (N,) of the (B, X, Y, Z) raw cubes, in `dtype`.
    `rounding`, where given, rounds both operands of every product (a
    lower-precision control)."""
    i, j, k = ijk
    rnd = rounding or (lambda t: t)
    planes = (cubes[b, :, j, :], cubes[b, i], cubes[b, :, :, k])  # xz, yz, xy
    out = []
    for p, (r, c) in zip(planes, plane_ops(scan, train, dtype, cubes.device)):
        p = p.to(dtype)
        if r is not None:
            p = torch.matmul(rnd(r), rnd(p))
        if c is not None:
            p = torch.matmul(rnd(p), rnd(c).T)
        out.append(p.reshape(p.shape[0], -1))
    return torch.cat(out, 1) / RADAR_MAX
