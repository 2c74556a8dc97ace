"""Batched feature-vector construction from radar projections.

Port of radarml_tpu/ops/features.py: the `FeatureSpec` that fixes the
(xz | yz | xy) feature layout, `predict_zoom` (the per-plane zoom from a
scan arena into the training arena), and the batched featurizers: select
the projections named by the mask, zoom each to the training arena with
the exact ndimage cubic B-spline semantics (two float32 matrix products
per plane, ops/resample.py), flatten, concatenate in xz | yz | xy order
and optionally scale to [0, 1] by RADAR_MAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from radarml_tpu_torch.core.arena import RADAR_MAX, Arena, ProjMask, ProjZoom
from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.ops.resample import spline_zoom_pair


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Static description of the projection→feature transformation."""

    xz_shape: Tuple[int, int]
    yz_shape: Tuple[int, int]
    xy_shape: Tuple[int, int]
    proj_mask: ProjMask = ProjMask(True, True, True)
    proj_zoom: ProjZoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0))
    scale: bool = False

    @staticmethod
    def for_arena(
        arena: Arena,
        proj_mask: ProjMask = ProjMask(True, True, True),
        proj_zoom: ProjZoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0)),
        scale: bool = False,
    ) -> "FeatureSpec":
        return FeatureSpec(
            xz_shape=arena.xz_shape,
            yz_shape=arena.yz_shape,
            xy_shape=arena.xy_shape,
            proj_mask=proj_mask,
            proj_zoom=proj_zoom,
            scale=scale,
        )

    @property
    def plane_out_shapes(self) -> Tuple[Tuple[int, int], ...]:
        outs = []
        for shape, zoom, keep in zip(
            (self.xz_shape, self.yz_shape, self.xy_shape),
            self.proj_zoom,
            self.proj_mask,
        ):
            if not keep:
                continue
            _, _, out_shape = spline_zoom_pair(tuple(shape), tuple(zoom))
            outs.append(out_shape)
        return tuple(outs)

    @property
    def feature_length(self) -> int:
        return sum(h * w for h, w in self.plane_out_shapes)


def predict_zoom(train_arena: Arena, scan_arena: Arena) -> ProjZoom:
    """Zoom factors mapping a scan arena into the training arena.

    Mirror of the reference's `calc_proj_zoom` (predict.py:34-54): per
    axis, factor = train_size / scan_size, composed per projection with
    the (row, col) layout of each plane — xz rows are theta (x), yz
    rows are phi (y), both with r columns; xy is (theta, phi).
    """
    zx = train_arena.size_x / scan_arena.size_x
    zy = train_arena.size_y / scan_arena.size_y
    zz = train_arena.size_z / scan_arena.size_z
    return ProjZoom(xz=(zx, zz), yz=(zy, zz), xy=(zx, zy))


@functools.lru_cache(maxsize=64)
def _zoom_mats(spec: FeatureSpec):
    """Per-plane (row_mat, col_mat) float64 numpy zoom operators, None
    for a masked plane. Cached per FeatureSpec (hashable, and it fully
    determines them)."""
    mats = []
    for shape, zoom, keep in zip(
        (spec.xz_shape, spec.yz_shape, spec.xy_shape), spec.proj_zoom, spec.proj_mask
    ):
        if not keep:
            mats.append(None)
            continue
        row_mat, col_mat, _ = spline_zoom_pair(tuple(shape), tuple(zoom))
        mats.append((np.asarray(row_mat), np.asarray(col_mat)))
    return tuple(mats)


def make_feature_fn(
    spec: FeatureSpec,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build a (xz, yz, xy) batch → (B, F) feature function.

    Inputs are (B, H, W) float32 stacks of each projection at its native
    scan shape, on one device; the output is the (B, feature_length)
    matrix the classifiers consume, on that device, in the JAX
    package's layout. The zoom operators are built once per spec and
    moved to the batch's device at the call.
    """
    mats = _zoom_mats(spec)
    scale = spec.scale

    def feature_fn(xz: torch.Tensor, yz: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
        # models.linear.full_f32, inlined: ops/ must not import models/
        torch.backends.cuda.matmul.allow_tf32 = False
        planes = []
        for batch, mat in zip((xz, yz, xy), mats):
            if mat is None:
                continue
            row_mat = torch.as_tensor(mat[0], dtype=batch.dtype, device=batch.device)
            col_mat = torch.as_tensor(mat[1], dtype=batch.dtype, device=batch.device)
            out = torch.einsum("oh,bhw->bow", row_mat, batch)
            out = torch.einsum("bow,pw->bop", out, col_mat)
            planes.append(out.reshape(out.shape[0], -1))
        feats = torch.cat(planes, dim=1)
        if scale:
            feats = feats / RADAR_MAX
        return feats

    return feature_fn


def process_samples(
    samples: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    proj_mask: ProjMask = ProjMask(True, True, True),
    proj_zoom: ProjZoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0)),
    scale: bool = False,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Batched equivalent of the reference's common.process_samples.

    Accepts the reference's list-of-(xz, yz, xy) sample format and
    returns the (N, F) float32 feature matrix on `device` (default: the
    CUDA card; pass "cpu" for the CPU). All samples must share plane
    shapes (true for any single-arena dataset).
    """
    dev = resolve_device(device)
    xz = np.stack([np.asarray(s[0], dtype=np.float32) for s in samples])
    yz = np.stack([np.asarray(s[1], dtype=np.float32) for s in samples])
    xy = np.stack([np.asarray(s[2], dtype=np.float32) for s in samples])
    return process_views(
        xz, yz, xy,
        proj_mask=proj_mask, proj_zoom=proj_zoom, scale=scale, device=dev,
    )


def process_views(
    xz,
    yz,
    xy,
    proj_mask: ProjMask = ProjMask(True, True, True),
    proj_zoom: ProjZoom = ProjZoom((1.0, 1.0), (1.0, 1.0), (1.0, 1.0)),
    scale: bool = False,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """`process_samples` for already-batched (B, H, W) view stacks (numpy
    or tensors), featurized on `device` (default: the CUDA card; pass
    "cpu" for the CPU)."""
    dev = resolve_device(device)
    norm_zoom = ProjZoom(*[
        tuple(float(v) for v in np.atleast_1d(z)[:2]) if np.ndim(z)
        else (float(z), float(z))
        for z in proj_zoom
    ])
    spec = FeatureSpec(
        xz_shape=tuple(int(s) for s in xz.shape[1:]),
        yz_shape=tuple(int(s) for s in yz.shape[1:]),
        xy_shape=tuple(int(s) for s in xy.shape[1:]),
        proj_mask=ProjMask(*(bool(m) for m in proj_mask)),
        proj_zoom=norm_zoom,
        scale=bool(scale),
    )
    return make_feature_fn(spec)(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (xz, yz, xy))
    )
