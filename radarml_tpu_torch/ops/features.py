"""Feature-vector geometry of the radar projections.

Port of the predict-path half of radarml_tpu/ops/features.py: the
`FeatureSpec` that fixes the (xz | yz | xy) feature layout and
`predict_zoom`, the per-plane zoom from a scan arena into the training
arena. The batched featurizers (`process_samples`, `make_feature_fn`)
belong to the training path and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from radarml_tpu_torch.core.arena import Arena, ProjMask, ProjZoom
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

