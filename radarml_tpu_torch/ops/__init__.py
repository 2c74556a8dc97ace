from radarml_tpu_torch.ops.resample import (
    bicubic_pair,
    bicubic_resize_matrix,
    bspline_zoom_matrix,
    spline_zoom_pair,
    zoom_output_size,
)
from radarml_tpu_torch.ops.features import FeatureSpec, predict_zoom

__all__ = [
    "bicubic_pair",
    "bicubic_resize_matrix",
    "bspline_zoom_matrix",
    "spline_zoom_pair",
    "zoom_output_size",
    "FeatureSpec",
    "predict_zoom",
]
