from radarml_tpu_torch.ops.resample import (
    bicubic_pair,
    bicubic_resize_matrix,
    bspline_zoom_matrix,
    spline_zoom_pair,
    zoom_output_size,
)
from radarml_tpu_torch.ops.features import (
    FeatureSpec,
    make_feature_fn,
    predict_zoom,
    process_samples,
    process_views,
)
from radarml_tpu_torch.ops.rbf import rbf_gram, rbf_gram_ref
from radarml_tpu_torch.ops.score import (
    NativeTemplates,
    fused_native_score,
    fused_native_score_ref,
    native_tables,
    native_tables_ref,
    native_templates,
)

__all__ = [
    "bicubic_pair",
    "bicubic_resize_matrix",
    "bspline_zoom_matrix",
    "spline_zoom_pair",
    "zoom_output_size",
    "FeatureSpec",
    "make_feature_fn",
    "predict_zoom",
    "process_samples",
    "process_views",
    "rbf_gram",
    "rbf_gram_ref",
    "NativeTemplates",
    "fused_native_score",
    "fused_native_score_ref",
    "native_tables",
    "native_tables_ref",
    "native_templates",
]
