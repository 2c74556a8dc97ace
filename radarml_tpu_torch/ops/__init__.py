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
from radarml_tpu_torch.ops.augment import (
    add_noise,
    augment_multiview,
    augment_samples,
    bspline_sample2d,
    clipped_zoom_batch,
    clipped_zoom_operator,
    draw_angles,
    draw_noise,
    draw_zoom_indices,
    rotate,
    rotate_batch,
    sparse_noise,
    spline_coeffs2d,
    zoom_palette,
)
from radarml_tpu_torch.ops.score import (
    NativeTemplates,
    fused_native_score,
    fused_native_score_ref,
    native_tables,
    native_tables_ref,
    native_templates,
)
# Registers the kernels as torch ops (radarml_torch::*), which the
# wrappers above call and serving artifacts record.
from radarml_tpu_torch.ops import library  # noqa: E402,F401

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
    "add_noise",
    "augment_multiview",
    "augment_samples",
    "bspline_sample2d",
    "clipped_zoom_batch",
    "clipped_zoom_operator",
    "draw_angles",
    "draw_noise",
    "draw_zoom_indices",
    "rotate",
    "rotate_batch",
    "sparse_noise",
    "spline_coeffs2d",
    "zoom_palette",
    "NativeTemplates",
    "fused_native_score",
    "fused_native_score_ref",
    "native_tables",
    "native_tables_ref",
    "native_templates",
]
