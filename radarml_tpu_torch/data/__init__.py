from radarml_tpu_torch.data.labels import (
    CLASS_ALIAS,
    LabelEncoder,
    apply_aliases,
    class_weights,
    filter_samples,
)
from radarml_tpu_torch.data.synthetic import (
    DEFAULT_CLASSES,
    SyntheticTarget,
    make_dataset,
    make_grid_probe,
    make_scan_batch,
    synth_cube,
    synth_sample,
)

__all__ = [
    "CLASS_ALIAS",
    "LabelEncoder",
    "apply_aliases",
    "class_weights",
    "filter_samples",
    "DEFAULT_CLASSES",
    "SyntheticTarget",
    "make_dataset",
    "make_grid_probe",
    "make_scan_batch",
    "synth_cube",
    "synth_sample",
]
