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
    "DEFAULT_CLASSES",
    "SyntheticTarget",
    "make_dataset",
    "make_grid_probe",
    "make_scan_batch",
    "synth_cube",
    "synth_sample",
]
