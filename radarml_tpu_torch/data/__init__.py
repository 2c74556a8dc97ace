from radarml_tpu_torch.data.store import (
    load_datasets,
    load_datasets_with_sup_mask,
    save_dataset,
    stack_samples,
    unstack_samples,
)
from radarml_tpu_torch.data.labels import (
    CLASS_ALIAS,
    LabelEncoder,
    apply_aliases,
    class_weights,
    filter_samples,
)
from radarml_tpu_torch.data.balance import balance_classes
from radarml_tpu_torch.data.split import train_test_split_indices, train_val_test_split
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
    "load_datasets",
    "load_datasets_with_sup_mask",
    "save_dataset",
    "stack_samples",
    "unstack_samples",
    "CLASS_ALIAS",
    "LabelEncoder",
    "apply_aliases",
    "class_weights",
    "filter_samples",
    "balance_classes",
    "train_test_split_indices",
    "train_val_test_split",
    "DEFAULT_CLASSES",
    "SyntheticTarget",
    "make_dataset",
    "make_grid_probe",
    "make_scan_batch",
    "synth_cube",
    "synth_sample",
]
