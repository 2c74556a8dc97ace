from radarml_tpu_torch.train.metrics import (
    accuracy_score,
    classification_report,
    confusion_matrix,
    evaluate_model,
    plot_confusion_matrix,
)
from radarml_tpu_torch.train.trainer import TrainConfig, train_cnn, weighted_xent_loss
from radarml_tpu_torch.train.checkpoint import CheckpointStore
from radarml_tpu_torch.train.sgan_trainer import (
    SGANConfig,
    SGANState,
    classifier_eval,
    generate_fake_dataset,
    make_sgan_step,
    select_supervised_samples,
    sgan_init,
    train_sgan,
)
from radarml_tpu_torch.train.gridsearch import (
    GridSearchResult,
    SGD_PARAM_GRID,
    SVC_PARAM_GRID,
    grid_search_sgd,
    grid_search_svc,
    parameter_grid,
    stratified_kfold_indices,
)

__all__ = [
    "accuracy_score",
    "classification_report",
    "confusion_matrix",
    "evaluate_model",
    "plot_confusion_matrix",
    "TrainConfig",
    "train_cnn",
    "weighted_xent_loss",
    "CheckpointStore",
    "SGANConfig",
    "SGANState",
    "classifier_eval",
    "generate_fake_dataset",
    "make_sgan_step",
    "select_supervised_samples",
    "sgan_init",
    "train_sgan",
    "GridSearchResult",
    "SGD_PARAM_GRID",
    "SVC_PARAM_GRID",
    "grid_search_sgd",
    "grid_search_svc",
    "parameter_grid",
    "stratified_kfold_indices",
]
