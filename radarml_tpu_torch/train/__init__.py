from radarml_tpu_torch.train.metrics import (
    accuracy_score,
    classification_report,
    confusion_matrix,
    evaluate_model,
    plot_confusion_matrix,
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
    "GridSearchResult",
    "SGD_PARAM_GRID",
    "SVC_PARAM_GRID",
    "grid_search_sgd",
    "grid_search_svc",
    "parameter_grid",
    "stratified_kfold_indices",
]
