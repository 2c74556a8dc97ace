"""Evaluation metrics and reporting.

Copy of radarml_tpu/train/metrics.py (it has no JAX in it); the port
keeps its own so that it never imports the JAX package. matplotlib is
imported only when a figure is drawn.

Standalone numpy implementations of the metrics the reference pulls
from sklearn (train.py:215-228): accuracy, confusion matrix, and a
per-class precision/recall/F1 classification report, plus the
normalized confusion-matrix figure (train.py:293-322). Kept free of
sklearn so the serving stack has no training-time dependencies.
"""

from __future__ import annotations

import io
import itertools
import logging
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = [
    "accuracy_score",
    "confusion_matrix",
    "precision_recall_f1",
    "classification_report",
    "plot_confusion_matrix",
    "evaluate_model",
]

logger = logging.getLogger(__name__)


def accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if y_true.size else 0.0


def confusion_matrix(
    y_true: np.ndarray, y_pred: np.ndarray, n_classes: Optional[int] = None
) -> np.ndarray:
    y_true, y_pred = np.asarray(y_true, int), np.asarray(y_pred, int)
    if n_classes is None:
        n_classes = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def precision_recall_f1(cm: np.ndarray):
    """Per-class (precision, recall, f1, support) from a confusion matrix."""
    support = cm.sum(axis=1)
    pred_count = cm.sum(axis=0)
    tp = np.diag(cm).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1, support


def classification_report(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    target_names: Sequence[str],
) -> str:
    """sklearn-style text report."""
    cm = confusion_matrix(y_true, y_pred, n_classes=len(target_names))
    precision, recall, f1, support = precision_recall_f1(cm)
    total = support.sum()
    acc = accuracy_score(y_true, y_pred)

    width = max(max(len(n) for n in target_names), len("weighted avg"))
    out = io.StringIO()
    head = f"{'':>{width}}  {'precision':>9} {'recall':>9} {'f1-score':>9} {'support':>9}\n\n"
    out.write(head)
    for i, name in enumerate(target_names):
        out.write(
            f"{name:>{width}}  {precision[i]:>9.2f} {recall[i]:>9.2f} "
            f"{f1[i]:>9.2f} {support[i]:>9d}\n"
        )
    out.write("\n")
    out.write(
        f"{'accuracy':>{width}}  {'':>9} {'':>9} {acc:>9.2f} {total:>9d}\n"
    )
    for avg_name, w in (
        ("macro avg", np.ones_like(support) / max(len(support), 1)),
        ("weighted avg", support / max(total, 1)),
    ):
        out.write(
            f"{avg_name:>{width}}  {np.sum(precision * w):>9.2f} "
            f"{np.sum(recall * w):>9.2f} {np.sum(f1 * w):>9.2f} {total:>9d}\n"
        )
    return out.getvalue()


def plot_confusion_matrix(cm: np.ndarray, class_names: Sequence[str]):
    """Normalized confusion-matrix figure (reference train.py:293-322)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figure = plt.figure(figsize=(8, 8))
    ax = plt.gca()
    im = ax.imshow(cm, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title("Confusion matrix")
    plt.colorbar(im, fraction=0.046, pad=0.04)
    tick_marks = np.arange(len(class_names))
    plt.xticks(tick_marks, class_names, rotation=45)
    plt.yticks(tick_marks, class_names)

    with np.errstate(divide="ignore", invalid="ignore"):
        norm = np.around(
            cm.astype("float") / cm.sum(axis=1)[:, np.newaxis], decimals=2
        )
    threshold = np.nanmax(norm) / 2.0
    for i, j in itertools.product(range(cm.shape[0]), range(cm.shape[1])):
        color = "white" if norm[i, j] > threshold else "black"
        plt.text(j, i, norm[i, j], horizontalalignment="center", color=color)

    plt.tight_layout()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    return figure


def evaluate_model(
    predict_fn,
    X_test,
    y_test: np.ndarray,
    target_names: Sequence[str],
    cm_path: Optional[str] = None,
) -> Dict[str, object]:
    """Accuracy + confusion matrix + report, optionally saving the CM
    figure — the reference's evaluate_model (train.py:215-228)."""
    y_pred = np.asarray(predict_fn(X_test))
    acc = accuracy_score(y_test, y_pred)
    logger.info("Accuracy: %s", acc)
    cm = confusion_matrix(y_test, y_pred, n_classes=len(target_names))
    logger.info("Confusion matrix:\n%s", cm)
    report = classification_report(y_test, y_pred, target_names)
    logger.info("Classification report:\n%s", report)
    if cm_path is not None:
        fig = plot_confusion_matrix(cm, class_names=target_names)
        logger.info("Saving confusion matrix plot to: %s", cm_path)
        fig.savefig(cm_path)
    return {"accuracy": acc, "confusion_matrix": cm, "report": report}
