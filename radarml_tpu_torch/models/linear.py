"""Linear classifier family: the inference half.

Port of radarml_tpu/models/linear.py:29-109: scoring is one float32
matrix product, probabilities follow sklearn's SGDClassifier(loss='log')
and CalibratedClassifierCV(sigmoid, prefit) semantics. `from_numpy`
converts the JAX package's parameters (as numpy arrays) to the port's.
SGD training and the sklearn loaders are not ported yet.

Float32 products on the card run in full float32: TF32 is switched off
(the JAX package scores at Precision.HIGHEST).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from radarml_tpu_torch.core.device import resolve_device

__all__ = [
    "LinearModel",
    "SigmoidCalibration",
    "decision_function",
    "predict",
    "proba_from_decision",
    "calibrated_from_decision",
    "predict_proba_log_loss",
    "predict_proba_calibrated",
    "from_numpy",
    "full_f32",
]


def full_f32() -> None:
    """Keep float32 products on the card in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class LinearModel:
    """One-vs-all linear model: logits = X @ coef.T + intercept."""

    coef: torch.Tensor  # (n_classes_ova, n_features) float32; (1, F) binary
    intercept: torch.Tensor  # (n_classes_ova,) float32


@dataclasses.dataclass(frozen=True)
class SigmoidCalibration:
    """Per-column Platt scaling: p = 1 / (1 + exp(a * f + b))."""

    a: torch.Tensor  # (n_cols,)
    b: torch.Tensor  # (n_cols,)


def from_numpy(
    coef,
    intercept,
    calib_a=None,
    calib_b=None,
    device: torch.device | str | None = None,
) -> Tuple[LinearModel, Optional[SigmoidCalibration]]:
    """The JAX package's (coef, intercept[, calibration a, b]) as numpy
    arrays → the port's float32 LinearModel and SigmoidCalibration
    (None when no calibration is given) on `device` (default: the CUDA
    card; pass "cpu" for the CPU)."""
    if (calib_a is None) != (calib_b is None):
        raise ValueError("calib_a and calib_b come together")
    dev = resolve_device(device)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    model = LinearModel(coef=f32(coef), intercept=f32(intercept))
    calib = None
    if calib_a is not None:
        calib = SigmoidCalibration(a=f32(calib_a), b=f32(calib_b))
    return model, calib


def decision_function(model: LinearModel, X: torch.Tensor) -> torch.Tensor:
    """(N, F) → (N, C) float32 margins: a single full-float32 product."""
    full_f32()
    return X.to(torch.float32) @ model.coef.T + model.intercept


def predict(model: LinearModel, X: torch.Tensor) -> torch.Tensor:
    """Class indices. Binary models use the sklearn (df > 0) rule."""
    df = decision_function(model, X)
    if model.coef.shape[0] == 1:
        return (df[:, 0] > 0).to(torch.int32)
    return torch.argmax(df, dim=1).to(torch.int32)


def _normalize(p: torch.Tensor) -> torch.Tensor:
    """Rows summed to one; uniform where every entry underflowed."""
    total = p.sum(dim=1, keepdim=True)
    pos = total > 0
    uniform = torch.full_like(p, 1.0 / p.shape[1])
    return torch.where(
        pos, p / torch.where(pos, total, torch.ones_like(total)), uniform
    )


def proba_from_decision(df: torch.Tensor) -> torch.Tensor:
    """OvA margins → probabilities, SGDClassifier(loss='log') semantics.

    Multiclass: per-class sigmoid normalized to sum one (uniform when
    all sigmoids underflow). Binary (one column): plain sigmoid pair.
    """
    if df.shape[1] == 1:
        p1 = torch.sigmoid(df[:, 0])
        return torch.stack([1.0 - p1, p1], dim=1)
    return _normalize(torch.sigmoid(df))


def calibrated_from_decision(
    df: torch.Tensor, calib: SigmoidCalibration
) -> torch.Tensor:
    """OvR margins → calibrated probabilities (prefit-sigmoid
    CalibratedClassifierCV semantics)."""
    p = 1.0 / (1.0 + torch.exp(calib.a * df + calib.b))
    if df.shape[1] == 1:
        return torch.cat([1.0 - p, p], dim=1)
    return _normalize(p)


def predict_proba_log_loss(model: LinearModel, X: torch.Tensor) -> torch.Tensor:
    """Probabilities with sklearn SGDClassifier(loss='log') semantics."""
    return proba_from_decision(decision_function(model, X))


def predict_proba_calibrated(
    model: LinearModel, calib: SigmoidCalibration, X: torch.Tensor
) -> torch.Tensor:
    """CalibratedClassifierCV(cv='prefit', sigmoid) semantics."""
    return calibrated_from_decision(decision_function(model, X), calib)
