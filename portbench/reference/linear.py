"""Plain reference of the linear configuration: SGDClassifier one-vs-rest
margins under CalibratedClassifierCV's prefit sigmoid (the reference's
train.py:324-440 and predict.py:133-157), then the min_proba threshold."""

from __future__ import annotations

import torch

UNKNOWN = -1


def decide(proba: torch.Tensor, valid: torch.Tensor, min_proba: float):
    """(N, C) probabilities → (N,) class index, UNKNOWN below min_proba
    or for an empty slot."""
    best, pred = proba.max(1)
    return torch.where(valid & (best >= min_proba), pred, torch.full_like(pred, UNKNOWN))


def answers(feats: torch.Tensor, model: dict, valid: torch.Tensor, min_proba: float):
    """(pred (N,), proba (N, C)) of (N, F) features under the model's
    coef (C, F), intercept (C,) and sigmoid calibration a, b (C,), in
    the features' dtype."""
    dt, dev = feats.dtype, feats.device

    def t(name):
        return torch.as_tensor(model[name], dtype=dt, device=dev)

    dec = feats @ t("coef").T + t("intercept")
    p = 1.0 / (1.0 + torch.exp(t("calib_a") * dec + t("calib_b")))
    total = p.sum(1, keepdim=True)
    proba = torch.where(total > 0, p / torch.where(total > 0, total, 1.0),
                        torch.full_like(p, 1.0 / p.shape[1]))
    return decide(proba, valid, min_proba), proba
