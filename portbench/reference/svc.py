"""Plain reference of the kernel-SVM configuration: libsvm's
SVC(probability=True) scoring (the reference's train.py:442-545 with
`--use_svc`): the RBF kernel against the support vectors, one-vs-one
decisions in libsvm's dual layout, pairwise Platt sigmoids, and
Wu-Lin-Weng pairwise coupling (libsvm's multiclass_probability), then the
min_proba threshold."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference.linear import decide


def pair_coef(dual: torch.Tensor, n_support) -> torch.Tensor:
    """(n_pairs, n_sv) coefficients of the pairs (i, j), i < j, from
    libsvm's (k - 1, n_sv) dual_coef: dual[j - 1] over class i's vectors
    and dual[i] over class j's."""
    k = len(n_support)
    starts = [0]
    for n in n_support:
        starts.append(starts[-1] + int(n))
    rows = []
    for i in range(k):
        for j in range(i + 1, k):
            w = torch.zeros(dual.shape[1], dtype=dual.dtype, device=dual.device)
            w[starts[i]:starts[i + 1]] = dual[j - 1, starts[i]:starts[i + 1]]
            w[starts[j]:starts[j + 1]] = dual[i, starts[j]:starts[j + 1]]
            rows.append(w)
    return torch.stack(rows)


def couple(r: torch.Tensor, max_iter: int = 100) -> torch.Tensor:
    """libsvm's multiclass_probability over a batch: r (N, k, k) with
    r[i, j] = P(i | i or j) → p (N, k). Each sample iterates until
    max_t |(Qp)_t - pQp| < 0.005 / k, or max(100, k) times."""
    n, k, _ = r.shape
    eye = torch.eye(k, dtype=torch.bool, device=r.device)
    rt = r.transpose(1, 2)
    Q = torch.where(eye, (rt * rt).masked_fill(eye, 0).sum(2, keepdim=True).expand(n, k, k),
                    -rt * r)
    p = torch.full((n, k), 1.0 / k, dtype=r.dtype, device=r.device)
    active = torch.ones(n, dtype=torch.bool, device=r.device)
    eps = 0.005 / k
    for _ in range(max(max_iter, k)):
        Qp = torch.einsum("ntj,nj->nt", Q, p)
        pQp = (p * Qp).sum(1)
        active &= (Qp - pQp[:, None]).abs().amax(1) >= eps
        if not bool(active.any()):
            break
        for t in range(k):
            diff = torch.where(active, (pQp - Qp[:, t]) / Q[:, t, t], 0.0)
            p = p.clone()
            p[:, t] += diff
            scale = 1.0 / (1.0 + diff)
            pQp = (pQp + diff * (diff * Q[:, t, t] + 2.0 * Qp[:, t])) * scale * scale
            Qp = (Qp + diff[:, None] * Q[:, t, :]) * scale[:, None]
            p = p * scale[:, None]
    return p / p.sum(1, keepdim=True)


def answers(feats: torch.Tensor, model: dict, valid: torch.Tensor, min_proba: float,
            rounding: Optional[Callable] = None):
    """(pred (N,), proba (N, k)) of (N, F) features under the model's
    support_vectors (n_sv, F), dual_coef, intercept, n_support, gamma,
    probA and probB, in the features' dtype. `rounding`, where given,
    rounds both operands of every product (a lower-precision control)."""
    dt, dev = feats.dtype, feats.device
    rnd = rounding or (lambda t: t)

    def t(name):
        return torch.as_tensor(model[name], dtype=dt, device=dev)

    S = t("support_vectors")
    d2 = ((feats * feats).sum(1)[:, None] + (S * S).sum(1)[None, :]
          - 2.0 * (rnd(feats) @ rnd(S).T))
    K = torch.exp(-float(model["gamma"]) * torch.clamp(d2, min=0.0))
    dec = rnd(K) @ rnd(pair_coef(t("dual_coef"), model["n_support"])).T + t("intercept")
    fApB = dec * t("probA") + t("probB")
    pij = torch.where(fApB >= 0, torch.exp(-fApB) / (1.0 + torch.exp(-fApB)),
                      1.0 / (1.0 + torch.exp(fApB)))
    pij = torch.clamp(pij, 1e-7, 1.0 - 1e-7)
    k = len(model["n_support"])
    r = torch.zeros((feats.shape[0], k, k), dtype=dt, device=dev)
    p = 0
    for i in range(k):
        for j in range(i + 1, k):
            r[:, i, j] = pij[:, p]
            r[:, j, i] = 1.0 - pij[:, p]
            p += 1
    proba = couple(r)
    return decide(proba, valid, min_proba), proba
