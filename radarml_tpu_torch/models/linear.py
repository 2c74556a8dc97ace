"""Linear classifier family: scoring, calibration and SGD training.

Port of radarml_tpu/models/linear.py. Scoring is one float32 matrix
product; probabilities follow sklearn's SGDClassifier(loss='log') and
CalibratedClassifierCV(sigmoid, prefit) semantics; `from_numpy` converts
the JAX package's parameters (as numpy arrays) to the port's. Platt
calibration fits on the host in float64, as in the JAX package.

Training is per-sample one-vs-all SGD with sklearn's dynamics (the
'optimal' learning-rate schedule, L1/L2/elasticnet penalties with the
cumulative L1 of Tsuruoka et al., optional averaging), for many
(fold, candidate) fits at once along leading axes of the state, with
sklearn-style tol early stopping: a candidate that has stopped stays
frozen while the others go on. The walk over the samples is sequential.
The JAX package runs all of a fit's epochs as one XLA program; here one
epoch's walk is one `_Walk.epoch` call, captured on the card as a CUDA
graph once per (penalty, average, shape) and replayed for every epoch
(the permutation row and the active mask are static buffers filled
before each replay), and run eagerly on the CPU. The host reads the
stop state once an epoch. A capture that fails raises.

The epoch permutations come from `np.random.default_rng(seed)` as in the
JAX package, so both packages walk the samples in the same order.
`sgd_state_from_numpy` carries a JAX `SGDState` across.
`from_sklearn_linear` / `from_sklearn_calibrated` read a fitted sklearn
estimator's attributes, so they take a live sklearn object or the inert
holder that apps/common_cli unpickles a reference pickle into without
sklearn.

Float32 products on the card run in full float32: TF32 is switched off
(the JAX package computes at Precision.HIGHEST).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.parallel.mesh import check_mesh

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
    "from_sklearn_linear",
    "from_sklearn_calibrated",
    "full_f32",
    "fit_sigmoid_calibration",
    "calibrate_ovr",
    "SGDConfig",
    "SGDState",
    "WALK_LOG",
    "sgd_init",
    "sgd_state_from_numpy",
    "sgd_fit",
    "sgd_model",
    "sgd_fit_many",
    "sgd_fit_many_folds",
]

logger = logging.getLogger(__name__)


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


def from_sklearn_linear(clf, device: torch.device | str | None = None) -> LinearModel:
    """A fitted sklearn linear estimator (SGDClassifier, LogisticRegression,
    LinearSVC; or its unpickled holder) → the port's LinearModel on
    `device` (default: the CUDA card)."""
    return from_numpy(*_sklearn_coef(clf), device=device)[0]


def _sklearn_coef(clf):
    return np.asarray(clf.coef_), np.ravel(np.asarray(clf.intercept_))


def from_sklearn_calibrated(
    cal_clf, device: torch.device | str | None = None
) -> Tuple[LinearModel, SigmoidCalibration]:
    """sklearn's CalibratedClassifierCV(prefit, sigmoid) over a linear
    estimator, the artifact the reference pickles (train.py:729-731) →
    (LinearModel, SigmoidCalibration) on `device` (default: the CUDA card).

    Reads either spelling: `estimator` or `base_estimator`, a
    FrozenEstimator around it (sklearn >= 1.6's prefit), `calibrators`
    or `calibrators_`. Where sklearn's probabilities are not the ones
    this model computes it raises ValueError: several calibrated
    classifiers (sklearn averages them) or a calibrator without Platt's
    a_ / b_ (isotonic)."""
    ccs = list(cal_clf.calibrated_classifiers_)
    if len(ccs) != 1:
        raise ValueError(
            f"CalibratedClassifierCV holds {len(ccs)} calibrated classifiers, whose "
            "probabilities sklearn averages; only one (cv='prefit' or a "
            "FrozenEstimator) is a single linear model")
    cc = ccs[0]
    base = getattr(cc, "estimator", None) or getattr(cc, "base_estimator", None)
    while base is not None and not hasattr(base, "coef_"):  # FrozenEstimator
        base = getattr(base, "estimator", None)
    if base is None:
        raise ValueError("the calibrated classifier wraps no linear estimator (no coef_)")
    calibrators = getattr(cc, "calibrators", None)
    if calibrators is None:
        calibrators = cc.calibrators_
    if not all(hasattr(c, "a_") and hasattr(c, "b_") for c in calibrators):
        raise ValueError("a calibrator lacks a_ / b_: only sigmoid (Platt) calibration "
                         "is a SigmoidCalibration, not isotonic")
    return from_numpy(*_sklearn_coef(base), [float(c.a_) for c in calibrators],
                      [float(c.b_) for c in calibrators], device=device)


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


# --------------------------------------------------------------------------
# Platt calibration (host, float64)
# --------------------------------------------------------------------------

def fit_sigmoid_calibration(
    df: np.ndarray, y: np.ndarray, max_iter: int = 100
) -> Tuple[float, float]:
    """Fit Platt scaling parameters (a, b) for one column.

    Implements Platt (1999) as refined by Lin/Weng/Keerthi (2007): a
    Newton iteration with backtracking on the regularized maximum
    likelihood objective, with Bayesian-prior targets. Host float64
    numpy, as in the JAX package; runs once per class on a validation
    split.
    """
    df = np.asarray(df, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    prior0 = float(np.sum(y <= 0))
    prior1 = float(y.shape[0] - prior0)
    T = np.where(y > 0, (prior1 + 1.0) / (prior1 + 2.0), 1.0 / (prior0 + 2.0))

    a, b = 0.0, float(np.log((prior0 + 1.0) / (prior1 + 1.0)))

    def nll(a_, b_):
        # P(y=1|f) = sigmoid(-(a f + b)); cross-entropy against targets T
        # simplifies to sum log(1+e^z) - (1-T) z with z = a f + b.
        z = a_ * df + b_
        lse = np.logaddexp(0.0, z)
        return float(np.sum(T * lse + (1.0 - T) * (lse - z)))

    sigma = 1e-12
    fval = nll(a, b)
    for _ in range(max_iter):
        z = a * df + b
        # NLL = sum log(1+e^z) - (1-T) z  →  dNLL/dz = sigmoid(z) - (1-T)
        s = 1.0 / (1.0 + np.exp(-z))
        d1 = s - (1.0 - T)
        d2 = s * (1.0 - s)
        grad_a = float(np.dot(d1, df))
        grad_b = float(np.sum(d1))
        h_aa = float(np.dot(d2, df * df)) + sigma
        h_bb = float(np.sum(d2)) + sigma
        h_ab = float(np.dot(d2, df))
        det = h_aa * h_bb - h_ab * h_ab
        if det == 0:
            break
        da = -(h_bb * grad_a - h_ab * grad_b) / det
        db = -(h_aa * grad_b - h_ab * grad_a) / det
        gd = grad_a * da + grad_b * db
        step = 1.0
        while step >= 1e-10:
            na, nb = a + step * da, b + step * db
            nf = nll(na, nb)
            if nf < fval + 1e-4 * step * gd:
                a, b, fval = na, nb, nf
                break
            step /= 2.0
        else:
            break
        if abs(gd) < 1e-12:
            break
    return float(a), float(b)


def calibrate_ovr(
    model: LinearModel, X_val, y_val: np.ndarray
) -> SigmoidCalibration:
    """Fit per-class sigmoid calibration on a validation split (the
    reference's CalibratedClassifierCV(cv='prefit') step). X_val (numpy
    or tensor) is scored on the model's device; the fits run on the host."""
    X = torch.as_tensor(X_val, dtype=torch.float32, device=model.coef.device)
    df = decision_function(model, X).cpu().numpy()
    y_val = np.asarray(y_val)
    n_ova = model.coef.shape[0]
    a_list, b_list = [], []
    for k in range(n_ova):
        y_bin = (y_val == (1 if n_ova == 1 else k)).astype(np.float64)
        a, b = fit_sigmoid_calibration(df[:, k], y_bin)
        a_list.append(a)
        b_list.append(b)
    dev = model.coef.device
    return SigmoidCalibration(
        a=torch.tensor(a_list, dtype=torch.float32, device=dev),
        b=torch.tensor(b_list, dtype=torch.float32, device=dev),
    )


# --------------------------------------------------------------------------
# SGD training (sklearn-compatible dynamics)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SGDConfig:
    """Hyperparameters mirroring sklearn.linear_model.SGDClassifier
    (the reference's grid axes, train.py:356-367)."""

    alpha: float = 1e-4
    penalty: str = "l2"  # l1 | l2 | elasticnet
    l1_ratio: float = 0.15
    max_iter: int = 1000
    average: bool = False
    tol: float = 1e-3
    fit_intercept: bool = True


class SGDState(NamedTuple):
    """Optimizer state; every field may carry leading (fold, candidate)
    axes."""

    coef: torch.Tensor  # (C, F)
    intercept: torch.Tensor  # (C,)
    t: torch.Tensor  # scalar step counter
    q: torch.Tensor  # (C, F) cumulative-L1 credit
    u: torch.Tensor  # scalar cumulative-L1 budget
    avg_coef: torch.Tensor
    avg_intercept: torch.Tensor


def _init_t(alpha: float) -> float:
    """sklearn's 'optimal' schedule initialization (Bottou heuristic)."""
    typw = np.sqrt(1.0 / np.sqrt(alpha))
    # dloss of log loss at (-typw, +1) has magnitude < 1, so eta0 = typw.
    eta0 = typw / max(1.0, 1.0 / (1.0 + np.exp(typw)))
    return 1.0 / (eta0 * alpha)


def _l1_ratio(penalty: str, l1_ratio: float) -> float:
    """The L1 share a penalty applies (l2: 0, l1: 1)."""
    if penalty == "elasticnet":
        return l1_ratio
    return 1.0 if penalty == "l1" else 0.0


#: The walk's product runs over blocks of this many folds (the reference's
#: five CV folds make one block): one shape whatever the fold count.
_FOLD_BLOCK = 5


def _zeros_state(lead: Tuple[int, ...], n_ova: int, n_features: int, t,
                 device) -> SGDState:
    z = torch.zeros(lead + (n_ova, n_features), dtype=torch.float32, device=device)
    zi = torch.zeros(lead + (n_ova,), dtype=torch.float32, device=device)
    return SGDState(
        coef=z, intercept=zi,
        t=torch.as_tensor(t, dtype=torch.float32, device=device).expand(lead).clone(),
        q=z.clone(), u=torch.zeros(lead, dtype=torch.float32, device=device),
        avg_coef=z.clone(), avg_intercept=zi.clone(),
    )


def sgd_init(
    n_classes: int, n_features: int, cfg: SGDConfig,
    device: torch.device | str | None = None,
) -> SGDState:
    """A fresh state on `device` (default: the CUDA card; pass "cpu")."""
    n_ova = 1 if n_classes == 2 else n_classes
    return _zeros_state((), n_ova, n_features, np.float32(_init_t(cfg.alpha)),
                        resolve_device(device))


def sgd_state_from_numpy(state, device: torch.device | str | None = None) -> SGDState:
    """A JAX `SGDState` (or anything with its seven fields, as arrays)
    → the port's float32 SGDState on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    return SGDState(*(
        torch.tensor(np.asarray(getattr(state, f), np.float32), device=dev)
        for f in SGDState._fields
    ))


def sgd_model(state: SGDState, cfg: SGDConfig) -> LinearModel:
    if cfg.average:
        return LinearModel(coef=state.avg_coef, intercept=state.avg_intercept)
    return LinearModel(coef=state.coef, intercept=state.intercept)


#: One record per fit the walk ran, appended by every fit: penalty,
#: average, the (folds, candidates, n, F) shape, epochs run, whether the
#: epochs replayed a CUDA graph, and the fit's seconds (host clock, the
#: copies in and out and any capture included). Callers clear it.
WALK_LOG: List[dict] = []


class _Walk:
    """One epoch of per-sample SGD for (folds, candidates) fits at once.

    Owns static buffers: the fold training sets X (folds, n, F; in whole
    blocks of folds, see __init__) and y (folds, n), the permutation row,
    the per-candidate schedule constants, the state with leading
    (folds, k) axes and, for early stopping, the active mask and each
    fit's summed epoch loss. `epoch`
    walks the samples in the permutation's order; with `masked`, a fit
    whose mask is off keeps the state it had before the epoch (the JAX
    package's masked while_loop). On the card the epoch is captured as
    a CUDA graph at its first call and replayed after.
    """

    def __init__(self, penalty, average, n_classes, folds, k, n, F, device, masked):
        dev = torch.device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.penalty, self.average, self.masked = penalty, average, masked
        self.use_l1 = penalty in ("l1", "elasticnet")
        self.n_ova = 1 if n_classes == 2 else n_classes
        self.shape = (folds, k, n, F)
        self.device = dev
        # The fold stacks X and coef are held in whole blocks of
        # _FOLD_BLOCK folds (the folds past `folds` stay zero), which
        # _sample's product reads: one shape for any fold count.
        blocks = -(-folds // _FOLD_BLOCK) * _FOLD_BLOCK
        self.X = torch.zeros((blocks, n, F), **f32)
        self.y = torch.zeros((folds, n), dtype=torch.int64, device=dev)
        self.perm = torch.zeros((n,), dtype=torch.int64, device=dev)
        self.alpha = torch.zeros((k,), **f32)
        self.l1r = torch.zeros((k,), **f32)
        self.t0 = torch.zeros((k,), **f32)
        coef = torch.zeros((blocks, k * self.n_ova, F), **f32)
        self.coef_blocks = coef.split(_FOLD_BLOCK)
        self.state = _zeros_state((folds, k), self.n_ova, F, 0.0, dev)._replace(
            coef=coef[:folds].view(folds, k, self.n_ova, F))
        self.old = _zeros_state((folds, k), self.n_ova, F, 0.0, dev)
        self.active = torch.ones((folds, k), dtype=torch.bool, device=dev)
        self.sumloss = torch.zeros((folds, k), **f32)
        self.classes = torch.arange(self.n_ova, device=dev)
        self.graph = None

    def load(self, X, y, alphas, l1rs, t0s, state: SGDState) -> None:
        self.X[:len(y)].copy_(X)
        self.y.copy_(y)
        self.alpha.copy_(alphas)
        self.l1r.copy_(l1rs)
        self.t0.copy_(t0s)
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        self.active.fill_(True)

    def _sample(self, s: int) -> None:
        """The update for the permutation's s-th sample, in place."""
        st = self.state
        p = self.perm[s:s + 1]
        rows = self.X.index_select(1, p)  # (blocks, 1, F)
        x = rows[:st.coef.shape[0], 0]  # (folds, F)
        yv = self.y.index_select(1, p)  # (folds, 1)
        if self.n_ova == 1:
            y_ova = torch.where(yv == 1, 1.0, -1.0)
        else:
            y_ova = torch.where(self.classes[None, :] == yv, 1.0, -1.0)
        y_ova = y_ova[:, None, :]  # (folds, 1, C)
        alpha = self.alpha
        eta = 1.0 / (alpha * st.t)  # (folds, k)
        folds, k, C, F = st.coef.shape
        # One batched product a block of folds, of one shape and layout
        # whatever the fold count: a batched product picks its route by the
        # batch count (a lone fold's took another on the CPU), and a fold's
        # bits must not depend on how many folds share the walk.
        xs = rows.view(len(rows), F, 1).split(_FOLD_BLOCK)
        dots = [torch.bmm(c, xb) for c, xb in zip(self.coef_blocks, xs)]
        dots = dots[0] if len(dots) == 1 else torch.cat(dots)
        margin = (dots[:folds].view(folds, k, C) + st.intercept) * y_ova
        if self.masked:
            # sklearn's sumloss: each sample's loss at the weights before
            # its update
            self.sumloss.add_(torch.logaddexp(-margin, torch.zeros_like(margin)).sum(-1))
        # log-loss gradient wrt margin: -y / (1 + exp(margin))
        g = -y_ova / (1.0 + torch.exp(torch.clamp(margin, -30.0, 30.0)))
        # L2 shrink before the gradient step, as sklearn does via wscale
        st.coef.mul_((1.0 - eta * alpha * (1.0 - self.l1r))[..., None, None])
        eta_g = eta[..., None] * g  # (folds, k, C)
        st.coef.sub_(eta_g[..., None] * x[:, None, None, :])
        st.intercept.sub_(eta_g)
        if self.use_l1:
            # Tsuruoka et al. cumulative L1 penalty
            st.u.add_(eta * alpha * self.l1r)
            u = st.u[..., None, None]
            z = st.coef
            new = torch.where(
                z > 0, torch.clamp(z - (u + st.q), min=0.0),
                torch.where(z < 0, torch.clamp(z + (u - st.q), max=0.0), z),
            )
            st.q.add_(new - z)
            st.coef.copy_(new)
        if self.average:
            # uniform average over all steps seen so far
            w = 1.0 / (st.t - self.t0 + 1.0)
            st.avg_coef.add_(w[..., None, None] * (st.coef - st.avg_coef))
            st.avg_intercept.add_(w[..., None] * (st.intercept - st.avg_intercept))
        st.t.add_(1.0)

    def _epoch_body(self) -> None:
        if self.masked:
            for dst, src in zip(self.old, self.state):
                dst.copy_(src)
            self.sumloss.zero_()
        for s in range(self.shape[2]):
            self._sample(s)
        if self.masked:
            for field, old in zip(self.state, self.old):
                m = self.active.view(self.active.shape + (1,) * (field.dim() - 2))
                field.copy_(torch.where(m, field, old))

    def _capture(self) -> None:
        full_f32()
        # the warm-up step updates the loaded state: keep it aside
        saved = [t.clone() for t in (*self.state, self.sumloss)]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._sample(0)  # warm-up: cuBLAS handles, workspaces
        torch.cuda.current_stream(self.device).wait_stream(side)
        for dst, src in zip((*self.state, self.sumloss), saved):
            dst.copy_(src)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._epoch_body()
        self.graph = graph

    def epoch(self, perm: np.ndarray, capture: bool = True) -> None:
        """One pass in `perm`'s order. On the card it replays the captured
        graph (`capture=False` walks eagerly, to compare the two); on the
        CPU it walks eagerly."""
        full_f32()
        self.perm.copy_(torch.from_numpy(np.asarray(perm, np.int64)))
        if self.device.type == "cuda" and capture:
            if self.graph is None:
                self._capture()
            self.graph.replay()
        else:
            self._epoch_body()


_WALKS: Dict[tuple, _Walk] = {}
_MAX_WALKS = 8


def _walk_for(penalty, average, n_classes, shape, device, masked) -> _Walk:
    """The cached walk (and its captured graph) for this configuration."""
    key = (penalty, bool(average), n_classes, shape, str(device), masked)
    walk = _WALKS.pop(key, None)
    if walk is None:
        walk = _Walk(penalty, bool(average), n_classes, *shape, device, masked)
    _WALKS[key] = walk  # most recently used last
    while len(_WALKS) > _MAX_WALKS:
        _WALKS.pop(next(iter(_WALKS)))
    return walk


def _run_walk(
    Xs: torch.Tensor,
    ys: torch.Tensor,
    n_classes: int,
    penalty: str,
    average: bool,
    alphas: np.ndarray,
    l1rs: np.ndarray,
    t0s: np.ndarray,
    state: SGDState,
    perms,
    tol: Optional[float],
    n_iter_no_change: int,
) -> SGDState:
    """Run `perms` (an iterable of epoch permutations) over the
    (folds, k) fits of `state`; with `tol`, sklearn-style early stopping
    per fit. Returns a new state with the same leading axes."""
    t_start = time.perf_counter()
    dev = Xs.device
    folds, n, F = Xs.shape
    k = len(alphas)
    masked = tol is not None
    walk = _walk_for(penalty, average, n_classes, (folds, k, n, F), dev, masked)
    walk.load(Xs, ys, torch.as_tensor(alphas), torch.as_tensor(l1rs),
              torch.as_tensor(t0s), state)
    if masked:
        best = torch.full((folds, k), float("inf"), dtype=torch.float32, device=dev)
        stale = torch.zeros((folds, k), dtype=torch.int32, device=dev)
    epochs = 0
    for perm in perms:
        walk.epoch(perm)
        epochs += 1
        if masked:
            # sklearn stopping: no improvement beyond tol for
            # n_iter_no_change consecutive epochs
            active = walk.active
            loss = walk.sumloss / n
            no_improve = loss > best - tol
            stale = torch.where(active & no_improve, stale + 1,
                                torch.where(active, torch.zeros_like(stale), stale))
            best = torch.where(active, torch.minimum(best, loss), best)
            active &= stale < n_iter_no_change
            if not bool(active.any()):  # the host's one look an epoch
                break
    out = SGDState(*(f.clone() for f in walk.state))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    WALK_LOG.append({
        "penalty": penalty, "average": bool(average), "shape": (folds, k, n, F),
        "epochs": epochs, "graph": dev.type == "cuda",
        "seconds": time.perf_counter() - t_start,
    })
    return out


def _perms(rng: np.random.Generator, n: int, epochs: int, shuffle: bool = True):
    for _ in range(epochs):
        yield rng.permutation(n) if shuffle else np.arange(n)


def _as_f32(X, device) -> torch.Tensor:
    if device is None and isinstance(X, torch.Tensor):
        device = X.device
    return torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))


def sgd_fit(
    X,
    y,
    n_classes: int,
    cfg: SGDConfig = SGDConfig(),
    epochs: Optional[int] = None,
    seed: int = 1234,
    state: Optional[SGDState] = None,
    shuffle: bool = True,
    device: torch.device | str | None = None,
) -> SGDState:
    """Fit (or continue fitting) the OvA SGD classifier.

    With `state` given this is the online-learning / partial_fit path
    (reference train.py:409-416); otherwise a fresh fit. `epochs`
    defaults to the uncapped sklearn heuristic max(1e6/n, 1000), the
    reference's online-learning iteration count (train.py:414). X (numpy
    or tensor) is moved to `device` (default: where a tensor X lies, else
    the CUDA card; pass "cpu" for the CPU).
    """
    Xd = _as_f32(X, device)
    dev = Xd.device
    y_t = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=dev)
    n = Xd.shape[0]
    if epochs is None:
        epochs = int(max(np.ceil(10**6 / n), 1000))
    if state is None:
        state = sgd_init(n_classes, Xd.shape[1], cfg, device=dev)
    state1 = SGDState(*(torch.as_tensor(f, dtype=torch.float32, device=dev)[None, None]
                        for f in state))
    l1r = np.asarray([_l1_ratio(cfg.penalty, cfg.l1_ratio)], np.float32)
    out = _run_walk(
        Xd[None], y_t[None], n_classes, cfg.penalty, cfg.average,
        np.asarray([cfg.alpha], np.float32), l1r,
        np.asarray([_init_t(cfg.alpha)], np.float32), state1,
        _perms(np.random.default_rng(seed), n, epochs, shuffle), None, 0,
    )
    return SGDState(*(f[0, 0] for f in out))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _many_state(lead, n_classes, n_features, t0s, device) -> SGDState:
    n_ova = 1 if n_classes == 2 else n_classes
    st = _zeros_state(lead, n_ova, n_features, 0.0, device)
    return st._replace(t=torch.as_tensor(t0s, device=device).expand(lead).clone())


def sgd_fit_many(
    X,
    y,
    n_classes: int,
    penalty: str,
    average: bool,
    alphas: Sequence[float],
    l1_ratios: Sequence[float],
    epochs: Optional[int] = None,
    seed: int = 1234,
    tol: Optional[float] = None,
    n_iter_no_change: int = 5,
    device: torch.device | str | None = None,
) -> SGDState:
    """Train many hyperparameter candidates at once, sharing (penalty,
    average): per-candidate results equal sequential `sgd_fit`s (same
    seed, same shuffles).

    With `tol`, each candidate early-stops sklearn-style: when its mean
    epoch training loss fails to improve on its best by more than tol
    for `n_iter_no_change` consecutive epochs, its state freezes while
    the rest continue. As in the JAX package, the criterion aggregates
    the OvA classes' losses per candidate.

    Returns an SGDState whose leading axis indexes candidates.
    """
    st = sgd_fit_many_folds(
        _as_f32(X, device)[None], np.asarray(y)[None], n_classes, penalty, average,
        alphas, l1_ratios, epochs=epochs, seed=seed, tol=tol,
        n_iter_no_change=n_iter_no_change, device=device,
    )
    return SGDState(*(f[0] for f in st))


def sgd_fit_many_folds(
    Xs,
    ys,
    n_classes: int,
    penalty: str,
    average: bool,
    alphas: Sequence[float],
    l1_ratios: Sequence[float],
    epochs: Optional[int] = None,
    seed: int = 1234,
    tol: Optional[float] = None,
    n_iter_no_change: int = 5,
    mesh=None,
    device: torch.device | str | None = None,
) -> SGDState:
    """`sgd_fit_many` over a leading fold axis: the whole cross-validation
    of one penalty group, every fold × every candidate, in one walk.

    Args:
        Xs: (folds, n, F) stacked fold training sets (equal-size), numpy
            or a tensor (its device is the default).
        ys: (folds, n) labels.
        mesh: a parallel.mesh.Mesh: the folds shard over its data ranks
            (the last fold repeated up to a multiple of their count, the
            copies dropped) and every rank returns every fold. A fold's
            walk is the same bits whatever stack it is in, so the sharded
            result equals the single-device one.

    Returns an SGDState with leading axes (folds, candidates).
    """
    if check_mesh(mesh) is not None:
        n_out = len(ys)
        order = mesh.padded_rows(n_out)
        if isinstance(Xs, torch.Tensor):
            Xs = Xs.index_select(0, torch.as_tensor(order, device=Xs.device))
        else:
            Xs = np.asarray(Xs)[order]
        local = sgd_fit_many_folds(
            Xs, _host(ys)[order], n_classes, penalty, average, alphas, l1_ratios,
            epochs=epochs, seed=seed, tol=tol, n_iter_no_change=n_iter_no_change,
            device=mesh.device if device is None else device)
        return SGDState(*(mesh.all_gather(f)[:n_out] for f in local))
    Xs = _as_f32(Xs, device)
    dev = Xs.device
    ys = torch.as_tensor(ys, dtype=torch.int64, device=dev)
    folds, n = ys.shape
    if epochs is None:
        epochs = int(min(max(np.ceil(10**6 / n), 5), 300))
    alphas_np = np.asarray(alphas, np.float32)
    l1rs = np.asarray(l1_ratios, np.float32)
    t0s = np.asarray([_init_t(float(a)) for a in alphas_np], np.float32)
    state = _many_state((folds, len(alphas_np)), n_classes, Xs.shape[2], t0s, dev)
    return _run_walk(
        Xs, ys, n_classes, penalty, average, alphas_np, l1rs, t0s, state,
        _perms(np.random.default_rng(seed), n, epochs), tol, n_iter_no_change,
    )
