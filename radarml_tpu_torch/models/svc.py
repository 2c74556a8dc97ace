"""Kernel SVM (SVC) family on PyTorch: scoring and SMO training.

Port of radarml_tpu/models/svc.py, the reference's
`svm.SVC(probability=True, class_weight='balanced')` path:

* **Scoring** — the kernel between queries and support vectors is the
  fused RBF Gram matrix (ops/rbf.py: the hand-written CUDA kernel on the
  card, its plain version on the CPU) or, for the linear kind, one
  float32 product; the one-vs-one pair decisions are a second product
  against the (n_pairs, n_sv) coefficient matrix. `predict` is libsvm
  pairwise voting; `predict_proba` is per-pair Platt sigmoids coupled
  with the Wu–Lin–Weng (2004) second method.
* **Training** — the maximal-violating-pair SMO dual solver, run for all
  one-vs-one pairs at once as a batched loop over a leading problem
  axis (the JAX package's `lax.while_loop` under `vmap`): a finished
  problem is frozen by a mask, and the host looks at the masks only
  every few iterations. The grid search's candidates, which differ only
  in C, share one Q along a leading candidate axis of the caps. Platt
  scaling fits on the same deterministic stratified folds as the JAX
  package.
* **Interop** — `from_numpy` carries a JAX-fitted SVC (as numpy arrays)
  across; `from_sklearn_svc` a fitted sklearn SVC, live or as the inert
  holder that apps/common_cli unpickles a reference pickle into without
  sklearn.

Float32 products run in full float32 (no TF32), as the JAX package
scores at Precision.HIGHEST.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.models.linear import full_f32
from radarml_tpu_torch.ops.rbf import rbf_gram

__all__ = [
    "SVCConfig",
    "SVCModel",
    "decision_function_ovo",
    "from_numpy",
    "from_sklearn_svc",
    "kernel_matrix",
    "platt_fit",
    "predict",
    "predict_proba",
    "svc_fit",
]

#: Iterations between the host's looks at the solvers' masks (each look
#: waits for the device); finished problems are frozen in between.
CHECK_EVERY = 64


# --------------------------------------------------------------------------
# Kernels
# --------------------------------------------------------------------------

def kernel_matrix(
    X: torch.Tensor, Y: torch.Tensor, kind: str, gamma: float
) -> torch.Tensor:
    """K(X, Y): the (n, m) Gram matrix. The rbf kind is the fused kernel
    (ops/rbf.rbf_gram) on every device; the linear kind is one float32
    product, as the JAX package leaves it to XLA."""
    X = X.to(torch.float32)
    Y = Y.to(torch.float32)
    if kind == "rbf":
        return rbf_gram(X.contiguous(), Y.contiguous(), gamma)
    if kind == "linear":
        full_f32()
        return X @ Y.T
    raise ValueError(f"unknown kernel {kind!r}")


# --------------------------------------------------------------------------
# Model container + scoring
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SVCModel:
    """Fitted OvO kernel SVM in the sklearn/libsvm layout.

    support_vectors: (n_sv, F); dual_coef: (k-1, n_sv) interleaved OvO
    coefficients; intercept: (n_pairs,); n_support: (k,) SV counts per
    class in class order; probA/probB: (n_pairs,) Platt parameters or
    None when fitted without probability. All tensors lie on one device.
    `fit_stats` holds the SMO iterations per problem when `svc_fit` made
    the model: {"pairs": [...], "platt": [...]}.
    """

    support_vectors: torch.Tensor
    dual_coef: torch.Tensor
    intercept: torch.Tensor
    n_support: Tuple[int, ...]
    kernel: str = "rbf"
    gamma: float = 0.01
    probA: Optional[torch.Tensor] = None
    probB: Optional[torch.Tensor] = None
    fit_stats: Optional[dict] = dataclasses.field(default=None, compare=False)

    @property
    def n_classes(self) -> int:
        return len(self.n_support)

    @property
    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        k = self.n_classes
        return tuple((i, j) for i in range(k) for j in range(i + 1, k))

    @property
    def device(self) -> torch.device:
        return self.support_vectors.device

    def to(self, device) -> "SVCModel":
        """The same model with its tensors on `device`."""
        device = torch.device(device)
        if device == self.device:
            return self

        def move(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self,
            support_vectors=move(self.support_vectors),
            dual_coef=move(self.dual_coef),
            intercept=move(self.intercept),
            probA=move(self.probA),
            probB=move(self.probB),
        )

    @functools.cached_property
    def pair_coef(self) -> torch.Tensor:
        """(n_pairs, n_sv) dense pairwise coefficient matrix, on the
        model's device.

        libsvm layout: SVs are grouped by class; for the pair (i, j)
        the decision uses dual_coef[j-1] over class-i SVs and
        dual_coef[i] over class-j SVs.
        """
        dual = self.dual_coef.detach().cpu().numpy()
        n_sv = dual.shape[1]
        starts = np.concatenate([[0], np.cumsum(self.n_support)])
        W = np.zeros((len(self.pairs), n_sv), dtype=np.float32)
        for p, (i, j) in enumerate(self.pairs):
            si, ei = starts[i], starts[i + 1]
            sj, ej = starts[j], starts[j + 1]
            W[p, si:ei] = dual[j - 1, si:ei]
            W[p, sj:ej] = dual[i, sj:ej]
        return torch.as_tensor(W, device=self.device)

    def fold(self) -> torch.Tensor:
        """`pair_coef`, folded now if it was not yet. Call it on the host
        before tracing a program that reads it: a traced call cannot run
        the numpy fold."""
        return self.pair_coef


def from_numpy(
    support_vectors,
    dual_coef,
    intercept,
    n_support,
    kernel: str = "rbf",
    gamma: float = 0.01,
    probA=None,
    probB=None,
    device: torch.device | str | None = None,
) -> SVCModel:
    """A JAX-fitted SVC's parameters (numpy arrays, as the JAX package's
    artifacts store them) → the port's float32 SVCModel on `device`
    (default: the CUDA card; pass "cpu" for the CPU)."""
    if (probA is None) != (probB is None):
        raise ValueError("probA and probB come together")
    dev = resolve_device(device)

    def f32(v):
        return None if v is None else torch.tensor(
            np.asarray(v, np.float32), device=dev
        )

    return SVCModel(
        support_vectors=f32(support_vectors),
        dual_coef=f32(dual_coef),
        intercept=f32(intercept),
        n_support=tuple(int(v) for v in n_support),
        kernel=str(kernel),
        gamma=float(gamma),
        probA=f32(probA),
        probB=f32(probB),
    )


def _first_attr(obj, *names):
    """The first of `names` that `obj` has: a public attribute, then the
    private twin that sklearn's pickled state stores under it."""
    for name in names:
        if hasattr(obj, name):
            return getattr(obj, name)
    raise AttributeError(f"{type(obj).__name__} has none of {names}")


def from_sklearn_svc(clf, device: torch.device | str | None = None) -> SVCModel:
    """A fitted sklearn.svm.SVC (or its unpickled holder) → the port's
    SVCModel on `device` (default: the CUDA card): serving parity for
    reference-trained pickles (reference predict.py:224-227).

    sklearn stores the binary problem with the decision negated (positive
    → classes_[1]); both dual_coef_ and intercept_ are negated back to the
    internal OvO convention (positive → the pair's first class), so
    scoring, voting and Platt orientation are the same for every k."""
    n_support = _first_attr(clf, "n_support_", "_n_support")
    probA = _first_attr(clf, "probA_", "_probA")
    probB = _first_attr(clf, "probB_", "_probB")
    dual = np.asarray(clf.dual_coef_, np.float32)
    intercept = np.asarray(clf.intercept_, np.float32)
    if len(n_support) == 2:
        dual, intercept = -dual, -intercept
    if probA is None or len(probA) == 0:
        probA = probB = None
    return from_numpy(
        clf.support_vectors_, dual, intercept, n_support, kernel=clf.kernel,
        gamma=float(_first_attr(clf, "_gamma", "gamma")), probA=probA, probB=probB,
        device=device,
    )


def decision_function_ovo(model: SVCModel, X) -> torch.Tensor:
    """(n, n_pairs) pairwise decisions on the model's device; positive
    favors the first class of the pair (sklearn
    `decision_function_shape='ovo'`)."""
    X = torch.as_tensor(X, dtype=torch.float32, device=model.device)
    K = kernel_matrix(X, model.support_vectors, model.kernel, model.gamma)
    full_f32()
    return K @ model.pair_coef.T + model.intercept[None, :]


def predict(model: SVCModel, X) -> torch.Tensor:
    """libsvm pairwise voting; ties go to the lower class index."""
    dec = decision_function_ovo(model, X)
    votes = torch.zeros(
        (dec.shape[0], model.n_classes), dtype=torch.int32, device=dec.device
    )
    for p, (i, j) in enumerate(model.pairs):
        win_i = (dec[:, p] > 0).to(torch.int32)
        votes[:, i] += win_i
        votes[:, j] += 1 - win_i
    # argmax returns the first maximum, as jnp.argmax does
    return torch.argmax(votes, dim=1).to(torch.int32)


def _pairwise_prob_matrix(model: SVCModel, dec: torch.Tensor) -> torch.Tensor:
    """(n, k, k) matrix r with r[i,j] = P(class i | {i,j}) via Platt."""
    if model.probA is None:
        raise ValueError("model fitted without probability estimates")
    fApB = dec * model.probA[None, :] + model.probB[None, :]
    # Numerically-stable sigmoid: P(first class) = 1 / (1 + exp(fApB)).
    pij = torch.where(
        fApB >= 0,
        torch.exp(-fApB) / (1.0 + torch.exp(-fApB)),
        1.0 / (1.0 + torch.exp(fApB)),
    )
    eps = 1e-7
    pij = torch.clamp(pij, eps, 1.0 - eps)
    k = model.n_classes
    r = torch.zeros((dec.shape[0], k, k), dtype=dec.dtype, device=dec.device)
    for p, (i, j) in enumerate(model.pairs):
        r[:, i, j] = pij[:, p]
        r[:, j, i] = 1.0 - pij[:, p]
    return r


def _couple_probabilities(
    r: torch.Tensor, max_iter: int = 100, check_every: int = 8
) -> torch.Tensor:
    """Wu–Lin–Weng (2004) second-method pairwise coupling.

    Solves min_p Σ_{i<j} (r_ji p_i − r_ij p_j)² over the simplex with
    the fixed-point iteration libsvm uses (Gauss–Seidel over classes),
    for a batch of samples at once. r: (n, k, k) → (n, k).

    libsvm stops a sample once max_t |Qp_t − pᵀQp| < 0.005/k; such a
    sample is frozen (its update is the identity), so the loop may stop
    as soon as no sample is active. That is checked every `check_every`
    iterations, each check waiting for the device once. While
    torch.export traces this (a serving artifact), that host branch
    cannot be recorded: all `max_iter` iterations run as one traced
    `while_loop` over a counter, as the JAX package's fori_loop does, and
    the frozen samples' identity updates give the same bits as the early
    stop.
    """
    n, k, _ = r.shape
    Q = torch.zeros((n, k, k), dtype=r.dtype, device=r.device)
    others = torch.arange(k, device=r.device)
    for t in range(k):
        # Q[t,t] = sum_{j != t} r[j,t]^2 ; Q[t,j] = -r[j,t] * r[t,j]
        Q[:, t, t] = torch.where(
            (others == t)[None, :], 0.0, r[:, :, t] ** 2
        ).sum(dim=1)
        for j in range(k):
            if j != t:
                Q[:, t, j] = -r[:, j, t] * r[:, t, j]
    diag = [torch.clamp(Q[:, t, t], min=1e-12) for t in range(k)]

    def measure(p):
        """Qp, pᵀQp and the samples still active."""
        Qp = torch.einsum("nkj,nj->nk", Q, p)
        pQp = torch.einsum("nk,nk->n", p, Qp)
        err = torch.amax(torch.abs(Qp - pQp[:, None]), dim=1)
        return Qp, pQp, err >= 0.005 / k

    def sweep(p, Qp, pQp, active):
        """One Gauss–Seidel pass over the classes; frozen samples keep p."""
        for t in range(k):
            diff = (-Qp[:, t] + pQp) / diag[t]
            diff = torch.where(active, diff, 0.0)
            p = p.clone()
            p[:, t] += diff
            scale = 1.0 / (1.0 + diff)
            pQp = (pQp + diff * (diff * Q[:, t, t] + 2.0 * Qp[:, t])) * scale**2
            Qp = (Qp + diff[:, None] * Q[:, t, :]) * scale[:, None]
            p = p * scale[:, None]
        return p

    p = torch.full((n, k), 1.0 / k, dtype=r.dtype, device=r.device)
    if torch.compiler.is_exporting():
        from torch._higher_order_ops.while_loop import while_loop

        _, p = while_loop(lambda it, p: it < max_iter,
                          lambda it, p: (it + 1, sweep(p, *measure(p))),
                          (torch.zeros((), dtype=torch.int64), p))
    else:
        for it in range(max_iter):
            Qp, pQp, active = measure(p)
            if it % check_every == 0 and not bool(active.any()):
                break
            p = sweep(p, Qp, pQp, active)
    return p / torch.sum(p, dim=1, keepdim=True)


def predict_proba(model: SVCModel, X) -> torch.Tensor:
    """(n, k) class probabilities (sklearn SVC.predict_proba math)."""
    dec = decision_function_ovo(model, X)
    return _couple_probabilities(_pairwise_prob_matrix(model, dec))


# --------------------------------------------------------------------------
# SMO dual solver (maximal violating pair, batched over problems)
# --------------------------------------------------------------------------

class _SMOResult(NamedTuple):
    alpha: torch.Tensor  # (P, m) box-constrained duals
    rho: torch.Tensor  # (P,); intercept = -rho
    n_iter: torch.Tensor  # (P,) iterations each problem ran


def _smo_kernel_solve(
    Q: torch.Tensor,  # (P, m, m) y_i y_j K_ij with zero-C padding rows/cols
    y: torch.Tensor,  # (P, m) ±1 (padding arbitrary)
    C: torch.Tensor,  # (P, m) or (nC, P, m) per-sample box caps (0 for padding)
    eps: float,
    max_iter: int,
    check_every: int = CHECK_EVERY,
) -> _SMOResult:
    """Solve min ½αᵀQα − eᵀα, 0≤α≤C, yᵀα=0 for P problems at once by
    maximal-violating-pair SMO.

    With caps of shape (nC, P, m) the nC × P problems share Q and y
    along the leading axis (the grid search's candidates differ only in
    C): Q is read in place, never copied per candidate, and the result's
    fields carry the leading (nC, P) axes.

    Each iteration is O(m) vector work per problem (two gradient rank-1
    updates and two masked argmax reductions). As in the JAX package's
    vmapped while_loop, a problem runs while `it < max_iter` and the
    previous iteration's gap exceeds `eps` (the iteration that finds the
    gap below `eps` still applies its update), and a problem that has
    stopped is frozen by a mask while the others go on. The host reads
    the masks every `check_every` iterations and stops when none is
    active. Padded entries have C=0, so they never enter the working set.
    """
    lead = C.shape[:-1]
    if C.dim() == 3:
        C = C.reshape(-1, C.shape[-1])
        y = y.repeat(lead[0], 1)
    P, m = y.shape
    dev, dt = Q.device, Q.dtype
    NEG, POS = -1e30, 1e30
    rows = torch.arange(P, device=dev)
    # each problem's Q: its own, or the one it shares with other candidates
    q_rows = rows if Q.shape[0] == P else rows % Q.shape[0]
    alpha = torch.zeros((P, m), dtype=dt, device=dev)
    grad = torch.full((P, m), -1.0, dtype=dt, device=dev)
    it = torch.zeros((P,), dtype=torch.int64, device=dev)
    gap = torch.full((P,), float("inf"), dtype=dt, device=dev)
    y_pos, y_neg = y > 0, y < 0

    step = 0
    while True:
        active = (it < max_iter) & (gap > eps)
        if step % check_every == 0 and not bool(active.any()):
            break
        step += 1
        ygrad = -y * grad
        in_up = (y_pos & (alpha < C)) | (y_neg & (alpha > 0))
        in_low = (y_pos & (alpha > 0)) | (y_neg & (alpha < C))
        up_vals = torch.where(in_up, ygrad, NEG)
        low_vals = torch.where(in_low, ygrad, POS)
        i = torch.argmax(up_vals, dim=1)
        j = torch.argmin(low_vals, dim=1)
        new_gap = up_vals[rows, i] - low_vals[rows, j]

        yi, yj = y[rows, i], y[rows, j]
        Qi, Qj = Q[q_rows, i], Q[q_rows, j]  # (P, m) rows of the working pair
        Qii, Qjj, Qij = Qi[rows, i], Qj[rows, j], Qi[rows, j]
        ai, aj = alpha[rows, i], alpha[rows, j]
        Ci, Cj = C[rows, i], C[rows, j]
        gi, gj = grad[rows, i], grad[rows, j]

        same = yi == yj
        quad = torch.where(same, Qii + Qjj - 2.0 * Qij, Qii + Qjj + 2.0 * Qij)
        quad = torch.clamp(quad, min=1e-12)
        # same-sign: alpha_i - delta, alpha_j + delta keeps the sum.
        delta_same = (gi - gj) / quad
        # diff-sign: alpha_i + delta, alpha_j + delta keeps the difference.
        delta_diff = (-gi - gj) / quad
        ai_new = torch.where(same, ai - delta_same, ai + delta_diff)

        # Project back onto the box along the constraint line.
        s = ai + aj
        d = ai - aj
        ai_s = torch.clamp(ai_new, torch.clamp(s - Cj, min=0.0), torch.minimum(Ci, s))
        ai_d = torch.clamp(ai_new, torch.clamp(d, min=0.0), torch.minimum(Ci, Cj + d))
        ai_new = torch.where(same, ai_s, ai_d)
        aj_new = torch.where(same, s - ai_s, ai_d - d)

        # A stopped problem keeps its state: its deltas are zero.
        ai_new = torch.where(active, ai_new, ai)
        aj_new = torch.where(active, aj_new, aj)
        grad = grad + Qi * (ai_new - ai)[:, None] + Qj * (aj_new - aj)[:, None]
        alpha = alpha.scatter(1, i[:, None], ai_new[:, None])
        alpha = alpha.scatter(1, j[:, None], aj_new[:, None])
        it = it + active.to(torch.int64)
        gap = torch.where(active, new_gap, gap)

    # rho: average -y*grad over free SVs; else midpoint of the bounds.
    ygrad = -y * grad
    free = (alpha > 1e-12) & (alpha < C - 1e-12) & (C > 0)
    n_free = free.sum(dim=1)
    in_up = (y_pos & (alpha < C)) | (y_neg & (alpha > 0))
    in_low = (y_pos & (alpha > 0)) | (y_neg & (alpha < C))
    ub = torch.amin(torch.where(in_low, ygrad, POS), dim=1)
    lb = torch.amax(torch.where(in_up, ygrad, NEG), dim=1)
    rho_free = torch.where(free, ygrad, 0.0).sum(dim=1) / torch.clamp(n_free, min=1)
    rho = torch.where(n_free > 0, rho_free, (ub + lb) / 2.0)
    return _SMOResult(alpha=alpha.reshape(lead + (m,)), rho=-rho.reshape(lead),
                      n_iter=it.reshape(lead))


# --------------------------------------------------------------------------
# Platt sigmoid fit (Lin–Weng–Keerthi Newton iteration)
# --------------------------------------------------------------------------

def platt_fit(dec: np.ndarray, y_pos: np.ndarray) -> Tuple[float, float]:
    """Fit P(y=1|dec) = 1/(1+exp(A*dec+B)) by regularized ML.

    Implements the Newton method with backtracking from Lin, Lin & Weng
    (2007), the algorithm libsvm's sigmoid_train uses, with the Platt
    prior-corrected targets. Host float64 numpy, as in the JAX package.
    """
    dec = np.asarray(dec, np.float64)
    y_pos = np.asarray(y_pos, bool)
    prior1, prior0 = float(y_pos.sum()), float((~y_pos).sum())
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = np.where(y_pos, hi, lo)

    A, B = 0.0, np.log((prior0 + 1.0) / (prior1 + 1.0))
    sigma = 1e-12

    def fval(A, B):
        fApB = dec * A + B
        return np.sum(
            np.where(
                fApB >= 0,
                t * fApB + np.log1p(np.exp(-fApB)),
                (t - 1.0) * fApB + np.log1p(np.exp(fApB)),
            )
        )

    f = fval(A, B)
    for _ in range(100):
        fApB = dec * A + B
        p = np.where(fApB >= 0, np.exp(-fApB) / (1 + np.exp(-fApB)),
                     1.0 / (1 + np.exp(fApB)))
        q = 1.0 - p
        d1 = t - p
        d2 = p * q
        g1 = float(np.sum(dec * d1))
        g2 = float(np.sum(d1))
        if abs(g1) < 1e-5 and abs(g2) < 1e-5:
            break
        h11 = float(np.sum(dec * dec * d2)) + sigma
        h22 = float(np.sum(d2)) + sigma
        h21 = float(np.sum(dec * d2))
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= 1e-10:
            newA, newB = A + step * dA, B + step * dB
            newf = fval(newA, newB)
            if newf < f + 1e-4 * step * gd:
                A, B, f = newA, newB, newf
                break
            step /= 2.0
        else:
            break
    return float(A), float(B)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SVCConfig:
    """Reference grid axes (train.py:472-477) + solver knobs."""

    C: float = 10.0
    kernel: str = "rbf"  # rbf | linear
    gamma: float = 0.01  # or "scale" / "auto", resolved against X
    class_weight: Optional[str] = "balanced"
    probability: bool = True
    eps: float = 1e-3
    max_iter: int = 200_000
    prob_folds: int = 5
    seed: int = 1234


def _resolve_gamma(gamma, X) -> float:
    """sklearn gamma rule; X may be a numpy array or a tensor. "scale"
    uses the population variance of all of X (numpy's `var`; for a
    tensor `var(correction=0)`, not torch's default sample variance)."""
    if isinstance(gamma, str):
        if gamma == "scale":
            var = X.var(correction=0) if isinstance(X, torch.Tensor) else X.var()
            return float(1.0 / (X.shape[1] * var))
        if gamma == "auto":
            return 1.0 / X.shape[1]
        raise ValueError(gamma)
    return float(gamma)


def _binary_weights(
    y: np.ndarray, classes: np.ndarray, class_weight: Optional[str]
) -> dict:
    if class_weight is None:
        return {int(c): 1.0 for c in classes}
    n = len(y)
    k = len(classes)
    return {
        int(c): n / (k * float((y == c).sum())) for c in classes
    }


def _problem_batch(K, idxb, yb, Cb):
    """Padded (P, m, m) SMO matrices y_i y_j K[idx_i, idx_j] on K's
    device; rows and columns of padding (C = 0) are zero."""
    dev = K.device
    idx = torch.as_tensor(idxb, dtype=torch.int64, device=dev)
    y_t = torch.as_tensor(yb, device=dev)
    C_t = torch.as_tensor(Cb, device=dev)
    valid = C_t > 0
    Ksub = K[idx[:, :, None], idx[:, None, :]]
    Ksub = torch.where(valid[:, :, None] & valid[:, None, :], Ksub, 0.0)
    return y_t[:, :, None] * y_t[:, None, :] * Ksub, idx, y_t, C_t


def _fit_pair_batch(
    K_full: torch.Tensor,
    y: np.ndarray,
    pairs: Sequence[Tuple[int, int]],
    class_idx: Sequence[np.ndarray],
    Cw: dict,
    C: float,
    eps: float,
    max_iter: int,
):
    """Solve all OvO pair QPs in one batched SMO call (padded)."""
    sizes = [len(class_idx[i]) + len(class_idx[j]) for i, j in pairs]
    m = max(sizes)
    nP = len(pairs)
    yb = np.ones((nP, m), np.float32)
    Cb = np.zeros((nP, m), np.float32)
    idxb = np.zeros((nP, m), np.int64)
    for p, (i, j) in enumerate(pairs):
        idx = np.concatenate([class_idx[i], class_idx[j]])
        s = len(idx)
        ypm = np.concatenate(
            [np.ones(len(class_idx[i])), -np.ones(len(class_idx[j]))]
        ).astype(np.float32)
        yb[p, :s] = ypm
        Cb[p, :s] = np.where(ypm > 0, C * Cw[i], C * Cw[j])
        idxb[p, :s] = idx
    Qb, _, y_t, C_t = _problem_batch(K_full, idxb, yb, Cb)
    res = _smo_kernel_solve(Qb, y_t, C_t, eps=eps, max_iter=max_iter)
    return res, idxb, sizes, yb


def svc_fit(
    X,
    y,
    cfg: SVCConfig = SVCConfig(),
    device: torch.device | str | None = None,
) -> SVCModel:
    """Fit an OvO kernel SVM with the batched SMO solver.

    Matches sklearn's SVC semantics: classes sorted, per-class
    balanced C, libsvm SV layout, rho→intercept sign, optional Platt
    probability calibration on deterministic stratified folds. X (numpy
    or tensor) is moved to `device` (default: where a tensor X lies, else
    the CUDA card; pass "cpu" for the CPU) and stays there with the Gram
    matrix and the solvers; only the dual solutions and held-out
    decisions come back to the host.
    """
    if device is None and isinstance(X, torch.Tensor):
        device = X.device
    Xd = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
    y = np.asarray(y)
    classes = np.unique(y)
    k = len(classes)
    y_enc = np.searchsorted(classes, y)
    gamma = _resolve_gamma(cfg.gamma, Xd)
    Cw = _binary_weights(y_enc, np.arange(k), cfg.class_weight)

    K_full = kernel_matrix(Xd, Xd, cfg.kernel, gamma)
    class_idx = [np.where(y_enc == c)[0] for c in range(k)]
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]

    res, idxb, sizes, yb = _fit_pair_batch(
        K_full, y_enc, pairs, class_idx, Cw, cfg.C, cfg.eps, cfg.max_iter
    )
    alphas = res.alpha.cpu().numpy()
    rhos = res.rho.cpu().numpy()

    # Collect SVs: union over pairs of samples with alpha > 0, grouped
    # by class in libsvm layout.
    alpha_by_pair = []
    for p, (i, j) in enumerate(pairs):
        s = sizes[p]
        idx = idxb[p, :s]
        a = alphas[p, :s] * yb[p, :s]
        alpha_by_pair.append(dict(zip(idx.tolist(), a.tolist())))

    is_sv = np.zeros(len(y), bool)
    for p, (i, j) in enumerate(pairs):
        for sample, a in alpha_by_pair[p].items():
            if abs(a) > 1e-10:
                is_sv[sample] = True
    sv_order = []
    n_support = []
    for c in range(k):
        members = [s for s in class_idx[c] if is_sv[s]]
        sv_order.extend(members)
        n_support.append(len(members))
    sv_pos = {s: i for i, s in enumerate(sv_order)}
    n_sv = len(sv_order)

    dual = np.zeros((k - 1, n_sv), np.float32)
    # dual_coef row r of a class-c SV holds its coefficient against the
    # r-th *other* class (libsvm interleaved layout).
    for p, (i, j) in enumerate(pairs):
        for sample, a in alpha_by_pair[p].items():
            if sample not in sv_pos:
                continue
            c = y_enc[sample]
            opp = j if c == i else i
            row = opp if opp < c else opp - 1
            dual[row, sv_pos[sample]] = a

    dev = Xd.device
    stats = {"pairs": res.n_iter.cpu().tolist()}
    model = SVCModel(
        support_vectors=Xd[torch.as_tensor(sv_order, dtype=torch.int64, device=dev)],
        dual_coef=torch.as_tensor(dual, device=dev),
        intercept=torch.as_tensor(-rhos, dtype=torch.float32, device=dev),
        n_support=tuple(n_support),
        kernel=cfg.kernel,
        gamma=gamma,
        fit_stats=stats,
    )

    if not cfg.probability:
        return model

    probA, probB, platt_iters = _fit_probabilities(
        Xd, y_enc, classes, pairs, class_idx, Cw, cfg, gamma, K_full=K_full
    )
    stats["platt"] = platt_iters
    return dataclasses.replace(
        model,
        probA=torch.as_tensor(probA, dtype=torch.float32, device=dev),
        probB=torch.as_tensor(probB, dtype=torch.float32, device=dev),
    )


def _fit_probabilities(
    X, y_enc, classes, pairs, class_idx, Cw, cfg, gamma, K_full=None
):
    """Per-pair Platt parameters from stratified-CV decision values.

    All (pair × prob-fold) binary sub-fits reuse the full Gram matrix on
    the device and solve as ONE batched SMO call; held-out decisions
    come from α against the resident Gram rows. The folds come from
    `np.random.default_rng(cfg.seed)` exactly as in the JAX package, so
    both packages fit on identical folds. Returns (probA, probB, SMO
    iterations per sub-fit).
    """
    rng = np.random.default_rng(cfg.seed)
    folds = cfg.prob_folds
    if K_full is None:
        K_full = kernel_matrix(X, X, cfg.kernel, gamma)
    K = K_full.to(torch.float32)

    # --- host: build the padded (pair, fold) problem batch -----------
    per_pair = []  # (idx, y_pos, fold_of)
    problems = []  # (pair_id, fold, tr_global, ypm, cvals, te_global)
    for pi, (i, j) in enumerate(pairs):
        idx = np.concatenate([class_idx[i], class_idx[j]])
        y_pos = np.concatenate(
            [np.ones(len(class_idx[i]), bool),
             np.zeros(len(class_idx[j]), bool)]
        )
        perm = rng.permutation(len(idx))
        fold_of = np.empty(len(idx), int)
        # Stratified round-robin assignment after a shuffle.
        for label in (True, False):
            members = perm[y_pos[perm] == label]
            fold_of[members] = np.arange(len(members)) % folds
        per_pair.append((idx, y_pos, fold_of))
        for f in range(folds):
            tr_m = fold_of != f
            te_m = fold_of == f
            if len(np.unique(y_pos[tr_m])) < 2 or not te_m.any():
                continue
            n_tr = int(tr_m.sum())
            cnt_i = int((y_pos & tr_m).sum())
            cnt_j = n_tr - cnt_i
            # class_weight='balanced' on the sub-fit's train set.
            if cfg.class_weight == "balanced":
                wi, wj = n_tr / (2.0 * cnt_i), n_tr / (2.0 * cnt_j)
            else:
                wi = wj = 1.0
            ypm = np.where(y_pos[tr_m], 1.0, -1.0).astype(np.float32)
            cvals = cfg.C * np.where(ypm > 0, wi, wj).astype(np.float32)
            problems.append(
                (pi, f, idx[tr_m], ypm, cvals, idx[te_m])
            )

    if not problems:
        return np.zeros(len(pairs)) - 1.0, np.zeros(len(pairs)), []

    m = max(len(p[2]) for p in problems)
    NP = len(problems)
    idxb = np.zeros((NP, m), np.int64)
    yb = np.ones((NP, m), np.float32)
    Cb = np.zeros((NP, m), np.float32)
    for q, (_pi, _f, tr, ypm, cvals, _te) in enumerate(problems):
        s = len(tr)
        idxb[q, :s] = tr
        yb[q, :s] = ypm
        Cb[q, :s] = cvals

    # --- device: one batched solve, then every sample's decision -----
    Qb, idx, y_t, C_t = _problem_batch(K, idxb, yb, Cb)
    res = _smo_kernel_solve(Qb, y_t, C_t, eps=cfg.eps, max_iter=cfg.max_iter)
    del Qb
    full_f32()
    coef = res.alpha * y_t  # (NP, m)
    dec = torch.einsum("qm,qmn->qn", coef, K[idx]) - res.rho[:, None]
    dec_all = dec.cpu().numpy()  # (NP, n); callers slice their test rows

    # --- scatter decisions back per pair, fit Platt -------------------
    dec_by_pair = [np.zeros(len(p[0])) for p in per_pair]
    pos_of = [
        {g: q for q, g in enumerate(p[0])} for p in per_pair
    ]
    for q, (pi, _f, _tr, _ypm, _cv, te) in enumerate(problems):
        local = np.asarray([pos_of[pi][g] for g in te])
        dec_by_pair[pi][local] = dec_all[q][te]
    probA, probB = [], []
    for pi, (idx_p, y_pos, _fold_of) in enumerate(per_pair):
        A, B = platt_fit(dec_by_pair[pi], y_pos)
        probA.append(A)
        probB.append(B)
    return np.array(probA), np.array(probB), res.n_iter.cpu().tolist()
