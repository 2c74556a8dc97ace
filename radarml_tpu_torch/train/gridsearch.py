"""Grid search + stratified K-fold harness for the classical families.

Port of radarml_tpu/train/gridsearch.py, the reference's
`find_best_sgd_svm_estimator` / `find_best_svm_estimator` (reference
train.py:350-381, 462-491): exhaustive search over the same
hyperparameter grids with 5-fold stratified cross-validation, selecting
the best mean validation accuracy (ties to the earliest grid entry, as
GridSearchCV ranks), then refitting on the full training set.

The fold splitter reproduces sklearn's `StratifiedKFold` assignment
exactly (no shuffle, as the reference constructs it) and the grid
enumeration matches sklearn's `ParameterGrid`: list-of-dicts order, keys
sorted, last key cycling fastest.

* **SGD**: the candidates sharing a (penalty, average) group train as
  one walk over every fold × candidate (`models.linear.sgd_fit_many_folds`),
  with sklearn-style tol early stopping per fit.
* **SVC**: the features move to the device once; G = X·Xᵀ is one
  full-float32 product, and each (kernel, γ) group's Gram is an
  elementwise transform of the cached G or d². The SMO duals of every
  (fold × one-vs-one pair) problem and every C of the group solve in one
  batched call that shares Q across the C axis; test decisions come
  from α against the resident Gram, and the voting runs on the host.
  The refit is `models.svc.svc_fit`, whose RBF Gram is the hand-written
  kernel on the card (ops/rbf.py).

With `mesh` (a parallel.mesh.Mesh), the SGD grid's folds shard over the
data ranks (`sgd_fit_many_folds`) and the SVC grid's candidate axis (the
C values of a kernel group) does: every rank computes the Gram itself,
solves its candidates' SMO batch, and the decisions are gathered. Every
rank then scores, selects and refits the same way.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from radarml_tpu_torch.models import svc as tsvc
from radarml_tpu_torch.models.linear import (
    SGDConfig,
    _as_f32,
    _l1_ratio,
    full_f32,
    predict as linear_predict,
    sgd_fit,
    sgd_fit_many,
    sgd_fit_many_folds,
    sgd_model,
)
from radarml_tpu_torch.parallel.mesh import check_mesh

logger = logging.getLogger(__name__)

__all__ = [
    "stratified_kfold_indices",
    "parameter_grid",
    "GridSearchResult",
    "grid_search_sgd",
    "grid_search_svc",
    "SGD_PARAM_GRID",
    "SVC_PARAM_GRID",
]


# --------------------------------------------------------------------------
# sklearn-parity stratified K-fold (no shuffle)
# --------------------------------------------------------------------------

def stratified_kfold_indices(
    y: np.ndarray, n_splits: int = 5
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, test_idx) per fold, matching StratifiedKFold(n).

    sklearn's allocation: sort the encoded labels, deal them round-
    robin into folds to get per-fold class allocations, then assign
    each class's members to folds in order of appearance.
    """
    y = np.asarray(y)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_enc = class_perm[y_inv]
    n_classes = len(y_idx)
    y_order = np.sort(y_enc)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes)
         for i in range(n_splits)]
    )
    test_folds = np.empty(len(y), dtype=int)
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        test_folds[y_enc == k] = folds_for_class
    out = []
    idx = np.arange(len(y))
    for f in range(n_splits):
        test = idx[test_folds == f]
        train = idx[test_folds != f]
        out.append((train, test))
    return out


def parameter_grid(grid) -> List[Dict]:
    """sklearn ParameterGrid enumeration order."""
    if isinstance(grid, dict):
        grid = [grid]
    out = []
    for p in grid:
        items = sorted(p.items())
        if not items:
            out.append({})
            continue
        keys, values = zip(*items)
        for combo in itertools.product(*values):
            out.append(dict(zip(keys, combo)))
    return out


# --------------------------------------------------------------------------
# Search driver
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GridSearchResult:
    best_params: Dict
    best_score: float
    best_model: object
    cv_results: List[Dict]
    # Full optimizer state of the refit winner (SGD family): carries the
    # eta-schedule position t and averaging accumulators so later
    # partial_fit continues the schedule instead of restarting it — the
    # reference partial_fits the refit best_estimator_ (train.py:419-438).
    best_state: object = None
    # SVC family: the most SMO iterations a problem of each kernel group
    # ran in the CV, {"linear": n, "rbf gamma 0.01": n, ...}.
    smo_iters: Optional[Dict[str, int]] = None

    def log_summary(self, folds: int):
        """Reference log shape (train.py:376-381)."""
        logger.info("\n Best estimator:")
        logger.info(self.best_model)
        logger.info(" Best score for %d-fold search:", folds)
        logger.info(self.best_score)
        logger.info(" Best hyperparameters:")
        logger.info(self.best_params)


def _mesh_device(mesh, device):
    """The device a search computes on: `device`, else the mesh rank's."""
    return mesh.device if check_mesh(mesh) is not None and device is None else device


def _best(candidates, scores, seconds) -> Tuple[int, float, List[Dict]]:
    """(best index, best mean, cv_results); ties go to the earliest."""
    cv_results = []
    best_score, best_i = -np.inf, 0
    for ci, params in enumerate(candidates):
        mean = float(np.mean(scores[ci]))
        cv_results.append(
            {"params": params, "mean_test_score": mean,
             "split_scores": [float(s) for s in scores[ci]],
             "fit_time": seconds / len(candidates)}
        )
        if mean > best_score:
            best_score, best_i = mean, ci
    return best_i, best_score, cv_results


def _run_grid(
    X,
    y: np.ndarray,
    grid,
    fit_score: Callable,
    refit: Callable,
    folds: int,
) -> GridSearchResult:
    """Candidate after candidate, fold after fold (GridSearchCV's order)."""
    splits = stratified_kfold_indices(y, folds)
    candidates = parameter_grid(grid)
    cv_results = []
    best_score, best_i = -np.inf, 0
    for ci, params in enumerate(candidates):
        t0 = time.perf_counter()
        scores = []
        for train_idx, test_idx in splits:
            s = fit_score(
                params, X[train_idx], y[train_idx], X[test_idx], y[test_idx]
            )
            scores.append(s)
        mean = float(np.mean(scores))
        cv_results.append(
            {"params": params, "mean_test_score": mean,
             "split_scores": scores, "fit_time": time.perf_counter() - t0}
        )
        logger.debug("grid %d/%d %s → %.4f", ci + 1, len(candidates), params, mean)
        if mean > best_score:
            best_score, best_i = mean, ci
    best_params = candidates[best_i]
    model = refit(best_params, X, y)
    return GridSearchResult(best_params, best_score, model, cv_results)


# Reference grids, train.py:356-367.
_SGD_ALPHAS = [10.0e-04, 10.0e-05, 10.0e-06, 10.0e-07]
_SGD_SMALL_ALPHAS = [10.0e-08, 10.0e-09, 10.0e-10]
_SGD_L1_RATIOS = [0.075, 0.15, 0.30]
SGD_PARAM_GRID = [
    {"alpha": _SGD_ALPHAS, "penalty": ["l1", "l2"], "average": [False]},
    {"alpha": _SGD_ALPHAS, "penalty": ["elasticnet"], "average": [False],
     "l1_ratio": _SGD_L1_RATIOS},
    {"alpha": _SGD_SMALL_ALPHAS, "penalty": ["l1", "l2"], "average": [True]},
    {"alpha": _SGD_SMALL_ALPHAS, "penalty": ["elasticnet"], "average": [True],
     "l1_ratio": _SGD_L1_RATIOS},
]

# Reference grids, train.py:472-477.
_SVC_CS = [0.01, 0.1, 1, 10, 100]
_SVC_GAMMAS = [0.001, 0.01, 0.1, 1, 10]
SVC_PARAM_GRID = [
    {"C": _SVC_CS, "kernel": ["linear"]},
    {"C": _SVC_CS, "gamma": _SVC_GAMMAS, "kernel": ["rbf"]},
]


def grid_search_sgd(
    X,
    y: np.ndarray,
    folds: int = 5,
    grid=None,
    epochs: Optional[int] = None,
    seed: int = 1234,
    vmap_candidates: bool = True,
    tol: Optional[float] = 1e-3,
    mesh=None,
    device: torch.device | str | None = None,
) -> GridSearchResult:
    """Reference find_best_sgd_svm_estimator equivalent.

    Epoch budget: the reference passes sklearn's max_iter heuristic
    max(1e6/n, 1000) (train.py:357) and relies on tol early stopping to
    cut it short. The candidate-batched CV and refit (`sgd_fit_many*`)
    cap it at 300 epochs, as the JAX package does; `epochs` overrides.

    With `vmap_candidates` (default), the candidates sharing (penalty,
    average) train together, all folds at once; otherwise each candidate
    and fold is its own `sgd_fit` (no early stop), in GridSearchCV's
    order. X (numpy or tensor) is moved to `device` (default: where a
    tensor X lies, else the CUDA card; pass "cpu").

    Returns a GridSearchResult whose best_model is (LinearModel, cfg).
    """
    Xd = _as_f32(X, _mesh_device(mesh, device))
    y = np.asarray(y)
    n_classes = len(np.unique(y))

    def make_cfg(params) -> SGDConfig:
        return SGDConfig(
            alpha=params["alpha"],
            penalty=params["penalty"],
            l1_ratio=params.get("l1_ratio", 0.15),
            average=params.get("average", False),
        )

    def fit_score(params, Xtr, ytr, Xte, yte):
        cfg = make_cfg(params)
        state = sgd_fit(Xtr, ytr, n_classes, cfg, epochs=epochs, seed=seed)
        pred = linear_predict(sgd_model(state, cfg), Xte).cpu().numpy()
        return float((pred == yte).mean())

    def refit(params, Xa, ya):
        cfg = make_cfg(params)
        if vmap_candidates:
            # one single-candidate walk with the CV fits' early stopping
            states = sgd_fit_many(
                Xa, ya, n_classes, cfg.penalty, cfg.average,
                [cfg.alpha], [_l1_ratio(cfg.penalty, cfg.l1_ratio)],
                epochs=epochs, seed=seed, tol=tol,
            )
            state = type(states)(*(f[0] for f in states))
        else:
            state = sgd_fit(Xa, ya, n_classes, cfg, epochs=epochs, seed=seed)
        return (sgd_model(state, cfg), cfg, state)

    grid = grid or SGD_PARAM_GRID
    if vmap_candidates:
        res = _run_grid_sgd_batched(
            Xd, y, grid, n_classes, folds, epochs, seed, refit, tol, mesh,
        )
    else:
        res = _run_grid(Xd, y, grid, fit_score, refit, folds)
    model, cfg, state = res.best_model
    res.best_model = (model, cfg)
    res.best_state = state
    return res


def _run_grid_sgd_batched(
    Xd, y, grid, n_classes, folds, epochs, seed, refit, tol=None, mesh=None,
) -> GridSearchResult:
    """Candidate-batched CV: one walk per (penalty, average) group over
    every fold × candidate.

    Fold train sets are trimmed to a common size so that the folds stack
    (fold sizes differ by ≤1 sample; the trim drops at most one training
    sample per fold, as in the JAX package)."""
    full_f32()
    candidates = parameter_grid(grid)
    splits = stratified_kfold_indices(y, folds)
    min_train = min(len(tr) for tr, _ in splits)
    splits = [(tr[:min_train], te) for tr, te in splits]
    groups: Dict[tuple, List[int]] = {}
    for ci, params in enumerate(candidates):
        key = (params["penalty"], params.get("average", False))
        groups.setdefault(key, []).append(ci)

    dev = Xd.device

    def rows(idx):
        return Xd.index_select(0, torch.as_tensor(idx, dtype=torch.int64, device=dev))

    Xs = torch.stack([rows(tr) for tr, _ in splits])
    ys = np.stack([y[tr] for tr, _ in splits])

    scores = np.zeros((len(candidates), folds))
    t_start = time.perf_counter()
    for (penalty, average), idxs in groups.items():
        alphas = [candidates[i]["alpha"] for i in idxs]
        l1rs = [_l1_ratio(penalty, candidates[i].get("l1_ratio", 0.15)) for i in idxs]
        states = sgd_fit_many_folds(
            Xs, ys, n_classes, penalty, average,
            alphas, l1rs, epochs=epochs, seed=seed, tol=tol, mesh=mesh,
        )
        # (folds, cand, C, F) model batch
        coef = states.avg_coef if average else states.coef
        intercept = states.avg_intercept if average else states.intercept
        for f, (_tr, te) in enumerate(splits):
            # (cand, n, C) decisions → per-candidate accuracy
            dec = (torch.einsum("nf,kcf->knc", rows(te), coef[f])
                   + intercept[f][:, None, :])
            if coef.shape[2] == 1:
                pred = (dec[..., 0] > 0).to(torch.int64)
            else:
                pred = torch.argmax(dec, dim=-1)
            pred = pred.cpu().numpy()
            scores[idxs, f] = (pred == y[te][None, :]).mean(axis=1)

    best_i, best_score, cv_results = _best(
        candidates, scores, time.perf_counter() - t_start)
    best_params = candidates[best_i]
    model = refit(best_params, Xd, y)
    return GridSearchResult(best_params, best_score, model, cv_results)


def grid_search_svc(
    X,
    y: np.ndarray,
    folds: int = 5,
    grid=None,
    probability: bool = True,
    seed: int = 1234,
    device_batched: bool = True,
    mesh=None,
    device: torch.device | str | None = None,
) -> GridSearchResult:
    """Reference find_best_svm_estimator equivalent.

    CV scoring fits without probability (scoring is accuracy via
    voting, as sklearn's GridSearchCV does); the refit adds Platt
    calibration when `probability` (SVC(probability=True) in the
    reference, train.py:478).

    With `device_batched` (default) the whole CV runs on the device: the
    Gram ingredients once, each candidate kernel an elementwise transform
    of them, and every (fold × pair × C) dual of a kernel group in one
    batched SMO call. Otherwise each candidate and fold is its own
    `svc_fit`. X (numpy or tensor) is moved to `device` (default: where a
    tensor X lies, else the CUDA card; pass "cpu").
    """
    Xd = _as_f32(X, _mesh_device(mesh, device))
    y = np.asarray(y)

    def make_cfg(params, prob) -> tsvc.SVCConfig:
        return tsvc.SVCConfig(
            C=params["C"],
            kernel=params["kernel"],
            gamma=params.get("gamma", 0.01),
            class_weight="balanced",
            probability=prob,
            seed=seed,
        )

    if device_batched:
        return _run_grid_svc_batched(
            Xd, y, grid or SVC_PARAM_GRID, folds, probability, make_cfg, mesh
        )

    def fit_score(params, Xtr, ytr, Xte, yte):
        model = tsvc.svc_fit(Xtr, ytr, make_cfg(params, False))
        pred = tsvc.predict(model, Xte).cpu().numpy()
        return float((pred == yte).mean())

    def refit(params, Xa, ya):
        return tsvc.svc_fit(Xa, ya, make_cfg(params, probability))

    return _run_grid(Xd, y, grid or SVC_PARAM_GRID, fit_score, refit, folds)


def _run_grid_svc_batched(Xd, y, grid, folds, probability, make_cfg,
                          mesh=None) -> GridSearchResult:
    """Device-resident SVC CV: one batched SMO call per kernel group.

    1. G = X·Xᵀ (one full-float32 product) and the pairwise d² once.
    2. Candidates group by (kernel, γ): each group's Gram K is G, or
       exp(-γ d²) elementwise; no feature products per candidate.
    3. Fold × OvO-pair dual subproblems are padded to a common size (the
       host builds only the integer index map); their Q matrices are
       gathered from K once per group and shared by the group's C values.
       Per-sample balanced-C weights follow each fold's train-set class
       counts, as class_weight='balanced' does per fit.
    4. Test decisions come from α: dec = (α·y)ᵀ K[idx, :] − ρ against the
       resident Gram. Voting (libsvm argmax, ties to the lower class) runs
       on the small (nC, pairs, n_te) host array.

    With a mesh, each rank solves its slice of a group's C values (the
    last repeated up to a multiple of the data ranks) and the decisions
    and iteration counts are gathered.
    """
    full_f32()
    t_start = time.perf_counter()
    dev = Xd.device
    classes = np.unique(y)
    k = len(classes)
    y_enc = np.searchsorted(classes, y)
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    nP = len(pairs)
    splits = stratified_kfold_indices(y_enc, folds)
    candidates = parameter_grid(grid)

    # --- one-time device work: Gram ingredients -----------------------
    G = Xd @ Xd.T
    xx = (Xd * Xd).sum(dim=1)
    d2 = torch.clamp(xx[:, None] + xx[None, :] - 2.0 * G, min=0.0)

    # --- host: fold×pair padded index map (integers only) -------------
    fold_class_idx = [[tr[y_enc[tr] == c] for c in range(k)] for tr, _te in splits]
    m = max(
        len(fold_class_idx[f][i]) + len(fold_class_idx[f][j])
        for f in range(folds) for (i, j) in pairs
    )
    FP = folds * nP
    idxb = np.zeros((FP, m), np.int64)
    yb = np.ones((FP, m), np.float32)
    cw = np.zeros((FP, m), np.float32)  # balanced weight, scaled by C later
    for f, (tr, _te) in enumerate(splits):
        counts = np.bincount(y_enc[tr], minlength=k)
        w = len(tr) / (k * np.maximum(counts, 1))  # class_weight='balanced'
        for pi, (i, j) in enumerate(pairs):
            fp = f * nP + pi
            idx = np.concatenate([fold_class_idx[f][i], fold_class_idx[f][j]])
            s = len(idx)
            idxb[fp, :s] = idx
            ypm = np.concatenate(
                [np.ones(len(fold_class_idx[f][i])),
                 -np.ones(len(fold_class_idx[f][j]))]
            )
            yb[fp, :s] = ypm
            cw[fp, :s] = np.where(ypm > 0, w[i], w[j])
    idx_d = torch.as_tensor(idxb, device=dev)
    yb_d = torch.as_tensor(yb, device=dev)
    cw_d = torch.as_tensor(cw, device=dev)
    valid = cw_d > 0

    groups: Dict[tuple, List[int]] = {}
    for ci, params in enumerate(candidates):
        key = (params["kernel"], params.get("gamma", None)
               if params["kernel"] != "linear" else None)
        groups.setdefault(key, []).append(ci)

    eps, max_iter = tsvc.SVCConfig().eps, tsvc.SVCConfig().max_iter

    def solve_group(K, Cs):
        """(nC,) box caps × (FP,) padded QPs → (nC, FP, n) decisions."""
        Ksub = K[idx_d[:, :, None], idx_d[:, None, :]]  # (FP, m, m)
        Ksub = torch.where(valid[:, :, None] & valid[:, None, :], Ksub, 0.0)
        Qb = yb_d[:, :, None] * yb_d[:, None, :] * Ksub
        del Ksub
        res = tsvc._smo_kernel_solve(
            Qb, yb_d, Cs[:, None, None] * cw_d[None], eps=eps, max_iter=max_iter)
        del Qb
        # decisions for every sample against every (candidate, fold, pair)
        # machine; the caller slices out each fold's test rows
        coef = res.alpha * yb_d[None]  # (nC, FP, m)
        dec = torch.einsum("qfm,fmn->qfn", coef, K[idx_d]) - res.rho[..., None]
        return dec, res.n_iter

    scores = np.zeros((len(candidates), folds))
    smo_iters: Dict[str, int] = {}
    for (kernel, gamma), idxs in groups.items():
        if kernel == "linear":
            K = G
        else:
            # String gammas ('scale'/'auto') resolve against the full
            # training matrix, as the final refit resolves them.
            K = torch.exp(-tsvc._resolve_gamma(gamma, Xd) * d2)
            # XLA flushes subnormals to zero (on the CPU and the TPU); so
            # does this Gram, or a γ·d² past ~87 leaves entries that move
            # the degenerate candidates' near-zero decisions
            K = torch.where(K < torch.finfo(torch.float32).tiny, 0.0, K)
        Cs = np.asarray([float(candidates[i]["C"]) for i in idxs], np.float32)
        if mesh is not None:
            Cs = Cs[mesh.padded_rows(len(Cs))]
        dec, n_iter = solve_group(K, torch.as_tensor(Cs, device=dev))
        if mesh is not None:
            dec = mesh.all_gather(dec)[:len(idxs)]
            n_iter = mesh.all_gather(n_iter)
        smo_iters[f"{kernel}" + ("" if gamma is None else f" gamma {gamma}")] = int(
            n_iter.max())
        dec = dec.cpu().numpy()  # (nC, FP, n)
        for f, (_tr, te) in enumerate(splits):
            votes = np.zeros((len(idxs), len(te), k), np.int32)
            for pi, (i, j) in enumerate(pairs):
                d = dec[:, f * nP + pi][:, te]
                votes[:, :, i] += d > 0
                votes[:, :, j] += ~(d > 0)
            pred = votes.argmax(axis=2)
            scores[idxs, f] = (pred == y_enc[te][None, :]).mean(axis=1)
    del G, d2

    best_i, best_score, cv_results = _best(
        candidates, scores, time.perf_counter() - t_start)
    best_params = candidates[best_i]
    logger.info("SVC CV: most SMO iterations per kernel group %s", smo_iters)
    model = tsvc.svc_fit(Xd, y, make_cfg(best_params, probability))
    return GridSearchResult(best_params, best_score, model, cv_results,
                            smo_iters=smo_iters)
