"""The port's grid searches and metrics against the JAX package's
(train/gridsearch.py, train/metrics.py).

Re-runs tests/test_gridsearch.py but its mesh cases, which run on gloo
ranks in tests/test_torch_mesh_train.py; here `mesh=` refuses anything
but a parallel.mesh.Mesh. Folds and grid order are
integer and equal; the grids run on the same numpy blobs in both
packages and give equal best parameters and equal fold scores. The
SVC's batched solver shares Q across the C axis and equals the
per-candidate solves bit for bit.
"""

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from radarml_tpu.models import svc as jsvc  # noqa: E402
from radarml_tpu.train import gridsearch as jg  # noqa: E402
from radarml_tpu.train import metrics as jm  # noqa: E402
from radarml_tpu_torch.models import linear as tl  # noqa: E402
from radarml_tpu_torch.models import svc as tsvc  # noqa: E402
from radarml_tpu_torch.train import gridsearch as tg  # noqa: E402
from radarml_tpu_torch.train import metrics as tm  # noqa: E402

CPU = "cpu"


def _blobs(rng, n=60, k=3, f=10, spread=1.0, scale=1.0):
    centers = rng.normal(size=(k, f)) * spread
    y = np.arange(n) % k
    X = ((centers[y] + rng.normal(size=(n, f))) * scale).astype(np.float32)
    return X, y


def _scores(res):
    return np.array([r["split_scores"] for r in res.cv_results])


def test_stratified_kfold_equal(rng):
    for n, k, folds in [(37, 3, 5), (60, 2, 5), (24, 4, 3)]:
        y = rng.integers(0, k, size=n)
        if len(np.unique(y)) < k:
            y[:k] = np.arange(k)
        for (a, b), (c, d) in zip(tg.stratified_kfold_indices(y, folds),
                                  jg.stratified_kfold_indices(y, folds)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    y = np.array(["dog", "cat", "dog", "person", "cat", "dog",
                  "person", "cat", "dog", "person", "cat", "dog"])
    for (a, b), (c, d) in zip(tg.stratified_kfold_indices(y, 3),
                              jg.stratified_kfold_indices(y, 3)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_parameter_grid_and_reference_grids_equal():
    grid = [
        {"alpha": [1e-3, 1e-4], "penalty": ["l1", "l2"], "average": [False]},
        {"alpha": [1e-5], "penalty": ["elasticnet"], "l1_ratio": [0.1, 0.2]},
    ]
    assert tg.parameter_grid(grid) == jg.parameter_grid(grid)
    assert tg.SGD_PARAM_GRID == jg.SGD_PARAM_GRID
    assert tg.SVC_PARAM_GRID == jg.SVC_PARAM_GRID
    assert len(tg.parameter_grid(tg.SGD_PARAM_GRID)) == 35
    assert len(tg.parameter_grid(tg.SVC_PARAM_GRID)) == 30


def test_grid_search_sgd_reference_grid_matches_jax(rng):
    X, y = _blobs(rng, n=90, f=12)
    want = jg.grid_search_sgd(X, y, folds=3, epochs=6)
    got = tg.grid_search_sgd(X, y, folds=3, epochs=6, device=CPU)
    assert got.best_params == want.best_params
    assert [r["params"] for r in got.cv_results] == [r["params"] for r in want.cv_results]
    np.testing.assert_array_equal(_scores(got), _scores(want))
    model, cfg = got.best_model
    jmodel, _ = want.best_model
    coef = np.asarray(jmodel.coef)
    assert float(np.abs(model.coef.numpy() - coef).max()) <= 1e-5 * float(np.abs(coef).max())
    np.testing.assert_array_equal(tl.predict(model, torch.as_tensor(X)).numpy(),
                                  np.asarray(jg.linear_predict(jmodel, X)))
    assert got.best_state.coef.shape == model.coef.shape


def test_grid_search_sgd_sequential_matches_batched(rng):
    X, y = _blobs(rng, n=45, f=12, spread=3.0)
    grid = [
        {"alpha": [1e-4, 1e-3], "penalty": ["l2"], "average": [False]},
        {"alpha": [1e-4], "penalty": ["elasticnet"], "average": [False],
         "l1_ratio": [0.1, 0.3]},
    ]
    seq = tg.grid_search_sgd(X, y, folds=3, grid=grid, epochs=6,
                             vmap_candidates=False, device=CPU)
    bat = tg.grid_search_sgd(X, y, folds=3, grid=grid, epochs=6, device=CPU)
    want = jg.grid_search_sgd(X, y, folds=3, grid=grid, epochs=6, vmap_candidates=False)
    assert seq.best_params == bat.best_params == want.best_params
    np.testing.assert_array_equal(_scores(seq), _scores(want))
    np.testing.assert_allclose(_scores(seq).mean(1), _scores(bat).mean(1), atol=1e-6)


def test_grid_search_sgd_tol_none_runs_the_budget(rng):
    X, y = _blobs(rng)
    grid = [{"alpha": [1e-4, 1e-3], "penalty": ["l2"], "average": [False]}]
    kw = dict(folds=3, grid=grid, epochs=25, device=CPU)
    tl.WALK_LOG.clear()
    none = tg.grid_search_sgd(X, y, tol=None, **kw)
    assert tl.WALK_LOG[0]["epochs"] == 25
    never = tg.grid_search_sgd(X, y, tol=-np.inf, **kw)
    np.testing.assert_array_equal(_scores(none), _scores(never))
    # 25 epochs at eta0 = alpha^(-1/4) on overlapping blobs: the walks
    # part by rounding, and a fold score may move by one test sample
    want = jg.grid_search_sgd(X, y, folds=3, grid=grid, epochs=25, tol=None)
    assert float(np.abs(_scores(none) - _scores(want)).max()) <= 1 / 20 + 1e-12


def test_grid_search_svc_reference_grid_matches_jax(rng):
    X, y = _blobs(rng, scale=0.3)
    want = jg.grid_search_svc(X, y, folds=3, probability=True)
    got = tg.grid_search_svc(X, y, folds=3, probability=True, device=CPU)
    assert got.best_params == want.best_params
    np.testing.assert_array_equal(_scores(got), _scores(want))
    assert set(got.smo_iters) == {"linear"} | {f"rbf gamma {g}" for g in tg._SVC_GAMMAS}
    assert got.best_model.n_support == want.best_model.n_support
    dj = np.asarray(jsvc.decision_function_ovo(want.best_model, X))
    dt = tsvc.decision_function_ovo(got.best_model, X).numpy()
    assert float((np.abs(dt - dj) / (5e-3 + 1e-2 * np.abs(dj))).max()) <= 1.0
    np.testing.assert_array_equal(tsvc.predict(got.best_model, X).numpy(),
                                  np.asarray(jsvc.predict(want.best_model, X)))
    proba = tsvc.predict_proba(got.best_model, X).numpy()
    np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-5)


def test_grid_search_svc_sequential_and_string_gamma(rng):
    X, y = _blobs(rng, n=48, f=12, spread=3.0)
    grid = [
        {"C": [0.1, 1.0, 10.0], "kernel": ["linear"]},
        {"C": [1.0, 10.0], "gamma": [0.01, 0.1], "kernel": ["rbf"]},
    ]
    seq = tg.grid_search_svc(X, y, folds=3, grid=grid, probability=False,
                             device_batched=False, device=CPU)
    bat = tg.grid_search_svc(X, y, folds=3, grid=grid, probability=False, device=CPU)
    want = jg.grid_search_svc(X, y, folds=3, grid=grid, probability=False)
    assert seq.best_params == bat.best_params == want.best_params
    np.testing.assert_array_equal(_scores(seq), _scores(bat))
    np.testing.assert_array_equal(_scores(bat), _scores(want))
    for gamma in ("scale", "auto"):
        g = tsvc._resolve_gamma(gamma, X)
        named, numeric = (
            tg.grid_search_svc(X, y, folds=3, probability=False, device=CPU,
                               grid=[{"C": [1.0], "gamma": [v], "kernel": ["rbf"]}])
            for v in (gamma, g))
        assert named.cv_results[0]["mean_test_score"] == numeric.cv_results[0]["mean_test_score"]


def test_shared_q_solver_equals_per_candidate_solves(rng):
    """Caps (nC, P, m) over one Q (P, m, m): each candidate's result is
    bit for bit the solve of that candidate's caps alone."""
    X, y = _blobs(rng, n=40, f=8, scale=0.3)
    K = tsvc.kernel_matrix(torch.as_tensor(X), torch.as_tensor(X), "rbf", 0.5)
    idx = np.stack([np.arange(0, 30), np.arange(10, 40)])
    yb = torch.as_tensor(np.where(y[idx] == 0, 1.0, -1.0).astype(np.float32))
    Cb = torch.ones((2, 30))
    Cb[1, -3:] = 0.0  # padding
    Q, idx_t, y_t, C_t = tsvc._problem_batch(K, idx, yb.numpy(), Cb.numpy())
    Cs = torch.tensor([0.1, 1.0, 10.0])[:, None, None] * C_t[None]
    shared = tsvc._smo_kernel_solve(Q, y_t, Cs, eps=1e-3, max_iter=10_000)
    assert tuple(shared.alpha.shape) == (3, 2, 30) and tuple(shared.rho.shape) == (3, 2)
    for c in range(3):
        alone = tsvc._smo_kernel_solve(Q, y_t, Cs[c], eps=1e-3, max_iter=10_000)
        assert torch.equal(shared.alpha[c], alone.alpha)
        assert torch.equal(shared.rho[c], alone.rho)
        assert torch.equal(shared.n_iter[c], alone.n_iter)


@pytest.mark.parametrize("search", ["sgd", "svc"])
def test_mesh_raises_and_names_a15(rng, search):
    """Sharding is ported (ROADMAP A15, done): a mesh that is not a
    parallel.mesh.Mesh is refused and the error names the type."""
    X, y = _blobs(rng, n=30)
    fn = tg.grid_search_sgd if search == "sgd" else tg.grid_search_svc
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        fn(X, y, folds=3, mesh=object(), device=CPU)


def test_metrics_match_jax(rng, tmp_path):
    y_true = rng.integers(0, 3, 50)
    y_pred = np.where(rng.random(50) < 0.7, y_true, rng.integers(0, 3, 50))
    names = ["cat", "dog", "person"]
    assert tm.accuracy_score(y_true, y_pred) == jm.accuracy_score(y_true, y_pred)
    assert tm.accuracy_score([], []) == 0.0
    cm = tm.confusion_matrix(y_true, y_pred)
    np.testing.assert_array_equal(cm, jm.confusion_matrix(y_true, y_pred))
    for a, b in zip(tm.precision_recall_f1(cm), jm.precision_recall_f1(cm)):
        np.testing.assert_array_equal(a, b)
    assert tm.classification_report(y_true, y_pred, names) == jm.classification_report(
        y_true, y_pred, names)
    png = tmp_path / "cm.png"
    out = tm.evaluate_model(lambda _: torch.as_tensor(y_pred).numpy(), None, y_true,
                            names, cm_path=str(png))
    assert png.exists() and png.stat().st_size > 0
    assert out["accuracy"] == jm.accuracy_score(y_true, y_pred)
    np.testing.assert_array_equal(out["confusion_matrix"], cm)
