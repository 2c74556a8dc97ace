"""Port parity: models/svc (kernel SVM scoring and SMO training) against
the JAX package's models/svc.

The same data (numpy, from a seed) goes through both packages on the
CPU. Tolerances, with their reasons:

* a JAX-fitted SVC carried across by `from_numpy` scores the same
  queries: OvO decisions within atol 1e-5 / rtol 1e-5 (float32 Gram and
  pair products summed in another order), equal votes, probabilities
  within 1e-6 (the same coupling on those decisions);
* the port's `svc_fit` reaches the JAX `svc_fit` optimum: the dual QP is
  strictly convex in the decision function, so both solvers stop within
  their KKT tolerance (eps=1e-3) of the same optimum, but float32
  rounding may pick other working pairs on the way — decisions within
  atol 5e-3 / rtol 1e-2 and >= 98% equal predictions, the bar of
  tests/test_svc.py:86-87 (JAX against libsvm);
* Platt folds are identical (the same numpy generator), and probA/probB
  within 1e-3 (Newton on decisions that differ within solver tolerance);
* `platt_fit`, `_binary_weights` and `_resolve_gamma` on numpy input are
  the same host float64 code: equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radarml_tpu.models import svc as jsvc
from radarml_tpu_torch.models import svc as tsvc

torch.set_num_threads(1)


def _blobs(rng, n=90, k=3, f=8, spread=2.5):
    centers = rng.normal(size=(k, f)) * spread
    y = np.arange(n) % k
    X = centers[y] + rng.normal(size=(n, f))
    return X.astype(np.float32), y


def _carry(m) -> tsvc.SVCModel:
    """A JAX SVCModel → the port's, through numpy as an artifact would."""
    return tsvc.from_numpy(
        np.asarray(m.support_vectors), np.asarray(m.dual_coef),
        np.asarray(m.intercept), m.n_support, kernel=m.kernel, gamma=m.gamma,
        probA=np.asarray(m.probA), probB=np.asarray(m.probB), device="cpu",
    )


def _cfgs(**kw):
    return jsvc.SVCConfig(**kw), tsvc.SVCConfig(**kw)


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("k", [2, 3])
def test_carried_model_scores_like_jax(rng, kernel, k):
    X, y = _blobs(rng, n=90, k=k)
    jcfg, _ = _cfgs(C=10.0, kernel=kernel, gamma=0.05, probability=True)
    jm = jsvc.svc_fit(X, y, jcfg)
    tm = _carry(jm)
    Xq = X + rng.normal(size=X.shape).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        tsvc.decision_function_ovo(tm, Xq).numpy(),
        np.asarray(jsvc.decision_function_ovo(jm, Xq)), atol=1e-5, rtol=1e-5,
    )
    np.testing.assert_array_equal(
        tsvc.predict(tm, Xq).numpy(), np.asarray(jsvc.predict(jm, Xq))
    )
    got = tsvc.predict_proba(tm, Xq).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jsvc.predict_proba(jm, Xq)), atol=1e-6, rtol=0
    )
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(tm.pair_coef.numpy(), jm.pair_coef)


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("k", [2, 3])
def test_fit_reaches_the_jax_optimum(rng, kernel, k):
    X, y = _blobs(rng, n=90, k=k)
    jcfg, tcfg = _cfgs(C=10.0, kernel=kernel, gamma=0.05, probability=True)
    jm = jsvc.svc_fit(X, y, jcfg)
    tm = tsvc.svc_fit(X, y, tcfg, device="cpu")
    Xq = X + rng.normal(size=X.shape).astype(np.float32) * 0.05
    want = np.asarray(jsvc.decision_function_ovo(jm, Xq))
    got = tsvc.decision_function_ovo(tm, Xq).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-2)
    agree = tsvc.predict(tm, Xq).numpy() == np.asarray(jsvc.predict(jm, Xq))
    assert agree.mean() > 0.98
    np.testing.assert_allclose(tm.probA.numpy(), np.asarray(jm.probA), atol=1e-3)
    np.testing.assert_allclose(tm.probB.numpy(), np.asarray(jm.probB), atol=1e-3)
    # iterations are recorded per problem: one per pair, one per Platt fold
    n_pairs = k * (k - 1) // 2
    assert len(tm.fit_stats["pairs"]) == n_pairs
    assert len(tm.fit_stats["platt"]) == n_pairs * tcfg.prob_folds
    assert all(0 < it < tcfg.max_iter for it in tm.fit_stats["pairs"])


def test_imbalanced_binary_fit_matches_jax(rng):
    """Class-balanced C on imbalanced classes (test_svc.py:90-100)."""
    X, y = _blobs(rng, n=80, k=2, f=6)
    keep = np.concatenate([np.where(y == 0)[0], np.where(y == 1)[0][:10]])
    X, y = X[keep], y[keep]
    jcfg, tcfg = _cfgs(C=1.0, kernel="rbf", gamma=0.1, probability=False)
    jm = jsvc.svc_fit(X, y, jcfg)
    tm = tsvc.svc_fit(X, y, tcfg, device="cpu")
    assert tm.probA is None and "platt" not in tm.fit_stats
    np.testing.assert_allclose(
        tsvc.decision_function_ovo(tm, X).numpy(),
        np.asarray(jsvc.decision_function_ovo(jm, X)), atol=5e-3, rtol=1e-2,
    )


def test_platt_folds_are_the_jax_folds(rng, monkeypatch):
    """Both packages draw each pair's shuffle from
    np.random.default_rng(cfg.seed): record the permutations they draw."""
    X, y = _blobs(rng, n=60, k=3)
    real = np.random.default_rng
    drawn = []

    class Recording:
        def __init__(self, seed):
            self._g = real(seed)

        def permutation(self, n):
            p = self._g.permutation(n)
            drawn[-1].append(p.copy())
            return p

    def recording_rng(seed):
        drawn.append([])
        return Recording(seed)

    monkeypatch.setattr(np.random, "default_rng", recording_rng)
    jcfg, tcfg = _cfgs(C=10.0, gamma=0.05, probability=True, seed=7)
    jm = jsvc.svc_fit(X, y, jcfg)
    tm = tsvc.svc_fit(X, y, tcfg, device="cpu")
    assert len(drawn) == 2 and len(drawn[0]) == len(drawn[1]) == 3
    for a, b in zip(*drawn):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tm.probA.numpy(), np.asarray(jm.probA), atol=1e-3)
    np.testing.assert_allclose(tm.probB.numpy(), np.asarray(jm.probB), atol=1e-3)


def test_platt_fit_is_the_jax_platt_fit(rng):
    for n_pos in (3, 20, 37):
        dec = rng.normal(size=40) * 2.0
        y_pos = np.zeros(40, bool)
        y_pos[rng.permutation(40)[:n_pos]] = True
        assert tsvc.platt_fit(dec, y_pos) == jsvc.platt_fit(dec, y_pos)


def test_resolve_gamma_and_weights_match_jax(rng):
    X = (rng.random((50, 30)) * 3.0).astype(np.float32)
    for g in ("scale", "auto", 0.25):
        assert tsvc._resolve_gamma(g, X) == jsvc._resolve_gamma(g, X)
    # a tensor takes the population variance (var(correction=0)), as a jax
    # array's .var() does; float32 reductions in another order
    np.testing.assert_allclose(
        tsvc._resolve_gamma("scale", torch.from_numpy(X)),
        jsvc._resolve_gamma("scale", jnp.asarray(X)), rtol=1e-6,
    )
    with pytest.raises(ValueError):
        tsvc._resolve_gamma("nope", X)
    y = rng.integers(0, 3, 40)
    for cw in ("balanced", None):
        assert tsvc._binary_weights(y, np.arange(3), cw) == jsvc._binary_weights(
            y, np.arange(3), cw
        )


def test_coupling_early_stop_is_exact(rng):
    """Stopping once no sample is active gives the full 100 iterations'
    result bit for bit (a frozen sample's update is the identity)."""
    X, y = _blobs(rng, n=60, k=3)
    jm = jsvc.svc_fit(X, y, jsvc.SVCConfig(C=10.0, gamma=0.05))
    tm = _carry(jm)
    Xq = X + rng.normal(size=X.shape).astype(np.float32) * 0.5
    r = tsvc._pairwise_prob_matrix(tm, tsvc.decision_function_ovo(tm, Xq))
    full = tsvc._couple_probabilities(r, check_every=1000)
    for every in (1, 8):
        assert torch.equal(tsvc._couple_probabilities(r, check_every=every), full)


def test_smo_freezes_finished_problems(rng):
    """A batch of problems solves each as if alone: the batched solver's
    result for a problem does not depend on the other problems."""
    X, y = _blobs(rng, n=40, k=2, f=5)
    K = tsvc.kernel_matrix(torch.from_numpy(X), torch.from_numpy(X), "rbf", 0.1)
    ypm = torch.from_numpy(np.where(y == 0, 1.0, -1.0).astype(np.float32))
    Q = ypm[:, None] * ypm[None, :] * K
    probs = [(Q, ypm, torch.full((40,), c)) for c in (0.5, 10.0)]
    batch = tsvc._smo_kernel_solve(
        torch.stack([p[0] for p in probs]), torch.stack([p[1] for p in probs]),
        torch.stack([p[2] for p in probs]), eps=1e-3, max_iter=10_000,
        check_every=3,
    )
    assert batch.n_iter[0] != batch.n_iter[1]
    for b, (Qp, yp, Cp) in enumerate(probs):
        one = tsvc._smo_kernel_solve(Qp[None], yp[None], Cp[None], eps=1e-3,
                                     max_iter=10_000)
        assert torch.equal(batch.alpha[b], one.alpha[0])
        assert torch.equal(batch.rho[b], one.rho[0])
        assert batch.n_iter[b] == one.n_iter[0]
    capped = tsvc._smo_kernel_solve(Q[None], ypm[None], torch.full((1, 40), 10.0),
                                    eps=1e-3, max_iter=5)
    assert int(capped.n_iter[0]) == 5  # max_iter counts per problem


def test_kernel_matrix_matches_jax(rng):
    X = rng.normal(size=(13, 21)).astype(np.float32)
    Y = rng.normal(size=(7, 21)).astype(np.float32)
    for kind in ("rbf", "linear"):
        np.testing.assert_allclose(
            tsvc.kernel_matrix(torch.from_numpy(X), torch.from_numpy(Y), kind, 0.05).numpy(),
            np.asarray(jsvc.kernel_matrix(jnp.asarray(X), jnp.asarray(Y), kind, 0.05)),
            atol=1e-5, rtol=1e-5,
        )
    with pytest.raises(ValueError):
        tsvc.kernel_matrix(torch.from_numpy(X), torch.from_numpy(Y), "poly", 0.05)


def test_model_without_probability_refuses_proba(rng):
    X, y = _blobs(rng, n=30, k=2)
    m = tsvc.svc_fit(X, y, tsvc.SVCConfig(probability=False), device="cpu")
    with pytest.raises(ValueError, match="probability"):
        tsvc.predict_proba(m, X)
    with pytest.raises(ValueError, match="together"):
        tsvc.from_numpy(np.zeros((1, 2)), np.zeros((1, 1)), np.zeros(1), (1, 0),
                        probA=np.zeros(1))
