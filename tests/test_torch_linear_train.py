"""The port's linear training half against the JAX package's
(models/linear.py: calibration and SGD).

Re-runs the SGD and calibration cases of tests/test_linear.py with both
packages on the same numpy inputs. Platt fits run in float64 on the host
in both, so they agree within 1e-5. The SGD walk is float32 in both,
in the same sample order (np.random.default_rng(seed) permutations);
the products sum in another order, so over a few epochs coef and
intercept agree within 1e-5 x max|coef| and the predictions are equal;
with tol, every candidate stops at the same epoch (t counts the samples
seen, so (t - t0) / n is the epoch a fit stopped at).

The SGD cases run on narrow features (the xy plane's 682 of the
default arena, or blobs) at step sizes where the walk does not amplify
rounding: the schedule starts at eta = alpha^(-1/4), and at alpha 1e-3
on the 10,010 features of all three planes a margin summed in another
order (~1e-4 apart) moves the two packages' coef apart by 6e-5 x
max|coef| within one epoch, in either package against itself summed
another way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import ProjMask
from radarml_tpu.data.labels import LabelEncoder
from radarml_tpu.data.synthetic import make_dataset
from radarml_tpu.models import linear as jl
from radarml_tpu.ops.features import process_samples
from radarml_tpu_torch.models import linear as tl

CPU = "cpu"


@pytest.fixture(scope="module")
def featurized():
    samples, labels = make_dataset(120, seed=3)
    le, y = LabelEncoder.fit_transform(labels)
    X = process_samples(samples, scale=True).astype(np.float32)
    return X, y, le


@pytest.fixture(scope="module")
def narrow():
    """The xy plane's 682 features of make_dataset(120, seed=3)."""
    samples, labels = make_dataset(120, seed=3)
    _, y = LabelEncoder.fit_transform(labels)
    X = process_samples(samples, proj_mask=ProjMask(False, False, True),
                        scale=True).astype(np.float32)
    return X, y


def _blobs(rng, n=60, k=3, f=12, spread=3.0):
    y = (np.arange(n) % k).astype(np.int64)
    centers = rng.normal(size=(k, f)).astype(np.float32) * spread
    X = centers[y] + rng.normal(size=(n, f)).astype(np.float32)
    return X, y


def _close(t_state, j_state, fields=("coef", "intercept")):
    for f in fields:
        want = np.asarray(getattr(j_state, f))
        got = getattr(t_state, f).numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale, f


def test_fit_sigmoid_calibration_matches_jax(rng):
    for n_pos in (7, 30, 55):
        df = rng.normal(size=60) * 3
        y = np.zeros(60)
        y[rng.permutation(60)[:n_pos]] = 1
        df[y > 0] += 1.5
        a, b = tl.fit_sigmoid_calibration(df, y)
        aj, bj = jl.fit_sigmoid_calibration(df, y)
        np.testing.assert_allclose([a, b], [aj, bj], atol=1e-5, rtol=0)


def test_calibrate_ovr_matches_jax(featurized):
    X, y, _ = featurized
    rng = np.random.default_rng(0)
    coef = rng.normal(size=(3, X.shape[1])).astype(np.float32) * 0.05
    intercept = rng.normal(size=3).astype(np.float32)
    jmodel = jl.LinearModel(jnp.asarray(coef), jnp.asarray(intercept))
    tmodel, _ = tl.from_numpy(coef, intercept, device=CPU)
    want = jl.calibrate_ovr(jmodel, X, y)
    got = tl.calibrate_ovr(tmodel, X, y)
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), atol=1e-5, rtol=0)
    proba = tl.predict_proba_calibrated(tmodel, got, torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-5)
    # binary: one column, the positive class is 1
    jb = jl.LinearModel(jnp.asarray(coef[:1]), jnp.asarray(intercept[:1]))
    tb, _ = tl.from_numpy(coef[:1], intercept[:1], device=CPU)
    yb = (y == 1).astype(np.int64)
    np.testing.assert_allclose(tl.calibrate_ovr(tb, X, yb).a.numpy(),
                               np.asarray(jl.calibrate_ovr(jb, X, yb).a), atol=1e-5)


@pytest.mark.parametrize("average", [False, True], ids=["plain", "average"])
@pytest.mark.parametrize("penalty", ["l2", "l1", "elasticnet"])
def test_sgd_fit_matches_jax(narrow, penalty, average):
    X, y = narrow
    kw = dict(alpha=1e-2, penalty=penalty, average=average)
    want = jl.sgd_fit(X[:100], y[:100], 3, jl.SGDConfig(**kw), epochs=4)
    got = tl.sgd_fit(X[:100], y[:100], 3, tl.SGDConfig(**kw), epochs=4, device=CPU)
    _close(got, want, ("coef", "intercept", "q", "avg_coef", "avg_intercept"))
    assert float(got.t) == float(want.t) and float(got.u) == pytest.approx(float(want.u))
    jm = jl.sgd_model(want, jl.SGDConfig(**kw))
    tm = tl.sgd_model(got, tl.SGDConfig(**kw))
    np.testing.assert_array_equal(
        tl.predict(tm, torch.as_tensor(X)).numpy(), np.asarray(jl.predict(jm, X)))


def test_sgd_fit_binary_and_unshuffled_match_jax(rng):
    X, y = _blobs(rng, n=40, k=2)
    cfg_j, cfg_t = jl.SGDConfig(alpha=1e-3), tl.SGDConfig(alpha=1e-3)
    for shuffle in (True, False):
        want = jl.sgd_fit(X, y, 2, cfg_j, epochs=3, shuffle=shuffle, seed=5)
        got = tl.sgd_fit(X, y, 2, cfg_t, epochs=3, shuffle=shuffle, seed=5, device=CPU)
        assert tuple(got.coef.shape) == (1, X.shape[1])
        _close(got, want)


def test_sgd_fit_many_early_stop_same_epochs_and_frozen(rng):
    """With tol, every candidate stops at the JAX package's epoch, and a
    stopped candidate's state is frozen: it equals a run of exactly that
    many epochs without early stopping."""
    X, y = _blobs(rng)
    alphas, n = [1e-4, 1e-3, 1e-2], len(y)
    t0 = np.asarray([jl._init_t(a) for a in alphas], np.float32)
    want = jl.sgd_fit_many(X, y, 3, "l2", False, alphas, [0.0] * 3, epochs=200,
                           seed=0, tol=1e-3)
    got = tl.sgd_fit_many(X, y, 3, "l2", False, alphas, [0.0] * 3, epochs=200,
                          seed=0, tol=1e-3, device=CPU)
    stop_j = np.rint((np.asarray(want.t) - t0) / n)
    stop_t = np.rint((got.t.numpy() - t0) / n)
    np.testing.assert_array_equal(stop_t, stop_j)
    assert stop_t.max() < 200
    for c in range(3):
        _close(type(got)(*(f[c] for f in got)), type(want)(*(f[c] for f in want)))
        full = tl.sgd_fit_many(X, y, 3, "l2", False, [alphas[c]], [0.0],
                               epochs=int(stop_t[c]), seed=0, tol=None, device=CPU)
        for a, b in zip(got, full):
            assert torch.equal(a[c], b[0])


@pytest.mark.parametrize("penalty,average", [("elasticnet", True), ("l1", False)])
def test_sgd_fit_many_folds_early_stop_matches_jax(rng, penalty, average):
    X, y = _blobs(rng, n=75)
    Xs = np.stack([X[:60], X[15:]])
    ys = np.stack([y[:60], y[15:]])
    alphas, l1r = [1e-3, 1e-2], [0.15, 0.3]
    t0 = np.asarray([jl._init_t(a) for a in alphas], np.float32)
    want = jl.sgd_fit_many_folds(Xs, ys, 3, penalty, average, alphas, l1r,
                                 epochs=60, tol=1e-3)
    got = tl.sgd_fit_many_folds(Xs, ys, 3, penalty, average, alphas, l1r,
                                epochs=60, tol=1e-3, device=CPU)
    assert tuple(got.coef.shape) == (2, 2, 3, X.shape[1])
    np.testing.assert_array_equal(np.rint((got.t.numpy() - t0) / 60),
                                  np.rint((np.asarray(want.t) - t0) / 60))
    _close(got, want, ("coef", "intercept", "avg_coef", "avg_intercept"))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):  # sharding: ported
        tl.sgd_fit_many_folds(Xs, ys, 3, penalty, average, alphas, l1r,
                              epochs=2, mesh=object(), device=CPU)


def test_online_continuation_from_jax_state(narrow):
    """A state fitted by the JAX package, carried across, continues in
    the port as it does in the JAX package."""
    X, y = narrow
    cfg_j, cfg_t = jl.SGDConfig(alpha=1e-2), tl.SGDConfig(alpha=1e-2)
    first = jl.sgd_fit(X[:60], y[:60], 3, cfg_j, epochs=3)
    want = jl.sgd_fit(X[60:100], y[60:100], 3, cfg_j, epochs=3, state=first)
    carried = tl.sgd_state_from_numpy(first, device=CPU)
    assert float(carried.t) == float(first.t)
    got = tl.sgd_fit(X[60:100], y[60:100], 3, cfg_t, epochs=3, state=carried, device=CPU)
    _close(got, want)
    np.testing.assert_array_equal(
        tl.predict(tl.sgd_model(got, cfg_t), torch.as_tensor(X)).numpy(),
        np.asarray(jl.predict(jl.sgd_model(want, cfg_j), X)))


def test_walk_log_records_each_fit(rng):
    X, y = _blobs(rng, n=30)
    tl.WALK_LOG.clear()
    tl.sgd_fit(X, y, 3, tl.SGDConfig(), epochs=2, device=CPU)
    tl.sgd_fit_many(X, y, 3, "l1", True, [1e-3, 1e-2], [1.0, 1.0], epochs=3, device=CPU)
    assert [(r["penalty"], r["shape"], r["epochs"], r["graph"]) for r in tl.WALK_LOG] == [
        ("l2", (1, 1, 30, 12), 2, False), ("l1", (1, 2, 30, 12), 3, False)]


@pytest.mark.parametrize("penalty,average", [("l2", False), ("elasticnet", True)])
def test_fold_walk_is_the_same_bits_in_any_stack(penalty, average):
    """Each fold walked alone equals the same fold inside a 7-fold stack
    (two blocks of the walk's product), and 3- and 2-fold stacks equal
    their slices of it, bit for bit, at 2,000 and 2,001 features: a
    sharded grid hands each rank a stack of another size. (At 2,000
    features a lone fold's product once took another route and parted by
    up to 0.029 in the coefficients.)"""
    rng = np.random.default_rng(0)
    for F in (2000, 2001):
        Xs = rng.normal(size=(7, 40, F)).astype(np.float32)
        ys = rng.integers(0, 3, size=(7, 40))
        kw = dict(n_classes=3, penalty=penalty, average=average, alphas=[1e-4, 1e-3],
                  l1_ratios=[0.15, 0.15], epochs=20, tol=1e-3, device=CPU)
        seven = tl.sgd_fit_many_folds(Xs, ys, **kw)
        for f in range(7):
            alone = tl.sgd_fit_many_folds(Xs[f:f + 1], ys[f:f + 1], **kw)
            assert all(torch.equal(a[f], b[0]) for a, b in zip(seven, alone)), (F, f)
        for lo, hi in ((1, 4), (5, 7)):
            part = tl.sgd_fit_many_folds(Xs[lo:hi], ys[lo:hi], **kw)
            assert all(torch.equal(a[lo:hi], b) for a, b in zip(seven, part)), (F, lo, hi)
