"""Port parity: apps/common_cli's model artifacts against the JAX
package's `save_model` / `load_model`.

A `radarml_tpu.v1` pickle holds numpy arrays, so an artifact either
package writes loads in the other. Loaded models score the same inputs
(numpy, from a seed) as the JAX package's loaded models, on the CPU:
decisions within atol 1e-5 / rtol 1e-5 and probabilities within 1e-6
(float32 products in another summation order, the bar of
tests/test_torch_svc.py and tests/test_torch_linear.py).
"""

import pickle
import sys

import numpy as np
import pytest
import torch

from radarml_tpu.apps import common_cli as jcli
from radarml_tpu.models import linear as jlin
from radarml_tpu.models import svc as jsvc
from radarml_tpu_torch.apps import common_cli as tcli
from radarml_tpu_torch.models import linear as tlin
from radarml_tpu_torch.models import svc as tsvc

torch.set_num_threads(1)


def _svc_artifact(rng, path, k=3, kernel="rbf"):
    """Fit a JAX SVC and write it as apps/train.py does."""
    centers = rng.normal(size=(k, 6)) * 2.5
    y = np.arange(60) % k
    X = (centers[y] + rng.normal(size=(60, 6))).astype(np.float32)
    m = jsvc.svc_fit(X, y, jsvc.SVCConfig(C=10.0, kernel=kernel, gamma=0.1))
    jcli.save_model(
        str(path), "svc",
        support_vectors=np.asarray(m.support_vectors),
        dual_coef=np.asarray(m.dual_coef), intercept=np.asarray(m.intercept),
        n_support=list(m.n_support), kernel=m.kernel, gamma=m.gamma,
        probA=np.asarray(m.probA), probB=np.asarray(m.probB),
        classes=[f"c{i}" for i in range(k)],
    )
    return X


@pytest.mark.parametrize("kernel,k", [("rbf", 3), ("rbf", 2), ("linear", 3)])
def test_jax_svc_artifact_loads_and_scores_the_same(rng, tmp_path, kernel, k):
    path = tmp_path / "svc.pkl"
    X = _svc_artifact(rng, path, k, kernel)
    jm, jcal = jcli.load_model(str(path))
    tm, tcal = tcli.load_model(str(path), device="cpu")
    assert jcal is None and tcal is None
    assert isinstance(tm, tsvc.SVCModel) and tm.n_support == jm.n_support
    Xq = X + rng.normal(size=X.shape).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        tsvc.decision_function_ovo(tm, Xq).numpy(),
        np.asarray(jsvc.decision_function_ovo(jm, Xq)), atol=1e-5, rtol=1e-5,
    )
    np.testing.assert_array_equal(tsvc.predict(tm, Xq).numpy(),
                                  np.asarray(jsvc.predict(jm, Xq)))
    np.testing.assert_allclose(tsvc.predict_proba(tm, Xq).numpy(),
                               np.asarray(jsvc.predict_proba(jm, Xq)), atol=1e-6)
    meta = tcli.load_model_meta(str(path))
    assert meta["kind"] == "svc" and meta["classes"] == jcli.load_model_meta(
        str(path))["classes"]


@pytest.mark.parametrize("calibrated", [True, False])
def test_jax_linear_artifact_loads_and_scores_the_same(rng, tmp_path, calibrated):
    coef = rng.normal(size=(3, 40)).astype(np.float32)
    intercept = rng.normal(size=3).astype(np.float32)
    a, b = -rng.uniform(0.5, 2.0, 3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    path = tmp_path / "linear.pkl"
    jcli.save_model(str(path), "linear", coef=coef, intercept=intercept,
                    calib_a=a if calibrated else None,
                    calib_b=b if calibrated else None,
                    classes=["cat", "dog", "person"], sgd_cfg={"alpha": 1e-5},
                    sgd_t=12.0)
    jm, jcal = jcli.load_model(str(path))
    tm, tcal = tcli.load_model(str(path), device="cpu")
    assert (tcal is None) == (not calibrated)
    X = rng.normal(size=(17, 40)).astype(np.float32)
    if calibrated:
        want = jlin.predict_proba_calibrated(jm, jcal, X)
        got = tlin.predict_proba_calibrated(tm, tcal, torch.from_numpy(X))
    else:
        want = jlin.predict_proba_log_loss(jm, X)
        got = tlin.predict_proba_log_loss(tm, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert tcli.load_model_meta(str(path))["sgd_t"] == 12.0


def test_port_artifact_loads_in_the_jax_package(rng, tmp_path):
    path = tmp_path / "port.pkl"
    tcli.save_model(str(path), "linear", coef=rng.normal(size=(3, 8)).astype(np.float32),
                    intercept=np.zeros(3, np.float32), calib_a=None, calib_b=None)
    jm, jcal = jcli.load_model(str(path))
    tm, _ = tcli.load_model(str(path), device="cpu")
    assert jcal is None
    np.testing.assert_array_equal(np.asarray(jm.coef), tm.coef.numpy())
    tmeta, jmeta = tcli.load_model_meta(str(path)), jcli.load_model_meta(str(path))
    assert sorted(tmeta) == sorted(jmeta)
    for key in tmeta:
        np.testing.assert_array_equal(tmeta[key], jmeta[key])


@pytest.mark.parametrize("kind,item", [("cnn", "A12"), ("sgan_classifier", "A13")])
def test_neural_artifacts_are_not_ported(tmp_path, kind, item):
    """Ported since ROADMAP A12 / A13: the neural kinds load as
    NeuralClassifiers (tests/test_torch_neural_serving.py holds them to
    the JAX package); an unknown kind still raises."""
    from radarml_tpu_torch.models.cnn import cnn_init_tree
    from radarml_tpu_torch.models.sgan import sgan_init_trees

    path = tmp_path / "net.pkl"
    if kind == "cnn":
        arrays = {"params": cnn_init_tree(3, (8, 8), seed=0)}
    else:
        _, (dp, ds) = sgan_init_trees(3, (8, 8), seed=0)
        arrays = {"d_params": dp, "d_stats": ds}
    tcli.save_model(str(path), kind, classes=["a", "b", "c"], rescale=(8, 8), **arrays)
    model, calib = tcli.load_model(str(path), device="cpu")
    assert type(model).__name__ == "NeuralClassifier" and calib is None, item
    assert model.rescale == (8, 8) and model.n_classes == 3
    tcli.save_model(str(path), "forest")
    with pytest.raises(ValueError, match="unknown model kind"):
        tcli.load_model(str(path), device="cpu")


def test_sklearn_pickles_are_refused_before_import(tmp_path, monkeypatch):
    """Reference sklearn pickles load, and no sklearn module is imported
    (the name is from before they were ported, ROADMAP A4): the SVC loads
    as the JAX loader loads it. A dict of another format gives {} from
    load_model_meta and is no model; a class outside the allow-list is
    refused before it is imported."""
    from sklearn.svm import SVC

    path = tmp_path / "sk.pkl"
    clf = SVC(kernel="rbf").fit(np.eye(4), [0, 1, 0, 1])
    with open(path, "wb") as fp:
        pickle.dump(clf, fp)
    jm, _ = jcli.load_model(str(path))
    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, name)
    tm, tcal = tcli.load_model(str(path), device="cpu")
    assert tcal is None and tm.n_support == jm.n_support == (2, 2)
    np.testing.assert_array_equal(tm.dual_coef.numpy(), np.asarray(jm.dual_coef))
    assert tcli.load_model_meta(str(path)) == {}
    assert not any(m.split(".")[0] == "sklearn" for m in sys.modules)
    with open(path, "wb") as fp:
        pickle.dump({"format": "other"}, fp)
    assert tcli.load_model_meta(str(path)) == {}
    with pytest.raises(ValueError, match="unrecognized model artifact"):
        tcli.load_model(str(path), device="cpu")
    with open(path, "wb") as fp:
        pickle.dump(tmp_path, fp)  # any class outside the allow-list
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tcli.load_model(str(path), device="cpu")
