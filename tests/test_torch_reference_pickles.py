"""The reference's sklearn pickles, read by the port without sklearn.

The port's `apps/common_cli.load_model` / `load_label_encoder` unpickle
an sklearn CalibratedClassifierCV over an SGDClassifier (the reference's
svm_radar_classifier.pickle), an SVC and a LabelEncoder through an
allow-list that maps each sklearn class to an inert holder, so no module
of sklearn is imported (sklearn is removed from sys.modules first and
must not come back). Held, on the CPU:

- against the JAX loader on the same file: float32 arrays bit-equal;
- against sklearn: the cases of tests/test_reference_parity.py,
  tests/test_linear.py:40-110 and tests/test_svc.py:25-60 on the port,
  at their bars (2e-6 direct and 5e-5 through the predictor with argmax
  equal; SVC 2e-4);
- the committed fixtures (radarml_tpu_torch/assets/reference_pickles/):
  read by the port they equal what sklearn unpickles, sklearn on them
  reproduces expected.npz, and the port's predictor reproduces
  expected.npz in every linear mode (5e-5, argmax equal) and the SVC in
  exact mode (1e-3, the SVC golden bar);
- hostile pickles (a numpy callable, builtins.eval, an unknown sklearn
  class, an allowed class whose state names a disallowed global) are
  refused by all three loaders, and their code never runs;
- the predict, serve and `train --online_learn` apps on a reference
  pickle against the JAX apps on the same files.

Run as a script from the repo root, where sklearn is installed, the file
regenerates the fixtures:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_reference_pickles.py
"""

import logging
import os
import pickle
import platform
import re
import sys
import warnings

import numpy as np
import pytest
import sklearn
import torch
from sklearn import calibration, linear_model, preprocessing, svm
from sklearn.frozen import FrozenEstimator

from radarml_tpu.apps import common_cli as jcli
from radarml_tpu.core.arena import DEFAULT_ARENA as J_ARENA
from radarml_tpu.data.synthetic import make_dataset, make_scan_batch
from radarml_tpu.models import linear as jlin
from radarml_tpu.models import svc as jsvc
from radarml_tpu.ops.features import process_samples
from radarml_tpu_torch.apps import common_cli as tcli
from radarml_tpu_torch.core.arena import DEFAULT_ARENA
from radarml_tpu_torch.models import linear as tlin
from radarml_tpu_torch.models import svc as tsvc
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                        "radarml_tpu_torch", "assets", "reference_pickles")
N_SCANS, SCAN_SEED = 64, 7  # expected.npz's scans: make_scan_batch(64, seed=7)
LINEAR_ATOL, SVC_ATOL = 5e-5, 1e-3


# --------------------------------------------------------------------------
# The fixtures and their generator (needs sklearn: this host only)
# --------------------------------------------------------------------------

def reference_linear(n=120, seed=3):
    """SGDClassifier(log_loss) calibrated by a prefit sigmoid, over the
    reference's 10,010 scaled features, as tests/test_reference_parity.py
    trains it (reference train.py:722-737); returns (cal, le, X, y)."""
    samples, labels = make_dataset(n, seed=seed)
    le = preprocessing.LabelEncoder()
    y = le.fit_transform(labels)
    X = process_samples(samples, scale=True).astype(np.float64)
    clf = linear_model.SGDClassifier(
        loss="log_loss", max_iter=50, random_state=1234, tol=None
    ).fit(X[:90], y[:90])
    cal = calibration.CalibratedClassifierCV(
        FrozenEstimator(clf), method="sigmoid").fit(X[90:], y[90:])
    return cal, le, X, y


def reference_svc(n=42, seed=11):
    """An RBF SVC(probability=True) at the full 10,010 features, on few
    enough samples that its float64 support vectors stay under 4 MB."""
    samples, labels = make_dataset(n, seed=seed)
    y = preprocessing.LabelEncoder().fit_transform(labels)
    X = process_samples(samples, scale=True).astype(np.float64)
    with warnings.catch_warnings():  # probability=True: the reference's artifact
        warnings.simplefilter("ignore", FutureWarning)
        return svm.SVC(kernel="rbf", C=10.0, gamma=0.01, probability=True,
                       class_weight="balanced", random_state=1234).fit(X, y)


def scan_features(n=N_SCANS, seed=SCAN_SEED):
    """(rounded cubes, targets, host features): each scan's target sliced
    and featurized by the reference's math (tests/test_reference_parity.py:
    80-91), on cubes rounded to integers so that every mode (int8 and bf16
    streams too) serves the same scans."""
    cubes, targets = make_scan_batch(n, seed=seed)
    cubes = np.rint(cubes)
    rows = []
    for b, t in enumerate(targets):
        i, j, k = (int(v) for v in J_ARENA.clamped_matrix_indices(t.x, t.y, t.z))
        rows.append((cubes[b][:, j, :], cubes[b][i, :, :], cubes[b][:, :, k]))
    return cubes, targets, np.asarray(process_samples(rows, scale=True), np.float64)


def expected_outputs(cal, sv, F):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return {"linear_proba": cal.predict_proba(F), "linear_pred": cal.predict(F),
                "svc_proba": sv.predict_proba(F), "svc_pred": sv.predict(F)}


def write_fixtures(out=FIXTURES):
    os.makedirs(out, exist_ok=True)
    cal, le, _, _ = reference_linear()
    sv = reference_svc()
    for name, obj in (("svm_radar_classifier", cal), ("radar_labels", le),
                      ("svc_radar_classifier", sv)):
        with open(os.path.join(out, f"{name}.pickle"), "wb") as fp:
            pickle.dump(obj, fp)
    _, targets, F = scan_features()
    np.savez(os.path.join(out, "expected.npz"), n_scans=N_SCANS, scan_seed=SCAN_SEED,
             targets_xyz=np.array([(t.x, t.y, t.z) for t in targets], np.float32),
             classes=np.asarray(le.classes_).astype(str), **expected_outputs(cal, sv, F),
             sklearn_version=sklearn.__version__, numpy_version=np.__version__,
             python_version=platform.python_version())


def fixture(name):
    return os.path.join(FIXTURES, name)


def sklearn_modules():
    return [m for m in sys.modules if m.split(".")[0] == "sklearn"]


def drop_sklearn(monkeypatch):
    """Take sklearn out of sys.modules (monkeypatch puts it back after)."""
    for name in sklearn_modules():
        monkeypatch.delitem(sys.modules, name)


@pytest.fixture
def no_sklearn(monkeypatch):
    """sklearn out of sys.modules for the test; it must not come back."""
    drop_sklearn(monkeypatch)
    yield
    assert not sklearn_modules()


def dump(tmp_path, obj, name="sk.pickle", protocol=None):
    path = str(tmp_path / name)
    with open(path, "wb") as fp:
        pickle.dump(obj, fp, protocol=protocol)
    return path


def arrays_equal(t, a):
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(a, np.float32))


# --------------------------------------------------------------------------
# tests/test_reference_parity.py on the port
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    cal, le, X, y = reference_linear()
    model_path, le_path = str(d / "svm_radar_classifier.pickle"), str(d / "radar_labels.pickle")
    with open(model_path, "wb") as fp:
        pickle.dump(cal, fp)
    with open(le_path, "wb") as fp:
        pickle.dump(le, fp)
    return model_path, le_path, cal, le, X, y


def test_sklearn_pickles_load_and_bit_match(reference_artifacts, no_sklearn):
    model_path, le_path, cal, le, X, y = reference_artifacts
    model, calib = tcli.load_model(model_path, device="cpu")
    assert list(tcli.load_label_encoder(le_path).classes_) == [str(c) for c in le.classes_]
    want = cal.predict_proba(X)
    got = tlin.predict_proba_calibrated(model, calib, torch.from_numpy(X.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))


def test_reference_model_through_predict_pipeline(reference_artifacts, no_sklearn):
    """The scan → prediction path with the loaded reference model equals
    sklearn on the reference's own preprocessing math."""
    model_path, _, cal, _, _, _ = reference_artifacts
    model, calib = tcli.load_model(model_path, device="cpu")
    predictor = RadarPredictor(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
                               model=model, calibration=calib, min_proba=0.0, device="cpu")
    cubes, targets, F = scan_features(6, 9)
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], 1)
    _, _, proba = predictor(cubes, xyz, valid)
    want = cal.predict_proba(F)
    got = proba.numpy()[:, 0, :]
    np.testing.assert_allclose(got, want, atol=LINEAR_ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# --------------------------------------------------------------------------
# tests/test_linear.py:40-110 and tests/test_svc.py:25-60 on the port
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def featurized():
    samples, labels = make_dataset(120, seed=3)
    y = preprocessing.LabelEncoder().fit_transform(labels)
    return process_samples(samples, scale=True).astype(np.float32), y


@pytest.fixture(scope="module")
def sgd(featurized):
    X, y = featurized
    return linear_model.SGDClassifier(loss="log_loss", alpha=1e-5, max_iter=200,
                                      random_state=1234).fit(X, y)


def test_decision_function_matches_sklearn(featurized, sgd):
    X, _ = featurized
    model = tlin.from_sklearn_linear(sgd, device="cpu")
    jm = jlin.from_sklearn_linear(sgd)
    arrays_equal(model.coef, jm.coef)
    arrays_equal(model.intercept, jm.intercept)
    got = tlin.decision_function(model, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, sgd.decision_function(X), rtol=1e-4, atol=1e-3)


def test_predict_proba_matches_sklearn(featurized, sgd):
    X, _ = featurized
    model = tlin.from_sklearn_linear(sgd, device="cpu")
    got = tlin.predict_proba_log_loss(model, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, sgd.predict_proba(X), rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(tlin.predict(model, torch.from_numpy(X)).numpy(),
                                  sgd.predict(X))


def test_calibrated_proba_matches_sklearn(featurized):
    X, y = featurized
    n = X.shape[0]
    clf = linear_model.SGDClassifier(loss="log_loss", alpha=1e-5, max_iter=200,
                                     random_state=1234).fit(X[: n // 2], y[: n // 2])
    cal = calibration.CalibratedClassifierCV(FrozenEstimator(clf), method="sigmoid")
    cal.fit(X[n // 2:], y[n // 2:])
    model, calib = tlin.from_sklearn_calibrated(cal, device="cpu")
    jm, jcal = jlin.from_sklearn_calibrated(cal)
    for t, j in ((model.coef, jm.coef), (model.intercept, jm.intercept),
                 (calib.a, jcal.a), (calib.b, jcal.b)):
        arrays_equal(t, j)
    got = tlin.predict_proba_calibrated(model, calib, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, cal.predict_proba(X), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind", ["ensemble", "isotonic"])
def test_calibrated_refuses_what_it_cannot_compute(featurized, sgd, kind):
    """Where the JAX loader computes something other than sklearn (it
    takes the first of several calibrated classifiers, which sklearn
    averages, and reads a_ / b_ that an isotonic calibrator lacks), the
    port raises and says why."""
    X, y = featurized
    if kind == "ensemble":
        cal = calibration.CalibratedClassifierCV(
            linear_model.SGDClassifier(loss="log_loss", max_iter=20, random_state=1),
            method="sigmoid", cv=3).fit(X, y)
        match = "3 calibrated classifiers"
    else:
        cal = calibration.CalibratedClassifierCV(FrozenEstimator(sgd),
                                                 method="isotonic").fit(X, y)
        match = "isotonic"
    with pytest.raises(ValueError, match=match):
        tlin.from_sklearn_calibrated(cal, device="cpu")


def _blobs(rng, n=120, k=3, f=12, spread=2.5):
    centers = rng.normal(size=(k, f)) * spread
    y = np.arange(n) % k
    X = centers[y] + rng.normal(size=(n, f))
    return X.astype(np.float32), y


def _svc(X, y, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return svm.SVC(probability=True, **kw).fit(X, y)


def _svc_bits(model, jm):
    assert model.n_support == jm.n_support and model.gamma == jm.gamma
    assert model.kernel == jm.kernel
    for name in ("support_vectors", "dual_coef", "intercept", "probA", "probB"):
        if getattr(jm, name) is None:
            assert getattr(model, name) is None, name
        else:
            arrays_equal(getattr(model, name), getattr(jm, name))


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_from_sklearn_decision_and_predict_parity(rng, kernel):
    X, y = _blobs(rng)
    clf = _svc(X, y, kernel=kernel, C=10.0, gamma=0.05, class_weight="balanced",
               random_state=1234)
    model = tsvc.from_sklearn_svc(clf, device="cpu")
    _svc_bits(model, jsvc.from_sklearn_svc(clf))
    Xq = rng.normal(size=(40, X.shape[1])).astype(np.float32) + X[:40] * 0.5
    clf.decision_function_shape = "ovo"
    np.testing.assert_allclose(tsvc.decision_function_ovo(model, Xq).numpy(),
                               clf.decision_function(Xq), atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(tsvc.predict(model, Xq).numpy(), clf.predict(Xq))
    np.testing.assert_allclose(tsvc.predict_proba(model, Xq).numpy(),
                               clf.predict_proba(Xq), atol=2e-4)


def test_binary_from_sklearn_parity(rng):
    X, y = _blobs(rng, k=2)
    clf = _svc(X, y, kernel="rbf", C=1.0, gamma=0.1)
    model = tsvc.from_sklearn_svc(clf, device="cpu")
    _svc_bits(model, jsvc.from_sklearn_svc(clf))
    Xq = X[:30] + 0.1
    # the internal OvO convention: positive favors class 0, the negation
    # of sklearn's binary decision_function
    np.testing.assert_allclose(tsvc.decision_function_ovo(model, Xq).numpy()[:, 0],
                               -clf.decision_function(Xq), atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(tsvc.predict(model, Xq).numpy(), clf.predict(Xq))
    np.testing.assert_allclose(tsvc.predict_proba(model, Xq).numpy(),
                               clf.predict_proba(Xq), atol=2e-4)


# --------------------------------------------------------------------------
# Pickles: bit for bit with the JAX loader, spellings, protocols
# --------------------------------------------------------------------------

def _pickled_models(rng):
    """name -> a fitted sklearn object of each artifact kind."""
    X, y = _blobs(rng, n=60, f=20)
    clf = linear_model.SGDClassifier(loss="log_loss", max_iter=30, tol=None,
                                     random_state=1234).fit(X[:40], y[:40])
    binary = linear_model.SGDClassifier(loss="log_loss", max_iter=30, tol=None,
                                        random_state=1234).fit(X[:40], y[:40] % 2)
    return {
        "calibrated": calibration.CalibratedClassifierCV(
            FrozenEstimator(clf), method="sigmoid").fit(X[40:], y[40:]),
        "calibrated_binary": calibration.CalibratedClassifierCV(
            FrozenEstimator(binary), method="sigmoid").fit(X[40:], y[40:] % 2),
        "svc": _svc(X, y, kernel="rbf", C=10.0, gamma=0.05, random_state=1234),
        "svc_binary": _svc(X, y % 2, kernel="rbf", C=1.0, gamma=0.1, random_state=1234),
        "svc_linear_no_proba": svm.SVC(kernel="linear", C=1.0).fit(X, y),
    }


@pytest.mark.parametrize("protocol", [3, 4, 5])
@pytest.mark.parametrize("name", ["calibrated", "calibrated_binary", "svc", "svc_binary",
                                  "svc_linear_no_proba"])
def test_pickle_loads_bit_equal_to_the_jax_loader(rng, tmp_path, monkeypatch, name,
                                                  protocol):
    path = dump(tmp_path, _pickled_models(rng)[name], protocol=protocol)
    jm, jcal = jcli.load_model(path)  # unpickles with sklearn
    drop_sklearn(monkeypatch)
    tm, tcal = tcli.load_model(path, device="cpu")
    assert not sklearn_modules()
    assert tcli.load_model_meta(path) == {} == jcli.load_model_meta(path)
    if name.startswith("svc"):
        assert tcal is None and jcal is None
        _svc_bits(tm, jm)
        if name == "svc_linear_no_proba":
            assert tm.probA is None and tm.probB is None
    else:
        for t, j in ((tm.coef, jm.coef), (tm.intercept, jm.intercept),
                     (tcal.a, jcal.a), (tcal.b, jcal.b)):
            arrays_equal(t, j)


@pytest.mark.parametrize("protocol", [3, 4, 5])
def test_label_encoder_pickle_loads_as_the_jax_loader(tmp_path, monkeypatch, protocol):
    with open(fixture("radar_labels.pickle"), "rb") as fp:
        path = dump(tmp_path, pickle.load(fp), protocol=protocol)
    jle = jcli.load_label_encoder(path)
    drop_sklearn(monkeypatch)
    le = tcli.load_label_encoder(path)
    assert le.classes_ == tuple(jle.classes_) == ("cat", "dog", "person")
    assert all(type(c) is str for c in le.classes_)
    assert tcli.load_model_meta(path) == {}
    with pytest.raises(ValueError, match="unrecognized model artifact 'LabelEncoder'"):
        tcli.load_model(path, device="cpu")
    assert not sklearn_modules()


def test_pre_022_and_numpy1_spellings_load_the_same(rng, tmp_path, monkeypatch):
    """The reference's Raspberry Pi pickles name sklearn's pre-0.22 public
    modules and numpy 1's numpy.core: both load as the current spellings
    (protocol 3 writes each global as text, so the bytes can be renamed)."""
    models = _pickled_models(rng)
    renames = {
        b"sklearn.linear_model._stochastic_gradient\n":
            b"sklearn.linear_model.stochastic_gradient\n",
        b"sklearn.svm._classes\n": b"sklearn.svm.classes\n",
        b"sklearn.preprocessing._label\n": b"sklearn.preprocessing.label\n",
        b"sklearn._loss._loss\nCyHalfBinomialLoss\n": b"sklearn.linear_model.sgd_fast\nLog\n",
        b"numpy._core.multiarray\n": b"numpy.core.multiarray\n",
    }
    le = preprocessing.LabelEncoder().fit(["person", "cat", "dog"])
    raws = {name: pickle.dumps(obj, protocol=3) for name, obj in (
        ("calibrated", models["calibrated"]), ("svc", models["svc"]), ("le", le))}
    drop_sklearn(monkeypatch)
    for name, raw in raws.items():
        old = raw
        for a, b in renames.items():
            old = old.replace(a, b)
        assert old != raw and b"numpy.core.multiarray" in old
        new_path, old_path = str(tmp_path / f"{name}.new"), str(tmp_path / f"{name}.old")
        for path, data in ((new_path, raw), (old_path, old)):
            with open(path, "wb") as fp:
                fp.write(data)
        if name == "le":
            assert tcli.load_label_encoder(old_path) == tcli.load_label_encoder(new_path)
            continue
        (a, ac), (b, bc) = (tcli.load_model(p, device="cpu") for p in (new_path, old_path))
        for field in ("coef", "intercept") if name == "calibrated" else (
                "support_vectors", "dual_coef", "intercept", "probA", "probB"):
            assert torch.equal(getattr(a, field), getattr(b, field))
        if ac is not None:
            assert torch.equal(ac.a, bc.a) and torch.equal(ac.b, bc.b)
    assert not sklearn_modules()


def test_unrecognized_artifacts_raise(tmp_path, no_sklearn):
    path = dump(tmp_path, {"format": "other"})
    assert tcli.load_model_meta(path) == {}
    with pytest.raises(ValueError, match="unrecognized model artifact 'dict'"):
        tcli.load_model(path, device="cpu")
    with pytest.raises(ValueError, match="label encoder"):
        tcli.load_label_encoder(path)


# --------------------------------------------------------------------------
# The committed fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def expected():
    with np.load(fixture("expected.npz")) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def sklearn_fixtures():
    out = {}
    for name in ("svm_radar_classifier", "svc_radar_classifier", "radar_labels"):
        with open(fixture(f"{name}.pickle"), "rb") as fp:
            out[name] = pickle.load(fp)
    return out


def test_fixtures_are_small_and_record_their_versions(expected):
    sizes = {n: os.path.getsize(fixture(n)) for n in os.listdir(FIXTURES)}
    assert sizes["svc_radar_classifier.pickle"] < 4 << 20
    assert sizes["svm_radar_classifier.pickle"] < 300 << 10
    assert str(expected["sklearn_version"]) and str(expected["numpy_version"])
    assert str(expected["python_version"]).startswith("3.")
    assert int(expected["n_scans"]) == N_SCANS and int(expected["scan_seed"]) == SCAN_SEED


def test_fixtures_read_by_the_port_equal_sklearn(sklearn_fixtures, no_sklearn):
    cal, sv, le = (sklearn_fixtures[n] for n in ("svm_radar_classifier",
                                                 "svc_radar_classifier", "radar_labels"))
    model, calib = tcli.load_model(fixture("svm_radar_classifier.pickle"), device="cpu")
    cc = cal.calibrated_classifiers_[0]
    arrays_equal(model.coef, cc.estimator.estimator.coef_)
    arrays_equal(model.intercept, cc.estimator.estimator.intercept_)
    arrays_equal(calib.a, [c.a_ for c in cc.calibrators])
    arrays_equal(calib.b, [c.b_ for c in cc.calibrators])
    assert model.coef.shape == (3, DEFAULT_ARENA.feature_length)
    svc_model, none = tcli.load_model(fixture("svc_radar_classifier.pickle"), device="cpu")
    assert none is None and svc_model.n_support == tuple(int(v) for v in sv.n_support_)
    assert svc_model.support_vectors.shape[1] == DEFAULT_ARENA.feature_length
    arrays_equal(svc_model.support_vectors, sv.support_vectors_)
    arrays_equal(svc_model.dual_coef, sv.dual_coef_)
    arrays_equal(svc_model.probA, sv.probA_)
    assert svc_model.gamma == sv._gamma
    assert tcli.load_label_encoder(fixture("radar_labels.pickle")).classes_ == tuple(
        str(c) for c in le.classes_)


def test_sklearn_on_the_fixtures_gives_expected(sklearn_fixtures, expected):
    """expected.npz is sklearn's own output on the fixture pickles (the
    stored digits, give or take another sklearn's last bits)."""
    cubes, targets, F = scan_features()
    np.testing.assert_array_equal(
        np.array([(t.x, t.y, t.z) for t in targets], np.float32), expected["targets_xyz"])
    got = expected_outputs(sklearn_fixtures["svm_radar_classifier"],
                           sklearn_fixtures["svc_radar_classifier"], F)
    for k, v in got.items():
        np.testing.assert_allclose(v, expected[k], rtol=0, atol=1e-12, err_msg=k)


@pytest.fixture(scope="module")
def fixture_scans(expected):
    """The expected scans as the port makes them, with one target in 4
    slots each (chip_smoke.py phase 16's inputs)."""
    from radarml_tpu_torch.data.synthetic import make_scan_batch as t_make_scan_batch

    cubes, targets = t_make_scan_batch(N_SCANS, seed=SCAN_SEED)
    xyz, valid = pad_targets([[(t.x, t.y, t.z)] for t in targets], 4)
    np.testing.assert_array_equal(xyz[:, 0], expected["targets_xyz"])
    return np.rint(cubes), xyz, valid


@pytest.mark.parametrize("mode", ["exact", "fused", "fused_sel3", "pallas", "fast_i8"])
def test_port_predictor_reproduces_expected_linear(expected, fixture_scans, no_sklearn,
                                                   mode):
    model, calib = tcli.load_model(fixture("svm_radar_classifier.pickle"), device="cpu")
    kw = {"exact": {}, "fused": {"mode": "fused"},
          "fused_sel3": {"mode": "fused", "fused_tail": "sel3"},
          "pallas": {"mode": "pallas", "cube_dtype": "bfloat16"},
          "fast_i8": {"mode": "fast", "cube_dtype": "int8"}}[mode]
    p = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, calib, min_proba=0.0,
                       device="cpu", **kw)
    cubes, xyz, valid = fixture_scans
    src = p.pack_host(cubes.astype(np.uint8)) if p.mode == "fused" else cubes
    pred, _, proba = (r.numpy() for r in p(src, xyz, valid))
    np.testing.assert_allclose(proba[:, 0], expected["linear_proba"], atol=LINEAR_ATOL)
    np.testing.assert_array_equal(pred[:, 0], expected["linear_pred"])
    assert (pred[:, 1:] == -1).all()


def test_port_predictor_reproduces_expected_svc(expected, fixture_scans, no_sklearn):
    model, _ = tcli.load_model(fixture("svc_radar_classifier.pickle"), device="cpu")
    p = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, min_proba=0.0, device="cpu")
    cubes, xyz, valid = fixture_scans
    pred, _, proba = (r.numpy() for r in p(cubes, xyz, valid))
    want = expected["svc_proba"]
    np.testing.assert_allclose(proba[:, 0], want, atol=SVC_ATOL)
    top2 = np.sort(want, 1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > SVC_ATOL
    assert decided.sum() >= N_SCANS // 2
    np.testing.assert_array_equal(pred[decided, 0], want.argmax(1)[decided])


# --------------------------------------------------------------------------
# Hostile pickles: refused, and nothing of them runs
# --------------------------------------------------------------------------

def _global(module, name):
    return b"c" + module.encode() + b"\n" + name.encode() + b"\n"


def _frag(value):
    """A str, None, bool or dict as a protocol-2 pickle fragment (no
    header, no STOP; protocol 2 has no frames)."""
    return pickle.dumps(value, protocol=2)[2:-1]


def _reduce(module, name, *args):
    """Fragment calling module.name(*args), each arg a fragment."""
    return _global(module, name) + b"(" + b"".join(args) + b"tR"


def _hostile(kind, tmp_path, marker):
    """A pickle that writes `marker` when an unpickler runs it."""
    write = _reduce("builtins", "eval", _frag(f"open({str(marker)!r}, 'w').write('ran')"))
    if kind == "runstring":
        body = _reduce("numpy.testing._private.utils", "runstring",
                       _frag(f"open({str(marker)!r}, 'w').write('ran')"), _frag({}))
    elif kind == "numpy_load":
        # numpy.load(npy, None, True) unpickles the file's object array in full
        evil = str(tmp_path / f"{marker.name}.npy")
        arr = np.empty(1, object)
        np.save(evil, arr, allow_pickle=True)
        with open(evil, "rb") as fp:
            head = fp.read()
        with open(evil, "wb") as fp:  # the array's pickle follows the npy header
            fp.write(head[:head.index(b"\x80")] + b"\x80\x02" + write + b".")
        body = _reduce("numpy", "load", _frag(evil), _frag(None), _frag(True))
    elif kind == "eval":
        body = write
    elif kind == "unknown_sklearn":
        body = _reduce("sklearn.pipeline", "Pipeline", write)
    else:  # an allowed sklearn class whose state names builtins.eval
        body = (_global("sklearn.svm._classes", "SVC") + b")\x81" + b"}" + _frag("kernel")
                + write + b"sb")
    path = str(tmp_path / f"{kind}.pickle")
    with open(path, "wb") as fp:
        fp.write(b"\x80\x02" + body + b".")
    return path


HOSTILE = ["runstring", "numpy_load", "eval", "unknown_sklearn", "sklearn_state_eval"]


@pytest.mark.parametrize("loader", ["load_model", "load_model_meta", "load_label_encoder"])
@pytest.mark.parametrize("kind", HOSTILE)
def test_hostile_pickles_are_refused_and_never_run(tmp_path, kind, loader):
    marker = tmp_path / "ran"
    path = _hostile(kind, tmp_path, marker)
    fn = getattr(tcli, loader)
    args = (path, "cpu") if loader == "load_model" else (path,)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        fn(*args)
    assert not marker.exists()


def test_hostile_pickles_would_run_without_the_allow_list(tmp_path):
    """The payloads are live: pickle.load runs each of them."""
    for kind in HOSTILE:
        marker = tmp_path / f"ran_{kind}"
        path = _hostile(kind, tmp_path, marker)
        with open(path, "rb") as fp, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                pickle.load(fp)
            except Exception:  # the payload ran before the result was unusable
                pass
        assert marker.exists(), kind


# --------------------------------------------------------------------------
# The apps on reference pickles, against the JAX apps
# --------------------------------------------------------------------------

SMALL_ARENA = "10,60,2,-42,42,14,-30,30,10"  # 7 x 7 x 26 scans, zoomed


@pytest.mark.parametrize("mode", [["--mode", "exact"], ["--mode", "fast"],
                                  ["--mode", "fused", "--batch_scans", "3"]],
                         ids=["exact", "fast", "fused"])
def test_predict_app_on_reference_pickles_matches_jax_app(tmp_path, monkeypatch, mode):
    from radarml_tpu.apps import predict as jpredict
    from radarml_tpu_torch.apps import predict as predict_app

    argv = ["--svm_model", fixture("svm_radar_classifier.pickle"),
            "--label_encoder", fixture("radar_labels.pickle"),
            "--log_file", str(tmp_path / "predict.log"), "--min_proba", "0.0",
            "--num_scans", "6", "--scan_arena", SMALL_ARENA, "--driver_seed", "31", *mode]
    want = jpredict.main(argv)  # unpickles with sklearn
    drop_sklearn(monkeypatch)
    got = predict_app.main(argv + ["--platform", "cpu"])
    assert not sklearn_modules()
    assert got and len(got) == len(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=1e-5, rtol=0)


def test_predict_app_on_the_svc_pickle(tmp_path, monkeypatch):
    from radarml_tpu.apps import predict as jpredict
    from radarml_tpu_torch.apps import predict as predict_app

    argv = ["--svm_model", fixture("svc_radar_classifier.pickle"),
            "--label_encoder", fixture("radar_labels.pickle"),
            "--log_file", str(tmp_path / "predict.log"), "--min_proba", "0.0",
            "--num_scans", "4", "--driver_seed", "5", "--batch_scans", "2"]
    want = jpredict.main(argv)
    drop_sklearn(monkeypatch)
    got = predict_app.main(argv + ["--platform", "cpu"])
    assert not sklearn_modules()
    assert got and [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=SVC_ATOL,
                               rtol=0)


class _Detections(logging.Handler):
    """(scan, target) -> (name, proba) from the serve apps' detection lines."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def emit(self, record):  # handle() holds the handler's lock
        m = re.match(r"scan (\d+) target (\d+): (\S+) \(([\d.]+)\)", record.getMessage())
        if m:
            self.seen[int(m[1]), int(m[2])] = (m[3], float(m[4]))


def test_serve_app_on_reference_pickles_matches_jax_app(tmp_path, monkeypatch):
    """Both serve loops on the same pickles and synthetic sensor: every
    scan both answered gets the same class (probabilities as logged, to
    3 digits); the fused artifact exported from the pickles serves the
    live predictor's bits."""
    from radarml_tpu.apps import serve as jserve
    from radarml_tpu_torch.apps import serve as serve_app
    from radarml_tpu_torch.serving import load_serving_artifact

    common = ["--svm_model", fixture("svm_radar_classifier.pickle"),
              "--label_encoder", fixture("radar_labels.pickle"), "--min_proba", "0.0",
              "--scan_arena", SMALL_ARENA, "--mode", "fused", "--max_batch", "4"]
    argv = common + ["--scan_period", "0.05", "--driver", "synthetic", "--log_detections"]
    seen = {}
    for name, app, extra in (("jax", jserve, []), ("port", serve_app, ["--platform", "cpu"])):
        if name == "port":
            drop_sklearn(monkeypatch)
        grab = _Detections()
        log = logging.getLogger(app.__name__)
        log.addHandler(grab)
        try:
            stats = app.main(argv + ["--duration", "3"] + extra)
        finally:
            log.removeHandler(grab)
        assert stats["processed"] > 0 and stats["predict_errors"] == 0, name
        seen[name] = grab.seen
    both = sorted(set(seen["port"]) & set(seen["jax"]))
    assert both
    for key in both:
        assert seen["port"][key][0] == seen["jax"][key][0], key
        assert abs(seen["port"][key][1] - seen["jax"][key][1]) <= 1.5e-3, key

    art = str(tmp_path / "ref_fused.rmlx")
    assert serve_app.main(common + ["--platform", "cpu", "--export_serving", art]) == {
        "exported": art}
    loaded = load_serving_artifact(art, device="cpu")
    model, calib = tcli.load_model(fixture("svm_radar_classifier.pickle"), device="cpu")
    from radarml_tpu_torch.core.arena import Arena

    scan = Arena(r_min=10, r_max=60, r_res=2, theta_min=-42, theta_max=42, theta_res=14,
                 phi_min=-30, phi_max=30, phi_res=10)
    live = RadarPredictor(DEFAULT_ARENA, scan, model, calib, min_proba=0.0, mode="fused",
                          device="cpu")
    rng = np.random.default_rng(0)
    cubes = rng.integers(0, 256, (4,) + scan.grid_shape).astype(np.float32)
    xyz, valid = pad_targets([[(1.0, 2.0, 40.0)]] * 4, max_targets=loaded.max_targets)
    for a, b in zip(live(cubes, xyz, valid), loaded(cubes, xyz, valid)):
        assert torch.equal(a, b)
    assert not sklearn_modules()


def test_train_online_learn_on_a_reference_pickle_matches_jax_app(tmp_path, monkeypatch):
    """--online_learn continues an sklearn pickle with default SGD
    settings (its hyperparameters live in the estimator), as the JAX app
    does: both write a v1 artifact from the same start."""
    from radarml_tpu.apps import train as jtrain
    from radarml_tpu_torch.apps import train as train_app

    from radarml_tpu.core.arena import ProjMask

    monkeypatch.chdir(tmp_path)
    # a model the reference fitted on earlier data of the same kind (the xy
    # plane's 682 features, unscaled as the SGD path takes them)
    samples, labels = make_dataset(60, seed=5)
    y = preprocessing.LabelEncoder().fit_transform(labels)
    X = process_samples(samples, proj_mask=ProjMask(False, False, True)).astype(np.float64)
    clf = linear_model.SGDClassifier(loss="log_loss", max_iter=20, tol=None,
                                     random_state=1234).fit(X[:40], y[:40])
    cal = calibration.CalibratedClassifierCV(FrozenEstimator(clf), method="sigmoid").fit(
        X[40:], y[40:])
    le = preprocessing.LabelEncoder().fit(["cat", "dog", "person"])
    for who in ("jax", "port"):
        dump(tmp_path, cal, f"{who}_ref.pickle")
        dump(tmp_path, le, f"{who}_le.pickle")
    base = ["--datasets", "ds.pickle", "--grid_epochs", "3", "--folds", "3",
            "--proj_mask", "False", "False", "True", "--online_learn"]

    def args(who):
        return ["--svm_model", f"{who}_ref.pickle", "--label_encoder", f"{who}_le.pickle",
                "--svm_cm", f"{who}_cm.png", "--log_file", f"{who}.log"]

    jtrain.main(["--synthetic", "45", *base, *args("jax")])
    drop_sklearn(monkeypatch)
    out = train_app.main([*base, *args("port"), "--platform", "cpu"])
    assert not sklearn_modules()
    assert out["kind"] == "linear" and out["grid"] is None
    with open("port_ref.pickle", "rb") as fp:
        got = pickle.load(fp)
    with open("jax_ref.pickle", "rb") as fp:
        want = pickle.load(fp)
    assert got["format"] == want["format"] == "radarml_tpu.v1"
    assert got["sgd_cfg"] == want["sgd_cfg"] and got["sgd_t"] == want["sgd_t"]
    assert not np.array_equal(got["coef"], np.float32(clf.coef_))
    scale = float(np.abs(want["coef"]).max())
    assert float(np.abs(got["coef"] - want["coef"]).max()) <= 1e-5 * scale
    # the label encoder stays the reference's pickle
    assert tcli.load_label_encoder("port_le.pickle").classes_ == ("cat", "dog", "person")


if __name__ == "__main__":
    write_fixtures()
    for name in sorted(os.listdir(FIXTURES)):
        print(name, os.path.getsize(os.path.join(FIXTURES, name)), "bytes")
