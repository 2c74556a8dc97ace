"""The port's train app (python -m radarml_tpu_torch.apps.train) against
the JAX package's, with --platform cpu.

Re-runs the train cases of tests/test_apps.py (artifacts, online
learning, augmentation epochs, --save_augmented). With --epochs 0 both
apps train on the same synthetic dataset pickle and their artifacts
match: the same keys, best parameters and fold scores, SGD coef and
intercept within 1e-5 x max|coef|, Platt parameters within 1e-4
(host float64 fits of decisions that differ in the 7th digit), and SVC
support vectors equal, Platt parameters within 1e-3 (the bar of
tests/test_torch_svc.py) and decisions on the dataset within atol 5e-3 /
rtol 1e-2 with >= 98% equal predictions (tests/test_svc.py:86-87). The artifacts load in both packages' `load_model` and serve
through the port's predict app. The SVC path's features equal
process_samples(raw, scale=True) of the same samples: the app divides
every plane by RADAR_MAX before the split, the scale the predictor
serves at (reference flow, apps/train.py:145 in the JAX package). The runs use
the xy plane's 682 features (--proj_mask False False True) but that one.
"""

import os
import pickle

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from radarml_tpu.apps import common_cli as jcli  # noqa: E402
from radarml_tpu.apps import train as jtrain  # noqa: E402
from radarml_tpu_torch.apps import common_cli as tcli  # noqa: E402
from radarml_tpu_torch.apps import predict as predict_app  # noqa: E402
from radarml_tpu_torch.apps import train as train_app  # noqa: E402
from radarml_tpu_torch.core.arena import RADAR_MAX  # noqa: E402
from radarml_tpu_torch.data.store import load_datasets  # noqa: E402
from radarml_tpu_torch.models import svc as tsvc  # noqa: E402
from radarml_tpu_torch.ops.features import process_samples  # noqa: E402

torch.set_num_threads(1)

# The xy plane's 682 features keep the CPU walk of the full SGD grid short.
BASE = ["--datasets", "ds.pickle", "--grid_epochs", "8", "--folds", "3",
        "--proj_mask", "False", "False", "True"]


def _args(name, *extra):
    return ["--svm_model", f"{name}.pkl", "--label_encoder", f"{name}_le.pkl",
            "--svm_cm", f"{name}_cm.png", "--log_file", f"{name}.log", *extra]


def _run_both(name, *extra):
    """Both apps on ds.pickle; the JAX app first (it writes the dataset
    the first time)."""
    jax_out = jtrain.main(["--synthetic", "45", *BASE, *_args(f"jax_{name}"), *extra])
    port_out = train_app.main(["--synthetic", "45", *BASE, *_args(f"port_{name}"),
                               "--platform", "cpu", *extra])
    return jax_out, port_out


def _artifact(path):
    with open(path, "rb") as fp:
        return pickle.load(fp)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_app")
    cwd = os.getcwd()
    os.chdir(d)
    yield d
    os.chdir(cwd)


@pytest.fixture(scope="module")
def trained(workdir):
    return _run_both("sgd")


@pytest.fixture(scope="module")
def trained_svc(workdir, trained):
    return _run_both("svc", "--use_svc")


def test_train_app_sgd_artifacts_match_jax(trained):
    jax_out, port_out = trained
    a, b = _artifact("jax_sgd.pkl"), _artifact("port_sgd.pkl")
    assert sorted(a) == sorted(b) and a["kind"] == b["kind"] == "linear"
    assert a["classes"] == b["classes"] and a["sgd_cfg"] == b["sgd_cfg"]
    assert a["sgd_t"] == b["sgd_t"]
    scale = float(np.abs(a["coef"]).max())
    assert float(np.abs(a["coef"] - b["coef"]).max()) <= 1e-5 * scale
    assert float(np.abs(a["intercept"] - b["intercept"]).max()) <= 1e-5 * max(
        scale, float(np.abs(a["intercept"]).max()))
    for k in ("calib_a", "calib_b"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-4, rtol=0)
    assert port_out["cfg"].__dict__ == jax_out["cfg"].__dict__  # the best parameters
    assert port_out["metrics"]["accuracy"] == jax_out["metrics"]["accuracy"]
    np.testing.assert_array_equal(port_out["metrics"]["confusion_matrix"],
                                  jax_out["metrics"]["confusion_matrix"])
    assert os.path.exists("port_sgd_cm.png") and os.path.exists("port_sgd_le.pkl")


def test_train_app_svc_artifacts_match_jax(trained_svc):
    jax_out, port_out = trained_svc
    a, b = _artifact("jax_svc.pkl"), _artifact("port_svc.pkl")
    assert sorted(a) == sorted(b) and a["kind"] == b["kind"] == "svc"
    assert port_out["params"] == jax_out["params"]
    assert list(a["n_support"]) == list(b["n_support"])
    assert a["kernel"] == b["kernel"] and a["gamma"] == b["gamma"]
    np.testing.assert_array_equal(b["support_vectors"], a["support_vectors"])
    for k in ("probA", "probB"):  # the bar of tests/test_torch_svc.py
        np.testing.assert_allclose(b[k], a[k], atol=1e-3, rtol=0)
    # SMO stops at a gap of 1e-3, so the duals are that loose; the
    # decisions meet the bar of tests/test_svc.py:86-87
    data = load_datasets(["ds.pickle"])
    X = process_samples(data["samples"], proj_mask=tcli.parse_proj_mask(BASE[-3:]),
                        scale=True, device="cpu")
    ma, _ = tcli.load_model("jax_svc.pkl", device="cpu")
    mb, _ = tcli.load_model("port_svc.pkl", device="cpu")
    da, db = (tsvc.decision_function_ovo(m, X).numpy() for m in (ma, mb))
    assert float((np.abs(db - da) / (5e-3 + 1e-2 * np.abs(da))).max()) <= 1.0
    assert float((tsvc.predict(ma, X) == tsvc.predict(mb, X)).float().mean()) >= 0.98
    assert port_out["metrics"]["accuracy"] == jax_out["metrics"]["accuracy"]


@pytest.mark.parametrize("name", ["sgd", "svc"])
def test_artifacts_load_in_both_packages_and_serve(trained, trained_svc, name):
    for who in ("jax", "port"):
        path = f"{who}_{name}.pkl"
        jmodel, _ = jcli.load_model(path)
        tmodel, _ = tcli.load_model(path, device="cpu")
        assert type(tmodel).__name__ == type(jmodel).__name__
        le = tcli.load_label_encoder(f"{who}_{name}_le.pkl")
        assert list(le.classes_) == ["cat", "dog", "person"]
    res = predict_app.main([
        "--svm_model", f"port_{name}.pkl", "--label_encoder", f"port_{name}_le.pkl",
        "--platform", "cpu", "--num_scans", "4", "--batch_scans", "4",
        "--mode", "exact", "--proj_mask", *BASE[-3:], "--log_file", "predict.log"])
    assert len(res) >= 4
    assert {n for n, _ in res} <= {"person", "dog", "cat", "Unknown"}


def test_svc_features_are_the_scaled_samples(trained_svc):
    """The SVC path featurizes planes divided by RADAR_MAX before the
    split: the same features as process_samples(raw, scale=True)."""
    data = load_datasets(["ds.pickle"])
    raw = data["samples"][:20]
    scaled = [tuple(np.asarray(p) / RADAR_MAX for p in s) for s in raw]
    seen = []
    real = train_app.balance_classes

    def spy(labels, F, *a, **k):
        seen.append(F)
        return real(labels, F, *a, **k)

    train_app.balance_classes = spy
    try:
        train_app._fit_svc(train_app.build_parser().parse_args(["--folds", "2"]),
                           torch.device("cpu"), tcli.parse_proj_mask([True] * 3),
                           scaled, np.arange(20) % 3)
    finally:
        train_app.balance_classes = real
    want = process_samples(raw, scale=True, device="cpu")
    torch.testing.assert_close(seen[0], want, atol=1e-6, rtol=1e-5)
    assert float(seen[0].max()) <= 1.0 + 1e-6


def test_train_app_online_learning_continues_model(trained):
    """--online_learn loads the saved model and continues fitting it with
    its hyperparameters and schedule position, without overwriting the
    label encoder (reference train.py:409-416, 733-737), as the JAX app
    does."""
    import time

    le_mtime = os.path.getmtime("port_sgd_le.pkl")
    before = _artifact("port_sgd.pkl")
    time.sleep(0.05)
    args = ["--online_learn", *BASE[:2], "--grid_epochs", "3", *BASE[4:]]
    out = train_app.main([*args, *_args("port_sgd"), "--platform", "cpu"])
    jtrain.main([*args, *_args("jax_sgd")])
    assert out["kind"] == "linear" and out["grid"] is None
    assert os.path.getmtime("port_sgd_le.pkl") == le_mtime
    after, jax_after = _artifact("port_sgd.pkl"), _artifact("jax_sgd.pkl")
    assert after["sgd_cfg"] == before["sgd_cfg"]
    assert after["sgd_t"] > before["sgd_t"] and after["sgd_t"] == jax_after["sgd_t"]
    assert not np.array_equal(after["coef"], before["coef"])
    scale = float(np.abs(jax_after["coef"]).max())
    assert float(np.abs(after["coef"] - jax_after["coef"]).max()) <= 1e-5 * scale


def test_train_app_augment_epochs(workdir):
    for fam in ([], ["--use_svc"]):
        out = train_app.main(["--synthetic", "30", "--datasets", "ds_aug.pickle",
                              "--grid_epochs", "3", "--folds", "3", "--epochs", "1",
                              "--proj_mask", "False", "False", "True",
                              "--platform", "cpu", *_args("aug"), *fam])
        assert out["kind"] == ("svc" if fam else "linear")
        assert 0.0 <= out["metrics"]["accuracy"] <= 1.0


def test_train_app_save_augmented_dumps_reference_schema(workdir):
    train_app.main(["--synthetic", "30", "--datasets", "ds_save_aug.pickle",
                    "--grid_epochs", "3", "--folds", "3", "--epochs", "1",
                    "--proj_mask", "False", "False", "True",
                    "--save_augmented", "aug_dump", "--platform", "cpu",
                    *_args("save_aug")])
    files = sorted(os.listdir("aug_dump"))
    assert files and all(f.startswith("batch_0_") and f.endswith(".pickle") for f in files)
    with open(os.path.join("aug_dump", files[0]), "rb") as fp:
        d = pickle.load(fp)
    assert set(d) == {"x_batch", "y_batch"}
    assert len(d["x_batch"]) == len(d["y_batch"]) > 0
    for v in d["x_batch"][0]:
        assert isinstance(v, np.ndarray) and v.ndim == 2
        assert 0.0 <= float(v.min()) and float(v.max()) <= 1.0


def test_train_app_without_matplotlib_writes_no_figure(workdir, monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    out = train_app.main(["--synthetic", "30", "--datasets", "ds_aug.pickle", "--use_svc",
                          "--folds", "3", "--proj_mask", "False", "False", "True",
                          "--platform", "cpu", *_args("nomatplotlib")])
    assert out["kind"] == "svc" and not os.path.exists("nomatplotlib_cm.png")
    with open("nomatplotlib.log") as fp:
        assert "matplotlib is not installed" in fp.read()


def test_train_app_raises_without_a_card(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        train_app.main([*BASE, *_args("nocard")])
