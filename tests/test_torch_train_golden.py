"""The golden asset radarml_tpu_torch/assets/golden_train.npz: one seeded
dataset's run of the JAX package's train app on the CPU, both families.

The dataset is make_dataset(GOLD_N, seed=GOLD_SEED, hardness=1.0),
written as a dataset pickle and trained with --proj_mask False False True
(the xy plane's 682 features, so that a fresh JAX run fits in a test).
The asset keeps both grids' per-candidate fold scores, the best
parameters, the SGD refit's coef and intercept and the app's test-split
predictions, the SVC refit's n_support and its test-split decisions and
predictions. `chip_smoke.py` phase 12 holds the card to it without
importing JAX, by the bars of `check_against_golden`:

- the fold scores: the reference's searches do not reproduce
  themselves to a test sample. The SGD walk's step size starts at
  alpha^(-1/4) (sklearn's 'optimal' schedule) and amplifies rounding;
  the SVC's degenerate candidates (gamma 1 and 10) hang on near-zero
  decisions. The asset keeps each family's JAX search run again on its
  training features moved one float32 ulp up and one down (np.nextafter):
  a fold score may differ from the asset's by at most the most those two
  runs differ from it, plus one test sample.
- SVC: the best parameters are equal; the test-split decisions are
  within atol 5e-4 / rtol 1e-3 (a tenth of tests/test_svc.py:86-87's
  bar, which the port met at 0.04x on the CPU and 0.0007x on an H100)
  with >= 98% equal predictions.
- SGD: the chosen candidate's mean score in the asset is within the
  largest spread of a candidate's mean score over the three JAX runs of
  the best mean score; the test-split predictions agree with the asset's
  at least as well as the one-ulp JAX runs' do (at most 98% is asked).

Regenerate with:  JAX_PLATFORMS=cpu python tests/test_torch_train_golden.py
(about a minute: three searches of each family on the CPU).
"""

import importlib.util
import json
import os
import pickle
import sys
import tempfile
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ASSET = REPO / "radarml_tpu_torch" / "assets" / "golden_train.npz"
GOLD_SEED, GOLD_N, GOLD_HARDNESS = 1234, 150, 1.0
GOLD_MASK = ["False", "False", "True"]
FOLDS = 5

torch.set_num_threads(1)


def run_app(argv):
    """The JAX package's train app on `argv`: (its result, the
    GridSearchResult its search returned, which the app does not return,
    and the search's arguments and keywords)."""
    from radarml_tpu.apps import train as app

    calls = []
    saved = app.grid_search_sgd, app.grid_search_svc

    def wrap(fn):
        def inner(*a, **k):
            res = fn(*a, **k)
            calls.append((res, a, k))
            return res
        return inner

    app.grid_search_sgd, app.grid_search_svc = (wrap(f) for f in saved)
    try:
        out = app.main(list(argv))
    finally:
        app.grid_search_sgd, app.grid_search_svc = saved
    return (out, *calls[0])


def app_args(d, name, *extra):
    return ["--svm_model", os.path.join(d, f"{name}.pkl"),
            "--label_encoder", os.path.join(d, f"{name}_le.pkl"),
            "--svm_cm", os.path.join(d, f"{name}_cm.png"),
            "--log_file", os.path.join(d, f"{name}.log"), *extra]


def write_golden_dataset(path):
    from radarml_tpu_torch.data.store import save_dataset
    from radarml_tpu_torch.data.synthetic import make_dataset

    samples, labels = make_dataset(GOLD_N, seed=GOLD_SEED, hardness=GOLD_HARDNESS)
    save_dataset(path, samples, labels, append=False)


def split_of(path):
    """The JAX package's helpers along the app's flow on the dataset at
    `path`: ((val features, y_val), (test features, y_test), balanced
    training labels), the features the xy plane's, as numpy."""
    from radarml_tpu.core.arena import RADAR_MAX, ProjMask
    from radarml_tpu.data.balance import balance_classes
    from radarml_tpu.data.labels import LabelEncoder, filter_samples
    from radarml_tpu.data.split import train_val_test_split
    from radarml_tpu.data.store import load_datasets
    from radarml_tpu.ops.features import process_samples

    data = load_datasets([path])
    samples, labels = filter_samples(data["samples"], data["labels"],
                                     ["person", "dog", "cat"])
    samples = [tuple(np.asarray(p) / RADAR_MAX for p in s) for s in samples]
    _, y = LabelEncoder.fit_transform(labels)
    (_, y_train), (X_val, y_val), (X_test, y_test) = train_val_test_split(
        samples, y, (0.8, 0.1, 0.1), seed=1234)
    y_bal, _ = balance_classes(y_train, np.zeros(len(y_train)))
    mask = ProjMask(False, False, True)

    def feats(X):
        return np.asarray(process_samples(X, proj_mask=mask))

    return ((feats(X_val), np.asarray(y_val)), (feats(X_test), np.asarray(y_test)),
            np.asarray(y_bal))


def golden_run(d: str, spread: bool = False) -> dict:
    """Both families of the JAX package's train app on the golden dataset
    in `d`: the golden record's fields (with `spread`, the JAX package's
    own spread under a one-ulp change of its features too)."""
    import jax.numpy as jnp

    from radarml_tpu.apps.common_cli import load_model
    from radarml_tpu.models import svc as jsvc
    from radarml_tpu.models.linear import predict_proba_calibrated
    from radarml_tpu.train.gridsearch import stratified_kfold_indices

    path = os.path.join(d, "golden.pickle")
    write_golden_dataset(path)
    base = ["--datasets", path, "--proj_mask", *GOLD_MASK, "--folds", str(FOLDS)]
    sgd, sgd_grid, sgd_args, sgd_kw = run_app(base + app_args(d, "sgd"))
    svc_out, svc_grid, svc_args, svc_kw = run_app(base + app_args(d, "svc", "--use_svc"))
    (F_val, y_val), (F_test, y_test), y_bal = split_of(path)
    fold_sizes = [len(te) for _, te in stratified_kfold_indices(y_bal, FOLDS)]
    model = svc_out["model"]
    # the app's test-split predictions: its saved calibrated model on the
    # test features (the JAX app does not return them)
    lin, calib = load_model(os.path.join(d, "sgd.pkl"))
    sgd_pred = np.asarray(predict_proba_calibrated(lin, calib, jnp.asarray(F_test))).argmax(1)

    def scores(grid):
        return np.asarray([r["split_scores"] for r in grid.cv_results], np.float64)

    out = dict(
        data_seed=np.int32(GOLD_SEED), n_samples=np.int32(GOLD_N),
        hardness=np.float32(GOLD_HARDNESS), folds=np.int32(FOLDS),
        fold_sizes=np.asarray(fold_sizes, np.int32),
        y_test=np.asarray(y_test, np.int32),
        sgd_params=np.asarray(json.dumps(sgd_grid.best_params, sort_keys=True)),
        sgd_scores=scores(sgd_grid), sgd_coef=np.asarray(sgd["model"].coef, np.float32),
        sgd_intercept=np.asarray(sgd["model"].intercept, np.float32),
        sgd_test_pred=np.asarray(sgd_pred, np.int32),
        svc_params=np.asarray(json.dumps(svc_grid.best_params, sort_keys=True)),
        svc_scores=scores(svc_grid),
        svc_n_support=np.asarray(model.n_support, np.int32),
        svc_test_dec=np.asarray(jsvc.decision_function_ovo(model, F_test), np.float32),
        svc_test_pred=np.asarray(jsvc.predict(model, F_test), np.int32),
    )
    if spread:
        out.update(_jax_spread({"sgd": (sgd_args, sgd_kw), "svc": (svc_args, svc_kw)},
                               F_val, y_val, F_test, out))
    return out


def _jax_spread(calls, F_val, y_val, F_test, base) -> dict:
    """Each family's JAX search again on its training features moved one
    ulp up and one down (np.nextafter): the runs' fold scores, and how
    well the SGD runs' test-split predictions (through the app's
    calibration) agree with the first run's."""
    import jax.numpy as jnp

    from radarml_tpu.models.linear import calibrate_ovr, predict_proba_calibrated
    from radarml_tpu.train import gridsearch as jg

    out, agree = {}, []
    for fam, (args, kw) in calls.items():
        X, y = np.asarray(args[0], np.float32), args[1]
        runs = []
        for to in (np.inf, -np.inf):
            res = getattr(jg, f"grid_search_{fam}")(np.nextafter(X, np.float32(to)), y, **kw)
            runs.append([r["split_scores"] for r in res.cv_results])
            if fam == "sgd":
                model, _ = res.best_model
                calib = calibrate_ovr(model, F_val, y_val)
                pred = np.asarray(predict_proba_calibrated(model, calib, jnp.asarray(F_test)))
                agree.append(float((pred.argmax(1) == base["sgd_test_pred"]).mean()))
        out[f"{fam}_ulp_scores"] = np.asarray(runs, np.float64)
    out["sgd_self_agree"] = np.float64(min(agree))
    return out


def generate() -> dict:
    with tempfile.TemporaryDirectory() as d:
        return golden_run(d, spread=True)


def load() -> dict:
    with np.load(ASSET) as f:
        return {k: f[k] for k in f.files}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_against_golden(got: dict, g: dict) -> dict:
    """The bars of the module docstring (chip_smoke.golden_train_check,
    which phase 12 applies on the card); returns what was measured."""
    return _chip_smoke().golden_train_check(got, g)


BASE_KEYS = ("data_seed", "n_samples", "hardness", "folds", "fold_sizes", "y_test",
             "sgd_params", "sgd_scores", "sgd_coef", "sgd_intercept", "sgd_test_pred",
             "svc_params", "svc_scores", "svc_n_support", "svc_test_dec", "svc_test_pred")


@pytest.fixture(scope="module")
def golden():
    return load()


def test_asset_is_small_and_consistent(golden):
    assert ASSET.stat().st_size < 64 * 1024
    assert (int(golden["data_seed"]), int(golden["n_samples"])) == (GOLD_SEED, GOLD_N)
    assert float(golden["hardness"]) == GOLD_HARDNESS
    assert golden["sgd_scores"].shape == (35, FOLDS)
    assert golden["svc_scores"].shape == (30, FOLDS)
    assert golden["sgd_ulp_scores"].shape == (2, 35, FOLDS)
    assert golden["svc_ulp_scores"].shape == (2, 30, FOLDS)
    n_test = len(golden["y_test"])
    assert golden["svc_test_dec"].shape == (n_test, 3)
    assert golden["sgd_coef"].shape == (3, 682)
    assert int(golden["svc_n_support"].sum()) > 0
    # the JAX run meets its own bars
    check_against_golden(golden, golden)


def test_asset_matches_fresh_jax_run(golden, tmp_path):
    """The JAX package's app, run again at the asset's seed, writes the
    asset's record (the one-ulp runs are not repeated here)."""
    fresh = golden_run(str(tmp_path))
    for k in BASE_KEYS:
        if golden[k].dtype.kind == "f":
            np.testing.assert_allclose(fresh[k], golden[k], atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(fresh[k], golden[k], err_msg=k)


def test_port_dataset_for_the_asset_equals_jax(tmp_path):
    """The card rebuilds the golden dataset with the port's generator:
    the same pickle the JAX package's would write."""
    from radarml_tpu.data.synthetic import make_dataset as jmake

    write_golden_dataset(str(tmp_path / "g.pickle"))
    with open(tmp_path / "g.pickle", "rb") as fp:
        data = pickle.load(fp)
    samples, labels = jmake(GOLD_N, seed=GOLD_SEED, hardness=GOLD_HARDNESS)
    assert data["labels"] == list(labels)
    for a, b in zip(data["samples"], samples):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = generate()
    np.savez_compressed(ASSET, **out)
    print(f"wrote {ASSET} ({ASSET.stat().st_size} bytes): SGD {out['sgd_params']}, "
          f"SVC {out['svc_params']}", file=sys.stderr)
