"""The port's predict and serve apps on the CPU (--platform cpu).

The predict and serve cases of tests/test_apps.py re-run against
radarml_tpu_torch.apps, on the demo linear model
(radarml_tpu_torch/assets/demo_linear.npz, written as a radarml_tpu.v1
artifact: nothing is trained here). The predict app's result list equals
the JAX app's on the same artifact and --driver_seed, in exact, fast and
fused mode (the JAX fused kernel runs interpreted on the CPU): the same
names, probabilities within 1e-5 (float32 in two libraries; the bar of
tests/test_torch_golden.py).

The port has no Mosaic gate and no fallback: the JAX package's gate
tests have one twin here, in which the combo kernel's entry raises and
each app's main raises with it.
"""

import argparse
import glob
import json
import os

import numpy as np
import pytest
import torch

from radarml_tpu.apps import common_cli as jcli
from radarml_tpu.apps import predict as jpredict
from radarml_tpu_torch.apps import common_cli as tcli
from radarml_tpu_torch.apps import predict as predict_app
from radarml_tpu_torch.apps import serve as serve_app
from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena
from radarml_tpu_torch.data.labels import LabelEncoder
from radarml_tpu_torch.drivers import RadarSession, SyntheticRadar
from radarml_tpu_torch.drivers import base as driver_base
from radarml_tpu_torch.models import pipeline as pipeline_mod
from radarml_tpu_torch.models.pipeline import UNKNOWN, RadarPredictor, pad_targets

torch.set_num_threads(1)

ASSET = os.path.join(os.path.dirname(__file__), os.pardir, "radarml_tpu_torch",
                     "assets", "demo_linear.npz")
# 7 x 7 x 26 scans zoomed into the default training arena: keeps the JAX
# fused kernel's interpreter cheap.
SMALL_ARENA = "10,60,2,-42,42,14,-30,30,10"
CLASSES = {"person", "dog", "cat", "Unknown"}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_apps")
    g = np.load(ASSET)
    model, le = str(d / "svm.pickle"), str(d / "le.pickle")
    tcli.save_model(model, "linear", coef=g["coef"], intercept=g["intercept"],
                    calib_a=g["calib_a"], calib_b=g["calib_b"],
                    classes=[str(c) for c in g["classes"]])
    tcli.save_label_encoder(le, LabelEncoder(tuple(str(c) for c in g["classes"])))
    return d, ["--svm_model", model, "--label_encoder", le]


def _predict(artifacts, *argv, app=predict_app, platform=True):
    d, files = artifacts
    args = [*files, "--log_file", str(d / "predict.log"), "--min_proba", "0.0", *argv]
    return app.main(args + (["--platform", "cpu"] if platform else []))


def _serve(artifacts, *argv):
    _, files = artifacts
    return serve_app.main([*files, "--platform", "cpu", "--min_proba", "0.0",
                           "--driver", "synthetic", *argv])


def test_predict_app_runs(artifacts):
    results = _predict(artifacts, "--num_scans", "4")
    assert results  # at least one target classified
    assert {n for n, _ in results} <= CLASSES
    for _, p in results:
        assert 0.0 <= p <= 1.0


def test_predict_app_fused_mode(artifacts):
    """--mode fused drives the one-read int8 table kernel's entry point
    (its plain version on the CPU) through the CLI batch loop."""
    results = _predict(artifacts, "--num_scans", "4", "--batch_scans", "2",
                       "--mode", "fused")
    assert results
    assert {n for n, _ in results} <= CLASSES


@pytest.mark.parametrize("mode", [
    ["--mode", "exact"],
    ["--mode", "fast"],
    ["--mode", "fused", "--batch_scans", "3"],
], ids=["exact", "fast", "fused"])
def test_predict_app_matches_jax_app(artifacts, mode):
    argv = ["--num_scans", "6", "--scan_arena", SMALL_ARENA, "--driver_seed", "31",
            *mode]
    got = _predict(artifacts, *argv)
    want = _predict(artifacts, *argv, app=jpredict, platform=False)
    assert got and len(got) == len(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                               atol=1e-5, rtol=0)


def test_fused_decisions_equal_fast_int8(artifacts):
    fused = _predict(artifacts, "--num_scans", "8", "--batch_scans", "4",
                     "--mode", "fused", "--driver_seed", "5")
    fast = _predict(artifacts, "--num_scans", "8", "--batch_scans", "4",
                    "--mode", "fast", "--cube_dtype", "int8", "--driver_seed", "5")
    assert [n for n, _ in fused] == [n for n, _ in fast]
    np.testing.assert_allclose([p for _, p in fused], [p for _, p in fast],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("app", ["predict", "serve"])
def test_fused_kernel_failure_raises(artifacts, monkeypatch, app):
    """No gate and no fallback: when the combo kernel's entry point
    fails, main raises instead of serving in another mode or device."""
    def broken(*a, **k):
        raise RuntimeError("i8_score_onepass_tables launch failed")

    monkeypatch.setattr(pipeline_mod, "onepass_tables_combined_i8", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        if app == "predict":
            _predict(artifacts, "--num_scans", "2", "--mode", "fused")
        else:
            _serve(artifacts, "--duration", "1", "--mode", "fused", "--max_batch", "4")


@pytest.mark.parametrize("app", [predict_app, serve_app], ids=["predict", "serve"])
def test_apps_raise_without_a_card(artifacts, monkeypatch, app):
    """Without --platform cpu the apps compute on the card; with none
    they raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, files = artifacts
    with pytest.raises(RuntimeError, match="--platform cpu"):
        app.main([*files, "--log_file", str(d / "predict.log"), "--num_scans", "1"]
                 if app is predict_app else [*files, "--duration", "1"])


def test_platform_flag_picks_the_device(monkeypatch):
    p = argparse.ArgumentParser()
    tcli.add_common_flags(p)
    assert tcli.device_of(p.parse_args(["--platform", "cpu"])) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tcli.device_of(p.parse_args([])) == torch.device("cuda", 0)


@pytest.mark.parametrize("app", ["predict", "serve"])
def test_fused_quant_single(artifacts, monkeypatch, app):
    """--fused_quant single builds the single-level predictor and the
    app still classifies end to end."""
    built = {}
    real = pipeline_mod.RadarPredictor

    def spy(*a, **k):
        p = real(*a, **k)
        built.update(mode=p.mode, fused_quant=p.fused_quant)
        return p

    module = predict_app if app == "predict" else serve_app
    monkeypatch.setattr(module, "RadarPredictor", spy)
    if app == "predict":
        assert _predict(artifacts, "--num_scans", "2", "--mode", "fused",
                        "--fused_quant", "single")
    else:
        stats = _serve(artifacts, "--duration", "1.5", "--mode", "fused",
                       "--fused_quant", "single", "--max_batch", "8")
        assert stats["processed"] > 0 and stats["predict_errors"] == 0
    assert built == {"mode": "fused", "fused_quant": "single"}


def test_serve_app_streams_detections(artifacts, capsys):
    stats = _serve(artifacts, "--duration", "2", "--mode", "fast", "--max_batch", "8")
    assert stats["processed"] > 0 and stats["predict_errors"] == 0
    assert stats["latency_p50_ms"] > 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["processed"] == stats["processed"]  # the JSON stats line


def test_serve_app_mode_fused_default_dtype(artifacts):
    """serve --mode fused works with the default --cube_dtype (bfloat16):
    the fused stream is int8 whatever was asked for."""
    stats = _serve(artifacts, "--duration", "2", "--mode", "fused", "--max_batch", "8")
    assert stats["processed"] > 0 and stats["predict_errors"] == 0


@pytest.mark.parametrize("driver", ["native", "synthetic"])
def test_serve_app_drivers_and_sensors(artifacts, driver):
    stats = _serve(artifacts, "--duration", "2", "--mode", "fused", "--max_batch", "8",
                   "--driver", driver, "--sensors", "3")
    assert stats["processed"] > 0 and stats["predict_errors"] == 0


def test_predict_app_derived_targets(artifacts, monkeypatch):
    """One derived target per scan, at derive_targets of the scan's cube."""
    seen = []
    real = predict_app.derive_targets

    def spy(cube, arena, num_targets=1):
        out = real(cube, arena, num_targets)
        seen.append((cube.clone(), [float(v[0]) for v in out[:3]]))
        return out

    monkeypatch.setattr(predict_app, "derive_targets", spy)
    results = _predict(artifacts, "--num_scans", "3", "--derived_targets")
    assert len(results) >= 3
    assert len(seen) == 3
    for cube, xyz in seen:
        # the strongest profile cells, on the CPU, by hand
        c = cube.double()
        ijk = [int(torch.argmax(c.sum(dim=dims))) for dims in ((1, 2), (0, 2), (0, 1))]
        want = DEFAULT_ARENA.grid_to_cartesian(*ijk)
        np.testing.assert_allclose(xyz, [float(w) for w in want], atol=1e-5)


def test_predict_app_profile_writes_a_trace(artifacts, tmp_path):
    out = tmp_path / "trace"
    assert _predict(artifacts, "--num_scans", "2", "--profile", str(out))
    traces = glob.glob(str(out / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as fp:
        assert json.load(fp)["traceEvents"]


def test_driver_flags_threshold_and_mti(artifacts, monkeypatch):
    """--threshold / --mti reach the driver, and --mti=false runs the
    explicit calibration loop before the scan loop (reference
    predict.py:203-213, common.py:82-91)."""
    p = argparse.ArgumentParser()
    tcli.add_driver_flags(p)
    args = p.parse_args(["--threshold", "7.5", "--mti", "false"])
    driver = tcli.build_driver(args)
    assert driver.threshold == 7.5 and driver.mti is False
    assert tcli.build_driver(p.parse_args([])).threshold == 5.0  # reference default

    calibrated = []
    real_calibrate = driver_base.calibrate

    def spying_calibrate(d, max_triggers=100):
        n = real_calibrate(d, max_triggers)
        calibrated.append(n)
        return n

    monkeypatch.setattr(driver_base, "calibrate", spying_calibrate)
    assert _predict(artifacts, "--num_scans", "2", "--mti", "false")
    assert calibrated and calibrated[0] > 0  # calibration loop actually ran

    calibrated.clear()
    _predict(artifacts, "--num_scans", "2")
    assert not calibrated  # MTI on (default): no calibration pass


def test_predict_app_cross_scan_arena(artifacts):
    """--scan_arena: the CLI serves scans from a finer arena than the
    model was trained on, and its predictions match the library
    cross-arena predictor fed the very same driver scans."""
    arena_spec = "10,360,1,-42,42,2,-30,30,2"  # finer r and theta
    scan_arena = Arena(r_res=1.0, theta_res=2.0)
    results = _predict(artifacts, "--num_scans", "3", "--scan_arena", arena_spec,
                       "--driver_seed", "77")
    assert results, "cross-arena CLI produced no classifications"

    _, files = artifacts
    model, calib = tcli.load_model(files[1], device="cpu")
    le = tcli.load_label_encoder(files[3])
    predictor = RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=scan_arena,
        model=model, calibration=calib, min_proba=0.0,
    )
    expected = []
    with RadarSession(SyntheticRadar(arena=scan_arena, seed=77, max_targets=2)) as radar:
        for _ in range(3):
            radar.trigger()
            targets = radar.get_sensor_targets()
            if not targets:
                continue
            xyz, valid = pad_targets([[(t.x, t.y, t.z) for t in targets]], 4)
            pred, proba, _ = predictor(radar.get_raw_image()[None], xyz, valid)
            for t in range(int(valid[0].sum())):
                name = ("Unknown" if pred[0, t] == UNKNOWN
                        else le.classes_[int(pred[0, t])])
                expected.append((name, float(proba[0, t])))
    assert [n for n, _ in results] == [n for n, _ in expected]
    np.testing.assert_allclose([p for _, p in results], [p for _, p in expected],
                               atol=1e-6, rtol=0)


def test_predict_app_pins_batch_shape(artifacts, monkeypatch):
    """Partial batches (scans whose target list is empty are dropped)
    pad to --batch_scans with valid=False rows, so every classify call
    runs one batch shape."""
    shapes = []
    real_predictor = pipeline_mod.RadarPredictor

    class Spy:
        def __init__(self, *a, **k):
            self._p = real_predictor(*a, **k)

        def __call__(self, cubes, xyz, valid):
            shapes.append((cubes.shape[0], bool(valid.all())))
            return self._p(cubes, xyz, valid)

    class FlakyTargets:
        """Wraps the session driver: every other scan has no targets."""

        def __init__(self, inner):
            self._inner = inner
            self._n = 0

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def get_sensor_targets(self):
            self._n += 1
            if self._n % 2 == 0:
                return []
            return self._inner.get_sensor_targets()

    real_build = predict_app.build_driver
    monkeypatch.setattr(predict_app, "RadarPredictor", Spy)
    monkeypatch.setattr(predict_app, "build_driver",
                        lambda *a, **k: FlakyTargets(real_build(*a, **k)))
    assert _predict(artifacts, "--num_scans", "4", "--batch_scans", "4")
    assert shapes, "predictor never called"
    assert all(b == 4 for b, _ in shapes)
    assert any(not all_valid for _, all_valid in shapes)


def test_label_encoder_v1_round_trip_with_jax(tmp_path):
    """Either package reads the other's v1 label encoder; a pickle of
    another class is refused before it is imported."""
    import pickle

    jpath, tpath = str(tmp_path / "j.pickle"), str(tmp_path / "t.pickle")
    classes = ("cat", "dog", "person")
    jcli.save_label_encoder(jpath, jcli.LabelEncoder(classes_=classes))
    tcli.save_label_encoder(tpath, LabelEncoder(classes_=classes))
    assert tcli.load_label_encoder(jpath).classes_ == classes
    assert tuple(jcli.load_label_encoder(tpath).classes_) == classes
    with open(tmp_path / "bad.pickle", "wb") as fp:
        pickle.dump(argparse.Namespace(classes_=classes), fp)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tcli.load_label_encoder(str(tmp_path / "bad.pickle"))
