"""The port's dnn and sgan apps on the CPU (--platform cpu), on
--synthetic data at a small size.

Each app writes a servable c_model.pickle (served here by the port's
RadarPredictor and loaded by the JAX package's common_cli.load_model),
its text summaries (equal to the JAX package's model_summary of the same
tree) and train.log; the PNG summaries where matplotlib imports. A run
resumed from the dnn app's checkpoints ends where an uninterrupted one
does. Without a card and without --platform cpu both apps raise.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from radarml_tpu.apps import common_cli as jcli
from radarml_tpu.utils.summary import model_summary as jax_model_summary
from radarml_tpu_torch.apps import common_cli as tcli
from radarml_tpu_torch.apps import dnn as dnn_app
from radarml_tpu_torch.apps import sgan as sgan_app
from radarml_tpu_torch.core.arena import DEFAULT_ARENA
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets

torch.set_num_threads(1)


def check_servable(path, kind, rescale):
    with open(path, "rb") as fp:
        obj = pickle.load(fp)
    assert obj["format"] == "radarml_tpu.v1" and obj["kind"] == kind
    assert tuple(obj["rescale"]) == rescale
    model, _ = tcli.load_model(path, device="cpu")
    jmodel, _ = jcli.load_model(path)
    assert type(jmodel).__name__ == "NeuralClassifier"
    cubes = np.random.default_rng(0).random((2,) + DEFAULT_ARENA.grid_shape) * 255
    xyz, valid = pad_targets([[(0.0, 0.0, 90.0)], [(3.0, 2.0, 150.0)]], 1)
    pred, best, proba = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model,
                                       min_proba=0.0)(cubes, xyz, valid)
    assert proba.shape == (2, 1, len(obj["classes"]))
    assert torch.isfinite(proba).all()
    return obj


def test_dnn_app_trains_and_writes_a_servable_artifact(tmp_path):
    d = str(tmp_path / "dnn")
    out = dnn_app.main(["--platform", "cpu", "--synthetic", "60", "--epochs", "3",
                        "--batch_size", "16", "--results_dir", d])
    assert len(out["history"]["loss"]) == 3
    assert np.isfinite(out["history"]["val_loss"]).all()
    obj = check_servable(out["model_path"], "cnn", (80, 80))
    assert obj["history"] == out["history"]
    text = open(os.path.join(d, "c_model_summary.txt")).read()
    assert text.splitlines()[2:] == jax_model_summary(obj["params"]).splitlines()[2:]
    assert "epoch 3" in open(os.path.join(d, "train.log")).read()
    assert os.path.exists(os.path.join(d, "dnn_model.png"))


def test_dnn_app_resume_matches_uninterrupted(tmp_path):
    base = ["--platform", "cpu", "--synthetic", "30", "--batch_size", "8",
            "--checkpoint_every", "1"]
    full = dnn_app.main(base + ["--epochs", "3", "--results_dir", str(tmp_path / "a")])
    ck = str(tmp_path / "ck")
    dnn_app.main(base + ["--epochs", "2", "--results_dir", str(tmp_path / "b"),
                         "--checkpoint_dir", ck])
    res = dnn_app.main(base + ["--epochs", "3", "--results_dir", str(tmp_path / "c"),
                               "--checkpoint_dir", ck, "--resume"])
    assert res["history"] == full["history"]


def test_sgan_app_trains_and_writes_a_servable_artifact(tmp_path):
    d = str(tmp_path / "sgan")
    out = sgan_app.main(["--platform", "cpu", "--synthetic", "45", "--epochs", "1",
                         "--batch_size", "8", "--sup_samples", "9", "--rescale", "16",
                         "--results_dir", d])
    assert 0.0 <= out["val_accuracy"] <= 1.0
    obj = check_servable(out["model_path"], "sgan_classifier", (16, 16))
    assert set(obj) >= {"d_params", "d_stats", "classes"}
    text = open(os.path.join(d, "d_model_summary.txt")).read()
    assert text.splitlines()[2:] == jax_model_summary(obj["d_params"]).splitlines()[2:]
    assert os.path.exists(os.path.join(d, "g_model_summary.txt"))
    assert list((tmp_path / "sgan").glob("generated_data_*.pickle"))
    for name in ("g", "d", "c", "gan"):
        assert os.path.exists(os.path.join(d, f"sgan_{name}_model.png"))


@pytest.mark.parametrize("app", [dnn_app, sgan_app], ids=["dnn", "sgan"])
def test_apps_raise_without_a_card(app, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        app.main(["--synthetic", "9", "--results_dir", str(tmp_path)])


def test_dnn_mesh_raises(tmp_path, monkeypatch):
    """--mesh 2 outside a group of two ranks says how to launch it (the
    torchrun run is in tests/test_torch_mesh_train.py)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run --nproc-per-node 2"):
        dnn_app.main(["--platform", "cpu", "--mesh", "2", "--results_dir", str(tmp_path)])


def test_apps_skip_figures_without_matplotlib(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = str(tmp_path / "dnn")
    dnn_app.main(["--platform", "cpu", "--synthetic", "24", "--epochs", "1",
                  "--batch_size", "8", "--results_dir", d])
    assert os.path.exists(os.path.join(d, "c_model.pickle"))
    assert os.path.exists(os.path.join(d, "c_model_summary.txt"))
    assert not os.path.exists(os.path.join(d, "dnn_model.png"))
    assert "model figure(s) skipped" in open(os.path.join(d, "train.log")).read()
