"""Neural-family serving in the port: CNN / SGAN classifiers through
RadarPredictor, the v1 artifacts and the apps (the cases of
tests/test_neural_serving.py, on the port).

The same numpy-made weights (models/cnn.cnn_init_tree,
models/sgan.sgan_init_trees) serve in both packages, on the same scans.
Decisions are equal where the JAX top-2 margin exceeds 1e-4 and the
probabilities agree within 1e-5 (float32 in two libraries: the slices,
the bicubic products and the network in another summation order;
measured ≤ 2e-7). The export round trip of tests/test_neural_serving.py
is in tests/test_torch_export.py with the port's other artifact cases.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from radarml_tpu.apps import common_cli as jcli
from radarml_tpu.apps import predict as jpredict
from radarml_tpu.core.arena import DEFAULT_ARENA as JAX_ARENA
from radarml_tpu.models import pipeline as jpipe
from radarml_tpu.models.cnn import MultiViewCNN as JaxCNN
from radarml_tpu.models.sgan import Discriminator as JaxDisc
from radarml_tpu_torch.apps import common_cli as tcli
from radarml_tpu_torch.apps import predict as predict_app
from radarml_tpu_torch.apps import serve as serve_app
from radarml_tpu_torch.core.arena import DEFAULT_ARENA, RADAR_MAX
from radarml_tpu_torch.data.labels import LabelEncoder
from radarml_tpu_torch.data.preprocess import resize_views, scale_to_symmetric
from radarml_tpu_torch.models import cnn, sgan
from radarml_tpu_torch.models.pipeline import UNKNOWN, RadarPredictor, pad_targets

RESCALE = (16, 16)
MARGIN, PROBA_ATOL = 1e-4, 1e-5
CLASSES = ["cat", "dog", "person"]

torch.set_num_threads(1)


def perturbed(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if "var" in jax.tree_util.keystr(p)
                      else rng.normal(0, 0.1, a.shape)).astype(np.float32), stats)


def artifact(kind):
    """The payload of a v1 artifact as the JAX apps write it."""
    if kind == "cnn":
        return {"format": "radarml_tpu.v1", "kind": "cnn",
                "params": cnn.cnn_init_tree(3, RESCALE, seed=1), "classes": CLASSES,
                "rescale": RESCALE}
    _, (dp, ds) = sgan.sgan_init_trees(3, RESCALE, seed=2)
    return {"format": "radarml_tpu.v1", "kind": "sgan_classifier", "d_params": dp,
            "d_stats": perturbed(ds, 3), "classes": CLASSES, "rescale": RESCALE}


def jax_classifier(obj):
    if obj["kind"] == "cnn":
        module = JaxCNN(n_classes=3)

        def apply(views):
            return module.apply({"params": obj["params"]}, views, train=False)
    else:
        module = JaxDisc(n_classes=3)

        def apply(views):
            return module.apply({"params": obj["d_params"], "batch_stats": obj["d_stats"]},
                                tuple(views[..., i:i + 1] for i in range(3)), train=False)
    return jpipe.NeuralClassifier(apply=apply, rescale=RESCALE, n_classes=3)


@pytest.fixture(scope="module", params=["cnn", "sgan_classifier"])
def written(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    obj = artifact(request.param)
    path = str(d / "c_model.pickle")
    with open(path, "wb") as fp:
        pickle.dump(obj, fp)
    le = str(d / "le.pickle")
    tcli.save_label_encoder(le, LabelEncoder(tuple(CLASSES)))
    return obj, path, le


def scans(seed, B, T):
    rng = np.random.default_rng(seed)
    cubes = np.rint(rng.random((B,) + DEFAULT_ARENA.grid_shape) * RADAR_MAX).astype(np.float32)
    xyz_list = [[(5.0 * t - 3.0, -4.0 * t + b, 80.0 + 20 * b + 7 * t) for t in range(T - b % 2)]
                for b in range(B)]
    return cubes, xyz_list


def check_against_jax(got, want, valid):
    pred, _, proba = (np.asarray(x) for x in got)
    jpred, _, jproba = (np.asarray(x) for x in want)
    np.testing.assert_allclose(proba, jproba, rtol=0, atol=PROBA_ATOL)
    top2 = np.sort(jproba, axis=-1)
    sure = (top2[..., -1] - top2[..., -2] > MARGIN) & valid
    np.testing.assert_array_equal(pred[sure], jpred[sure])
    assert (pred[~valid] == UNKNOWN).all()


@pytest.mark.parametrize("cube_dtype", ["float32", "int8", "bfloat16"])
def test_predictor_matches_jax(written, cube_dtype):
    obj, path, _ = written
    model, calib = tcli.load_model(path, device="cpu")
    assert type(model).__name__ == "NeuralClassifier" and calib is None
    cubes, xyz_list = scans(2, 4, 3)
    xyz, valid = pad_targets(xyz_list, max_targets=3)
    ours = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, min_proba=0.0,
                          cube_dtype=cube_dtype)
    theirs = jpipe.RadarPredictor(train_arena=JAX_ARENA, scan_arena=JAX_ARENA,
                                  model=jax_classifier(obj), min_proba=0.0,
                                  cube_dtype=cube_dtype)
    check_against_jax(ours(cubes, xyz, valid), theirs(cubes, xyz, valid), valid)


def test_predictor_matches_training_preprocessing(written):
    """Predictor proba == slice → preprocess.resize_views → forward → softmax."""
    obj, path, _ = written
    model, _ = tcli.load_model(path, device="cpu")
    predictor = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, min_proba=0.0)
    cubes, xyz_list = scans(5, 3, 2)
    xyz_list = [t[:1] + t[:1] for t in xyz_list]
    xyz, valid = pad_targets(xyz_list, max_targets=2)
    pred, _, proba = predictor(cubes, xyz, valid)
    planes = {"xz": [], "yz": [], "xy": []}
    for b in range(3):
        for x, y, z in xyz_list[b]:
            i, j, k = (int(v) for v in DEFAULT_ARENA.clamped_matrix_indices(
                torch.tensor(x), torch.tensor(y), torch.tensor(z)))
            planes["yz"].append(cubes[b][i, :, :])
            planes["xz"].append(cubes[b][:, j, :])
            planes["xy"].append(cubes[b][:, :, k])
    views = resize_views(*(scale_to_symmetric(np.stack(planes[p])) for p in ("xz", "yz", "xy")),
                         RESCALE, device="cpu")
    with torch.no_grad():
        expect = torch.softmax(model.apply(views), -1).reshape(3, 2, 3)
    torch.testing.assert_close(proba, expect, rtol=0, atol=2e-6)
    assert torch.equal(pred, expect.argmax(-1).to(torch.int32))


def test_threshold_mask_and_refused_modes(written):
    _, path, _ = written
    model, _ = tcli.load_model(path, device="cpu")
    predictor = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, min_proba=1.1)
    rng = np.random.default_rng(3)
    cubes = rng.random((2,) + DEFAULT_ARENA.grid_shape).astype(np.float32)
    xyz, valid = pad_targets([[(0.0, 0.0, 100.0)], []], max_targets=2)
    pred, _, _ = predictor(cubes, xyz, valid)
    assert (pred == UNKNOWN).all()
    with pytest.raises(ValueError, match="linear"):
        RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, mode="fused")
    with pytest.raises(ValueError):
        RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, mode="pallas", cube_dtype="int8")


def test_jax_written_artifact_served_by_port_predict_app(written, tmp_path):
    _, path, le = written
    argv = ["--svm_model", path, "--label_encoder", le, "--min_proba", "0.0",
            "--num_scans", "5", "--driver_seed", "17", "--log_file", str(tmp_path / "p.log")]
    got = predict_app.main(argv + ["--platform", "cpu"])
    want = jpredict.main(argv)
    assert got and len(got) == len(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=PROBA_ATOL,
                               rtol=0)


def test_port_written_artifact_loads_in_jax(written, tmp_path):
    """The port's artifact (as its dnn / sgan apps write it, from its own
    modules) loads in the JAX package and serves the same answers."""
    obj, path, _ = written
    model, _ = tcli.load_model(path, device="cpu")
    module = model.apply.func if hasattr(model.apply, "func") else model.apply
    out = str(tmp_path / "port.pickle")
    if obj["kind"] == "cnn":
        tcli.save_model(out, "cnn", params=cnn.cnn_params_to_numpy(module), classes=CLASSES,
                        rescale=RESCALE, history={"loss": [1.0]})
    else:
        dp, ds = sgan.sgan_params_to_numpy(module)
        tcli.save_model(out, "sgan_classifier", d_params=dp, d_stats=ds, classes=CLASSES,
                        rescale=RESCALE)
    jmodel, jcalib = jcli.load_model(out)
    assert type(jmodel).__name__ == "NeuralClassifier" and jcalib is None
    cubes, xyz_list = scans(9, 3, 2)
    xyz, valid = pad_targets(xyz_list, max_targets=2)
    theirs = jpipe.RadarPredictor(train_arena=JAX_ARENA, scan_arena=JAX_ARENA,
                                  model=jmodel, min_proba=0.0)
    ours = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, min_proba=0.0)
    check_against_jax(ours(cubes, xyz, valid), theirs(cubes, xyz, valid), valid)
    # and the payload round-trips through the port's loader bit for bit
    with open(out, "rb") as fp:
        again = pickle.load(fp)
    key = "params" if obj["kind"] == "cnn" else "d_params"
    for a, b in zip(jax.tree.leaves(again[key]), jax.tree.leaves(obj[key])):
        assert np.array_equal(a, b)


def test_artifact_serves_in_the_serve_app(written):
    _, path, le = written
    stats = serve_app.main(["--svm_model", path, "--label_encoder", le, "--platform", "cpu",
                            "--duration", "1.5", "--scan_period", "0.05", "--max_batch", "4",
                            "--min_proba", "0.0"])
    assert stats["processed"] > 0 and stats["predict_errors"] == 0


def test_jax_neural_classifier_path_refuses_nothing_new():
    """The JAX package serves neural models in exact mode with a bf16
    stream too; the port does the same (no mode the JAX package accepts
    is refused)."""
    obj = artifact("cnn")
    model = tcli.neural_classifier(cnn.MultiViewCNN(3, RESCALE), RESCALE, "cpu")
    for mode in ("exact", "fast", "pallas"):
        RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, mode=mode, cube_dtype="bfloat16")
        jpipe.RadarPredictor(train_arena=JAX_ARENA, scan_arena=JAX_ARENA,
                             model=jax_classifier(obj), mode=mode, cube_dtype="bfloat16")
