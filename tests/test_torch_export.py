"""The port's AOT serving artifacts: the cases of tests/test_export.py,
the fused hot-reload case of tests/test_reload.py and the neural export
case of tests/test_neural_serving.py, re-run on radarml_tpu_torch on the
CPU, and the loader's refusals of other formats and devices
(tests/test_torch_export_ops.py has the refusals of unsafe programs, the
kernels as torch ops and the SVC program).

The same numpy-made model and scans go through the port's live
predictor, its artifact and, where the JAX test file has the case, the
JAX package's artifact. Tolerances, with their reasons:

* an artifact against the port's live predictor: bit for bit (the
  exported graph runs the same ops on the same device);
* the port's artifact against the JAX package's (fast mode, float32):
  probabilities within 1e-5 and decisions equal where the JAX top-2
  margin exceeds 1e-4 (float32 sums in another order, as in
  tests/test_torch_pipeline.py);
* the JAX test's own bar between its artifact and its live predictor,
  1e-6 on probabilities, is kept where the JAX test has it.
"""

import json
import logging
import pickle
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import DEFAULT_ARENA as JAX_ARENA
from radarml_tpu.models import linear as jlin
from radarml_tpu.models import pipeline as jpipe
from radarml_tpu.serving import export as jexport
from radarml_tpu_torch.apps import serve as serve_app
from radarml_tpu_torch.apps.common_cli import save_label_encoder, save_model
from radarml_tpu_torch.core.arena import DEFAULT_ARENA, RADAR_MAX
from radarml_tpu_torch.data.labels import LabelEncoder
from radarml_tpu_torch.models import linear as tlin
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets
from radarml_tpu_torch.serving import export_predictor, load_serving_artifact
from radarml_tpu_torch.serving.export import FORMAT, MAGIC

torch.set_num_threads(1)

CLASSES = ["cat", "dog", "person"]
MARGIN, PROBA_ATOL = 1e-4, 1e-5


def _weights():
    rng = np.random.default_rng(0)
    C, F = 3, DEFAULT_ARENA.feature_length
    return ((rng.normal(size=(C, F)) * 0.01).astype(np.float32), np.zeros(C, np.float32),
            -np.ones(C, np.float32), np.zeros(C, np.float32))


@pytest.fixture(scope="module")
def predictor():
    model, calib = tlin.from_numpy(*_weights(), device="cpu")
    return RadarPredictor(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
                          calibration=calib, mode="fast", cube_dtype="uint8", device="cpu")


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """The JAX package's artifact of the same model (fast, uint8)."""
    coef, intercept, a, b = _weights()
    p = jpipe.RadarPredictor(
        train_arena=JAX_ARENA, scan_arena=JAX_ARENA,
        model=jlin.LinearModel(coef=jnp.asarray(coef), intercept=jnp.asarray(intercept)),
        calibration=jlin.SigmoidCalibration(a=jnp.asarray(a), b=jnp.asarray(b)),
        mode="fast", cube_dtype="uint8")
    path = str(tmp_path_factory.mktemp("jax") / "serving.rmlx")
    jexport.export_predictor(p, path, max_targets=4)
    return path


def _cubes(rng, B):
    return np.rint(rng.random((B,) + DEFAULT_ARENA.grid_shape) * 255).astype(np.float32)


def _equal(live, got):
    for w, g in zip(live, got):
        assert torch.equal(torch.as_tensor(w), torch.as_tensor(g))


def test_export_roundtrip_bit_parity_and_symbolic_batch(tmp_path, predictor, jax_artifact):
    path = str(tmp_path / "serving.rmlx")
    meta = export_predictor(predictor, path, max_targets=4)
    assert meta["format"].startswith("radarml_tpu_torch.serving_export")
    assert meta["platforms"] == ["cpu"]

    art = load_serving_artifact(path, device="cpu")
    assert art.cube_dtype == "uint8" and art.max_targets == 4 and art.batch is None
    jart = jexport.load_serving_artifact(jax_artifact)

    rng = np.random.default_rng(1)
    # Three batch sizes through ONE artifact (symbolic batch), B = 1
    # included: torch.export specializes a dimension it sees at 1.
    for B in (1, 2, 7):
        cubes = _cubes(rng, B)
        xyz, valid = pad_targets([[(5.0, 5.0, 100.0 + 3 * b)] for b in range(B)],
                                 max_targets=4)
        got = art(cubes, xyz, valid)
        _equal(predictor(cubes, xyz, valid), got)
        jpred, _, jproba = (np.asarray(x) for x in jart(cubes, xyz, valid))
        np.testing.assert_allclose(got[2].numpy(), jproba, rtol=0, atol=PROBA_ATOL)
        top2 = np.sort(jproba, axis=-1)
        sure = (top2[..., -1] - top2[..., -2]) > MARGIN
        np.testing.assert_array_equal(got[0].numpy()[sure], jpred[sure])


@pytest.mark.parametrize("mode", ["exact", "pallas", "fast"])
def test_symbolic_artifact_serves_one_scan(tmp_path, predictor, mode):
    """B = 1 (the unary gRPC path and warm-up) and B = 3 through one
    artifact of each symbolic mode, bit-equal to the live predictor."""
    import dataclasses

    p = dataclasses.replace(predictor, mode=mode, cube_dtype="float32")
    path = str(tmp_path / f"{mode}.rmlx")
    export_predictor(p, path, max_targets=2)
    art = load_serving_artifact(path, device="cpu")
    rng = np.random.default_rng(3)
    cubes = _cubes(rng, 3)
    xyz, valid = pad_targets([[(1.0, -2.0, 90.0), (4.0, 3.0, 140.0)], [], [(0.0, 0.0, 60.0)]],
                             max_targets=2)
    for B in (1, 3):
        _equal(p(cubes[:B], xyz[:B], valid[:B]), art(cubes[:B], xyz[:B], valid[:B]))


@pytest.mark.parametrize("mode,dtype", [("pallas", "bfloat16"), ("exact", "float32"),
                                        ("fast", "int8")])
def test_artifact_lays_out_permuted_inputs(tmp_path, predictor, mode, dtype):
    """The program was traced on contiguous inputs and holds no layout
    step of its own, so ServingArtifact.__call__ hands it contiguous
    tensors whatever the caller's strides (a transposed host array): the
    program sees only contiguous inputs, and the answers equal the live
    predictor's on the same values, bit for bit."""
    import dataclasses

    p = dataclasses.replace(predictor, mode=mode, cube_dtype=dtype)
    path = str(tmp_path / f"{mode}.rmlx")
    export_predictor(p, path, max_targets=2)
    art = load_serving_artifact(path, device="cpu")
    seen, call = [], art.call

    def program(*args):
        seen.append([a.is_contiguous() for a in args])
        return call(*args)

    art = dataclasses.replace(art, call=program)
    rng = np.random.default_rng(5)
    cubes = torch.from_numpy(_cubes(rng, 3))
    strided = cubes.transpose(1, 2).contiguous().transpose(1, 2)
    xyz, valid = pad_targets([[(1.0, -2.0, 90.0)], [(4.0, 3.0, 140.0)], []], max_targets=2)
    xyz = torch.from_numpy(xyz)
    xyz_strided = xyz.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous() and not xyz_strided.is_contiguous()
    _equal(p(cubes, xyz, valid), art(strided, xyz_strided, valid))
    assert seen == [[True, True, True]]


def test_container_is_pickle_free_and_v1_pickles_are_refused(tmp_path, predictor):
    """MAGIC + JSON line + the programs' archives (no unpickler on load).
    The port has no legacy v1 pickle container: one is refused and its
    payload never runs, and allow_v1_pickle=True raises at once, whatever
    the file."""
    path = str(tmp_path / "serving.rmlx")
    export_predictor(predictor, path, max_targets=4)
    raw = open(path, "rb").read()
    assert raw.startswith(MAGIC)
    head, _, blob = raw[len(MAGIC):].partition(b"\n")
    meta = json.loads(head.decode("utf-8"))  # header is plain JSON
    assert meta["format"] == FORMAT and meta["format"].endswith(".v2")
    assert sum(meta["programs"].values()) == len(blob)

    from test_torch_export_ops import Payload

    marker = tmp_path / "ran"
    v1 = tmp_path / "serving_v1.pickle"
    with open(v1, "wb") as fp:
        pickle.dump({**meta, "format": "radarml_tpu.serving_export.v1", "blob": blob,
                     "payload": Payload(str(marker))}, fp)
    with pytest.raises(ValueError, match="not a serving artifact"):
        load_serving_artifact(str(v1), device="cpu")
    for either in (str(v1), path):
        with pytest.raises(ValueError, match="no legacy v1 pickle"):
            load_serving_artifact(either, allow_v1_pickle=True, device="cpu")
    assert not marker.exists()


def test_load_rejects_non_artifact(tmp_path):
    bogus = tmp_path / "bogus.pickle"
    with open(bogus, "wb") as fp:
        pickle.dump({"format": "something_else"}, fp)
    with pytest.raises(ValueError):
        load_serving_artifact(str(bogus), device="cpu")
    header = tmp_path / "bogus.rmlx"
    header.write_bytes(MAGIC + json.dumps({"format": "something_else"}).encode() + b"\n")
    with pytest.raises(ValueError, match="not a serving export artifact"):
        load_serving_artifact(str(header), device="cpu")


def test_jax_artifact_is_refused_by_name(jax_artifact):
    with pytest.raises(ValueError, match=r"radarml_tpu\.serving_export\.v2 artifact"):
        load_serving_artifact(jax_artifact, device="cpu")


def test_missing_platform_raises(tmp_path, predictor):
    """A CPU-only artifact has no program for the card; nothing falls
    back to the CPU one."""
    path = str(tmp_path / "serving.rmlx")
    export_predictor(predictor, path, max_targets=4, platforms=("cpu",))
    with pytest.raises(ValueError, match="none for cuda"):
        load_serving_artifact(path, device="cuda")
    with pytest.raises(ValueError, match="platforms"):
        export_predictor(predictor, path, platforms=("tpu",))


def test_serve_cli_export_and_artifact_serving(tmp_path, predictor):
    """The serve CLI exports an artifact and serves from it."""
    model_path = str(tmp_path / "svm.pickle")
    le_path = str(tmp_path / "le.pickle")
    coef, intercept, a, b = _weights()
    save_model(model_path, "linear", coef=coef, intercept=intercept, calib_a=a, calib_b=b,
               classes=CLASSES)
    save_label_encoder(le_path, LabelEncoder(classes_=tuple(CLASSES)))
    art_path = str(tmp_path / "serving.rmlx")
    out = serve_app.main([
        "--platform", "cpu", "--svm_model", model_path, "--label_encoder", le_path,
        "--cube_dtype", "uint8", "--export_serving", art_path,
    ])
    assert out == {"exported": art_path}

    stats = serve_app.main([
        "--platform", "cpu", "--label_encoder", le_path, "--serving_artifact", art_path,
        "--duration", "1.5", "--scan_period", "0.02", "--max_batch", "8",
    ])
    assert stats["processed"] > 0 and stats["predict_errors"] == 0


def test_int8_artifact_roundtrip_and_encode_host(tmp_path, predictor):
    """An int8-stream export serves canonical f32/u8 cubes correctly:
    __call__ applies the value-128 wire encoding (a straight int8 cast
    of 0..255 would overflow) and encode_host narrows on host."""
    import dataclasses

    p_i8 = dataclasses.replace(predictor, cube_dtype="int8")
    path = str(tmp_path / "serving_i8.rmlx")
    export_predictor(p_i8, path, max_targets=4)
    art = load_serving_artifact(path, device="cpu")
    assert art.cube_dtype == "int8"

    rng = np.random.default_rng(2)
    B = 3
    cubes = _cubes(rng, B)
    xyz, valid = pad_targets([[(2.0 * b, -b, 95.0 + 4 * b)] for b in range(B)], max_targets=4)
    want = p_i8(cubes, xyz, valid)
    for feed in (cubes, cubes.astype(np.uint8), art.encode_host(cubes)):
        _equal(want, art(feed, xyz, valid))
    assert art.encode_host(cubes).dtype == torch.int8


@pytest.mark.parametrize("tail", ["combo", "sel3"])
def test_fused_artifact_static_batch_roundtrip(tmp_path, predictor, tail):
    """mode='fused' exports bake a static batch and reproduce the live
    fused predictor bit for bit; smaller batches pad up, larger raise."""
    import dataclasses

    fused = dataclasses.replace(predictor, mode="fused", fused_tail=tail,
                                cube_dtype="float32")
    path = str(tmp_path / "fused.rmlx")
    with pytest.raises(ValueError, match="static batch"):
        export_predictor(fused, path, max_targets=3)
    meta = export_predictor(fused, path, max_targets=3, batch=4)
    assert meta["batch"] == 4

    art = load_serving_artifact(path, device="cpu")
    assert art.mode == "fused" and art.batch == 4

    rng = np.random.default_rng(2)
    cubes = _cubes(rng, 4)
    xyz, valid = pad_targets([[(1.0, 2.0, 80.0)]] * 4, max_targets=3)
    want = fused(cubes, xyz, valid)
    _equal(want, art(cubes, xyz, valid))

    # Smaller batches pad up to the baked shape inside the artifact (the
    # unary gRPC path and warm-up run batch 1); larger ones raise.
    _equal([w[:1] for w in want], art(cubes[:1], xyz[:1], valid[:1]))
    with pytest.raises(ValueError, match="chunks"):
        art(np.concatenate([cubes, cubes]), np.concatenate([xyz, xyz]),
            np.concatenate([valid, valid]))


def test_serve_cli_hot_reload_fused_artifact(tmp_path):
    """Hot reload of a mode='fused' AOT artifact mid-serve: the baked
    static batch warms (batch 1 pads up inside ServingArtifact), the
    re-export replaces the file atomically, and predictions flip class
    without a restart."""
    # Small scan arena (7x7x26 grid) keeps the plain kernel cheap; the
    # training arena stays DEFAULT (cross-arena zoom).
    arena_flag = "10,60,2,-42,42,14,-30,30,10"
    C, F = 3, DEFAULT_ARENA.feature_length
    model_path = str(tmp_path / "svm.pickle")
    art_path = str(tmp_path / "fused.rmlx")
    le_path = str(tmp_path / "le.pickle")
    save_label_encoder(le_path, LabelEncoder(classes_=tuple(CLASSES)))

    def export_model(boost_class):
        intercept = np.full((C,), -5.0, np.float32)
        intercept[boost_class] = 5.0
        save_model(model_path, "linear", coef=np.zeros((C, F), np.float32),
                   intercept=intercept, calib_a=-np.ones((C,), np.float32),
                   calib_b=np.zeros((C,), np.float32), classes=CLASSES)
        out = serve_app.main([
            "--platform", "cpu", "--svm_model", model_path, "--label_encoder", le_path,
            "--mode", "fused", "--max_batch", "4", "--scan_arena", arena_flag,
            "--export_serving", art_path,
        ])
        assert out == {"exported": art_path}

    export_model(0)

    labels_seen = []
    out = {}
    # The loop serves until a "person" is logged after the re-export (or
    # the deadline far above the export's seconds), not for fixed seconds.
    stop = threading.Event()

    def run():
        out["res"] = serve_app.main([
            "--platform", "cpu", "--label_encoder", le_path,
            "--serving_artifact", art_path, "--scan_arena", arena_flag,
            "--duration", "120", "--scan_period", "0.05",
            "--max_batch", "4", "--min_proba", "0.0",
            "--reload_poll", "0.3", "--log_detections",
        ], stop=stop)

    class Grab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "target" in msg and "(" in msg:
                for name in CLASSES:
                    if f" {name} " in msg:
                        labels_seen.append(name)

    grab = Grab()
    log = logging.getLogger("radarml_tpu_torch.apps.serve")
    log.addHandler(grab)
    try:
        th = threading.Thread(target=run)
        th.start()
        deadline = time.time() + 15
        while "cat" not in labels_seen and time.time() < deadline:
            time.sleep(0.2)
        export_model(2)  # atomic re-export: swap to always-person
        deadline = time.time() + 100
        while "person" not in labels_seen and th.is_alive() and time.time() < deadline:
            time.sleep(0.2)
        stop.set()
        th.join(timeout=120)
        assert not th.is_alive()
    finally:
        stop.set()
        log.removeHandler(grab)

    res = out["res"]
    assert res["model_reloads"] >= 1 and res["predict_errors"] == 0
    assert "cat" in labels_seen  # before reload
    assert "person" in labels_seen  # after reload


def test_neural_predictor_aot_export_roundtrip(tmp_path):
    """The neural serving program exports and reloads like the linear one."""
    from radarml_tpu_torch.apps.common_cli import load_model
    from radarml_tpu_torch.models import cnn

    model_path = str(tmp_path / "c_model.pickle")
    with open(model_path, "wb") as fp:
        pickle.dump({"format": "radarml_tpu.v1", "kind": "cnn",
                     "params": cnn.cnn_init_tree(3, (16, 16), seed=1), "classes": CLASSES,
                     "rescale": (16, 16)}, fp)
    net, _ = load_model(model_path, device="cpu")
    p = RadarPredictor(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=net,
                       min_proba=0.0, cube_dtype="bfloat16", device="cpu")
    path = str(tmp_path / "cnn_serving.rmlx")
    export_predictor(p, path, max_targets=2)
    art = load_serving_artifact(path, device="cpu")

    rng = np.random.default_rng(5)
    cubes = np.rint(rng.random((3,) + DEFAULT_ARENA.grid_shape) * RADAR_MAX).astype(np.float32)
    xyz, valid = pad_targets([[(1.0, 1.0, 90.0)], [(2.0, -2.0, 120.0)], []], max_targets=2)
    live, aot = p(cubes, xyz, valid), art(cubes, xyz, valid)
    _equal(live, aot)
    assert np.isfinite(aot[2].numpy()).all()
