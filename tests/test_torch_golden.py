"""The demo model and golden outputs in radarml_tpu_torch/assets/demo_linear.npz.

The file holds the bench recipe's 3-class linear model over the
default arena's 10,010 features (make_dataset(90, seed=11), 15 SGD
epochs, per-class sigmoid calibration — bench.py:193-199) and the JAX
package's `exact`, `fused` (combo, split) and `pallas` (bfloat16 stream,
its kernel in interpret mode) outputs on make_scan_batch(64, seed=7)
with one target per scan padded to 4 slots.
chip_smoke.py holds the port on the card to these outputs.

Regenerate with:  JAX_PLATFORMS=cpu python tests/test_torch_golden.py

Tolerances: the regenerated parameters agree with the committed ones
to rtol 1e-5 (float32 training, same seed and program); the port on the
CPU reproduces the golden probabilities within 1e-5 (exact; pallas,
whose JAX kernel splits the float32 templates into bf16 hi + lo halves
where the port keeps them float32) and 1e-6 (fused: exact integer
tables, same float32 tail), with decisions equal wherever the golden
top-2 margin exceeds 1e-4.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
ASSET = REPO / "radarml_tpu_torch" / "assets" / "demo_linear.npz"
N_SCANS, SCAN_SEED, MAX_TARGETS = 64, 7, 4

torch.set_num_threads(1)


def scan_batch(n=N_SCANS, seed=SCAN_SEED):
    """The golden input, as bench.py makes it (numpy only)."""
    from radarml_tpu_torch.data.synthetic import make_scan_batch
    from radarml_tpu_torch.models.pipeline import pad_targets

    cubes, targets = make_scan_batch(n, seed=seed)
    xyz, valid = pad_targets(
        [[(t.x, t.y, t.z)] for t in targets], max_targets=MAX_TARGETS
    )
    return np.rint(cubes), xyz, valid


def generate() -> dict:
    """Train the demo model and record the golden outputs with JAX."""
    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.data.labels import LabelEncoder
    from radarml_tpu.data.synthetic import make_dataset
    from radarml_tpu.models.linear import (
        SGDConfig, calibrate_ovr, sgd_fit, sgd_model,
    )
    from radarml_tpu.models.pipeline import RadarPredictor
    from radarml_tpu.ops.features import process_samples

    samples, labels = make_dataset(90, seed=11)
    le, y = LabelEncoder.fit_transform(labels)
    X = process_samples(samples, scale=True).astype(np.float32)
    cfg = SGDConfig(alpha=1e-5)
    state = sgd_fit(X[:70], y[:70], n_classes=len(le.classes_), cfg=cfg,
                    epochs=15)
    model = sgd_model(state, cfg)
    calib = calibrate_ovr(model, X[70:], y[70:])
    kw = dict(train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA,
              model=model, calibration=calib, min_proba=0.7)
    cubes, xyz, valid = scan_batch()
    exact = RadarPredictor(mode="exact", **kw)(cubes, xyz, valid)
    fused = RadarPredictor(mode="fused", **kw)
    fz = fused(fused.pack_host(cubes.astype(np.uint8)), xyz, valid)
    pallas = RadarPredictor(mode="pallas", cube_dtype="bfloat16", **kw)(cubes, xyz, valid)
    out = dict(
        coef=np.asarray(model.coef, np.float32),
        intercept=np.asarray(model.intercept, np.float32),
        calib_a=np.asarray(calib.a, np.float32),
        calib_b=np.asarray(calib.b, np.float32),
        classes=np.asarray(le.classes_, dtype=str),
        min_proba=np.float32(0.7),
        n_scans=np.int32(N_SCANS), scan_seed=np.int32(SCAN_SEED),
        max_targets=np.int32(MAX_TARGETS),
    )
    for name, res in (("exact", exact), ("fused", fz), ("pallas", pallas)):
        out[f"{name}_pred"] = np.asarray(res[0])
        out[f"{name}_best"] = np.asarray(res[1])
        out[f"{name}_proba"] = np.asarray(res[2])
    return out


def load() -> dict:
    with np.load(ASSET) as f:
        return {k: f[k] for k in f.files}


def test_fixture_regenerates_from_jax():
    want, got = load(), generate()
    assert sorted(want) == sorted(got)
    assert list(want["classes"]) == list(got["classes"])
    for k in ("coef", "intercept", "calib_a", "calib_b"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
    for k in ("exact", "fused", "pallas"):
        np.testing.assert_allclose(
            got[f"{k}_proba"], want[f"{k}_proba"], atol=1e-6, rtol=0
        )
        np.testing.assert_array_equal(got[f"{k}_pred"], want[f"{k}_pred"])


def _margin_ok(proba, best, min_proba):
    top2 = np.sort(proba, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0] > 1e-4) & (np.abs(best - min_proba) > 1e-4)


@pytest.mark.parametrize("mode,atol", [("exact", 1e-5), ("fused", 1e-6), ("pallas", 1e-5)])
def test_port_reproduces_golden_on_cpu(mode, atol):
    from radarml_tpu_torch.core.arena import DEFAULT_ARENA
    from radarml_tpu_torch.models.linear import from_numpy
    from radarml_tpu_torch.models.pipeline import RadarPredictor

    g = load()
    model, calib = from_numpy(g["coef"], g["intercept"], g["calib_a"],
                              g["calib_b"], device="cpu")
    pred = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, calib,
                          min_proba=float(g["min_proba"]), mode=mode,
                          cube_dtype="bfloat16" if mode == "pallas" else "float32")
    cubes, xyz, valid = scan_batch()
    if mode == "fused":
        cubes = pred.pack_host(cubes.astype(np.uint8))
    p, best, proba = (t.numpy() for t in pred(cubes, xyz, valid))
    np.testing.assert_allclose(proba, g[f"{mode}_proba"], atol=atol, rtol=0)
    ok = _margin_ok(g[f"{mode}_proba"], g[f"{mode}_best"], g["min_proba"])
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(p[ok], g[f"{mode}_pred"][ok])
    # padded slots are UNKNOWN; real targets carry a class or UNKNOWN
    assert (p[~valid] == -1).all()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    ASSET.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(ASSET, **generate())
    print(f"wrote {ASSET} ({ASSET.stat().st_size} bytes)", file=sys.stderr)
