"""The JAX-fitted SVC and golden outputs in radarml_tpu_torch/assets/demo_svc.npz.

The JAX package fits an RBF SVC (C=10, gamma=0.01, class_weight
'balanced', probability=True: one point of the reference's grid,
train/gridsearch.py) on make_dataset(1824, seed=DATA_SEED,
hardness=1.0) featurized by process_samples(scale=True): the
reference's data scale (benchmarks/svc_grid_bench.py) at the default
arena's 10,010 features. The file keeps the dataset seed and the
INDICES of the support vectors into that dataset instead of the
10,010-wide vectors, plus dual_coef, intercept, n_support, gamma,
probA/probB and the JAX `exact` predictor's outputs on
make_scan_batch(64, seed=7) with one target per scan padded to 4 slots.
The port rebuilds the support vectors from its own make_dataset and
process_samples.

Regenerate with:  JAX_PLATFORMS=cpu python tests/test_torch_svc_golden.py

Tolerances: the two packages' make_dataset samples are equal (same
numpy generator); their features agree within 1e-6 (float32 zoom
products in another order). The port on the CPU reproduces the golden
probabilities within 1e-4: a decision sums 1,823 Gram entries weighted
by dual coefficients whose absolute sum reaches ~980, so Gram entries
that differ in the 7th digit (features and products summed in another
order) move a decision by up to ~1e-4 and a Platt probability by at most
|probA|/4 (< 1) times that; decisions are equal wherever the golden
top-2 margin exceeds 1e-3.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
ASSET = REPO / "radarml_tpu_torch" / "assets" / "demo_svc.npz"
DATA_SEED, N_SAMPLES, HARDNESS = 2024, 1824, 1.0
C, GAMMA = 10.0, 0.01
N_SCANS, SCAN_SEED, MAX_TARGETS, MIN_PROBA = 64, 7, 4, 0.7
MARGIN = 1e-3

torch.set_num_threads(1)


def scan_batch(n=N_SCANS, seed=SCAN_SEED):
    """The golden input (numpy only): one target per scan in 4 slots."""
    from radarml_tpu_torch.data.synthetic import make_scan_batch
    from radarml_tpu_torch.models.pipeline import pad_targets

    cubes, targets = make_scan_batch(n, seed=seed)
    xyz, valid = pad_targets(
        [[(t.x, t.y, t.z)] for t in targets], max_targets=MAX_TARGETS
    )
    return np.rint(cubes), xyz, valid


def jax_dataset():
    from radarml_tpu.data.synthetic import make_dataset

    return make_dataset(N_SAMPLES, seed=DATA_SEED, hardness=HARDNESS)


def generate(samples=None, labels=None) -> dict:
    """Fit the SVC and record the golden outputs with JAX (on the JAX
    package's dataset, made here unless given)."""
    from radarml_tpu.core.arena import DEFAULT_ARENA
    from radarml_tpu.models import svc as jsvc
    from radarml_tpu.models.pipeline import RadarPredictor
    from radarml_tpu.ops.features import process_samples

    if samples is None:
        samples, labels = jax_dataset()
    X = process_samples(samples, scale=True).astype(np.float32)
    cfg = jsvc.SVCConfig(C=C, kernel="rbf", gamma=GAMMA, probability=True)
    model = jsvc.svc_fit(X, np.asarray(labels), cfg)
    # svc_fit gathers its support vectors from X: find their rows.
    row_of = {r.tobytes(): i for i, r in enumerate(X)}
    assert len(row_of) == len(X), "dataset rows are not distinct"
    sv_index = np.asarray(
        [row_of[r.tobytes()] for r in np.asarray(model.support_vectors)],
        np.int32,
    )
    cubes, xyz, valid = scan_batch()
    exact = RadarPredictor(
        train_arena=DEFAULT_ARENA, scan_arena=DEFAULT_ARENA, model=model,
        min_proba=MIN_PROBA, mode="exact",
    )(cubes, xyz, valid)
    out = dict(
        data_seed=np.int32(DATA_SEED), n_samples=np.int32(N_SAMPLES),
        hardness=np.float32(HARDNESS), C=np.float32(C),
        classes=np.unique(labels).astype(str),
        sv_index=sv_index,
        dual_coef=np.asarray(model.dual_coef, np.float32),
        intercept=np.asarray(model.intercept, np.float32),
        n_support=np.asarray(model.n_support, np.int32),
        gamma=np.float32(model.gamma),
        probA=np.asarray(model.probA, np.float32),
        probB=np.asarray(model.probB, np.float32),
        min_proba=np.float32(MIN_PROBA),
        n_scans=np.int32(N_SCANS), scan_seed=np.int32(SCAN_SEED),
        max_targets=np.int32(MAX_TARGETS),
    )
    out["exact_pred"] = np.asarray(exact[0])
    out["exact_best"] = np.asarray(exact[1])
    out["exact_proba"] = np.asarray(exact[2])
    return out


def load() -> dict:
    with np.load(ASSET) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def golden():
    return load()


@pytest.fixture(scope="module")
def port_data():
    """The port's dataset for the asset's seed and its scaled features."""
    from radarml_tpu_torch.data.synthetic import make_dataset
    from radarml_tpu_torch.ops.features import process_samples

    samples, labels = make_dataset(N_SAMPLES, seed=DATA_SEED, hardness=HARDNESS)
    return samples, labels, process_samples(samples, scale=True, device="cpu")


@pytest.fixture(scope="module")
def jax_data():
    return jax_dataset()


def test_asset_is_small_and_names_its_data(golden):
    assert ASSET.stat().st_size < 64 * 1024
    assert (int(golden["data_seed"]), int(golden["n_samples"])) == (DATA_SEED, N_SAMPLES)
    assert float(golden["hardness"]) == HARDNESS
    n_sv = len(golden["sv_index"])
    assert golden["dual_coef"].shape == (len(golden["classes"]) - 1, n_sv)
    assert int(golden["n_support"].sum()) == n_sv
    assert len(np.unique(golden["sv_index"])) == n_sv


def test_port_dataset_equals_jax(port_data, jax_data):
    t_samples, t_labels, _ = port_data
    j_samples, j_labels = jax_data
    assert t_labels == j_labels
    for a, b in zip(t_samples, j_samples):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)


def test_port_features_match_jax(port_data, jax_data):
    from radarml_tpu.ops.features import process_samples

    want = process_samples(jax_data[0][:200], scale=True)
    np.testing.assert_allclose(port_data[2][:200].numpy(), want, atol=1e-6, rtol=0)


def _port_svc(g, X):
    from radarml_tpu_torch.models import svc

    return svc.from_numpy(
        X[torch.as_tensor(g["sv_index"], dtype=torch.int64)].numpy(),
        g["dual_coef"], g["intercept"], g["n_support"], kernel="rbf",
        gamma=float(g["gamma"]), probA=g["probA"], probB=g["probB"],
        device="cpu",
    )


def _margin_ok(proba, best, min_proba):
    top2 = np.sort(proba, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0] > MARGIN) & (np.abs(best - min_proba) > MARGIN)


def test_port_reproduces_golden_on_cpu(golden, port_data):
    """The port rebuilds the support vectors from its own data and
    serves the JAX-fitted SVC in exact mode on the CPU."""
    from radarml_tpu_torch.core.arena import DEFAULT_ARENA
    from radarml_tpu_torch.models.pipeline import RadarPredictor

    pred = RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, _port_svc(golden, port_data[2]),
                          min_proba=float(golden["min_proba"]), mode="exact")
    cubes, xyz, valid = scan_batch()
    p, best, proba = (t.numpy() for t in pred(cubes, xyz, valid))
    np.testing.assert_allclose(proba, golden["exact_proba"], atol=1e-4, rtol=0)
    ok = _margin_ok(golden["exact_proba"], golden["exact_best"], golden["min_proba"])
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(p[ok], golden["exact_pred"][ok])
    assert (p[~valid] == -1).all()


def test_port_fit_reaches_the_asset_optimum(golden, port_data):
    """The port's svc_fit on its own data at full width reaches the
    JAX-fitted optimum: decisions within atol 5e-3 / rtol 1e-2 and >= 98%
    equal predictions on the training set (tests/test_svc.py:86-87)."""
    from radarml_tpu_torch.models import svc

    _, labels, X = port_data
    cfg = svc.SVCConfig(C=float(golden["C"]), gamma=float(golden["gamma"]))
    fitted = svc.svc_fit(X, np.asarray(labels), cfg)
    ref = _port_svc(golden, X)
    want = svc.decision_function_ovo(ref, X).numpy()
    np.testing.assert_allclose(svc.decision_function_ovo(fitted, X).numpy(), want,
                               atol=5e-3, rtol=1e-2)
    assert (svc.predict(fitted, X) == svc.predict(ref, X)).float().mean() >= 0.98
    np.testing.assert_allclose(fitted.probA.numpy(), golden["probA"], atol=1e-3)
    np.testing.assert_allclose(fitted.probB.numpy(), golden["probB"], atol=1e-3)


def test_asset_regenerates_from_jax(golden, jax_data):
    """The JAX package refits the same SVC from the asset's seed: the
    same support vectors, and outputs within the SMO's tolerance (1e-3:
    float32 rounding on another CPU may choose other working pairs)."""
    got = generate(*jax_data)
    assert sorted(got) == sorted(golden)
    np.testing.assert_array_equal(got["sv_index"], golden["sv_index"])
    np.testing.assert_array_equal(got["n_support"], golden["n_support"])
    for key in ("intercept", "probA", "probB", "exact_proba"):
        np.testing.assert_allclose(got[key], golden[key], atol=1e-3, rtol=0)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    ASSET.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    g = generate()
    np.savez_compressed(ASSET, **g)
    print(f"wrote {ASSET} ({ASSET.stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.1f} s; n_sv {len(g['sv_index'])}",
          file=sys.stderr)
