"""Port parity: the inference half of models/linear.

Decisions agree with the JAX package within rtol 1e-5 (a float32 dot
summed in another order); probabilities within atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radarml_tpu.models import linear as jl
from radarml_tpu_torch.models import linear as tl

torch.set_num_threads(1)


@pytest.mark.parametrize("n_classes", [1, 3])
@pytest.mark.parametrize("calibrated", [False, True])
def test_linear_inference_matches_jax(rng, n_classes, calibrated):
    F, N = 600, 40
    coef = (rng.normal(size=(n_classes, F)) * 0.05).astype(np.float32)
    intercept = rng.normal(size=(n_classes,)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, n_classes).astype(np.float32)
    b = rng.normal(size=n_classes).astype(np.float32)
    X = rng.random((N, F)).astype(np.float32)
    X[0] = 0.0

    jm = jl.LinearModel(jnp.asarray(coef), jnp.asarray(intercept))
    tm, tc = tl.from_numpy(coef, intercept, *((a, b) if calibrated else ()),
                           device="cpu")
    assert (tc is None) != calibrated
    assert tm.coef.dtype == torch.float32

    jdf = np.asarray(jl.decision_function(jm, jnp.asarray(X)))
    tdf = tl.decision_function(tm, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(tdf, jdf, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tl.predict(tm, torch.from_numpy(X)).numpy(),
        np.asarray(jl.predict(jm, jnp.asarray(X))),
    )
    if calibrated:
        jc = jl.SigmoidCalibration(jnp.asarray(a), jnp.asarray(b))
        jp = jl.predict_proba_calibrated(jm, jc, jnp.asarray(X))
        tp = tl.predict_proba_calibrated(tm, tc, torch.from_numpy(X))
    else:
        jp = jl.predict_proba_log_loss(jm, jnp.asarray(X))
        tp = tl.predict_proba_log_loss(tm, torch.from_numpy(X))
    assert tp.shape == (N, max(2, n_classes))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)


def test_proba_edge_cases_match_jax():
    """All sigmoids underflow → uniform rows, as in the JAX package."""
    df = np.array([[-200.0, -300.0, -250.0], [5.0, -1.0, 0.0]], np.float32)
    np.testing.assert_allclose(
        tl.proba_from_decision(torch.from_numpy(df)).numpy(),
        np.asarray(jl.proba_from_decision(jnp.asarray(df))), atol=1e-6,
    )
    a = np.full(3, 50.0, np.float32)
    b = np.full(3, 200.0, np.float32)
    np.testing.assert_allclose(
        tl.calibrated_from_decision(
            torch.from_numpy(df),
            tl.SigmoidCalibration(torch.from_numpy(a), torch.from_numpy(b)),
        ).numpy(),
        np.asarray(jl.calibrated_from_decision(
            jnp.asarray(df), jl.SigmoidCalibration(jnp.asarray(a), jnp.asarray(b))
        )),
        atol=1e-6,
    )
    with pytest.raises(ValueError, match="together"):
        tl.from_numpy(np.zeros((3, 4)), np.zeros(3), calib_a=np.zeros(3))
