"""Port parity: RadarPredictor serving a kernel SVM, against the JAX
package's predictor on the same SVC, cubes and targets.

A JAX-fitted SVC is carried across by `svc.from_numpy`; cubes and
targets are made with numpy from a seed. Both predictors slice, zoom and
scale the same features and score them with the same SVC on the CPU,
with float32 products in another summation order. A decision sums n_sv
Gram entries weighted by dual coefficients up to C times the class
weight (their absolute sum is in the hundreds here), so Gram entries
that differ by ~1e-7 move probabilities by up to a few 1e-5: they agree
within 5e-5, and decisions are equal wherever the JAX top-2 margin (and
the distance to min_proba) exceeds 1e-4.
"""

import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import DEFAULT_ARENA as J_DEFAULT
from radarml_tpu.core.arena import Arena as JArena, ProjMask as JMask
from radarml_tpu.data.synthetic import make_dataset as jax_make_dataset
from radarml_tpu.models import pipeline as jpipe
from radarml_tpu.models import svc as jsvc
from radarml_tpu.ops.features import process_samples as jax_process_samples
from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena, ProjMask
from radarml_tpu_torch.data.synthetic import make_scan_batch
from radarml_tpu_torch.models import pipeline as tpipe
from radarml_tpu_torch.models import svc as tsvc

torch.set_num_threads(1)

SCAN = dict(r_min=10.0, r_max=60.0, r_res=2.0, theta_min=-12.0,
            theta_max=12.0, theta_res=4.0, phi_min=-6.0, phi_max=6.0,
            phi_res=2.0)  # (7, 7, 26) cube
TRAIN = dict(SCAN, theta_res=3.0, r_res=2.5)  # (9, 7, 21): zooms differ


def _carry(m):
    return tsvc.from_numpy(
        np.asarray(m.support_vectors), np.asarray(m.dual_coef),
        np.asarray(m.intercept), m.n_support, kernel=m.kernel, gamma=m.gamma,
        probA=np.asarray(m.probA), probB=np.asarray(m.probB), device="cpu",
    )


def _check(jout, tout, min_proba, atol=5e-5):
    jp, jb, jq = (np.asarray(o) for o in jout)
    tp, tb, tq = (o.numpy() for o in tout)
    assert tp.dtype == np.int32 and tq.shape == jq.shape
    np.testing.assert_allclose(tq, jq, atol=atol, rtol=0)
    np.testing.assert_allclose(tb, jb, atol=atol, rtol=0)
    top2 = np.sort(jq, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > 1e-4) & (np.abs(jb - min_proba) > 1e-4)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(tp[clear], jp[clear])


@pytest.fixture(scope="module")
def full_arena_svc():
    """A JAX SVC fitted on scaled radar features at the default arena."""
    samples, labels = jax_make_dataset(30, seed=17, hardness=1.0)
    X = jax_process_samples(samples, scale=True).astype(np.float32)
    return jsvc.svc_fit(X, np.asarray(labels),
                        jsvc.SVCConfig(C=10.0, gamma=0.01, probability=True))


def test_exact_svc_matches_jax_at_the_default_arena(full_arena_svc):
    cubes, targets = make_scan_batch(3, seed=4)
    cubes = np.rint(cubes)
    xyz, valid = tpipe.pad_targets([[(t.x, t.y, t.z)] for t in targets], 2)
    kw = dict(min_proba=0.4, mode="exact")
    j = jpipe.RadarPredictor(J_DEFAULT, J_DEFAULT, full_arena_svc, **kw)
    t = tpipe.RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, _carry(full_arena_svc), **kw)
    tout = t(cubes, xyz, valid)
    _check(j(cubes, xyz, valid), tout, 0.4)
    assert (tout[0].numpy()[~valid] == -1).all()  # padded slots are UNKNOWN
    assert t.device == torch.device("cpu")  # where the support vectors lie


@pytest.mark.parametrize(
    "train,mask", [(SCAN, (True, True, True)), (TRAIN, (True, True, True)),
                   (TRAIN, (True, False, True))]
)
def test_exact_svc_matches_jax_with_zoom_and_mask(rng, train, mask):
    jt, js = JArena(**train), JArena(**SCAN)
    F = sum(h * w for (h, w), k in zip((jt.xz_shape, jt.yz_shape, jt.xy_shape), mask) if k)
    X = (rng.random((45, F)) * 0.5).astype(np.float32)
    y = np.arange(45) % 3
    X[np.arange(45), y] += 1.0  # separable on three features
    jm = jsvc.svc_fit(X, y, jsvc.SVCConfig(C=10.0, gamma=2.0 / F))
    cubes = np.rint(rng.random((5,) + js.grid_shape) * 255).astype(np.float32)
    cells = np.stack([rng.integers(0, n, size=(5, 3)) for n in js.grid_shape], -1)
    xyz = np.stack(js.grid_to_cartesian_np(*cells.T.astype(np.float64)), -1)
    xyz = (xyz.transpose(1, 0, 2) + rng.normal(scale=0.3, size=(5, 3, 3))).astype(np.float32)
    valid = rng.random((5, 3)) < 0.8
    j = jpipe.RadarPredictor(jt, js, jm, proj_mask=JMask(*mask), min_proba=0.4)
    t = tpipe.RadarPredictor(Arena(**train), Arena(**SCAN), _carry(jm),
                             proj_mask=ProjMask(*mask), min_proba=0.4)
    _check(j(cubes, xyz, valid), t(cubes, xyz, valid), 0.4)


def test_fast_is_exact_and_fused_refuses_an_svc(rng):
    jt = JArena(**SCAN)
    F = jt.feature_length
    X = rng.random((30, F)).astype(np.float32)
    jm = jsvc.svc_fit(X, np.arange(30) % 3, jsvc.SVCConfig(gamma=1.0 / F))
    model = _carry(jm)
    arena = Arena(**SCAN)
    cubes = np.rint(rng.random((4,) + arena.grid_shape) * 255).astype(np.float32)
    xyz = rng.uniform([-5, -5, 15], [5, 5, 55], size=(4, 2, 3)).astype(np.float32)
    exact = tpipe.RadarPredictor(arena, arena, model, mode="exact")
    fast = tpipe.RadarPredictor(arena, arena, model, mode="fast")
    for a, b in zip(exact(cubes, xyz), fast(cubes, xyz)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="fused mode folds linear models only"):
        tpipe.RadarPredictor(arena, arena, model, mode="fused")
    with pytest.raises(ValueError, match="fused mode folds linear models only"):
        jpipe.RadarPredictor(jt, jt, jm, mode="fused")
    # pallas has no fold for an SVC either: both packages build the exact path
    pallas = tpipe.RadarPredictor(arena, arena, model, mode="pallas")
    for a, b in zip(exact(cubes, xyz), pallas(cubes, xyz)):
        assert torch.equal(a, b)
    _check(jpipe.RadarPredictor(jt, jt, jm, mode="pallas")(cubes, xyz),
           pallas(cubes, xyz), 0.7)


def test_other_model_families_raise(rng):
    arena = Arena(**SCAN)
    with pytest.raises(NotImplementedError, match="A12"):
        tpipe.RadarPredictor(arena, arena, model=object())
