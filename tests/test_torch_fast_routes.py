"""The fast path's table routes against the JAX package's fast path.

models/pipeline.folded_tables (mode="fast" with a float32, bfloat16 or
uint8 stream, on every device) and folded_tables_exact (mode="fast" with
cube_dtype="int8" on the card) read the cube as it lies. The same
templates and cubes (numpy, from a seed) go through them, the port's
CPU int64 einsums and the JAX package's einsums, at the default arena
with 3, 5 and 9 classes and at the 43 x 31 x 351 scan arena
(tests/test_apps.py:580) with 3, each at B = 1, 7 and 64. Tolerances,
with their reasons:

* the exact route: bit-equal (int64) to the int64 einsums and to the JAX
  package's int32 einsums (preferred_element_type=int32): every float32
  run it sums holds at most EXACT_F32_TERMS int8 products, so every
  partial sum is an integer below 2^24;
* the float32 route: within 1e-5 x max|JAX| of the JAX package's
  Precision.HIGHEST einsums (float32 sums in another order), and the
  predictor's probabilities within 1e-5 of the JAX predictor's with
  decisions equal where the JAX top-2 margin exceeds 1e-4, the bars of
  tests/test_torch_pipeline.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from radarml_tpu.core.arena import Arena as JArena
from radarml_tpu.models import linear as jlin
from radarml_tpu.models import pipeline as jpipe
from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena
from radarml_tpu_torch.models import linear as tlin
from radarml_tpu_torch.models import pipeline as tpipe

torch.set_num_threads(1)

FINE = dict(r_res=1.0, theta_res=2.0)  # 43 x 31 x 351
SHAPES = [({}, 3), ({}, 5), ({}, 9), (FINE, 3)]
IDS = ["default-3", "default-5", "default-9", "43x31x351-3"]
SPECS = ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz")


def _predictors(C, scan):
    """JAX and port predictor kwargs of one random C-class linear model
    trained at the default arena, served at `scan`'s arena."""
    rng = np.random.default_rng(C)
    F = DEFAULT_ARENA.feature_length
    coef = (rng.normal(size=(C, F)) * 0.01).astype(np.float32)
    intercept = rng.normal(size=(C,)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    b = (rng.normal(size=C) * 0.1).astype(np.float32)
    jkw = dict(train_arena=JArena(), scan_arena=JArena(**scan), min_proba=0.4,
               model=jlin.LinearModel(jnp.asarray(coef), jnp.asarray(intercept)),
               calibration=jlin.SigmoidCalibration(jnp.asarray(a), jnp.asarray(b)))
    model, calib = tlin.from_numpy(coef, intercept, a, b, device="cpu")
    tkw = dict(train_arena=DEFAULT_ARENA, scan_arena=Arena(**scan), min_proba=0.4,
               model=model, calibration=calib)
    return jkw, tkw


def _cubes(rng, arena, B):
    return np.rint(rng.random((B,) + arena.grid_shape) * 255).astype(np.float32)


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("scan,C", SHAPES, ids=IDS)
def test_exact_route_equals_int64_and_jax(rng, scan, C, B):
    """folded_tables_exact: the int64 einsums' and the JAX package's int32
    einsums' raw tables, bit for bit, on the port's quantized templates
    (the JAX package's bytes, tests/test_torch_pipeline.py), and on the
    extreme values of both operands."""
    jkw, tkw = _predictors(C, scan)
    t = tpipe.RadarPredictor(mode="fast", cube_dtype="int8", **tkw)
    quant = [q[0] for q in t._quantized_split_templates()]
    arena = tkw["scan_arena"]
    cubes = tpipe.encode_int8_cubes(_cubes(rng, arena, B)).numpy()
    extreme = [np.full((2,) + arena.grid_shape, -128, np.int8),
               [np.full_like(q, -127) for q in quant]]
    for cube, qs in ((cubes, quant), tuple(extreme)):
        got = tpipe.folded_tables_exact(torch.from_numpy(cube),
                                        [torch.from_numpy(q) for q in qs])
        v = torch.from_numpy(cube).to(torch.int64)
        for g, spec, q in zip(got, SPECS, qs):
            want = torch.einsum(spec, torch.from_numpy(q).to(torch.int64), v)
            assert g.dtype == torch.int64 and torch.equal(g, want), spec
            jax_raw = jnp.einsum(spec, jnp.asarray(q), jnp.asarray(cube),
                                 preferred_element_type=jnp.int32)
            np.testing.assert_array_equal(g.numpy(), np.asarray(jax_raw))


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("scan,C", SHAPES, ids=IDS)
def test_f32_route_matches_jax(rng, scan, C, B):
    """folded_tables within 1e-5 x max|JAX| of the JAX package's float32
    tables, and the port's fast predictor (float32 stream) within the
    fast-path bars of the JAX predictor's."""
    jkw, tkw = _predictors(C, scan)
    t = tpipe.RadarPredictor(mode="fast", **tkw)
    arena = tkw["scan_arena"]
    cubes = _cubes(rng, arena, B)
    templates = [torch.as_tensor(x) for x in t._split_templates()]
    got = tpipe.folded_tables(torch.from_numpy(cubes), templates)
    for g, spec, tm in zip(got, SPECS, templates):
        want = np.asarray(jnp.einsum(spec, jnp.asarray(tm.numpy()), jnp.asarray(cubes),
                                     precision=lax.Precision.HIGHEST))
        assert np.abs(g.numpy() - want).max() <= 1e-5 * np.abs(want).max(), spec
    T = 3
    cells = np.stack([rng.integers(0, n, size=(B, T)) for n in arena.grid_shape], -1)
    xyz = np.stack(arena.grid_to_cartesian_np(*cells.T.astype(np.float64)), -1)
    xyz = xyz.transpose(1, 0, 2).astype(np.float32)
    valid = np.ones((B, T), bool)
    jp, jb, jproba = (np.asarray(o) for o in
                      jpipe.RadarPredictor(mode="fast", **jkw)(cubes, xyz, valid))
    tp, tb, tproba = (o.numpy() for o in t(cubes, xyz, valid))
    np.testing.assert_allclose(tproba, jproba, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tb, jb, atol=1e-5, rtol=0)
    top2 = np.sort(jproba, axis=-1)[..., -2:]
    ok = (top2[..., 1] - top2[..., 0] > 1e-4) & (np.abs(jb - 0.4) > 1e-4)
    np.testing.assert_array_equal(tp[ok], jp[ok])


def test_masked_planes_and_exactness_limit():
    """A masked plane gives no table on either route, and a run never
    holds more products than float32 sums exactly: 1032 of at most
    127 x 128 each stay below 2^24."""
    assert tpipe.EXACT_F32_TERMS * 127 * 128 <= 1 << 24
    assert (tpipe.EXACT_F32_TERMS + 1) * 127 * 128 > 1 << 24
    rng = np.random.default_rng(3)
    cube = rng.integers(-128, 128, (2, 5, 7, 9), dtype=np.int8)
    q = rng.integers(-127, 128, (4, 5, 9), dtype=np.int8)
    got = tpipe.folded_tables_exact(torch.from_numpy(cube), [torch.from_numpy(q), None, None])
    assert got[1] is None and got[2] is None
    want = torch.einsum(SPECS[0], torch.from_numpy(q).long(), torch.from_numpy(cube).long())
    assert torch.equal(got[0], want)
    f = tpipe.folded_tables(torch.from_numpy(cube).float(), [None, None, None])
    assert f == [None, None, None]
