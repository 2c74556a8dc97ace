"""The fast path's table routes against the JAX package's fast path.

models/pipeline.folded_tables (mode="fast" with a float32, bfloat16 or
uint8 stream, on every device) and folded_tables_exact (mode="fast" with
cube_dtype="int8" on the card) read the cube as it lies. The same
templates and cubes (numpy, from a seed) go through them, the port's
CPU int64 einsums and the JAX package's einsums, at the default arena
with 3, 5 and 9 classes and at the 43 x 31 x 351 scan arena
(tests/test_apps.py:580) with 3, each at B = 1, 7 and 64: as each
function chooses its route, and with each of its two routes forced (the
float32 route's M1 over a permuted copy or a x; the int8 route's m1 and
m3 over the (scan, x) blocks or a x and in runs of (x, y)). The routes'
budgets are also checked on each side of a lowered threshold, at their
committed values, and through torch.export with a symbolic batch.
Tolerances, with their reasons:

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


def _check_exact(rng, tkw, B):
    """folded_tables_exact against the int64 einsums and the JAX package's
    int32 einsums, bit for bit, on the port's quantized templates and on
    the extreme values of both operands."""
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


def _check_f32_tables(t, cubes):
    """folded_tables within 1e-5 x max|JAX| of the JAX package's float32
    tables."""
    templates = [torch.as_tensor(x) for x in t._split_templates()]
    got = tpipe.folded_tables(torch.from_numpy(cubes), templates)
    for g, spec, tm in zip(got, SPECS, templates):
        want = np.asarray(jnp.einsum(spec, jnp.asarray(tm.numpy()), jnp.asarray(cubes),
                                     precision=lax.Precision.HIGHEST))
        assert np.abs(g.numpy() - want).max() <= 1e-5 * np.abs(want).max(), spec


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("scan,C", SHAPES, ids=IDS)
def test_exact_route_equals_int64_and_jax(rng, scan, C, B):
    """folded_tables_exact: the int64 einsums' and the JAX package's int32
    einsums' raw tables, bit for bit, on the port's quantized templates
    (the JAX package's bytes, tests/test_torch_pipeline.py), and on the
    extreme values of both operands."""
    _, tkw = _predictors(C, scan)
    _check_exact(rng, tkw, B)


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
    _check_f32_tables(t, cubes)
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


ROUTES = {"one_product": 1 << 62, "per_x": 0}  # route budgets forcing each route


def _force(monkeypatch, budget):
    for name in ("M1_SLAB_BYTES", "EXACT_BLOCK_BYTES"):
        monkeypatch.setattr(tpipe, name, budget)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("scan,C", SHAPES, ids=IDS)
def test_each_route_forced_matches_jax(rng, monkeypatch, scan, C, B, route):
    """Each route of both functions, forced: the int8 route's m1 and m3
    over the (scan, x) blocks, or a x and in runs of (x, y) (at 43 x 31 x
    351, X·Y = 1333 > EXACT_F32_TERMS: two runs), bit for bit as in
    test_exact_route_equals_int64_and_jax, extreme values included; the
    float32 route's M1 over a permuted copy, or a x, within the bar of
    test_f32_route_matches_jax."""
    _force(monkeypatch, ROUTES[route])
    _, tkw = _predictors(C, scan)
    shape = (B,) + tkw["scan_arena"].grid_shape
    one = route == "one_product"
    assert tpipe.one_product_m1(shape) == one
    assert tpipe.block_products_exact(shape, [2 * C, 2 * C]) == one
    _check_exact(rng, tkw, B)
    _check_f32_tables(tpipe.RadarPredictor(mode="fast", **tkw),
                      _cubes(rng, tkw["scan_arena"], B))


@pytest.mark.parametrize("B", [7, 8])
def test_routes_on_each_side_of_the_threshold(rng, monkeypatch, B):
    """With each budget at 7 scans of the default arena (the float32
    route's slab; the int8 route's copies and partials at 3 classes), B=7
    takes the one product and the blocks, B=8 the products a x, each equal
    to the JAX package's tables."""
    X, Y, Z = DEFAULT_ARENA.grid_shape
    monkeypatch.setattr(tpipe, "M1_SLAB_BYTES", 7 * Y * Z * 4)
    monkeypatch.setattr(tpipe, "EXACT_BLOCK_BYTES", 7 * 2 * 4 * X * (Y * Z + (Y + Z) * 6))
    _, tkw = _predictors(3, {})
    shape = (B,) + DEFAULT_ARENA.grid_shape
    assert tpipe.one_product_m1(shape) == (B == 7)
    assert tpipe.block_products_exact(shape, [6, 6]) == (B == 7)
    _check_exact(rng, tkw, B)
    _check_f32_tables(tpipe.RadarPredictor(mode="fast", **tkw), _cubes(rng, DEFAULT_ARENA, B))


def test_committed_budgets():
    """The committed budgets' routes: at both arenas the demo model's
    small batches (3 classes, B <= 128) take the one product and the
    blocks, and 4096 scans the products a x; the int8 route's last block
    batch, from the bytes its two products move, falls as the class rows
    grow."""
    for arena in (DEFAULT_ARENA, Arena(**FINE)):
        X, Y, Z = arena.grid_shape
        for B in (1, 64, 128):
            assert tpipe.one_product_m1((B, X, Y, Z))
            assert tpipe.block_products_exact((B, X, Y, Z), [6, 6])
        assert not tpipe.one_product_m1((4096, X, Y, Z))
        assert not tpipe.block_products_exact((4096, X, Y, Z), [6, 6])
        last = [tpipe.EXACT_BLOCK_BYTES // (2 * 4 * X * (Y * Z + (Y + Z) * 2 * C))
                for C in (3, 9, 16)]
        assert last[0] > last[1] > last[2] >= 128
        for n, C in zip(last, (3, 9, 16)):
            assert tpipe.block_products_exact((n, X, Y, Z), [2 * C, 2 * C])
            assert not tpipe.block_products_exact((n + 1, X, Y, Z), [2 * C, 2 * C])
        # a masked plane: one product's bytes, so a later last batch
        assert tpipe.block_products_exact((last[0] + 1, X, Y, Z), [6])


def test_symbolic_batch_is_not_specialized():
    """torch.export of both routes' functions keeps the batch symbolic:
    the route is chosen from a concrete batch only."""
    from torch.export import Dim

    X, Y, Z, C = 3, 4, 5, 2
    q = torch.randint(-127, 128, (C, X, Z), dtype=torch.int8)

    class Tables(torch.nn.Module):
        def forward(self, cubes):
            return (tpipe.folded_tables_exact(cubes, [q, None, None])[0],
                    tpipe.folded_tables(cubes.float(), [q.float(), None, None])[0])

    cubes = torch.randint(-128, 128, (2, X, Y, Z), dtype=torch.int8)
    ep = torch.export.export(Tables(), (cubes,), dynamic_shapes=({0: Dim("b", min=1)},))
    for B in (1, 9):
        c = torch.randint(-128, 128, (B, X, Y, Z), dtype=torch.int8)
        want = torch.einsum(SPECS[0], q.long(), c.long())
        exact, f32 = ep.module()(c)
        assert torch.equal(exact, want) and torch.equal(f32, want.float())


@pytest.mark.parametrize("route", list(ROUTES))
def test_symbolic_batch_takes_each_route(monkeypatch, route):
    """An exported program of both functions (all three planes, and a
    masked xz plane) chooses each route at each call through torch.cond
    and keeps the int64 einsums' values, at a budget between its two
    batches and forced either way."""
    from torch.export import Dim

    X, Y, Z, C = 3, 4, 5, 2
    _force(monkeypatch, ROUTES[route])
    if route == "per_x":  # between the two batches: 1 scan fits, 9 do not
        monkeypatch.setattr(tpipe, "EXACT_BLOCK_BYTES", 2 * 4 * X * (Y * Z + (Y + Z) * C))
        monkeypatch.setattr(tpipe, "M1_SLAB_BYTES", Y * Z * 4)
    qs = [torch.randint(-127, 128, (C,) + sh, dtype=torch.int8) for sh in ((X, Z), (Y, Z), (X, Y))]
    for quant in (qs, [None] + qs[1:]):

        class Tables(torch.nn.Module):
            def forward(self, cubes, quant=quant):
                exact = tpipe.folded_tables_exact(cubes, quant)
                f32 = tpipe.folded_tables(cubes.float(),
                                          [None if q is None else q.float() for q in quant])
                return tuple(m for m in exact + f32 if m is not None)

        cubes = torch.randint(-128, 128, (2, X, Y, Z), dtype=torch.int8)
        ep = torch.export.export(Tables(), (cubes,), dynamic_shapes=({0: Dim("b", min=1)},))
        for B in (1, 9):
            c = torch.randint(-128, 128, (B, X, Y, Z), dtype=torch.int8)
            want = [torch.einsum(s, q.long(), c.long()) for s, q in zip(SPECS, quant)
                    if q is not None]
            got = ep.module()(c)
            assert all(torch.equal(g, w) for g, w in zip(got, want + [w.float() for w in want]))
