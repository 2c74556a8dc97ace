"""Port parity at the shapes past the table kernels' earlier limits: class
counts over 8 class rows (B1-B5) and over 7 classes (B7), and scan arenas
finer than the default (Z = 351 > 256).

The same inputs (numpy, from a seed) go through the JAX package and the
port on the CPU, where each port wrapper runs its plain version. The
CUDA kernels are held to those plain versions on the card by
chip_smoke.py (phase 3 and phase 17) and by the card-only tests of
tests/test_torch_i8_score.py, test_torch_i8_tails.py and
test_torch_native_score.py. Tolerances, with their reasons:

* int8 tables and reads (B1-B5): exact integers, bit-equal to the JAX
  kernels in interpret mode (the JAX lookup, glookup, sel and sel3
  weights hold C2 = 2C rows, levels 2 only, so at 9 rows those four are
  held to the int64 einsum oracle and only the combo kernel, which takes
  levels 1, to the JAX kernel);
* B7: within 1e-5 x max|JAX| of the JAX kernel in interpret mode (the
  JAX kernel splits each float32 template into bf16 hi + lo halves);
* RadarPredictor, B = 2: probabilities within 1e-5 of the JAX
  predictor's in fast int8 and pallas mode, decisions equal where the
  JAX top-2 margin exceeds 1e-4; each fused split tail's decisions equal
  the port's fast int8 decisions exactly and its probabilities within
  1e-6 (the JAX package's own contract). The JAX side runs fast int8 and
  pallas only: its interpret-mode fused tails take 8-42 s a call here.

The work plans that let the kernels take these shapes (one block of two
n-tiles or class groups and the staged route for the int8 kernels, the
long-row instance, z-chunks and class groups for B7) are made by the
CUDA sources, which the wrappers
ask on the card. Each has a host mirror, ops/i8_score.whole_scan_plan and
ops/score.native_plan, checked here to serve every listed shape and to
keep the default arena's earlier plan, and against the kernels' own on
the card (chip_smoke.py, phase 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radarml_tpu.core.arena import Arena as JArena
from radarml_tpu.models import linear as jlin
from radarml_tpu.models import pipeline as jpipe
from radarml_tpu.ops import pallas_i8_score as jk
from radarml_tpu.ops import pallas_score as jscore
from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena
from radarml_tpu_torch.models import linear as tlin
from radarml_tpu_torch.models import pipeline as tpipe
from radarml_tpu_torch.ops import i8_score as ts
from radarml_tpu_torch.ops import i8_tails as tt
from radarml_tpu_torch.ops import score

torch.set_num_threads(1)

DEFAULT = (22, 31, 176)
# The finer scan arenas: tests/test_apps.py:580, tests/test_pipeline.py:388,
# and every axis at half the default step.
FINE = {(43, 31, 351): dict(r_res=1.0, theta_res=2.0), (22, 31, 351): dict(r_res=1.0),
        (43, 61, 351): dict(r_res=1.0, theta_res=2.0, phi_res=1.0)}
SMALL = [(5, 7, 9), (9, 13, 180)]
ROWS = [9, 10, 16, 18, 32]  # class rows C2 = levels x C: 9 = 9 x 1, else 2 x C
ENTRIES = ["combo", "lookup", "glookup", "sel", "sel3"]


def _levels(c2):
    return 1 if c2 % 2 else 2


def _quant(rng, dims, c2):
    """Random int8 templates of c2 rows: the port's (q, s1, s2, const)
    tuples and the JAX builders' (q, None, None, None)."""
    X, Y, Z = dims
    levels = _levels(c2)
    s = np.ones((c2 // levels,), np.float32)
    port, jax_q = [], []
    for shape in ((X, Z), (Y, Z), (X, Y)):
        q = rng.integers(-127, 128, (c2,) + shape).astype(np.int8)
        port.append((q, s, s if levels == 2 else None, s))
        jax_q.append((q, None, None, None))
    return port, jax_q


def _ijk(rng, dims, B, T):
    ijk = np.stack([rng.integers(0, n, (B, T)) for n in dims], -1).astype(np.int32)
    ijk[0, -1] = -1
    ijk[-1, 0, 2] = dims[2]  # past the end of z
    return ijk


def _port(entry, port_q, dims, c2, cube, ijk, valid):
    levels = _levels(c2)
    if entry == "combo":
        return ts.onepass_tables_combined_i8(
            cube, ts.build_combined_weights(port_q, dims, levels=levels))
    if entry == "glookup":
        return tt.onepass_tables_grouped_i8(
            cube, tt.build_grouped_weights(port_q, dims, min(16, dims[1]), levels=levels))
    w = tt.build_onepass_weights(port_q, dims, levels=levels)
    if entry == "lookup":
        return tt.onepass_tables_i8(cube, w)
    if entry == "sel":
        return tt.onepass_tables_sel_i8(cube, w, ijk[..., 2])
    return tt.onepass_scores_i8(cube, w, ijk, valid)


def _oracle(entry, port_q, cubes, ijk, valid):
    """int64 numpy einsums, and for sel / sel3 their reads: an index
    outside its range or an invalid slot reads zero."""
    v = cubes.astype(np.int64) - 128
    m = [np.einsum(spec, q[0].astype(np.int64), v) for q, spec in
         zip(port_q, ("cxz,bxyz->cyb", "cyz,bxyz->cxb", "cxy,bxyz->zcb"))]
    if entry not in ("sel", "sel3"):
        return m
    B, T, _ = ijk.shape
    reads = [np.zeros((m[0].shape[0], T, B), np.int64) for _ in range(3)]
    for b in range(B):
        for t in range(T):
            i, j, k = ijk[b, t]
            ok = entry == "sel" or valid[b, t]
            if ok and 0 <= j < m[0].shape[1]:
                reads[0][:, t, b] = m[0][:, j, b]
            if ok and 0 <= i < m[1].shape[1]:
                reads[1][:, t, b] = m[1][:, i, b]
            if ok and 0 <= k < m[2].shape[0]:
                reads[2][:, t, b] = m[2][k, :, b]
    return (m[0], m[1], reads[2]) if entry == "sel" else reads


def _jax(entry, jax_q, dims, c2, cubes, ijk, valid):
    """The JAX kernel in interpret mode, sliced to the port's shapes."""
    Y, B, T = dims[1], cubes.shape[0], ijk.shape[1]
    if entry == "combo":
        w = jk.build_combined_weights(jax_q, dims, levels=_levels(c2))
        m = jk.onepass_tables_combined_i8(jk.pack_cubes_i8(cubes, y_group=w.y_group), w,
                                          interpret=True)
    elif entry == "glookup":
        w = jk.build_grouped_weights(jax_q, dims)
        m = jk.onepass_tables_grouped_i8(jk.pack_cubes_i8(cubes, y_group=w.y_group), w,
                                         interpret=True)
    elif entry == "lookup":
        w = jk.build_onepass_weights(jax_q, dims)
        m = jk.onepass_tables_i8(jk.pack_cubes_i8(cubes), w, interpret=True)
    elif entry == "sel":
        w = jk.build_onepass_weights(jax_q, dims)
        m1, m2, d3 = jk.onepass_tables_sel_i8(jk.pack_cubes_i8(cubes), w, ijk[..., 2],
                                              interpret=True)
        return (np.asarray(m1)[:, :Y, :B], np.asarray(m2)[..., :B],
                np.asarray(d3)[:, :T, :B])
    else:
        w = jk.build_grouped_weights(jax_q, dims)
        out = jk.onepass_scores_i8(jk.pack_cubes_i8(cubes, y_group=w.y_group), w, ijk, valid,
                                   interpret=True)
        return tuple(np.asarray(s)[:, :T, :B] for s in out)
    return np.asarray(m[0])[:, :Y, :B], np.asarray(m[1])[..., :B], np.asarray(m[2])[..., :B]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("c2", ROWS)
@pytest.mark.parametrize("dims", SMALL, ids=lambda d: "x".join(map(str, d)))
def test_int8_tables_past_eight_rows_match_jax(rng, dims, c2, entry):
    """B1-B5 (plain versions) at 9 / 10 / 16 / 18 / 32 class rows, bit-equal
    to the JAX kernels in interpret mode; -1, past-the-end and invalid
    slots read zero in both."""
    port_q, jax_q = _quant(rng, dims, c2)
    B, T = 3, 2
    cubes = rng.integers(0, 256, (B,) + dims).astype(np.uint8)
    ijk = _ijk(rng, dims, B, T)
    valid = np.array([[True, True], [False, True], [True, True]])
    got = _port(entry, port_q, dims, c2, ts.pack_cubes_i8(cubes), ijk, valid)
    wants = [_oracle(entry, port_q, cubes, ijk, valid)]
    if entry == "combo" or c2 % 2 == 0:
        wants.append(_jax(entry, jax_q, dims, c2, cubes, ijk, valid))
    for want in wants:
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy().astype(np.int64), w)
    assert got[0].shape[0] == c2


@pytest.mark.parametrize("C", ROWS)
@pytest.mark.parametrize("dims", SMALL, ids=lambda d: "x".join(map(str, d)))
def test_b7_past_seven_classes_matches_jax(rng, dims, C):
    """B7 (plain version, through fused_native_score) at 9 / 10 / 16 / 18
    classes, within 1e-5 x max|JAX| of the JAX kernel in interpret mode."""
    X, Y, Z = dims
    t = [(rng.normal(size=(C,) + s) * 0.01).astype(np.float32)
         for s in ((X, Z), (Y, Z), (X, Y))]
    b = rng.normal(size=C).astype(np.float32)
    cubes = rng.integers(0, 256, (3,) + dims).astype(np.float32)
    ijk = _ijk(rng, dims, 3, 4)
    ijk = np.clip(ijk, 0, np.asarray(dims) - 1)  # the predictor clamps them
    want = np.asarray(jscore.fused_native_score(
        jnp.asarray(cubes), jnp.asarray(ijk), *map(jnp.asarray, t), jnp.asarray(b),
        interpret=True))
    got = score.fused_native_score(torch.from_numpy(cubes), torch.from_numpy(ijk), *t, b)
    assert tuple(got.shape) == (3, 4, C)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def _predictors(rng, C, scan):
    """JAX and port predictor kwargs of one random C-class linear model
    trained at the default arena, served at `scan`'s arena."""
    F = DEFAULT_ARENA.feature_length
    coef = (rng.normal(size=(C, F)) * 0.01).astype(np.float32)
    intercept = rng.normal(size=(C,)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    bb = (rng.normal(size=C) * 0.1).astype(np.float32)
    jkw = dict(train_arena=JArena(), scan_arena=JArena(**scan), min_proba=0.4,
               model=jlin.LinearModel(jnp.asarray(coef), jnp.asarray(intercept)),
               calibration=jlin.SigmoidCalibration(jnp.asarray(a), jnp.asarray(bb)))
    model, calib = tlin.from_numpy(coef, intercept, a, bb, device="cpu")
    tkw = dict(train_arena=DEFAULT_ARENA, scan_arena=Arena(**scan), min_proba=0.4,
               model=model, calibration=calib)
    return jkw, tkw


def _margin_ok(proba, best, min_proba=0.4):
    top2 = np.sort(proba, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0] > 1e-4) & (np.abs(best - min_proba) > 1e-4)


def _against_jax(jkw, tkw, cubes, xyz, valid):
    """The port's fast int8 and pallas outputs, each held to the JAX
    predictor's in the same mode: probabilities and best probabilities
    within 1e-5, decisions equal where the JAX top-2 margin exceeds 1e-4
    (at least half the valid slots). Returns {mode: port outputs}."""
    B, T = valid.shape
    C = max(tkw["model"].coef.shape[0], 2)  # one class serves as two columns
    out = {}
    for name, kw in (("fast_i8", dict(mode="fast", cube_dtype="int8")),
                     ("pallas", dict(mode="pallas"))):
        j = [np.asarray(o) for o in jpipe.RadarPredictor(**kw, **jkw)(cubes, xyz, valid)]
        t = [o.numpy() for o in tpipe.RadarPredictor(**kw, **tkw)(cubes, xyz, valid)]
        assert t[2].shape == (B, T, C) and np.isfinite(t[2]).all()
        np.testing.assert_allclose(t[2], j[2], atol=1e-5, rtol=0)
        np.testing.assert_allclose(t[1], j[1], atol=1e-5, rtol=0)
        ok = _margin_ok(j[2], j[1])
        assert ok.sum() >= valid.sum() // 2
        np.testing.assert_array_equal(t[0][ok], j[0][ok])
        out[name] = t
    return out


@pytest.mark.parametrize("C,scan", [(5, {}), (9, {}), (3, FINE[(43, 31, 351)])],
                         ids=["5_classes", "9_classes", "3_classes_43x31x351"])
def test_predictor_serves_the_shape_like_jax(rng, C, scan):
    """RadarPredictor at 5 and 9 classes (default arena) and at the
    43 x 31 x 351 scan arena: fast int8 and pallas against the JAX
    predictor's; every fused split tail equal to the port's fast int8;
    fused single (combo, levels 1) returns finite outputs too."""
    jkw, tkw = _predictors(rng, C, scan)
    arena = tkw["scan_arena"]
    B, T = 2, 3
    cubes = np.rint(rng.random((B,) + arena.grid_shape) * 255).astype(np.float32)
    cells = np.stack([rng.integers(0, n, size=(B, T)) for n in arena.grid_shape], -1)
    xyz = np.stack(arena.grid_to_cartesian_np(*cells.T.astype(np.float64)), -1)
    xyz = (xyz.transpose(1, 0, 2) + rng.normal(scale=0.3, size=(B, T, 3))).astype(np.float32)
    valid = np.array([[True, True, False], [True, True, True]])
    out = _against_jax(jkw, tkw, cubes, xyz, valid)
    for tail in ("combo", "lookup", "glookup", "sel", "sel3"):
        p = tpipe.RadarPredictor(mode="fused", fused_tail=tail, **tkw)
        got = [o.numpy() for o in p(cubes, xyz, valid)]
        np.testing.assert_array_equal(got[0], out["fast_i8"][0])
        np.testing.assert_allclose(got[2], out["fast_i8"][2], atol=1e-6, rtol=0)
    single = tpipe.RadarPredictor(mode="fused", fused_quant="single", **tkw)(cubes, xyz, valid)
    assert tuple(single[2].shape) == (B, T, C) and torch.isfinite(single[2]).all()


PORT_SHAPES = ([((), C) for C in (1, 4, 8, 16)] + [(d, C) for d in FINE for C in (3, 5)]
               + [((43, 31, 351), 9)])


@pytest.mark.parametrize("dims,C", PORT_SHAPES,
                         ids=[f"{'x'.join(map(str, d)) or 'default'}-{C}" for d, C in PORT_SHAPES])
def test_port_serves_every_listed_shape(rng, dims, C):
    """At the listed shapes the test above does not take, B = 1: the
    port's fast int8 and pallas held to the JAX predictor's as above; the
    port's RadarPredictor returns outputs in every mode and tail that runs
    a table kernel (and in fast f32, pallas's comparator): finite, of the
    class count (two columns for one class, the binary case); every fused
    split tail's decisions equal fast int8's (probabilities within 1e-6),
    pallas decisions equal fast f32's where the top-2 margin exceeds
    1e-4."""
    jkw, kw = _predictors(rng, C, FINE[dims] if dims else {})
    arena = kw["scan_arena"]
    cubes = np.rint(rng.random((1,) + arena.grid_shape) * 255).astype(np.float32)
    cells = np.stack([rng.integers(0, n, size=(1, 2)) for n in arena.grid_shape], -1)
    xyz = np.stack(arena.grid_to_cartesian_np(*cells.T.astype(np.float64)), -1)
    xyz = xyz.transpose(1, 0, 2).astype(np.float32)
    valid = np.ones((1, 2), bool)
    out = _against_jax(jkw, kw, cubes, xyz, valid)
    modes = {"fast": dict(mode="fast"), "single": dict(mode="fused", fused_quant="single")}
    modes |= {t: dict(mode="fused", fused_tail=t) for t in ENTRIES}
    for name, m in modes.items():
        out[name] = [o.numpy() for o in tpipe.RadarPredictor(**m, **kw)(cubes, xyz, valid)]
        assert out[name][2].shape == (1, 2, max(C, 2)) and np.isfinite(out[name][2]).all(), name
    for tail in ENTRIES:
        np.testing.assert_array_equal(out[tail][0], out["fast_i8"][0])
        np.testing.assert_allclose(out[tail][2], out["fast_i8"][2], atol=1e-6, rtol=0)
    ok = _margin_ok(out["fast"][2], out["fast"][1])
    np.testing.assert_array_equal(out["pallas"][0][ok], out["fast"][0][ok])


# Every listed shape: (dims, class counts).
LISTED = [(DEFAULT, (1, 4, 5, 8, 9, 16))] + [(d, (3, 5, 9)) for d in FINE]


@pytest.mark.parametrize("dims,classes", LISTED, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v[0], int) else None)
def test_every_listed_shape_has_a_card_plan(dims, classes):
    """B7's z-chunks and class groups (its host mirror, ops/score.native_plan)
    give a plan at every listed shape, each launch within one launch's
    limits; the default arena keeps one launch up to 7 classes, and Z =
    351 goes as one chunk of the long-row instance in groups of at most 3
    classes where Y = 31 (one launch at 3 classes), and in two z-chunks
    (176 and 175 wide) at 43 x 61 x 351, where the long-row instance's
    yz template of 3 classes does not fit a block. The int8 kernels'
    plans (class rows a group, slab width) come from their host mirror,
    ops/i8_score.whole_scan_plan: at Z = 351 the staged route, its slabs
    wider than one x row where Y = 31. chip_smoke.py's phase 3 holds both
    mirrors to the CUDA sources' plans on the card."""
    X, Y, Z = dims
    for C in classes:
        zc, cg = score.native_plan(*dims, C)
        long_rows = zc > score.MAX_Z
        assert zc <= (score.LONG_MAX_Z if long_rows else score.MAX_Z)
        assert cg <= (score.LONG_MAX_C if long_rows else score.MAX_C)
        assert score.shared_memory_bytes(X, Y, zc, cg) <= score.SMEM_MAX
        if dims == DEFAULT and C <= 7:
            assert (zc, cg) == (176, C)
        if Z == 351:
            assert (zc, cg) == ((351, min(C, 3)) if Y == 31 else (176, 3))
        rows, width = ts.whole_scan_plan(*dims, 2 * C)
        assert 1 <= rows <= ts.MAX_TILES * ts.MAX_GROUP_ROWS and 1 <= width <= X
        if rows > ts.MAX_GROUP_ROWS:  # one block of two n-tiles a scan, slabs kept wide
            assert rows == 2 * C and width >= min(X, ts.WIDE_SLAB)
        assert ts.layout_bytes(width, 1, *dims, rows, staged=ts.staged_route(*dims)) \
            <= ts.SMEM_MAX
        if Z == 351 and Y == 31:
            assert ts.staged_route(*dims) and width > 1


def test_card_refusals_name_the_limit(rng):
    """A shape past what any plan takes: the CPU computes it (the plain
    versions), B7's host mirror has no plan for it, and the CUDA
    implementations refuse a CPU tensor before any launch. On the card
    they refuse the shape itself, naming the 232,448-byte limit (the card
    tests of test_torch_i8_score.py and test_torch_native_score.py)."""
    huge = (43, 200, 400)  # one int8 class row's whole-scan block needs ~320 KB
    q = [torch.zeros((1,) + s, dtype=torch.int8) for s in ((43, 400), (200, 400), (43, 200))]
    w = ts.CombinedWeights(*q, dims=huge + (1,), levels=1)
    cube = torch.zeros((1,) + huge, dtype=torch.int8)
    before = ts.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="no one-pass kernel for device cpu"):
        ts.card_operands(cube, w)
    assert not ts.onepass_tables_combined_i8(cube, w)[0].any()
    assert ts.KERNEL_LAUNCHES == before
    huge = (250, 250, 9)  # B7's xy template alone, 250 x 250 floats, is 250 KB
    assert score.native_plan(*huge, 1) is None
    tm = score.native_templates(*[np.zeros((1,) + s, np.float32)
                                  for s in ((250, 9), (250, 9), (250, 250))])
    cube = torch.zeros((1,) + huge, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no native_score kernel for device cpu"):
        score.native_tables_cuda(cube, tm)
    assert not score.native_tables(cube, tm)[2].any()
