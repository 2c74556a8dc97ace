"""Port parity: models/pipeline.RadarPredictor against the JAX package's.

The same model, cubes and targets (made with numpy from a seed) go
through both predictors on the CPU. Tolerances, with their reasons:

* exact and fast float32 modes sum float32 products in another order
  than XLA: probabilities within 1e-5, and decisions equal wherever the
  reference's top-2 probability margin exceeds 1e-4;
* fast int8 and fused compute exact integer tables and the same float32
  dequantize ops: probabilities within 1e-6, decisions equal where the
  margin exceeds 1e-4;
* the port's fused split decisions equal the port's fast int8 decisions
  exactly (the JAX package's own contract), probabilities within 1e-6;
* pallas: the JAX kernel splits each float32 template into bf16 hi + lo
  halves, the port keeps float32 templates: probabilities within 1e-5,
  decisions equal where the margin exceeds 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radarml_tpu.core.arena import Arena as JArena, ProjMask as JMask
from radarml_tpu.models import linear as jlin
from radarml_tpu.models import pipeline as jpipe
from radarml_tpu_torch.core.arena import Arena, ProjMask
from radarml_tpu_torch.models import linear as tlin
from radarml_tpu_torch.models import pipeline as tpipe

torch.set_num_threads(1)

SCAN = dict(r_min=10.0, r_max=60.0, r_res=2.0, theta_min=-12.0,
            theta_max=12.0, theta_res=4.0, phi_min=-6.0, phi_max=6.0,
            phi_res=2.0)  # (7, 7, 26) cube
TRAIN = dict(SCAN, theta_res=3.0, r_res=2.5)  # (9, 7, 21): zooms differ


def _fixture(rng, train=SCAN, mask=(True, True, True), calibrated=True,
             B=5, T=3):
    """Both packages' predictor kwargs + one batch of numpy inputs."""
    jt, js = JArena(**train), JArena(**SCAN)
    shapes = (jt.xz_shape, jt.yz_shape, jt.xy_shape)
    F = sum(h * w for (h, w), k in zip(shapes, mask) if k)
    coef = (rng.normal(size=(3, F)) * 0.05).astype(np.float32)
    intercept = rng.normal(size=(3,)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=3).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32) * 0.1
    jkw = dict(
        train_arena=jt, scan_arena=js, proj_mask=JMask(*mask), min_proba=0.5,
        model=jlin.LinearModel(jnp.asarray(coef), jnp.asarray(intercept)),
        calibration=(jlin.SigmoidCalibration(jnp.asarray(a), jnp.asarray(b))
                     if calibrated else None),
    )
    model, calib = tlin.from_numpy(
        coef, intercept, *((a, b) if calibrated else ()), device="cpu"
    )
    tkw = dict(
        train_arena=Arena(**train), scan_arena=Arena(**SCAN),
        proj_mask=ProjMask(*mask), min_proba=0.5, model=model,
        calibration=calib,
    )
    cubes = np.rint(rng.random((B,) + js.grid_shape) * 255).astype(np.float32)
    cells = np.stack([rng.integers(0, n, size=(B, T)) for n in js.grid_shape], -1)
    xyz = np.stack(js.grid_to_cartesian_np(*cells.T.astype(np.float64)), -1)
    xyz = xyz.transpose(1, 0, 2) + rng.normal(scale=0.3, size=(B, T, 3))
    xyz[0, 0] = (0.0, 0.0, 5000.0)  # out-of-arena sentinels clamp
    xyz[1, 1] = (-900.0, 900.0, -10.0)
    valid = rng.random((B, T)) < 0.8
    return jkw, tkw, (cubes, xyz.astype(np.float32), valid)


def _check(jout, tout, atol):
    jp, jb, jproba = (np.asarray(o) for o in jout)
    tp, tb, tproba = (o.numpy() for o in tout)
    assert tp.dtype == np.int32 and tproba.dtype == np.float32
    assert tproba.shape == jproba.shape and tp.shape == jp.shape
    np.testing.assert_allclose(tproba, jproba, atol=atol, rtol=0)
    np.testing.assert_allclose(tb, jb, atol=atol, rtol=0)
    top2 = np.sort(jproba, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > 1e-4) & (
        np.abs(jb - 0.5) > 1e-4
    )
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(tp[clear], jp[clear])


@pytest.mark.parametrize(
    "train,mask,calibrated",
    [
        (SCAN, (True, True, True), True),
        (TRAIN, (True, True, True), True),
        (TRAIN, (True, False, True), False),
    ],
)
def test_exact_mode_matches_jax(rng, train, mask, calibrated):
    jkw, tkw, (cubes, xyz, valid) = _fixture(rng, train, mask, calibrated)
    j = jpipe.RadarPredictor(mode="exact", **jkw)
    t = tpipe.RadarPredictor(mode="exact", **tkw)
    _check(j(cubes, xyz, valid), t(cubes, xyz, valid), atol=1e-5)


@pytest.mark.parametrize("cube_dtype", ["float32", "bfloat16", "uint8", "int8"])
@pytest.mark.parametrize("train", [SCAN, TRAIN])
def test_fast_mode_matches_jax(rng, cube_dtype, train):
    jkw, tkw, (cubes, xyz, valid) = _fixture(rng, train)
    j = jpipe.RadarPredictor(mode="fast", cube_dtype=cube_dtype, **jkw)
    t = tpipe.RadarPredictor(mode="fast", cube_dtype=cube_dtype, **tkw)
    atol = 1e-6 if cube_dtype == "int8" else 1e-5
    _check(j(cubes, xyz, valid), t(cubes, xyz, valid), atol=atol)
    # host-encoded stream input scores the same as raw float cubes
    enc = t.encode_host(cubes)
    np.testing.assert_array_equal(
        np.asarray(jpipe.encode_host_cubes(cubes, cube_dtype)).astype(np.float32),
        enc.to(torch.float32).numpy(),
    )
    for a, b in zip(t(enc, xyz, valid), t(cubes, xyz, valid)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("levels", [2, 1])
@pytest.mark.parametrize("mask", [(True, True, True), (True, False, True)])
def test_quantized_templates_equal_jax_bytes(rng, levels, mask):
    jkw, tkw, _ = _fixture(rng, TRAIN, mask)
    j = jpipe.RadarPredictor(mode="fast", **jkw)
    t = tpipe.RadarPredictor(mode="fast", **tkw)
    for jq, tq in zip(
        j._quantized_split_templates(levels),
        t._quantized_split_templates(levels),
    ):
        assert (jq is None) == (tq is None)
        if jq is None:
            continue
        assert tq[0].dtype == np.int8
        assert np.asarray(jq[0]).tobytes() == tq[0].tobytes()
        for a, b in zip(jq[1:], tq[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.asarray(a).tobytes() == b.tobytes()


TAILS = ("combo", "lookup", "glookup", "sel", "sel3")
MASKS = ((True, True, True), (False, True, True))
FUSED_CASES = [  # the combo cases keep their first ids
    pytest.param(mask, quant, "combo", id=f"mask{m}-{quant}")
    for m, mask in enumerate(MASKS) for quant in ("split", "single")
] + [
    pytest.param(mask, "split", tail, id=f"mask{m}-split-{tail}")
    for m, mask in enumerate(MASKS) for tail in TAILS[1:]
]


@pytest.mark.parametrize("mask,quant,tail", FUSED_CASES)
def test_fused_mode_matches_jax(rng, mask, quant, tail):
    """Port fused (plain versions on the CPU) against JAX fused (interpret
    mode) under the same tail: the same tables feed the same tail, in
    that tail's own float order."""
    jkw, tkw, (cubes, xyz, valid) = _fixture(rng, SCAN, mask)
    j = jpipe.RadarPredictor(mode="fused", fused_quant=quant, fused_tail=tail, **jkw)
    t = tpipe.RadarPredictor(mode="fused", fused_quant=quant, fused_tail=tail, **tkw)
    assert t.cube_dtype == "int8"
    _check(j(j.pack_host(cubes), xyz, valid),
           t(t.pack_host(cubes), xyz, valid), atol=1e-6)


def test_fused_wire_layout_is_tail_independent(rng):
    """The port's twin of the JAX package's test: one pack_host batch
    scores the same under every fused tail and as fast+int8 (decisions
    equal, probabilities within 1e-6: the lookup tails dequantize before
    the read, sel/sel3 after), and the 4-D ingest equals the packed one."""
    _, tkw, (cubes, xyz, valid) = _fixture(rng, TRAIN, B=6, T=4)
    preds = {t: tpipe.RadarPredictor(mode="fused", fused_tail=t, **tkw) for t in TAILS}
    packed = preds["sel3"].pack_host(cubes)  # pack once
    got = {t: preds[t](packed, xyz, valid) for t in TAILS}
    got["fast_i8"] = tpipe.RadarPredictor(mode="fast", cube_dtype="int8", **tkw)(
        cubes, xyz, valid)
    for t in list(TAILS[1:]) + ["fast_i8"]:
        assert torch.equal(got[t][0], got["combo"][0]), t
        np.testing.assert_allclose(got[t][2].numpy(), got["combo"][2].numpy(),
                                   atol=1e-6, rtol=0)
    for t in TAILS:
        assert all(torch.equal(a, b) for a, b in zip(preds[t](cubes, xyz, valid), got[t]))


@pytest.mark.parametrize("tail", TAILS[1:])
def test_single_quant_is_combo_only(rng, tail):
    _, tkw, _ = _fixture(rng)
    with pytest.raises(ValueError, match="single"):
        tpipe.RadarPredictor(mode="fused", fused_tail=tail, fused_quant="single", **tkw)
    with pytest.raises(ValueError, match="fused_tail"):
        tpipe.RadarPredictor(mode="fused", fused_tail=tail + "x", **tkw)


def test_fused_split_decisions_equal_fast_int8(rng):
    """The JAX package's contract, held on the port: packed and 4-D
    ingest paths, decisions equal, probabilities within 1e-6."""
    _, tkw, (cubes, xyz, valid) = _fixture(rng, TRAIN, B=7, T=4)
    fast = tpipe.RadarPredictor(mode="fast", cube_dtype="int8", **tkw)
    fused = tpipe.RadarPredictor(mode="fused", **tkw)
    pf, bf, qf = fast(cubes, xyz, valid)
    pk, bk, qk = fused(fused.pack_host(cubes), xyz, valid)
    p4, b4, q4 = fused(cubes, xyz, valid)
    assert torch.equal(pk, pf) and torch.equal(p4, pf)
    np.testing.assert_allclose(qk.numpy(), qf.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(qk, q4)


def test_pad_targets_and_defaults_match_jax(rng):
    lists = [[(1.0, 2.0, 30.0)], [], [(0.0, 0.0, 50.0)] * 6]
    for a, b in zip(jpipe.pad_targets(lists, 4), tpipe.pad_targets(lists, 4)):
        np.testing.assert_array_equal(a, b)
    assert tpipe.UNKNOWN == jpipe.UNKNOWN
    jkw, tkw, (cubes, xyz, _) = _fixture(rng)
    j = jpipe.RadarPredictor(mode="fast", **jkw)(cubes, xyz)
    t = tpipe.RadarPredictor(mode="fast", **tkw)(cubes, xyz)
    np.testing.assert_array_equal(np.asarray(j[0]) == -1, t[0].numpy() == -1)


@pytest.mark.parametrize("cube_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [SCAN, TRAIN], ids=["scan", "train"])
def test_pallas_mode_matches_jax(rng, cube_dtype, train):
    """Port pallas (the plain tables on the CPU) against JAX pallas (its
    kernel in interpret mode): the JAX kernel's bf16 hi/lo template split
    errs by ~3e-6 relative, the port keeps float32 templates, so
    probabilities agree within 1e-5 and decisions where the margin
    exceeds 1e-4. Against the port's own exact path the JAX package's
    pallas-vs-exact bar holds: probabilities within 2e-4, decisions
    equal (the cubes are integers, exact in bf16)."""
    jkw, tkw, (cubes, xyz, valid) = _fixture(rng, train)
    j = jpipe.RadarPredictor(mode="pallas", cube_dtype=cube_dtype, **jkw)
    t = tpipe.RadarPredictor(mode="pallas", cube_dtype=cube_dtype, **tkw)
    got = t(cubes, xyz, valid)
    _check(j(cubes, xyz, valid), got, atol=1e-5)
    exact = tpipe.RadarPredictor(mode="exact", **tkw)(cubes, xyz, valid)
    np.testing.assert_allclose(got[2].numpy(), exact[2].numpy(), atol=2e-4, rtol=0)
    assert torch.equal(got[0], exact[0])
    # a host-encoded stream scores the same as the raw float cubes
    for a, b in zip(t(t.encode_host(cubes), xyz, valid), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cube_dtype", ["uint8", "int8"])
def test_pallas_refuses_8bit_streams(rng, cube_dtype):
    jkw, tkw, _ = _fixture(rng)
    for pipe, kw in ((jpipe, jkw), (tpipe, tkw)):
        with pytest.raises(ValueError, match="use mode='fused' for int8"):
            pipe.RadarPredictor(mode="pallas", cube_dtype=cube_dtype, **kw)


def test_pallas_refuses_a_partial_mask(rng):
    jkw, tkw, _ = _fixture(rng, TRAIN, (True, False, True))
    for pipe, kw in ((jpipe, jkw), (tpipe, tkw)):
        with pytest.raises(ValueError, match="full ProjMask"):
            pipe.RadarPredictor(mode="pallas", **kw)


@pytest.mark.parametrize(
    "kw,item",
    [  # the id the case had beside the fused tails' cases
        pytest.param(dict(mesh=object()), "A15", id="kw5-A15"),
    ],
)
def test_unported_parts_raise(rng, kw, item):
    _, tkw, _ = _fixture(rng)
    with pytest.raises(NotImplementedError, match=item):
        tpipe.RadarPredictor(**kw, **tkw)
    # the neural families are ported (ROADMAP A12, A13): a NeuralClassifier builds
    assert tpipe.NeuralClassifier(apply=None, rescale=(8, 8), n_classes=3).n_classes == 3
