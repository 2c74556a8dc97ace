"""Port parity: the float64 host-side operators (ops/resample, ops/features),
the synthetic generator and the stage timers.

These are numpy in both packages, so the port must give byte-identical
arrays (tolerance 0).
"""

import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import DEFAULT_ARENA as JDEF, Arena as JArena
from radarml_tpu.data import synthetic as jsyn
from radarml_tpu.ops import features as jfeat
from radarml_tpu.ops import resample as jres
from radarml_tpu_torch.core.arena import DEFAULT_ARENA as TDEF, Arena as TArena
from radarml_tpu_torch.data import synthetic as tsyn
from radarml_tpu_torch.ops import features as tfeat
from radarml_tpu_torch.ops import resample as tres
from radarml_tpu_torch.utils.profiling import RateMeter, StageTimer

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "shape,zoom",
    [((22, 176), (1.0, 1.0)), ((31, 176), (29 / 31, 150 / 176)),
     ((22, 31), (1.5, 0.5)), ((7, 26), (9 / 7, 21 / 26)), ((1, 5), (3.0, 1.0))],
)
def test_spline_zoom_pair_bytes_equal(shape, zoom):
    a, b = jres.spline_zoom_pair(shape, zoom), tres.spline_zoom_pair(shape, zoom)
    assert a[2] == b[2]
    for x, y in zip(a[:2], b[:2]):
        assert x.dtype == y.dtype == np.float64
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize(
    "shape,out", [((22, 176), (64, 64)), ((31, 176), (10, 200)), ((3, 3), (3, 3))]
)
def test_bicubic_pair_bytes_equal(shape, out):
    for x, y in zip(jres.bicubic_pair(shape, out), tres.bicubic_pair(shape, out)):
        assert x.tobytes() == y.tobytes()


def test_feature_spec_and_predict_zoom_equal():
    small = dict(theta_res=3.0, r_res=2.5)
    for train in ({}, small):
        jz = jfeat.predict_zoom(JArena(**train), JDEF)
        tz = tfeat.predict_zoom(TArena(**train), TDEF)
        assert tuple(jz) == tuple(tz)
        js = jfeat.FeatureSpec.for_arena(JArena(**train), proj_zoom=jz)
        ts = tfeat.FeatureSpec.for_arena(TArena(**train), proj_zoom=tz)
        assert js.plane_out_shapes == ts.plane_out_shapes
        assert js.feature_length == ts.feature_length


def test_synthetic_bytes_equal():
    a, ta = jsyn.make_scan_batch(3, seed=7)
    b, tb = tsyn.make_scan_batch(3, seed=7)
    assert a.tobytes() == b.tobytes()
    assert [t.__dict__ for t in ta] == [t.__dict__ for t in tb]
    sa, la = jsyn.make_dataset(4, seed=11, hardness=0.5)
    sb, lb = tsyn.make_dataset(4, seed=11, hardness=0.5)
    assert la == lb
    for pa, pb in zip(sa, sb):
        for x, y in zip(pa, pb):
            assert x.tobytes() == y.tobytes()


def test_stage_timer_and_rate_meter():
    timer = StageTimer()
    for _ in range(3):
        with timer("classify"):
            pass
    row = timer.summary()["classify"]
    assert row["count"] == 3 and row["min_ms"] <= row["mean_ms"] <= row["max_ms"]
    timer.reset()
    assert timer.summary() == {}
    meter = RateMeter()
    meter.tick(4)
    meter.tick(4)
    assert meter.count == 8 and meter.rate > 0
