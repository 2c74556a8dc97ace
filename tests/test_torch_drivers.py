"""Port parity: the radar drivers and derived targets against the JAX
package's.

The cases of tests/test_drivers.py re-run against radarml_tpu_torch, and
where the JAX function can be called on the same inputs the two are
held together:

- SyntheticRadar: the same seed gives the same cubes (exactly: one
  numpy generator, float64 then float32 in both) and the same target
  reports (the same floats) for seeds 0-3;
- NativeScanSource: the port's copy of the C++ source streams the same
  cubes, target rows and sequence numbers as the JAX package's for one
  seed (exactly: the same generator in C++);
- derive_targets: equal indices on cubes with tied profiles (integer
  cubes, whose profile sums are exact in both), and coordinates and
  amplitudes within 1e-4 (float32 trig in two libraries).

The native source is built with g++ into radarml_tpu_torch/_build/.
"""

import numpy as np
import pytest
import torch

from radarml_tpu.core import arena as ja
from radarml_tpu.drivers import NativeScanSource as JNativeScanSource
from radarml_tpu.drivers import SyntheticRadar as JSyntheticRadar
from radarml_tpu.drivers import RadarSession as JRadarSession
from radarml_tpu_torch.core import arena as ta
from radarml_tpu_torch.core.arena import Arena
from radarml_tpu_torch.drivers import (
    DriverState,
    NativeRadar,
    NativeScanSource,
    RadarSession,
    RadarTarget,
    ReplayRadar,
    StateError,
    Status,
    SyntheticRadar,
    calibrate,
)
from radarml_tpu_torch.drivers import native
from radarml_tpu_torch.ops import _cuda_build

torch.set_num_threads(1)

ARENA = Arena()  # default 22x31x176


def test_state_machine_enforced():
    d = SyntheticRadar(arena=ARENA)
    with pytest.raises(StateError):
        d.trigger()
    with pytest.raises(StateError):
        d.start()
    d.connect()
    with pytest.raises(StateError):
        d.start()  # must configure first
    d.configure()
    d.start()
    d.trigger()
    assert d.get_raw_image().shape == ARENA.grid_shape
    d.stop()
    with pytest.raises(StateError):
        d.trigger()
    d.disconnect()
    assert d.state == DriverState.CREATED


def test_synthetic_scan_contents():
    d = SyntheticRadar(arena=ARENA, seed=7, max_targets=2)
    with RadarSession(d) as r:
        r.trigger()
        cube = r.get_raw_image()
        targets = r.get_sensor_targets()
    assert cube.dtype == np.float32
    assert 0.0 <= cube.min() and cube.max() <= 255.0
    assert 1 <= len(targets) <= 2
    for t in targets:
        assert t.z > 0  # in front of the radar
    assert len(d.truth_labels) == len(targets)


def test_synthetic_determinism():
    def scans(seed):
        d = SyntheticRadar(arena=ARENA, seed=seed)
        with RadarSession(d) as r:
            r.trigger()
            return r.get_raw_image().copy()

    np.testing.assert_array_equal(scans(3), scans(3))
    assert not np.array_equal(scans(3), scans(4))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_synthetic_radar_equals_jax(seed):
    """Three triggers (up to 2 targets, one scan in three empty) give the
    JAX driver's cubes, targets and truth labels, bit for bit."""
    kw = dict(seed=seed, max_targets=2, empty_scan_rate=0.3)
    got, want = [], []
    for cls, session, out in ((SyntheticRadar, RadarSession, got),
                              (JSyntheticRadar, JRadarSession, want)):
        with session(cls(**kw)) as r:
            for _ in range(3):
                r.trigger()
                out.append((r.get_raw_image().copy(),
                            [tuple(t) for t in r.get_sensor_targets()],
                            r.truth_labels))
    for (gc, gt, gl), (wc, wt, wl) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        assert gt == wt and gl == wl


def test_calibration_loop_runs_when_mti_off():
    d = SyntheticRadar(arena=ARENA, mti=False, calibration_triggers=4)
    d.connect()
    d.configure()
    d.start()
    assert d.get_status()[0] == Status.CALIBRATING
    n = calibrate(d)
    assert n == 4
    assert d.get_status()[0] == Status.CLEAN
    d.disconnect()


def test_replay_round_trip():
    rng = np.random.default_rng(0)
    scans = [
        (rng.random(ARENA.grid_shape).astype(np.float32),
         [RadarTarget(1.0, 2.0, 100.0, 50.0)]),
        (rng.random(ARENA.grid_shape).astype(np.float32), []),
    ]
    d = ReplayRadar(arena=ARENA, scans=scans)
    with RadarSession(d) as r:
        r.trigger()
        np.testing.assert_array_equal(r.get_raw_image(), scans[0][0])
        assert r.get_sensor_targets() == [RadarTarget(1.0, 2.0, 100.0, 50.0)]
        r.trigger()
        assert r.get_sensor_targets() == []
        r.trigger()  # loops
        np.testing.assert_array_equal(r.get_raw_image(), scans[0][0])


def test_native_library_builds_into_the_build_dir():
    """The port builds its own copy of the source into _build/, under a
    name keyed on the source's hash, never next to the source."""
    path = native.build_library()
    assert path.startswith(str(_cuda_build.BUILD_DIR)) and path.endswith(".so")
    assert native.SOURCE.parent.name == "csrc"
    assert not list(native.SOURCE.parent.glob("*.so"))
    assert native.build_library() == path  # built once


def test_native_source_synthetic_stream():
    src = NativeScanSource(arena=ARENA, seed=5)
    src.start()
    try:
        out = src.next(timeout_s=5.0)
        assert out is not None
        cube, targets, seq = out
        assert cube.shape == ARENA.grid_shape
        assert cube.max() <= 255.0 and cube.min() >= 0.0
        assert len(targets) >= 1
        i, j, k, amp = targets[0]
        # planted blob actually present near the reported cell
        assert cube[int(i), int(j), int(k)] > 50.0
        out2 = src.next(timeout_s=5.0)
        assert out2 is not None and out2[2] != seq
    finally:
        src.close()


def _drain(cls, n, seed):
    """seq -> (cube, target rows) of n scans read from a source. A scan's
    contents depend on its sequence number only, so scans that a loaded
    host let the ring overwrite (newest-wins) are skipped, not misread."""
    src = cls(arena=ARENA, seed=seed, capacity=64, scan_period_us=2000.0)
    src.start()
    try:
        out = [src.next(timeout_s=10.0) for _ in range(n)]
    finally:
        src.close()
    return {seq: (cube, rows) for cube, rows, seq in out}


def test_native_source_stream_equals_jax():
    got, want = _drain(NativeScanSource, 6, 21), _drain(JNativeScanSource, 6, 21)
    common = sorted(set(got) & set(want))
    assert common
    for seq in common:
        np.testing.assert_array_equal(got[seq][0], want[seq][0])
        np.testing.assert_array_equal(got[seq][1], want[seq][1])


def test_native_source_replay_pool():
    rng = np.random.default_rng(1)
    cubes = rng.random((3,) + ARENA.grid_shape).astype(np.float32)
    targets = [np.array([[1, 2, 3, 9.0]]), np.zeros((0, 4)), np.array([[4, 5, 6, 7.0]])]
    src = NativeScanSource(arena=ARENA, mode="replay")
    src.load_pool(cubes, targets)
    src.start()
    try:
        seen = []
        for _ in range(4):
            out = src.next(timeout_s=5.0)
            assert out is not None
            cube, rows, seq = out
            seen.append((seq % 3, rows.shape[0]))
            np.testing.assert_array_equal(cube, cubes[seq % 3])
        assert {s for s, _ in seen} <= {0, 1, 2}
    finally:
        src.close()


def test_native_radar_driver_end_to_end():
    d = NativeRadar(arena=ARENA, seed=11)
    with RadarSession(d) as r:
        r.trigger()
        cube = r.get_raw_image()
        targets = r.get_sensor_targets()
    assert cube.shape == ARENA.grid_shape
    assert targets and targets[0].z > 0


SMALL = dict(r_min=10.0, r_max=60.0, r_res=2.0, theta_min=-12.0, theta_max=12.0,
             theta_res=4.0, phi_min=-6.0, phi_max=6.0, phi_res=2.0)


@pytest.mark.parametrize("num_targets", [1, 3])
@pytest.mark.parametrize("kw", [{}, SMALL], ids=["default", "small"])
def test_derive_targets_equals_jax_with_ties(rng, kw, num_targets):
    """Integer cubes built so that every profile has ties at its top: the
    lower index counts as stronger in both (jax.lax.top_k's order)."""
    tarena, jarena = ta.Arena(**kw), ja.Arena(**kw)
    X, Y, Z = tarena.grid_shape
    cube = np.zeros((X, Y, Z), np.float32)
    # equal blocks on a few cells: every axis profile ties between them
    for i, j, k in ((1, 2, 3), (X - 2, Y - 2, Z - 4), (X // 2, 1, Z // 2)):
        cube[i, j, k] = 200.0
    got = ta.derive_targets(torch.from_numpy(cube), tarena, num_targets)
    want = ja.derive_targets(cube, jarena, num_targets)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (num_targets,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_derive_targets_weakest_to_strongest(rng):
    """Distinct profiles: the strongest target comes last, and the cube's
    device and dtype (numpy, uint8 tensor) do not change the answer."""
    cube = rng.integers(0, 10, ARENA.grid_shape).astype(np.float32)
    cube[5] += 80.0
    cube[:, 7] += 80.0
    cube[:, :, 100] += 80.0  # at most 249: a uint8 copy is the same cube
    x, y, z, amp = ta.derive_targets(cube, ARENA, 2)
    want = ARENA.grid_to_cartesian(5, 7, 100)
    for g, w in zip((x[-1], y[-1], z[-1]), want):
        assert abs(float(g) - float(w)) < 1e-4
    assert amp[-1] >= amp[0]
    again = ta.derive_targets(torch.from_numpy(cube.astype(np.uint8)), ARENA, 2)
    for g, w in zip(again[:3], (x, y, z)):
        assert torch.equal(g, w)
