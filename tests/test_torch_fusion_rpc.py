"""The port's camera link and fusion: the cases of tests/test_fusion_rpc.py
re-run on radarml_tpu_torch, and the port held against the JAX package.

The coordinate math and the association are numpy float64 in both
packages, on the same inputs: equal within 1e-12 (the same operations in
the same order). The capture loop runs both packages' synthetic drivers
from one seed, with detections placed at each driver's own planted
targets: the same samples, projections equal exactly (the drivers' cubes
are the same float32 values), labels equal, distances within 1e-9. The
port's client and fake server speak the JAX package's wire: each talks
to the other's.
"""

import numpy as np
import pytest

from radarml_tpu.drivers import RadarSession as JRadarSession
from radarml_tpu.drivers import RadarTarget as JRadarTarget
from radarml_tpu.drivers import SyntheticRadar as JSyntheticRadar
from radarml_tpu.fusion import CaptureConfig as JCaptureConfig
from radarml_tpu.fusion import associate as jassociate
from radarml_tpu.fusion import capture_samples as jcapture_samples
from radarml_tpu.fusion import convert_coordinates as jconvert
from radarml_tpu.rpc import Detection as JDetection
from radarml_tpu.rpc import DetectionClient as JDetectionClient
from radarml_tpu.rpc import FakeDetectionServer as JFakeDetectionServer
from radarml_tpu_torch.core.arena import Arena
from radarml_tpu_torch.drivers import RadarSession, RadarTarget, SyntheticRadar
from radarml_tpu_torch.fusion import (
    CaptureConfig,
    MountConfig,
    associate,
    capture_samples,
    convert_coordinates,
    pair_distances,
)
from radarml_tpu_torch.rpc import (
    DEFAULT_CAMERA,
    CameraInfo,
    Centroid,
    Detection,
    DetectionClient,
    FakeDetectionServer,
)
from radarml_tpu_torch.rpc import detection_server_pb2 as pb


# --------------------------------------------------------------------------
# Wire contract
# --------------------------------------------------------------------------

def test_detected_object_wire_bytes():
    """Field numbers/types must match the reference descriptor exactly:
    label=1 (string), score=2 (float), centroid=4 {x=1,y=2}."""
    obj = pb.DetectedObject(label="person", score=0.9)
    obj.centroid.x = 3.0
    want = b'\n\x06person\x15fff?"\x05\r\x00\x00@@'
    assert obj.SerializeToString() == want


def test_desired_labels_and_resolution_wire():
    assert pb.DesiredLabels(labels=["dog"]).SerializeToString() == b"\n\x03dog"
    r = pb.CameraResolution(width=640, height=480)
    assert r.SerializeToString() == b"\x08\x80\x05\x10\xe0\x03"


# --------------------------------------------------------------------------
# Coordinate fusion
# --------------------------------------------------------------------------

def _reference_convert(camera_point, target_z, fx, fy, cx, cy, mount):
    """Straight transcription of the documented reference math
    (ground_truth_samples.py:66-109) for parity checking."""
    cam_x, cam_y = camera_point
    world_x = (cam_x - cx) * (target_z - mount.z_offset_cm) / fx
    world_y = (cam_y - cy) * (target_z - mount.z_offset_cm) / fy
    if mount.horizontal:
        return (world_y - mount.y_offset_cm, world_x - mount.x_offset_cm)
    return (world_x - mount.x_offset_cm, -world_y - mount.y_offset_cm)


@pytest.mark.parametrize("horizontal", [True, False])
def test_convert_coordinates_parity(rng, horizontal):
    from radarml_tpu.fusion import MountConfig as JMountConfig

    mount = MountConfig(horizontal=horizontal)
    cam = DEFAULT_CAMERA
    pixels = rng.uniform(0, 640, size=(5, 2))
    zs = rng.uniform(50, 300, size=5)
    got = convert_coordinates(pixels, zs, cam.fx, cam.fy, cam.cx, cam.cy, mount)
    for p, z, g in zip(pixels, zs, got):
        want = _reference_convert(tuple(p), z, cam.fx, cam.fy, cam.cx, cam.cy, mount)
        np.testing.assert_allclose(g, want, atol=1e-9)
    jgot = jconvert(pixels, zs, cam.fx, cam.fy, cam.cx, cam.cy,
                    JMountConfig(horizontal=horizontal))
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pair_distances(got, got[::-1]),
                               np.linalg.norm(got[:, None] - got[None, ::-1], axis=-1),
                               rtol=0, atol=1e-12)


def _pixel_for(x, y, z, cam: CameraInfo, mount: MountConfig):
    """Inverse of convert_coordinates: normalized centroid that maps a
    detection onto radar position (x, y) at depth z."""
    if mount.horizontal:
        world_y = x + mount.y_offset_cm
        world_x = y + mount.x_offset_cm
    else:
        world_x = x + mount.x_offset_cm
        world_y = -(y + mount.y_offset_cm)
    depth = z - mount.z_offset_cm
    px = world_x * cam.fx / depth + cam.cx
    py = world_y * cam.fy / depth + cam.cy
    return Centroid(px / cam.width, py / cam.height)


def test_associate_picks_closest_and_gates():
    cam = DEFAULT_CAMERA
    cfg = CaptureConfig()
    target = RadarTarget(10.0, -5.0, 150.0, 100.0)
    exact = Detection("person", 0.9, 0.1, _pixel_for(10.0, -5.0, 150.0, cam, cfg.mount))
    near = Detection("dog", 0.9, 0.1, _pixel_for(14.0, -5.0, 150.0, cam, cfg.mount))
    low_score = Detection("cat", 0.3, 0.1, exact.centroid)
    far = Detection("cat", 0.9, 0.1, _pixel_for(100.0, 80.0, 150.0, cam, cfg.mount))

    m = associate([target], [far, near, exact, low_score], cam, cfg)
    assert m[0] is not None
    d_i, dist, _ = m[0]
    assert d_i == 2 and dist < 1e-6  # the exact match wins

    # only the far + low-score ones → no match
    m2 = associate([target], [far, low_score], cam, cfg)
    assert m2[0] is None

    # gate scales with depth: 4 cm off is within 25% of z=150 (37.5)
    m3 = associate([target], [near], cam, cfg)
    assert m3[0] is not None and abs(m3[0][1] - 4.0) < 1e-6

    # the JAX package's association of the same pairs
    jt = JRadarTarget(*target)
    dets = [far, near, exact, low_score]
    jm = jassociate([jt], [JDetection(*d) for d in dets], cam, JCaptureConfig())
    assert jm[0][0] == m[0][0]
    np.testing.assert_allclose(jm[0][1], m[0][1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(jm[0][2], m[0][2], rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# gRPC client/server round trip
# --------------------------------------------------------------------------

SCRIPT = [
    [Detection("person", 0.9, 0.2, Centroid(0.5, 0.5))],
    [],  # server had nothing this frame
    [Detection("", 0.0, 0.0, Centroid(0.0, 0.0))],  # sentinel frame
    [
        Detection("dog", 0.8, 0.1, Centroid(0.3, 0.3)),
        Detection("bird", 0.9, 0.1, Centroid(0.6, 0.6)),
    ],
]


def _round_trip(server, client_cls):
    with server as addr:
        with client_cls(addr) as client:
            info = client.get_camera_info()
            assert info.width == 640 and info.fx == pytest.approx(580.0)
            d1 = client.get_detected_objects(["person", "dog"])
            assert [d.label for d in d1] == ["person"]
            assert d1[0].score == pytest.approx(0.9)
            assert client.get_detected_objects(["person"]) == []
            # sentinel dropped by the client
            assert client.get_detected_objects(["person"]) == []
            # desired-labels filter applied server-side
            d4 = client.get_detected_objects(["dog"])
            assert [d.label for d in d4] == ["dog"]
            # drained → sentinel → empty at the client
            assert client.get_detected_objects(["dog"]) == []


@pytest.mark.parametrize("pair", ["port", "port_client_jax_server", "jax_client_port_server"])
def test_fake_server_round_trip(pair):
    """The port's client and fake server, and each against the JAX
    package's twin over the same wire."""
    if pair == "port":
        _round_trip(FakeDetectionServer(script=SCRIPT), DetectionClient)
    elif pair == "port_client_jax_server":
        _round_trip(JFakeDetectionServer(script=[[JDetection(*d) for d in f] for f in SCRIPT]),
                    DetectionClient)
    else:
        _round_trip(FakeDetectionServer(script=SCRIPT), JDetectionClient)


def test_client_error_raises_not_exits():
    from radarml_tpu_torch.rpc import DetectionServerError

    client = DetectionClient("127.0.0.1:1")  # nothing listening
    with pytest.raises(DetectionServerError):
        client.get_camera_info()
    client.close()


# --------------------------------------------------------------------------
# End-to-end hardware-free capture
# --------------------------------------------------------------------------

def _capture(driver_cls, session_cls, capture, detection_cls, cfg, seed=9):
    """Capture with a camera that "sees" exactly what the radar sees:
    detections placed at the synthetic targets' true positions."""
    arena_cls = Arena if driver_cls is SyntheticRadar else None
    if arena_cls is None:
        from radarml_tpu.core.arena import Arena as arena_cls
    driver = driver_cls(arena=arena_cls(), seed=seed, max_targets=1)
    cam = DEFAULT_CAMERA

    def detections_for_current_scan(desired):
        out = [detection_cls(label, 0.9, 0.1, _pixel_for(t.x, t.y, t.z, cam, cfg.mount))
               for t, label in zip(driver._targets, driver.truth_labels)]
        return [d for d in out if d.label in desired]

    with session_cls(driver) as d:
        return list(capture(d, detections_for_current_scan, cam, cfg))


def test_capture_samples_end_to_end():
    arena = Arena()
    cfg = CaptureConfig(num_samples=5, max_scans=50)
    samples = _capture(SyntheticRadar, RadarSession, capture_samples, Detection, cfg)
    assert len(samples) == 5
    for s in samples:
        xz, yz, xy = s.projections
        assert xz.shape == arena.xz_shape
        assert yz.shape == arena.yz_shape
        assert xy.shape == arena.xy_shape
        assert s.label in cfg.desired_labels
        assert s.distance_cm < 0.25 * s.target_position[2]
    # captured labels match planted ground truth distributions loosely
    assert len({s.label for s in samples}) >= 1


def test_capture_samples_equal_the_jax_capture():
    """The same driver seed and detections through both packages'
    capture loops: the same samples."""
    got = _capture(SyntheticRadar, RadarSession, capture_samples, Detection,
                   CaptureConfig(num_samples=12, max_scans=200))
    want = _capture(JSyntheticRadar, JRadarSession, jcapture_samples, JDetection,
                    JCaptureConfig(num_samples=12, max_scans=200))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.label == w.label
        assert g.target_position == w.target_position
        for gp, wp in zip(g.projections, w.projections):
            np.testing.assert_array_equal(gp, np.asarray(wp))
        np.testing.assert_allclose(g.centroid_position, w.centroid_position, rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(g.distance_cm, w.distance_cm, rtol=0, atol=1e-9)
        assert g.score == w.score


def test_capture_retries_transient_rpc_failures():
    from radarml_tpu_torch.fusion.capture import _detections_with_retry
    from radarml_tpu_torch.rpc.client import DetectionServerError

    class FakeErr(DetectionServerError):
        def __init__(self):
            RuntimeError.__init__(self, "UNAVAILABLE: gone")

    calls = []

    def flaky(desired):
        calls.append(1)
        if len(calls) < 3:
            raise FakeErr()
        return ["ok"]

    cfg = CaptureConfig(rpc_retries=3, rpc_backoff_s=0.0)
    assert _detections_with_retry(flaky, cfg) == ["ok"]
    assert len(calls) == 3

    def always(desired):
        raise FakeErr()

    with pytest.raises(DetectionServerError):
        _detections_with_retry(always, CaptureConfig(rpc_retries=1, rpc_backoff_s=0.0))


def test_walabot_gated_absent():
    from radarml_tpu_torch.drivers import walabot_available

    assert walabot_available() is False  # no vendor SDK in this image
