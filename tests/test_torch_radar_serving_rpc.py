"""The port's gRPC radar endpoint on the CPU: the cases of
tests/test_radar_serving_rpc.py re-run against radarml_tpu_torch.rpc,
and the two servers held together.

Parity: the port's server and the JAX package's, over the same linear
model, answer the same requests on the same wire with the same labels
and class probabilities within 1e-5 (fast mode, float32 in two
libraries). Answers of one server are compared with a direct call of
its predictor within 1e-6 (the same float32 math, batched differently).

The port's twin of test_dynamic_batching_coalesces_and_matches does not
depend on how fast the host coalesces: its predictor holds the first
batch until every other request is queued, so the rest must ride one
more batch.
"""

import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import DEFAULT_ARENA as JDEFAULT_ARENA
from radarml_tpu.models.linear import LinearModel as JLinearModel
from radarml_tpu.models.linear import SigmoidCalibration as JSigmoidCalibration
from radarml_tpu.models.pipeline import RadarPredictor as JRadarPredictor
from radarml_tpu.rpc import RadarServingServer as JRadarServingServer
from radarml_tpu_torch.apps import serve as serve_app
from radarml_tpu_torch.apps.common_cli import save_label_encoder, save_model
from radarml_tpu_torch.core.arena import DEFAULT_ARENA
from radarml_tpu_torch.data.labels import LabelEncoder
from radarml_tpu_torch.models.linear import from_numpy
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets
from radarml_tpu_torch.rpc import (
    RadarServingClient,
    RadarServingError,
    RadarServingServer,
)
from radarml_tpu_torch.rpc import radar_serving_pb2 as pb

torch.set_num_threads(1)

CLASSES = ["cat", "dog", "person"]
GRID = DEFAULT_ARENA.grid_shape


def _weights(seed):
    rng = np.random.default_rng(seed)
    C, F = 3, DEFAULT_ARENA.feature_length
    return ((rng.normal(size=(C, F)) * 0.01).astype(np.float32),
            np.zeros((C,), np.float32), -np.ones((C,), np.float32),
            np.zeros((C,), np.float32))


def _predictor(seed=0, **kw):
    model, calib = from_numpy(*_weights(seed), device="cpu")
    kw = {"mode": "fast", "min_proba": 0.0, **kw}
    return RadarPredictor(DEFAULT_ARENA, DEFAULT_ARENA, model, calib, **kw)


def _cube(rng):
    return np.rint(rng.random(GRID) * 255).astype(np.float32)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _probas(dets):
    return np.asarray([d.class_probas for d in dets])


@pytest.fixture(scope="module")
def served():
    predictor = _predictor()
    server = RadarServingServer(predictor, classes=CLASSES, grid_shape=GRID).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}")
    yield predictor, server, client
    client.close()
    server.stop()


def test_classify_round_trip_matches_local(served):
    predictor, server, client = served
    cube = _cube(np.random.default_rng(1))
    targets = [(5.0, 5.0, 100.0), (-10.0, 3.0, 150.0)]

    dets = client.classify(cube, targets, dtype="uint8")
    assert len(dets) == 2

    xyz, valid = pad_targets([targets], max_targets=4)
    proba = predictor(cube[None], xyz, valid)[2].numpy()[0]
    for t, det in enumerate(dets):
        assert det.target_index == t
        np.testing.assert_allclose(np.asarray(det.class_probas), proba[t], atol=1e-6)
        assert det.label in ("cat", "dog", "person", "")


def test_responses_equal_the_jax_server(served):
    """The same requests to the JAX package's server over the same
    weights: the same labels, probabilities within 1e-5."""
    _, _, client = served
    coef, intercept, a, b = _weights(0)
    jpred = JRadarPredictor(
        train_arena=JDEFAULT_ARENA, scan_arena=JDEFAULT_ARENA,
        model=JLinearModel(coef=jnp.asarray(coef), intercept=jnp.asarray(intercept)),
        calibration=JSigmoidCalibration(a=jnp.asarray(a), b=jnp.asarray(b)),
        mode="fast", min_proba=0.0,
    )
    jserver = JRadarServingServer(jpred, classes=CLASSES, grid_shape=GRID).start()
    jclient = RadarServingClient(f"127.0.0.1:{jserver.port}")
    try:
        rng = np.random.default_rng(17)
        for wire in ("uint8", "int8", "float32"):
            cube = _cube(rng)
            targets = [(3.0, -2.0, 95.0), (-8.0, 4.0, 160.0), (0.0, 0.0, 300.0)]
            got = client.classify(cube, targets, dtype=wire)
            want = jclient.classify(cube, targets, dtype=wire)
            assert [d.label for d in got] == [d.label for d in want]
            assert [d.target_index for d in got] == [d.target_index for d in want]
            np.testing.assert_allclose(_probas(got), _probas(want), atol=1e-5)
        assert list(client.get_config().classes) == list(jclient.get_config().classes)
    finally:
        jclient.close()
        jserver.stop()


def test_float32_transport_and_config(served):
    _, _, client = served
    cube = np.random.default_rng(2).random(GRID).astype(np.float32) * 255
    assert len(client.classify(cube, [(0.0, 0.0, 90.0)], dtype="float32")) == 1
    cfg = client.get_config()
    assert tuple(cfg.grid_shape) == GRID
    assert list(cfg.classes) == CLASSES
    assert cfg.mode == "fast"


def test_bad_request_raises(served):
    _, _, client = served
    with pytest.raises(Exception):
        bad = pb.ScanRequest(cube=b"123", dtype="uint8", shape=[2, 2, 2, 7])
        client._classify(bad, timeout=5)


def _write_artifacts(tmp_path):
    model_path = str(tmp_path / "svm.pickle")
    coef, intercept, a, b = _weights(3)
    save_model(model_path, "linear", coef=coef, intercept=intercept, calib_a=a,
               calib_b=b, classes=CLASSES)
    le_path = str(tmp_path / "le.pickle")
    save_label_encoder(le_path, LabelEncoder(classes_=tuple(CLASSES)))
    return ["--svm_model", model_path, "--label_encoder", le_path,
            "--platform", "cpu", "--min_proba", "0.0"]


def test_serve_cli_grpc_mode(tmp_path):
    """serve --grpc_port serves the endpoint for --duration and exits."""
    out = {}
    argv = _write_artifacts(tmp_path) + ["--grpc_port", "0", "--duration", "2"]
    th = threading.Thread(target=lambda: out.update(res=serve_app.main(argv)))
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert out["res"]["grpc_port"] > 0


def test_grpc_serving_from_aot_artifact(tmp_path, served):
    """AOT artifact + gRPC endpoint compose: same wire answers (the
    artifact's program equals the live predictor: within 1e-6, the JAX
    test's bar)."""
    from radarml_tpu_torch.serving import export_predictor, load_serving_artifact

    predictor, _server, _client = served
    path = str(tmp_path / "serving.rmlx")
    export_predictor(predictor, path, max_targets=3)
    art = load_serving_artifact(path, device="cpu")

    server = RadarServingServer(art, classes=CLASSES, grid_shape=art.grid_shape,
                                max_targets=art.max_targets).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}")
    try:
        cube = _cube(np.random.default_rng(7))
        targets = [(2.0, -1.0, 110.0)]
        via_art = client.classify(cube, targets, dtype="uint8")
        via_live = _client.classify(cube, targets, dtype="uint8")
        assert len(via_art) == len(via_live) == 1
        np.testing.assert_allclose(_probas(via_art), _probas(via_live), atol=1e-6)
    finally:
        client.close()
        server.stop()


def test_subscribe_receives_published_detections(served):
    _, server, client = served
    got = []

    def consume():
        for ev in client.subscribe(timeout_s=8):
            got.append((ev.seq, ev.label, round(ev.proba, 3)))
            if len(got) >= 3:
                break

    th = threading.Thread(target=consume)
    th.start()
    time.sleep(0.5)  # let the stream register
    for i in range(3):
        server.publish(i, 0, "dog", 0.9 + 0.01 * i, latency_ms=1.0)
        time.sleep(0.05)
    th.join(timeout=10)
    assert not th.is_alive()
    assert [g[0] for g in got] == [0, 1, 2]
    assert all(g[1] == "dog" for g in got)


def test_serve_cli_grpc_publish_mode(tmp_path):
    """--grpc_port + --grpc_publish runs the sensor loop AND streams its
    detections to a subscriber."""
    port = _free_port()
    out = {}
    argv = _write_artifacts(tmp_path) + [
        "--grpc_port", str(port), "--grpc_publish", "--duration", "5",
        "--scan_period", "0.05", "--max_batch", "4",
    ]
    th = threading.Thread(target=lambda: out.update(res=serve_app.main(argv)))
    th.start()
    events = []

    def consume():
        client = RadarServingClient(f"127.0.0.1:{port}", timeout_s=20)
        deadline = time.time() + 20
        try:
            while time.time() < deadline and not events:
                try:
                    for ev in client.subscribe(timeout_s=4):
                        events.append(ev)
                        if len(events) >= 2:
                            return
                except RadarServingError:  # not up yet
                    time.sleep(0.3)
        finally:
            client.close()

    sub = threading.Thread(target=consume)
    sub.start()
    th.join(timeout=90)
    sub.join(timeout=30)
    assert not th.is_alive()
    assert out["res"]["processed"] > 0
    assert len(events) >= 1  # the local loop's detections reached the wire


def test_get_stats_counts_requests_and_events(served):
    _, server, client = served
    before = client.get_stats()
    client.classify(_cube(np.random.default_rng(8)), [(0.0, 0.0, 100.0)])
    server.publish(99, 0, "cat", 0.8)
    after = client.get_stats()
    assert after.classify_requests == before.classify_requests + 1
    assert after.events_published == before.events_published + 1
    assert after.uptime_s > 0


class _HeldPredictor:
    """Holds its first call until `n` requests are in hand: those of its
    own batch (one target each) plus those queued on the server. Then
    every call runs the wrapped predictor."""

    def __init__(self, predictor, n):
        self._p = predictor
        self._n = n
        self.server = None
        self.first_rows = None
        self.released = threading.Event()

    def __getattr__(self, name):
        return getattr(self._p, name)

    def __call__(self, cubes, xyz, valid):
        if self.first_rows is None:
            self.first_rows = int(np.asarray(valid).any(axis=1).sum())
            deadline = time.monotonic() + 60.0
            while (self.first_rows + len(self.server._bq) < self._n
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            self.released.set()
        return self._p(cubes, xyz, valid)


def test_dynamic_batching_coalesces_and_matches(served):
    """Concurrent Classify calls on a batching server coalesce into fewer
    batches and return the same answers as the unbatched server. One
    leader slot; the first batch is held until the other requests are
    queued, so they ride exactly one more batch, however slow the host."""
    predictor, _server, plain_client = served
    held = _HeldPredictor(predictor, 4)
    batched = RadarServingServer(
        held, classes=CLASSES, grid_shape=GRID,
        batch_window_ms=80.0, batch_size=4, max_concurrent_batches=1,
    )
    held.server = batched
    batched.start()
    client = RadarServingClient(f"127.0.0.1:{batched.port}", timeout_s=60)
    try:
        rng = np.random.default_rng(9)
        cubes = [_cube(rng) for _ in range(4)]
        targets = [(1.0 * i, -1.0 * i, 90.0 + 10 * i) for i in range(4)]
        results = [None] * 4

        def call(i):
            results[i] = client.classify(cubes[i], [targets[i]], dtype="uint8")

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert all(r is not None for r in results)
        assert held.released.is_set()

        for i in range(4):
            want = plain_client.classify(cubes[i], [targets[i]], dtype="uint8")
            np.testing.assert_allclose(_probas(results[i]), _probas(want), atol=1e-6)

        stats = client.get_stats()
        assert stats.classify_requests == 4
        assert stats.classify_batches == (1 if held.first_rows == 4 else 2)
    finally:
        client.close()
        batched.stop()


def test_adaptive_batching_lone_request_skips_window(served):
    """A lone Classify on a batching server with a 5 s window returns in
    well under the window: the window is an on/off switch, never a
    hold."""
    predictor, _server, _plain = served
    batched = RadarServingServer(
        predictor, classes=CLASSES, grid_shape=GRID,
        batch_window_ms=5000.0, batch_size=4,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{batched.port}", timeout_s=30)
    try:
        cube = _cube(np.random.default_rng(11))
        client.classify(cube, [(0.0, 0.0, 90.0)], dtype="uint8")
        t0 = time.perf_counter()
        dets = client.classify(cube, [(1.0, -1.0, 110.0)], dtype="uint8")
        elapsed = time.perf_counter() - t0
        assert len(dets) == 1
        assert elapsed < 2.5, f"lone request took {elapsed:.2f}s"
        assert client.get_stats().classify_batches == 2  # one per lone request
    finally:
        client.close()
        batched.stop()


def test_batch_buckets_bound_program_shapes(served):
    """The batcher pads to power-of-two buckets ≤ batch_size, and a
    partial burst through a bucketed server matches the unbatched
    answers."""
    predictor, _server, plain_client = served
    batched = RadarServingServer(
        predictor, classes=CLASSES, grid_shape=GRID,
        batch_window_ms=50.0, batch_size=16,
    )
    assert batched.batch_buckets == (1, 2, 4, 8, 16)
    assert batched._bucket(1) == 1
    assert batched._bucket(3) == 4
    assert batched._bucket(16) == 16
    odd = RadarServingServer(predictor, classes=["cat"], grid_shape=GRID,
                             batch_window_ms=1.0, batch_size=6)
    assert odd.batch_buckets == (1, 2, 4, 6)
    assert odd._bucket(5) == 6

    batched.start()
    client = RadarServingClient(f"127.0.0.1:{batched.port}", timeout_s=30)
    try:
        rng = np.random.default_rng(13)
        cubes = [_cube(rng) for _ in range(3)]
        results = [None] * 3

        def call(i):
            results[i] = client.classify(cubes[i], [(1.0 * i, 0.0, 100.0)])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(r is not None for r in results)
        for i in range(3):
            want = plain_client.classify(cubes[i], [(1.0 * i, 0.0, 100.0)])
            np.testing.assert_allclose(_probas(results[i]), _probas(want), atol=1e-6)
    finally:
        client.close()
        batched.stop()


def test_client_retries_transient_unavailable(served):
    """The client retries UNAVAILABLE with backoff: a call made while
    the server is briefly down succeeds once it returns."""
    predictor, _server, _client = served
    port = _free_port()
    s1 = RadarServingServer(predictor, classes=CLASSES, grid_shape=GRID,
                            port=port).start()
    client = RadarServingClient(f"127.0.0.1:{port}", timeout_s=10, retries=7,
                                backoff_s=0.3)
    s2 = []
    try:
        assert list(client.get_config().classes) == CLASSES
        s1.stop(grace=0)

        def bring_back():
            time.sleep(0.5)
            s2.append(RadarServingServer(predictor, classes=CLASSES,
                                         grid_shape=GRID, port=port).start())

        th = threading.Thread(target=bring_back)
        th.start()
        cfg2 = client.get_config()  # retried through the downtime
        th.join()
        assert list(cfg2.classes) == CLASSES
    finally:
        client.close()
        for s in s2:
            s.stop()


def test_stop_drains_inflight_batched_requests():
    """stop() must not leave batched Classify handlers blocked forever:
    in-flight and straggler requests fail fast instead of hanging."""
    server = RadarServingServer(
        _predictor(9), classes=["a", "b", "c"], grid_shape=GRID,
        batch_window_ms=300.0, batch_size=8,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}", timeout_s=15.0, retries=0)
    cube = np.zeros(GRID, np.float32)
    outcomes = []

    def call():
        try:
            outcomes.append(("ok", client.classify(cube, [(0, 0, 100.0)])))
        except Exception as e:
            outcomes.append(("err", e))

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # let requests land in the batcher
    server.stop()
    for t in threads:
        t.join(timeout=20.0)
        assert not t.is_alive(), "Classify handler hung across stop()"
    assert len(outcomes) == 4
    client.close()


def test_drain_never_overwrites_a_delivered_result():
    """The stop path's drain error goes only to rows without a result: a
    leader that answers after the drain deadline keeps its answer (the
    JAX package's stop path overwrote it)."""
    server = RadarServingServer(_predictor(), classes=CLASSES, grid_shape=GRID,
                                batch_window_ms=1.0)
    done = server._Pending(None, None, None)
    done.result = ("pred", "best", "proba", 1.0)
    waiting = server._Pending(None, None, None)
    server._drain_batch([done, waiting], RuntimeError("server stopped"))
    assert done.error is None and done.result == ("pred", "best", "proba", 1.0)
    assert isinstance(waiting.error, RuntimeError) and waiting.result is None
    assert done.done.is_set() and waiting.done.is_set()


def test_int8_wire_transport_matches_uint8(served):
    _, _, client = served
    cube = _cube(np.random.default_rng(4))
    targets = [(2.0, -4.0, 120.0)]
    d_u8 = client.classify(cube, targets, dtype="uint8")
    d_i8 = client.classify(cube, targets, dtype="int8")
    assert len(d_i8) == len(d_u8) == 1
    np.testing.assert_allclose(_probas(d_i8), _probas(d_u8), atol=1e-6)
    assert d_i8[0].label == d_u8[0].label


@pytest.mark.parametrize("stream_dtype", ["uint8", "int8"])
@pytest.mark.parametrize("batched", [False, True])
def test_narrow_stream_predictor_serves_all_wire_dtypes(stream_dtype, batched):
    """A predictor with an 8-bit stream serves u8/i8/f32 wires like the
    local call, on the unbatched and the dynamic-batching path."""
    predictor = _predictor(cube_dtype=stream_dtype)
    server = RadarServingServer(
        predictor, classes=CLASSES, grid_shape=GRID,
        batch_window_ms=20.0 if batched else 0.0, batch_size=4,
    ).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}", timeout_s=30)
    try:
        cube = _cube(np.random.default_rng(6))
        targets = [(3.0, 1.0, 110.0), (-6.0, 2.0, 140.0)]
        xyz, valid = pad_targets([targets], max_targets=4)
        want = predictor(cube[None], xyz, valid)[2].numpy()[0]
        for wire in ("uint8", "int8", "float32"):
            dets = client.classify(cube, targets, dtype=wire)
            assert len(dets) == 2, wire
            np.testing.assert_allclose(_probas(dets), want[:2], atol=1e-6,
                                       err_msg=f"wire={wire}")
    finally:
        client.close()
        server.stop()


def test_fused_predictor_serves_the_stream_and_unary(served):
    """The fused (int8 kernel) predictor behind the server: unary and
    streamed answers equal a direct call on the same batch."""
    predictor = _predictor(mode="fused")
    server = RadarServingServer(predictor, classes=CLASSES, grid_shape=GRID,
                                batch_window_ms=1.0, batch_size=4).start()
    client = RadarServingClient(f"127.0.0.1:{server.port}", timeout_s=30)
    try:
        rng = np.random.default_rng(29)
        scans = [(_cube(rng), [(1.0 * i, -2.0, 90.0 + 7 * i)]) for i in range(6)]
        xyz, valid = pad_targets([t for _, t in scans], 4)
        want = predictor(np.stack([c for c, _ in scans]), xyz, valid)[2].numpy()
        streamed = list(client.classify_stream(iter(scans)))
        for s, (cube, targets) in enumerate(scans):
            np.testing.assert_allclose(_probas(streamed[s]), want[s, :1], atol=1e-6)
            np.testing.assert_allclose(_probas(client.classify(cube, targets)),
                                       want[s, :1], atol=1e-6)
    finally:
        client.close()
        server.stop()


def test_classify_stream_matches_unary_in_order(served):
    _, _, client = served
    rng = np.random.default_rng(11)
    scans = [
        (_cube(rng), [(1.0 * i, -2.0, 90.0 + 6 * i), (0.0, 3.0, 150.0)][: 1 + i % 2])
        for i in range(10)
    ]
    stats0 = client.get_stats()
    streamed = list(client.classify_stream(iter(scans), dtype="uint8"))
    stats1 = client.get_stats()

    assert len(streamed) == len(scans)
    for (cube, targets), dets in zip(scans, streamed):
        want = client.classify(cube, targets, dtype="uint8")
        assert len(dets) == len(want) == len(targets)
        for d, w in zip(dets, want):
            assert d.target_index == w.target_index
            assert d.label == w.label
        np.testing.assert_allclose(_probas(dets), _probas(want), atol=1e-6)

    reqs = stats1.classify_requests - stats0.classify_requests
    batches = stats1.classify_batches - stats0.classify_batches
    assert reqs >= len(scans)
    assert 1 <= batches <= len(scans)


def test_concurrent_classify_streams_do_not_cross(served):
    """Several ClassifyStream calls at once each get their OWN scans'
    detections back, in order."""
    _, server, client = served
    rng = np.random.default_rng(23)
    n_streams, n_scans = 3, 12
    per_stream = [
        [(_cube(rng), [(1.0 * s, -2.0, 90.0 + 5 * i), (0.0, 3.0, 150.0)][: 1 + (s + i) % 2])
         for i in range(n_scans)]
        for s in range(n_streams)
    ]
    results = [None] * n_streams
    errors = []

    def run(s):
        own = RadarServingClient(f"127.0.0.1:{server.port}")
        try:
            results[s] = list(own.classify_stream(iter(per_stream[s]), dtype="uint8"))
        except Exception as e:  # surfaced by the assert below
            errors.append((s, e))
        finally:
            own.close()

    threads = [threading.Thread(target=run, args=(s,)) for s in range(n_streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors

    for s, scans in enumerate(per_stream):
        assert results[s] is not None and len(results[s]) == n_scans
        for (cube, targets), dets in zip(scans, results[s]):
            want = client.classify(cube, targets, dtype="uint8")
            assert [d.label for d in dets] == [w.label for w in want]
            np.testing.assert_allclose(_probas(dets), _probas(want), atol=1e-6)


def test_classify_stream_aborts_on_bad_cube(served):
    _, _, client = served
    good = np.zeros(GRID, np.float32)
    bad = np.zeros((2, 2, 2), np.float32)
    with pytest.raises(RadarServingError):
        list(client.classify_stream(
            iter([(good, [(0.0, 0.0, 100.0)]), (bad, [(0.0, 0.0, 100.0)])]),
            dtype="uint8",
        ))


def test_classify_stream_abort_releases_reader_thread(served):
    """A mid-stream abort must not leak the reader thread."""
    _, _, client = served
    good = np.zeros(GRID, np.float32)
    bad = np.zeros((2, 2, 2), np.float32)
    tgt = [(0.0, 0.0, 100.0)]
    scans = [(bad, tgt)] + [(good, tgt)] * 200
    with pytest.raises(RadarServingError):
        list(client.classify_stream(iter(scans), dtype="uint8"))

    deadline = time.time() + 10.0
    while time.time() < deadline:
        readers = [t for t in threading.enumerate()
                   if t.name == "rpc-stream-reader" and t.is_alive()]
        if not readers:
            break
        time.sleep(0.1)
    assert not readers, "stream reader thread leaked after abort"
    assert len(client.classify(good, tgt, dtype="uint8")) == 1
