"""The port's StreamingClassifier on the CPU: every scan of a finite
source is answered, with the detections of a direct predictor call on
the same scans (exact equality: the same batch through the same path),
and no predict error; and the cases of the JAX package's
tests/test_serving.py on the port: drops under a stalled consumer,
ingest and predict loops that survive errors, several sensors on one
batcher, bounded stats, an 8-bit stream equal to a float32 one.

No case waits on the wall clock to decide: a source or a detection
callback sets an event when what the case needs has happened, and the
timeouts on those events only bound a hung run.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from radarml_tpu_torch.core.arena import DEFAULT_ARENA, Arena
from radarml_tpu_torch.models.linear import from_numpy
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets
from radarml_tpu_torch.serving.stream import Scan, StreamConfig, StreamingClassifier

torch.set_num_threads(1)

ARENA = Arena(r_min=10.0, r_max=60.0, r_res=2.0, theta_min=-12.0,
              theta_max=12.0, theta_res=4.0, phi_min=-6.0, phi_max=6.0,
              phi_res=2.0)


def test_stream_answers_every_scan_like_a_direct_call(rng):
    N, max_batch = 37, 8
    coef = (rng.normal(size=(3, ARENA.feature_length)) * 0.05).astype(np.float32)
    model, calib = from_numpy(
        coef, rng.normal(size=3), -np.ones(3), np.zeros(3), device="cpu"
    )
    pred = RadarPredictor(ARENA, ARENA, model, calib, mode="fused",
                          min_proba=0.4)
    cubes = rng.integers(0, 256, (N,) + ARENA.grid_shape).astype(np.float32)
    targets = [
        [tuple(rng.uniform([-5, -5, 15], [5, 5, 55]))
         for _ in range(1 + s % 3)]
        for s in range(N)
    ]
    lock = threading.Lock()
    sent = []

    def source():
        with lock:
            n = len(sent)
            if n < N:
                sent.append(n)
        if n >= N:
            time.sleep(0.001)  # wait like a sensor between frames
            return None
        return cubes[n], targets[n]

    got = []
    svc = StreamingClassifier(
        pred, StreamConfig(max_batch=max_batch, max_wait_s=0.005,
                           queue_depth=N + 1, max_targets=4),
        on_detection=got.append,
    )
    svc.start(source)
    # Generous waits: the assertions below, not these limits, decide the
    # test; a host loaded by parallel test workers may starve a thread
    # for seconds, which the default 5 s join in stop() did not allow for.
    deadline = time.monotonic() + 300.0
    n_targets = sum(len(t) for t in targets)
    while len(got) < n_targets and time.monotonic() < deadline:
        time.sleep(0.01)
    svc.stop(timeout=60.0)
    stats = svc.stats()
    assert stats["predict_errors"] == 0 and stats["dropped"] == 0
    assert stats["processed"] == N and len(got) == n_targets
    assert not any(t.is_alive() for t in svc._ingest_threads)
    assert not svc._predict_thread.is_alive()

    xyz, valid = pad_targets(targets, 4)
    p, best, _ = pred(cubes.astype(np.uint8), xyz, valid)
    want = {
        (s, t): (int(p[s, t]), float(best[s, t]))
        for s in range(N) for t in range(len(targets[s]))
    }
    # a scan's seq is its ingest order, which the single source fixes
    assert {(d.seq, d.target_index): (d.label_index, d.proba) for d in got} == want


WAIT_S = 120.0  # bounds a hung run only; the events decide


def _linear(arena, seed, mode="fast", **kw):
    rng = np.random.default_rng(seed)
    coef = (rng.normal(size=(3, arena.feature_length)) * 0.01).astype(np.float32)
    model, calib = from_numpy(coef, np.zeros(3), -np.ones(3), np.zeros(3), device="cpu")
    return RadarPredictor(arena, arena, model, calib, mode=mode, min_proba=0.0, **kw)


@pytest.fixture(scope="module")
def predictor():
    return _linear(ARENA, 1234)


class _Count:
    """A detection callback that sets `done` once `n` detections are in."""

    def __init__(self, n):
        self.n, self.got, self.done = n, [], threading.Event()
        self._lock = threading.Lock()

    def __call__(self, d):
        with self._lock:
            self.got.append(d)
            if len(self.got) >= self.n:
                self.done.set()


def test_queue_drops_when_consumer_stalls(predictor):
    """A firehose source against a tiny queue with no consumer must drop
    the oldest scans, not block: 20 scans into a queue of 4 drop 16."""
    cube = np.zeros(ARENA.grid_shape, np.float32)
    svc = StreamingClassifier(
        predictor, StreamConfig(max_batch=4, max_wait_s=0.001, queue_depth=4))
    sent = []

    def firehose():
        sent.append(1)
        if len(sent) == 20:
            svc._stop.set()  # the 20th scan is the last the loop takes
        return cube, [(0.0, 0.0, 20.0)]

    svc._stop.clear()
    t = threading.Thread(target=svc._ingest_loop, args=(firehose,), daemon=True)
    t.start()  # the predict thread never starts: the consumer is stalled
    t.join(WAIT_S)
    assert not t.is_alive()
    assert len(sent) == 20 and svc.dropped == 16 and svc._q.qsize() == 4
    assert [svc._q.get_nowait().seq for _ in range(4)] == [16, 17, 18, 19]  # newest win


def test_ingest_survives_source_errors(predictor):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("sensor hiccup")
        return np.zeros(ARENA.grid_shape, np.float32), [(0.0, 0.0, 20.0)]

    seen = _Count(2)
    svc = StreamingClassifier(predictor, StreamConfig(max_batch=2, max_wait_s=0.01),
                              on_detection=seen)
    svc.start(flaky)
    recovered = seen.done.wait(WAIT_S)
    svc.stop(timeout=60.0)
    assert recovered and svc.processed >= 2  # recovered after two errors
    assert len(calls) >= 3 and svc.predict_errors == 0


def test_multi_sensor_ingest(predictor):
    """A fleet of sources multiplexes onto one shared batcher: every scan
    of each of 3 sensors is answered once, under its own sequence number."""
    cube = np.zeros(ARENA.grid_shape, np.float32)
    per_sensor = 6
    finished = threading.Event()

    def make_source(sensor_id):
        left = [per_sensor]

        def src():
            if left[0] == 0:
                finished.wait()  # an idle sensor, until the case ends
                return None
            left[0] -= 1
            return cube, [(float(sensor_id), 0.0, 20.0)]
        return src

    seen = _Count(3 * per_sensor)
    svc = StreamingClassifier(predictor, StreamConfig(max_batch=8, max_wait_s=0.02),
                              on_detection=seen)
    svc.start([make_source(i) for i in range(3)])
    done = seen.done.wait(WAIT_S)
    finished.set()
    svc.stop(timeout=60.0)
    assert done and svc.processed == 3 * per_sensor and svc.dropped == 0
    seqs = sorted(d.seq for d in seen.got)
    assert seqs == list(range(3 * per_sensor))  # unique across sensors
    assert svc._seq == svc.processed


def test_predict_loop_survives_predictor_exceptions():
    """A raising predictor (or callback) is counted and retried instead of
    silently killing the predict thread."""
    calls = {"n": 0}

    def flaky_predictor(cubes, xyz, valid):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("transient device error")
        B, T = valid.shape
        return (torch.zeros((B, T), dtype=torch.int32), torch.ones((B, T)),
                torch.ones((B, T, 3)) / 3)

    seen = _Count(1)
    svc = StreamingClassifier(
        flaky_predictor, StreamConfig(max_batch=2, max_wait_s=0.01, queue_depth=8),
        on_detection=seen)
    stop_source = threading.Event()

    def source():
        if calls["n"] > 2 and seen.done.is_set():
            stop_source.wait()
            return None
        return np.zeros(ARENA.grid_shape, np.float32), [(0.0, 0.0, 20.0)]

    svc.start(source)
    recovered = seen.done.wait(WAIT_S)
    stop_source.set()
    svc.stop(timeout=60.0)
    assert svc.stats()["predict_errors"] >= 2
    assert recovered, "service never recovered after predictor exceptions"


def test_stats_memory_bounded(predictor):
    """Long-running stats stay memory-flat: percentile/batch windows are
    bounded deques; counts and mean_batch remain all-time."""
    svc = StreamingClassifier(
        predictor, StreamConfig(max_batch=2, max_wait_s=0.05, stats_window=16))
    cube = np.zeros(ARENA.grid_shape, np.float32)
    n_batches = 100
    for b in range(n_batches):
        for i in range(2):
            svc._q.put_nowait(Scan(cube, [(0.0, 0.0, 20.0)], time.perf_counter(), 2 * b + i))
        svc._predict_once()
    assert svc.processed == 2 * n_batches
    assert len(svc.latencies_ms) == 16  # bounded, not 200
    assert len(svc.batches) == 16
    stats = svc.stats()
    assert stats["mean_batch"] == 2.0  # all-time mean, not window mean
    assert stats["processed"] == 2 * n_batches
    with pytest.raises(queue.Empty):
        svc._q.get_nowait()


def _stream(p, scans):
    """Serve `scans` through a StreamingClassifier over p; (seq, target)
    -> (label, proba rounded to 5 places) of every detection."""
    it = iter(scans)
    exhausted = threading.Event()

    def source():
        out = next(it, None)
        if out is None:
            exhausted.wait()  # the stream is over; idle until the case ends
        return out

    seen = _Count(len(scans))
    svc = StreamingClassifier(p, StreamConfig(max_batch=4, max_wait_s=0.02),
                              on_detection=seen)
    svc.start(source)
    done = seen.done.wait(WAIT_S)
    exhausted.set()
    svc.stop(timeout=60.0)
    assert done and svc.processed == len(scans) and svc.predict_errors == 0
    return {(e.seq, e.target_index): (e.label_index, round(e.proba, 5)) for e in seen.got}


def test_streaming_narrow_ingest_matches_f32():
    """An 8-bit-stream predictor gets canonical-u8 queued scans (1 B/voxel
    from ingest on) and emits the same detections as the f32 predictor on
    integer-valued cubes; a fused sel3 predictor streams through the same
    loop with the same labels (its probabilities differ only by the
    templates' quantization)."""
    f32 = _linear(DEFAULT_ARENA, 1234)
    u8 = _linear(DEFAULT_ARENA, 1234, cube_dtype="uint8")
    rng = np.random.default_rng(77)
    scans = [(np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(np.float32),
              [(2.0 * i, -1.0, 100.0 + 5 * i)]) for i in range(6)]
    got_u8 = _stream(u8, scans)
    assert got_u8 == _stream(f32, scans) and len(got_u8) == len(scans)
    small = Arena(r_max=60.0, theta_res=14.0, phi_res=10.0)  # 7 x 7 x 26
    small_scans = [(np.rint(rng.random(small.grid_shape) * 255).astype(np.float32),
                    [(2.0 * i, -1.0, 20.0 + 3 * i)]) for i in range(6)]
    got_small = _stream(_linear(small, 4321), small_scans)
    got_fused = _stream(_linear(small, 4321, mode="fused", fused_tail="sel3"), small_scans)
    assert set(got_fused) == set(got_small) and len(got_fused) == len(small_scans)
    assert all(got_fused[k][0] == got_small[k][0] for k in got_small)
