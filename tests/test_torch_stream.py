"""The port's StreamingClassifier on the CPU: every scan of a finite
source is answered, with the detections of a direct predictor call on
the same scans (exact equality: the same batch through the same path),
and no predict error."""

import threading
import time

import numpy as np
import torch

from radarml_tpu_torch.core.arena import Arena
from radarml_tpu_torch.models.linear import from_numpy
from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets
from radarml_tpu_torch.serving.stream import StreamConfig, StreamingClassifier

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
