"""Streaming serving runtime: sensor → batcher → GPU → detections.

Port of radarml_tpu/serving/stream.py:

* an **ingest thread** per sensor pulls scans into a bounded queue —
  newest-wins drop policy when the device falls behind, like the sensor
  itself;
* a **batch assembler** forms device batches by max-size-or-max-wait;
* the **predict loop** runs the RadarPredictor (any mode) and hands
  detection events to a callback;
* per-stage stats: EMA scans/s, dropped scans, batch-size histogram,
  end-to-end latency percentiles, predict errors.

Everything is plain threads + queues on the host. Results come back to
the host with `.cpu().numpy()` (np.asarray on a CUDA tensor raises).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Deque, List, NamedTuple, Optional, Sequence

import numpy as np

from radarml_tpu_torch.models.pipeline import RadarPredictor, pad_targets
from radarml_tpu_torch.utils.profiling import RateMeter

logger = logging.getLogger(__name__)

__all__ = ["Scan", "Detection", "StreamConfig", "StreamingClassifier"]


class Scan(NamedTuple):
    cube: np.ndarray
    targets: Sequence  # [(x, y, z), ...] or RadarTarget list
    t_ingest: float
    seq: int


class Detection(NamedTuple):
    seq: int
    target_index: int
    label_index: int  # UNKNOWN (-1) below threshold
    proba: float
    latency_ms: float


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    max_batch: int = 64
    max_wait_s: float = 0.01
    queue_depth: int = 256
    max_targets: int = 4
    # Sliding window for latency percentiles / batch-size stats. The
    # service is a long-running loop: unbounded per-scan lists would
    # grow by ~tens of millions of floats per day at 1k scans/s, so
    # stats keep a bounded recent window plus running totals.
    stats_window: int = 4096


class StreamingClassifier:
    """Continuous scan classification service.

    Usage:
        svc = StreamingClassifier(predictor, on_detection=print)
        svc.start(scan_source)   # callable () -> Optional[(cube, targets)]
        ...
        svc.stop()
    """

    def __init__(
        self,
        predictor: RadarPredictor,
        cfg: StreamConfig = StreamConfig(),
        on_detection: Optional[Callable[[Detection], None]] = None,
    ):
        self.predictor = predictor
        self.cfg = cfg
        self.on_detection = on_detection
        self._q: "queue.Queue[Scan]" = queue.Queue(cfg.queue_depth)
        self._stop = threading.Event()
        self._ingest_threads: List[threading.Thread] = []
        self._predict_thread: Optional[threading.Thread] = None
        self._seq_lock = threading.Lock()
        # stats
        self.ingest_rate = RateMeter()
        self.classify_rate = RateMeter()
        self.dropped = 0
        self.processed = 0
        self.predict_errors = 0
        # Bounded recent windows (memory-flat over day-long runs) plus
        # running totals for all-time aggregates.
        self.batches: Deque[int] = collections.deque(maxlen=cfg.stats_window)
        self.latencies_ms: Deque[float] = collections.deque(
            maxlen=cfg.stats_window
        )
        self._batch_count = 0
        self._batch_sum = 0
        self._seq = 0

    # -- ingest ------------------------------------------------------------
    def _ingest_loop(self, scan_source: Callable):
        consecutive_errors = 0
        while not self._stop.is_set():
            try:
                out = scan_source()
            except Exception:
                # A failing sensor must not silently kill the service;
                # log, back off, keep trying (bounded exponential).
                consecutive_errors += 1
                logger.exception(
                    "scan source error (%d consecutive)", consecutive_errors
                )
                self._stop.wait(min(0.1 * 2**consecutive_errors, 5.0))
                continue
            consecutive_errors = 0
            if out is None:
                continue
            cube, targets = out
            if getattr(self.predictor, "cube_dtype", "float32") in (
                "uint8", "int8",
            ):
                # Narrow to canonical uint8 at ingest: every downstream
                # copy (queue, stack, pad) then moves 1 B/voxel instead
                # of 4. Only for the 8-bit stream dtypes whose device
                # cast already truncates;
                # bf16/f32 streams keep non-integer cubes intact.
                # Canonical u8 (not the predictor's wire encoding) so a
                # model hot-swap mid-queue can't misread queued scans;
                # the predictor encodes per batch at __call__ time.
                cube = np.asarray(cube)
                if cube.dtype != np.uint8:
                    cube = cube.astype(np.uint8)
            with self._seq_lock:
                seq = self._seq
                self._seq += 1
            scan = Scan(cube, targets, time.perf_counter(), seq)
            self.ingest_rate.tick()
            try:
                self._q.put_nowait(scan)
            except queue.Full:
                # Newest-wins: evict the oldest queued scan.
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass
                try:
                    self._q.put_nowait(scan)
                except queue.Full:
                    self.dropped += 1

    # -- batching + predict ------------------------------------------------
    def _collect_batch(self) -> List[Scan]:
        batch: List[Scan] = []
        deadline = None
        while len(batch) < self.cfg.max_batch and not self._stop.is_set():
            timeout = 0.05
            if deadline is not None:
                timeout = max(deadline - time.perf_counter(), 0.0)
                if timeout == 0.0:
                    break
            try:
                scan = self._q.get(timeout=timeout)
            except queue.Empty:
                if batch:
                    break
                continue
            batch.append(scan)
            if deadline is None:
                deadline = time.perf_counter() + self.cfg.max_wait_s
        return batch

    def _predict_loop(self):
        # Same survival policy as the ingest loop: any exception —
        # a hot-swapped predictor edge case, a transient device error,
        # a raising on_detection callback — is counted and logged with
        # bounded backoff instead of silently killing the service
        # while ingest keeps running.
        backoff = 0.05
        while not self._stop.is_set():
            try:
                self._predict_once()
                backoff = 0.05
            except Exception:
                self.predict_errors += 1
                logger.exception(
                    "predict loop error (#%d); retrying in %.2fs",
                    self.predict_errors, backoff,
                )
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 2.0)

    def _predict_once(self):
        batch = self._collect_batch()
        if not batch:
            return
        cubes = np.stack([s.cube for s in batch])
        target_lists = [
            [(t[0], t[1], t[2]) for t in s.targets] for s in batch
        ]
        xyz, valid = pad_targets(target_lists, self.cfg.max_targets)
        # Eager PyTorch needs no fixed batch shape, so unlike the JAX
        # package's compiled program the batch is not padded to max_batch.
        pred, proba, _ = self.predictor(cubes, xyz, valid)
        pred = pred.cpu().numpy()
        proba = proba.cpu().numpy()
        now = time.perf_counter()
        self.processed += len(batch)
        self.batches.append(len(batch))
        self._batch_count += 1
        self._batch_sum += len(batch)
        self.classify_rate.tick(len(batch))
        for b, scan in enumerate(batch):
            lat_ms = (now - scan.t_ingest) * 1e3
            self.latencies_ms.append(lat_ms)
            for t in range(valid.shape[1]):
                if not valid[b, t]:
                    continue
                d = Detection(
                    seq=scan.seq,
                    target_index=t,
                    label_index=int(pred[b, t]),
                    proba=float(proba[b, t]),
                    latency_ms=lat_ms,
                )
                if self.on_detection is not None:
                    self.on_detection(d)

    # -- lifecycle ---------------------------------------------------------
    def start(self, scan_source):
        """Start serving. `scan_source` is one callable or a list of
        them — one ingest thread per sensor, all feeding the shared
        batcher (a fleet of radars multiplexed onto one chip)."""
        sources = (
            list(scan_source) if isinstance(scan_source, (list, tuple))
            else [scan_source]
        )
        self._stop.clear()
        self._predict_thread = threading.Thread(
            target=self._predict_loop, name="predict", daemon=True
        )
        self._ingest_threads = [
            threading.Thread(
                target=self._ingest_loop, args=(src,),
                name=f"ingest-{n}", daemon=True,
            )
            for n, src in enumerate(sources)
        ]
        self._predict_thread.start()
        for t in self._ingest_threads:
            t.start()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        for t in [*self._ingest_threads, self._predict_thread]:
            if t is not None:
                t.join(timeout)

    def stats(self) -> dict:
        """Percentiles cover the recent `stats_window` scans; counts
        and mean batch size are all-time."""
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else np.zeros(1)
        mean_batch = (
            self._batch_sum / self._batch_count if self._batch_count else 0.0
        )
        return {
            "processed": self.processed,
            "dropped": self.dropped,
            "ingest_rate": self.ingest_rate.rate,
            "classify_rate": self.classify_rate.rate,
            "mean_batch": float(mean_batch),
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "predict_errors": self.predict_errors,
        }

