"""gRPC serving endpoint for the radar classifier.

Port of radarml_tpu/rpc/radar_server.py with the same wire
(rpc/radar_serving.proto; radar_serving_pb2.py is a copy of the JAX
package's generated module, since grpc_tools is not installed to
regenerate it). An edge client triggers the sensor, ships the raw cube
(uint8 — 1 B/voxel — for a ~120 KB request at the default arena), and
gets calibrated detections back from the predictor on the card.
Stub-free: handlers and client calls are built directly on grpc generic
handlers / `unary_unary`.

The rpc package (this module, the camera client and its fake server) is
the only part of the port that imports grpc and protobuf.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent import futures
from typing import Iterator, List, Optional, Sequence, Tuple

import grpc
import numpy as np

import torch

from radarml_tpu_torch.models.pipeline import UNKNOWN
from radarml_tpu_torch.rpc import radar_serving_pb2 as pb

__all__ = [
    "SERVICE_NAME",
    "RadarServingServer",
    "RadarServingClient",
    "RadarServingError",
]

SERVICE_NAME = "radar_serving.RadarServing"

logger = logging.getLogger(__name__)

_DTYPES = {"uint8": np.uint8, "float32": np.float32, "int8": np.int8}


class RadarServingError(RuntimeError):
    pass


def _host(x) -> np.ndarray:
    """A predictor output as a host numpy array (np.asarray refuses a
    tensor on the card)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class RadarServingServer:
    """Serve a RadarPredictor over gRPC.

    Without batching, each Classify runs the predictor on its own
    (1, max_targets) batch on the handler's thread. With
    `batch_window_ms > 0`, concurrent Classify calls coalesce by
    LEADER-FOLLOWER dynamic batching: a handler enqueues its request,
    then competes for one of `max_concurrent_batches` leader slots. A
    leader claims everything queued (up to `batch_size`), pads to the
    smallest power-of-two bucket ≥ its batch (`batch_buckets`), runs ONE
    predictor call inline on its own handler thread, and wakes the
    followers whose rows it carried.

    Concurrency scales with demand (every handler can run the predictor,
    as on the unbatched path, so a lightly loaded server behaves as if
    batching were off), and coalescing comes from slot contention: when
    more than `max_concurrent_batches` requests are in flight, the
    excess queues and the next free leader carries it in one call. There
    is no hold window, no handoff thread and no idle sleep.

    Leaders call one predictor from several threads. Each call allocates
    its own outputs and launches on the calling thread's current stream
    (the default stream), so the calls do not share buffers.
    """

    def __init__(
        self,
        predictor,
        classes: Sequence[str],
        grid_shape: Tuple[int, int, int],
        max_targets: int = 4,
        port: int = 0,
        max_workers: int = 8,
        loop_stats_fn=None,
        host: str = "127.0.0.1",
        batch_window_ms: float = 0.0,
        batch_size: int = 8,
        max_concurrent_batches: int = 8,
    ):
        """`loop_stats_fn`: optional zero-arg callable returning the
        local sensor loop's stats dict (StreamingClassifier.stats()),
        surfaced through GetStats when serving alongside the loop.
        `host`: bind address — use "0.0.0.0" to accept remote edge
        clients (the offload topology the proto documents)."""
        self._predictor = predictor
        self._classes = list(classes)
        self._grid = tuple(int(g) for g in grid_shape)
        self._max_targets = int(max_targets)
        self._unknown = UNKNOWN
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self._server.add_generic_rpc_handlers((self._handlers(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._subs: set = set()
        self._subs_lock = threading.Lock()
        self._loop_stats_fn = loop_stats_fn
        self._stats_lock = threading.Lock()
        self._classify_count = 0
        self._events_published = 0
        self._batches_run = 0
        self._started_at = time.monotonic()
        self.model_reloads = 0  # maintained via note_model_reload()

        self._batch_window_s = max(float(batch_window_ms), 0.0) / 1e3
        self._batch_size = max(int(batch_size), 1)
        # Power-of-two program shapes up to batch_size: a batch of n
        # requests pads to the smallest bucket ≥ n so transfer bytes
        # and FLOPs track actual load instead of the static maximum.
        self.batch_buckets: Tuple[int, ...] = tuple(
            [
                1 << i
                for i in range(self._batch_size.bit_length())
                if (1 << i) < self._batch_size
            ]
            + [self._batch_size]
        )
        self._batch_enabled = self._batch_window_s > 0
        self._bq: List["RadarServingServer._Pending"] = []
        self._bq_lock = threading.Lock()
        # Leader slots bound concurrent device programs from the
        # batched path; excess demand queues and coalesces.
        self._leaders = threading.Semaphore(max(int(max_concurrent_batches), 1))
        self._stopping = False

    # -- dynamic batching ----------------------------------------------

    class _Pending:
        __slots__ = ("cube", "xyz", "valid", "done", "result", "error")

        def __init__(self, cube, xyz, valid):
            self.cube = cube
            self.xyz = xyz
            self.valid = valid
            self.done = threading.Event()
            self.result = None
            self.error = None

    def _bucket(self, n: int) -> int:
        """Smallest pre-declared program batch shape ≥ n."""
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self._batch_size

    def _run_batch(self, batch):
        """Stack, encode, run and distribute one claimed batch (leader
        body; runs inline on a handler thread)."""
        T = self._max_targets
        try:
            Bp = self._bucket(len(batch))
            # Pending cubes are CANONICAL (u8 for 8-bit wires, f32
            # otherwise) so a predictor hot-swap mid-queue can't
            # mix encodings; stack narrow when the batch is
            # dtype-uniform, then encode once for the (possibly
            # just-reloaded) predictor.
            predictor = self._predictor
            dtypes = {p.cube.dtype for p in batch}
            stack_dt = batch[0].cube.dtype if len(dtypes) == 1 else (
                np.float32
            )
            cubes = np.zeros((Bp,) + self._grid, stack_dt)
            xyz = np.zeros((Bp, T, 3), np.float32)
            valid = np.zeros((Bp, T), bool)
            for i, p in enumerate(batch):
                cubes[i] = p.cube
                xyz[i] = p.xyz
                valid[i] = p.valid
            encode = getattr(predictor, "encode_host", None)
            if encode is not None:
                cubes = encode(cubes)
            elif cubes.dtype != np.float32:
                cubes = cubes.astype(np.float32)
            t0 = time.perf_counter()
            pred, best_p, proba = (_host(r) for r in predictor(cubes, xyz, valid))
            ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                self._batches_run += 1
            for i, p in enumerate(batch):
                p.result = (pred[i], best_p[i], proba[i], ms)
                p.done.set()
        except Exception as e:  # surface to every waiter
            self._drain_batch(batch, e)

    def _classify_batched(self, p: "_Pending"):
        """Leader-follower election: enqueue, then either lead a batch
        (claim the queue, run the device program inline) or ride a
        leader's batch. Never hangs: a request that no leader claims is
        eventually claimed by its own handler here."""
        with self._bq_lock:
            self._bq.append(p)
        while not p.done.is_set():
            if self._stopping:
                # stop() fails everything still queued. A row NOT in
                # the queue was claimed by a leader whose _run_batch
                # always sets done (success or drained error): wait for
                # it, bounded, since a leader killed by a BaseException
                # or wedged in a device call would otherwise hang this
                # handler forever. After the deadline the row drains —
                # unless its result arrived meanwhile (_drain_batch
                # re-checks), so a late leader's answer is never
                # overwritten by the drain error.
                with self._bq_lock:
                    mine = p in self._bq
                    if mine:
                        self._bq.remove(p)
                if mine:
                    self._drain_batch([p], RuntimeError("server stopped"))
                elif not p.done.wait(timeout=60.0):
                    self._drain_batch(
                        [p],
                        RuntimeError(
                            "server stopped; in-flight batch never "
                            "completed"
                        ),
                    )
                return
            if self._leaders.acquire(blocking=False):
                try:
                    while not p.done.is_set():
                        with self._bq_lock:
                            batch = self._bq[: self._batch_size]
                            del self._bq[: len(batch)]
                        if not batch:
                            break
                        self._run_batch(batch)
                finally:
                    self._leaders.release()
                # Queue empty but our row not done: it rides another
                # leader's in-flight batch. Wait on its done-set
                # instead of re-acquiring leadership in a tight loop —
                # that spin lasts a whole device round trip and (on a
                # 1-core host) competes with the very leader serving
                # this request.
                if not p.done.is_set():
                    p.done.wait(timeout=0.02)
            else:
                # All leader slots busy: our row rides someone's
                # batch, or we retry leadership on the next tick.
                p.done.wait(timeout=0.02)

    @staticmethod
    def _drain_batch(batch, error):
        """Fail every row of `batch` that has no result yet."""
        for p in batch:
            if p.result is None:
                p.error = error
            p.done.set()

    # -- RPC implementations ------------------------------------------

    def _decode(self, request: pb.ScanRequest, context):
        """Wire → (canonical cube, xyz, valid, n_targets); aborts the
        RPC on malformed input. Canonical = u8 for the 8-bit wire
        dtypes (bit view + xor for int8's value-128 format, never a
        float32 round trip), f32 otherwise."""
        shape = tuple(request.shape) or self._grid
        dt = _DTYPES.get(request.dtype or "uint8")
        if dt is None:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"unsupported dtype {request.dtype!r}",
            )
        if tuple(int(s) for s in shape) != self._grid:
            # Enforce the server's arena grid: the predictor's
            # features are built for it, and another shape would fail
            # deep inside the pipeline.
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"cube shape {tuple(shape)} does not match the serving "
                f"arena grid {self._grid} (see GetServingConfig)",
            )
        cube = np.frombuffer(request.cube, dtype=dt)
        if cube.size != int(np.prod(shape)):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"cube bytes ({cube.size}) do not match shape {shape}",
            )
        cube = cube.reshape(shape)
        if dt is np.int8:
            cube = cube.view(np.uint8) ^ np.uint8(0x80)

        n = min(len(request.targets), self._max_targets)
        xyz = np.zeros((self._max_targets, 3), np.float32)
        valid = np.zeros((self._max_targets,), bool)
        for t in range(n):
            tgt = request.targets[t]
            xyz[t] = (tgt.x, tgt.y, tgt.z)
            valid[t] = True
        return cube, xyz, valid, n

    def _respond(self, pred, best_p, proba, n, latency_ms):
        resp = pb.ClassifyResponse(model_latency_ms=latency_ms)
        for t in range(n):
            label = (
                "" if pred[t] == self._unknown else self._classes[int(pred[t])]
            )
            resp.detections.append(
                pb.RadarDetection(
                    target_index=t,
                    label=label,
                    proba=float(best_p[t]),
                    class_probas=[float(v) for v in proba[t]],
                )
            )
        return resp

    def _classify(self, request: pb.ScanRequest, context) -> pb.ClassifyResponse:
        cube, xyz, valid, n = self._decode(request, context)
        # Canonical cubes narrow to the predictor's stream dtype here —
        # or at batch-stack time in the batcher — so host-side copies
        # and the host→device transfer never pay the old
        # decode-to-float32 round trip.
        encode = getattr(self._predictor, "encode_host", None)
        if not self._batch_enabled:
            cube = (
                encode(cube) if encode is not None
                else np.ascontiguousarray(cube, np.float32)
            )

        with self._stats_lock:
            self._classify_count += 1
        if self._batch_enabled:
            p = self._Pending(cube, xyz, valid)
            # Leader-follower: runs the device program inline on this
            # thread or rides another handler's batch; always returns
            # with done set (success, device error, or stop()).
            self._classify_batched(p)
            if p.result is None:
                context.abort(grpc.StatusCode.INTERNAL, str(p.error))
            pred, best_p, proba, latency_ms = p.result
        else:
            t0 = time.perf_counter()
            pred, best_p, proba = (
                _host(r)[0]
                for r in self._predictor(cube[None], xyz[None], valid[None])
            )
            latency_ms = (time.perf_counter() - t0) * 1e3

        return self._respond(pred, best_p, proba, n, latency_ms)

    def _classify_stream(self, request_iterator, context):
        """Bulk scoring: coalesce a client's request stream into padded
        device batches; stream responses back in request order.

        Per-RPC overhead (serialize, HTTP/2 frame, handler dispatch,
        one device program per request) bounds the unary Classify path;
        here one call amortizes it across the whole stream: a reader
        thread drains the request iterator into a bounded queue (gRPC
        flow control backpressures the client when it fills) and the
        handler packs whatever has arrived — up to `batch_size`
        requests, padded to the same power-of-two bucket shapes the
        dynamic batcher uses — into one device pass per iteration.
        """
        B = self._batch_size
        done = object()
        q: "queue.Queue" = queue.Queue(maxsize=4 * B)
        # Set when this handler exits for ANY reason (abort on a
        # malformed cube, device error, client cancel): the reader
        # must never block forever on a full queue once nobody drains
        # it — that would leak one thread + 4·B pinned requests per
        # broken stream on a long-lived server.
        closed = threading.Event()

        def reader():
            try:
                for req in request_iterator:
                    while True:
                        if closed.is_set():
                            return
                        try:
                            q.put(req, timeout=0.25)
                            break
                        except queue.Full:
                            continue
            except Exception:
                logger.debug("stream reader ended", exc_info=True)
            finally:
                try:
                    q.put_nowait(done)
                except queue.Full:
                    pass  # handler gone; closed is (being) set

        threading.Thread(
            target=reader, daemon=True, name="rpc-stream-reader"
        ).start()
        context.add_callback(closed.set)

        try:
            yield from self._classify_stream_batches(q, done, B, context)
        finally:
            closed.set()

    def _classify_stream_batches(self, q, done, B, context):
        finished = False
        while not finished:
            first = q.get()
            if first is done:
                return
            batch = [self._decode(first, context)]
            while len(batch) < B:
                try:
                    nxt = q.get(timeout=0.002)
                except queue.Empty:
                    break
                if nxt is done:
                    finished = True
                    break
                batch.append(self._decode(nxt, context))

            n_real = len(batch)
            Bp = self._bucket(n_real)
            predictor = self._predictor
            dtypes = {b[0].dtype for b in batch}
            stack_dt = batch[0][0].dtype if len(dtypes) == 1 else np.float32
            cubes = np.zeros((Bp,) + self._grid, stack_dt)
            xyz = np.zeros((Bp, self._max_targets, 3), np.float32)
            valid = np.zeros((Bp, self._max_targets), bool)
            for i, (cube, x, v, _n) in enumerate(batch):
                cubes[i] = cube
                xyz[i] = x
                valid[i] = v
            encode = getattr(predictor, "encode_host", None)
            if encode is not None:
                cubes = encode(cubes)
            elif cubes.dtype != np.float32:
                cubes = cubes.astype(np.float32)
            t0 = time.perf_counter()
            try:
                pred, best_p, proba = (
                    _host(r) for r in predictor(cubes, xyz, valid)
                )
            except Exception as e:
                logger.exception("ClassifyStream device batch failed")
                context.abort(grpc.StatusCode.INTERNAL, str(e))
            ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                self._classify_count += n_real
                self._batches_run += 1
            for i in range(n_real):
                yield self._respond(
                    pred[i], best_p[i], proba[i], batch[i][3], ms
                )

    def _get_config(self, request, context) -> pb.ServingConfig:
        p = self._predictor
        return pb.ServingConfig(
            grid_shape=list(self._grid),
            classes=self._classes,
            min_proba=float(getattr(p, "min_proba", 0.0)),
            mode=str(getattr(p, "mode", "")),
            cube_dtype=str(getattr(p, "cube_dtype", "float32")),
        )

    def set_predictor(self, predictor):
        """Atomically swap the serving model (hot reload)."""
        self._predictor = predictor

    def note_model_reload(self):
        with self._stats_lock:
            self.model_reloads += 1

    def set_loop_stats_fn(self, fn):
        """Attach the local sensor loop's stats supplier after the loop
        exists (the server typically starts first)."""
        self._loop_stats_fn = fn

    # -- live detection feed --------------------------------------------

    def publish(
        self,
        seq: int,
        target_index: int,
        label: str,
        proba: float,
        latency_ms: float = 0.0,
    ):
        """Push one detection from the local sensor loop to every
        subscriber. Slow consumers drop events (newest-wins, like the
        serving batcher) instead of back-pressuring the loop."""
        ev = pb.DetectionEvent(
            seq=int(seq), target_index=int(target_index), label=label,
            proba=float(proba), latency_ms=float(latency_ms),
        )
        with self._subs_lock:
            subs = list(self._subs)
        with self._stats_lock:
            self._events_published += 1
        for q in subs:
            try:
                q.put_nowait(ev)
            except queue.Full:
                pass

    def _subscribe(self, request, context) -> Iterator[pb.DetectionEvent]:
        q: queue.Queue = queue.Queue(maxsize=256)
        with self._subs_lock:
            self._subs.add(q)
        try:
            while context.is_active():
                try:
                    yield q.get(timeout=0.5)
                except queue.Empty:
                    continue
        finally:
            with self._subs_lock:
                self._subs.discard(q)

    def _handlers(self):
        rpcs = {
            "Classify": grpc.unary_unary_rpc_method_handler(
                self._classify,
                request_deserializer=pb.ScanRequest.FromString,
                response_serializer=pb.ClassifyResponse.SerializeToString,
            ),
            "ClassifyStream": grpc.stream_stream_rpc_method_handler(
                self._classify_stream,
                request_deserializer=pb.ScanRequest.FromString,
                response_serializer=pb.ClassifyResponse.SerializeToString,
            ),
            "GetServingConfig": grpc.unary_unary_rpc_method_handler(
                self._get_config,
                request_deserializer=pb.Empty.FromString,
                response_serializer=pb.ServingConfig.SerializeToString,
            ),
            "Subscribe": grpc.unary_stream_rpc_method_handler(
                self._subscribe,
                request_deserializer=pb.Empty.FromString,
                response_serializer=pb.DetectionEvent.SerializeToString,
            ),
            "GetStats": grpc.unary_unary_rpc_method_handler(
                self._get_stats,
                request_deserializer=pb.Empty.FromString,
                response_serializer=pb.ServingStats.SerializeToString,
            ),
        }
        return grpc.method_handlers_generic_handler(SERVICE_NAME, rpcs)

    def _get_stats(self, request, context) -> pb.ServingStats:
        with self._subs_lock:
            n_subs = len(self._subs)
        with self._stats_lock:
            classify_count = self._classify_count
            events = self._events_published
            reloads = self.model_reloads
            batches = self._batches_run
        stats = pb.ServingStats(
            classify_requests=classify_count,
            subscribers=n_subs,
            uptime_s=time.monotonic() - self._started_at,
            events_published=events,
            model_reloads=reloads,
            classify_batches=batches,
        )
        if self._loop_stats_fn is not None:
            try:
                loop = self._loop_stats_fn()
                stats.loop_processed = int(loop.get("processed", 0))
                stats.loop_dropped = int(loop.get("dropped", 0))
                stats.loop_latency_p50_ms = float(
                    loop.get("latency_p50_ms", 0.0)
                )
                stats.loop_latency_p95_ms = float(
                    loop.get("latency_p95_ms", 0.0)
                )
            except Exception:
                logger.debug("loop stats unavailable", exc_info=True)
        return stats

    # -- lifecycle ----------------------------------------------------

    def start(self):
        self._server.start()
        logger.info("radar serving endpoint on port %d", self.port)
        return self

    def stop(self, grace: Optional[float] = 0.5):
        """Stop serving and return once the port is closed: a client's
        next call is refused (UNAVAILABLE, which it retries), not
        cancelled by a server still shutting down. In-flight calls get
        `grace` seconds to finish."""
        if self._batch_enabled:
            # Fail everything still queued; handlers blocked in the
            # election loop see _stopping and return, leaders finish
            # their in-flight device batch and deliver it normally.
            self._stopping = True
            with self._bq_lock:
                stragglers, self._bq = self._bq, []
            if stragglers:
                self._drain_batch(stragglers, RuntimeError("server stopped"))
        self._server.stop(grace).wait(timeout=(grace or 0.0) + 30.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class RadarServingClient:
    """Thin client: numpy cube + (x, y, z) targets → detections.

    Unary calls retry transient failures (UNAVAILABLE — server
    restarting or network blip — and DEADLINE_EXCEEDED) with
    exponential backoff before surfacing RadarServingError, mirroring
    the capture loop's camera-RPC policy (fusion/capture.py).
    """

    _RETRYABLE = (
        grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED,
    )

    def __init__(
        self,
        address: str,
        timeout_s: float = 10.0,
        retries: int = 2,
        backoff_s: float = 0.25,
    ):
        self._channel = grpc.insecure_channel(address)
        self._timeout = timeout_s
        self._retries = max(int(retries), 0)
        self._backoff_s = backoff_s
        self._classify = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Classify",
            request_serializer=pb.ScanRequest.SerializeToString,
            response_deserializer=pb.ClassifyResponse.FromString,
        )
        self._config = self._channel.unary_unary(
            f"/{SERVICE_NAME}/GetServingConfig",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ServingConfig.FromString,
        )

    def _call(self, fn, request):
        delay = self._backoff_s
        for attempt in range(self._retries + 1):
            try:
                return fn(request, timeout=self._timeout)
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if attempt >= self._retries or code not in self._RETRYABLE:
                    raise RadarServingError(str(e)) from e
                logger.debug(
                    "retrying %s after %s (attempt %d)", fn, code, attempt + 1
                )
                time.sleep(delay)
                delay *= 2

    @staticmethod
    def _make_request(
        cube: np.ndarray,
        targets: Sequence[Tuple[float, float, float]],
        dtype: str,
    ) -> pb.ScanRequest:
        arr = np.ascontiguousarray(cube)
        if dtype == "uint8":
            arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
        elif dtype == "int8":
            # Wire format: value-128 (see models/pipeline
            # encode_int8_cubes). Same 1 B/voxel as uint8.
            if arr.dtype != np.int8:
                u8 = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
                arr = (u8 ^ np.uint8(0x80)).view(np.int8)
        else:
            arr = arr.astype(np.float32)
        return pb.ScanRequest(
            cube=arr.tobytes(),
            dtype=dtype,
            shape=list(arr.shape),
            targets=[
                pb.ScanRequest.Target(x=float(x), y=float(y), z=float(z))
                for x, y, z in targets
            ],
        )

    def classify(
        self,
        cube: np.ndarray,
        targets: Sequence[Tuple[float, float, float]],
        dtype: str = "uint8",
    ) -> List[pb.RadarDetection]:
        req = self._make_request(cube, targets, dtype)
        return list(self._call(self._classify, req).detections)

    def classify_stream(
        self,
        scans,
        dtype: str = "uint8",
        timeout_s: Optional[float] = None,
    ):
        """Bulk scoring over one streaming call.

        `scans`: iterable of (cube, targets). Yields the detection list
        for each scan, in order. One RPC amortizes serialization and
        per-request dispatch across the whole stream; the server packs
        in-flight requests into device batches (ClassifyStream in
        radar_serving.proto).
        """
        call = self._channel.stream_stream(
            f"/{SERVICE_NAME}/ClassifyStream",
            request_serializer=pb.ScanRequest.SerializeToString,
            response_deserializer=pb.ClassifyResponse.FromString,
        )

        def requests():
            for cube, targets in scans:
                yield self._make_request(cube, targets, dtype)

        try:
            for resp in call(requests(), timeout=timeout_s or self._timeout):
                yield list(resp.detections)
        except grpc.RpcError as e:
            raise RadarServingError(str(e)) from e

    def get_config(self) -> pb.ServingConfig:
        return self._call(self._config, pb.Empty())

    def get_stats(self) -> pb.ServingStats:
        stats = self._channel.unary_unary(
            f"/{SERVICE_NAME}/GetStats",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ServingStats.FromString,
        )
        return self._call(stats, pb.Empty())

    def subscribe(self, timeout_s: Optional[float] = None):
        """Iterate live DetectionEvents from the server's sensor loop.

        Blocks on the stream; cancel by breaking out (the context
        manager form closes the call) or via the timeout.
        """
        sub = self._channel.unary_stream(
            f"/{SERVICE_NAME}/Subscribe",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DetectionEvent.FromString,
        )
        try:
            yield from sub(pb.Empty(), timeout=timeout_s or self._timeout)
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            if code not in (
                grpc.StatusCode.DEADLINE_EXCEEDED,
                grpc.StatusCode.CANCELLED,
            ):
                raise RadarServingError(str(e)) from e

    def close(self):
        self._channel.close()
