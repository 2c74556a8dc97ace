"""CLI: continuous streaming classification service.

Port of radarml_tpu/apps/serve.py: a C++ (or synthetic) scan source
feeds an ingest thread; scans batch by max-size-or-max-wait; each batch
runs the RadarPredictor on the card (`--platform cpu` for the CPU);
detections stream to the log with end-to-end latency. Prints a JSON
stats line on exit. `--grpc_port` serves classifications over gRPC
(rpc/radar_server.py), `--reload_poll` hot-swaps the model when its
artifact changes.

There is no Mosaic gate and no fallback: under `--mode fused` a kernel
that fails to build or launch raises. `--export_serving` writes the
predictor as a torch.export artifact (serving/export.py) and exits;
`--serving_artifact` serves one, and `--reload_poll` then watches it.

    python -m radarml_tpu_torch.apps.serve --svm_model M --label_encoder L
"""

from __future__ import annotations

import argparse
import json
import logging
import threading

import numpy as np
import torch

from radarml_tpu_torch.apps.common_cli import (
    add_common_flags,
    add_driver_flags,
    add_scan_arena_flag,
    build_driver,
    device_of,
    load_label_encoder,
    load_model,
    parse_arena,
    setup_logging,
    warm_transfers,
)
from radarml_tpu_torch.core.arena import DEFAULT_ARENA
from radarml_tpu_torch.models.pipeline import UNKNOWN, RadarPredictor
from radarml_tpu_torch.serving import (
    StreamConfig,
    StreamingClassifier,
    driver_scan_source,
    native_scan_source,
)

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--svm_model", type=str,
                   default="train-results/svm_radar_classifier.pickle")
    p.add_argument("--label_encoder", type=str,
                   default="train-results/radar_labels.pickle")
    p.add_argument("--min_proba", type=float, default=0.7)
    p.add_argument("--cube_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16", "uint8", "int8"],
                   help="device dtype of the scan stream; bfloat16/uint8/"
                        "int8 are lossless for 8-bit radar data and cut "
                        "host-to-device traffic 2x/4x/4x (int8 scores "
                        "exactly in integers against quantized templates; "
                        "uint8/int8 truncate non-integer cubes)")
    p.add_argument("--mode", type=str, default="fast",
                   choices=["exact", "fast", "fused"],
                   help="scoring path (identical detections): exact "
                        "reference math, folded templates (fast), or the "
                        "one-read int8 table kernel (fused; its stream is "
                        "int8 whatever --cube_dtype says)")
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds to serve (0 = until interrupted)")
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.add_argument("--log_detections", action="store_true")
    p.add_argument("--sensors", type=int, default=1,
                   help="number of (synthetic) sensors to multiplex")
    p.add_argument("--export_serving", type=str, default="",
                   help="export the predictor (torch.export, symbolic "
                        "batch, weights folded in; fused mode bakes "
                        "--max_batch) to this path and exit; the "
                        "artifact serves via --serving_artifact with no "
                        "model pickles or pipeline code")
    p.add_argument("--serving_artifact", type=str, default="",
                   help="serve from an AOT artifact written by "
                        "--export_serving instead of building the "
                        "predictor from --svm_model")
    p.add_argument("--grpc_port", type=int, default=-1,
                   help="serve classifications over gRPC on this port "
                        "(0 = auto-pick) instead of running the local "
                        "sensor loop; clients ship raw scan cubes and "
                        "get calibrated detections (rpc/radar_serving"
                        ".proto)")
    p.add_argument("--grpc_host", type=str, default="127.0.0.1",
                   help="gRPC bind address; 0.0.0.0 accepts remote "
                        "edge clients")
    p.add_argument("--grpc_batch_window_ms", type=float, default=0.0,
                   help="dynamic batching: >0 enables leader-follower "
                        "coalescing of concurrent Classify calls "
                        "(bucketed padding, no hold window — the value "
                        "is only an on/off switch; 0 = off)")
    p.add_argument("--grpc_max_inflight_batches", type=int, default=8,
                   help="dynamic batching: concurrent leader slots "
                        "(predictor calls in flight); excess demand "
                        "queues and coalesces")
    p.add_argument("--grpc_batch_size", type=int, default=8,
                   help="dynamic batching: max requests per device batch")
    p.add_argument("--grpc_publish", action="store_true",
                   help="with --grpc_port: run the local sensor loop "
                        "AND stream its detections to gRPC Subscribe "
                        "consumers (Classify stays available)")
    p.add_argument("--reload_poll", type=float, default=0.0,
                   help="hot-reload: poll the model artifact every N "
                        "seconds and swap the predictor in place when "
                        "it changes (0 = off)")
    p.add_argument("--no_mosaic_gate", dest="mosaic_gate",
                   action="store_false",
                   help="accepted for parity with the JAX package's CLI; "
                        "does nothing on this card (there is no Mosaic "
                        "compiler to probe)")
    p.add_argument("--fused_quant", type=str, default="split",
                   choices=["split", "single"],
                   help="fused-mode template quantization: 'split' "
                        "(default) keeps decisions equal to fast+int8; "
                        "'single' halves the kernel's template rows at a "
                        "coarser template error (RadarPredictor.fused_quant)")
    add_scan_arena_flag(p)
    add_driver_flags(p)
    add_common_flags(p)
    return p


def warm(predictor, batch: int, grid, device) -> None:
    """One call at `batch` scans (valid targets in every slot: 4, or an
    artifact's baked count), waited for: the first call builds and loads
    the mode's CUDA kernels, so the first real batch does not pay for it."""
    T = int(getattr(predictor, "max_targets", 4))
    cubes = np.zeros((batch,) + tuple(grid), np.float32)
    xyz = np.tile(np.array([0.0, 0.0, 100.0], np.float32), (batch, T, 1))
    predictor(cubes, xyz, np.ones((batch, T), bool))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, stop: threading.Event | None = None) -> dict:
    """Serve for --duration seconds (0: until interrupted); `stop`, when
    given and set, ends the serve loop sooner (a caller that embeds the
    app in a thread)."""
    args = build_parser().parse_args(argv)
    setup_logging(None, args.logging_level)
    if args.export_serving and args.serving_artifact:
        raise SystemExit(
            "--export_serving needs a predictor built from "
            "--svm_model, not --serving_artifact"
        )
    device = device_of(args)
    warm_transfers(device)

    le = load_label_encoder(args.label_encoder)
    # Sensors scan --scan_arena; the predictor zooms projections into
    # the training arena (reference predict.py:34-54). An artifact bakes
    # its scan grid, which must be this one.
    scan_arena = parse_arena(args.scan_arena)
    grid = scan_arena.grid_shape

    def build_predictor():
        if args.serving_artifact:
            from radarml_tpu_torch.serving import load_serving_artifact

            p = load_serving_artifact(args.serving_artifact, device=device)
            logger.info("serving from AOT artifact %s (mode=%s, platforms=%s)",
                        args.serving_artifact, p.mode, p.platforms)
            if tuple(p.grid_shape) != tuple(grid):
                raise ValueError(f"the artifact's scan grid {p.grid_shape} is not "
                                 f"--scan_arena's {tuple(grid)}")
            if abs(p.min_proba - args.min_proba) > 1e-9:
                logger.warning(
                    "--min_proba %.2f ignored: the artifact bakes in %.2f "
                    "(thresholds are constants in the exported program; "
                    "re-export to change)", args.min_proba, p.min_proba)
            return p
        model, calib = load_model(args.svm_model, device=device)
        return RadarPredictor(
            train_arena=DEFAULT_ARENA, scan_arena=scan_arena,
            model=model, calibration=calib,
            min_proba=args.min_proba, mode=args.mode,
            cube_dtype=args.cube_dtype,
            fused_quant=args.fused_quant if args.mode == "fused" else "split",
            device=device,
        )

    predictor = build_predictor()
    if args.export_serving:
        from radarml_tpu_torch.serving import export_predictor

        fused = predictor.mode == "fused"
        export_predictor(
            predictor, args.export_serving,
            # a non-fused program is exported for both devices when it is
            # traced on the card, as the JAX CLI lowers for ("tpu",
            # "cpu") (a CUDA program needs the card to hold its
            # constants); a fused one for this device only
            platforms=None if fused or device.type != "cuda" else ("cuda", "cpu"),
            # fused exports bake a static batch; the service scores in
            # --max_batch chunks, so bake that
            batch=args.max_batch if fused else None,
        )
        return {"exported": args.export_serving}
    # A fused AOT artifact bakes a static batch; smaller batches pad up
    # inside ServingArtifact, but LARGER ones cannot run — clamp the
    # service's batch knobs so every served shape fits.
    baked = getattr(predictor, "batch", None)
    if baked:
        for knob in ("max_batch", "grpc_batch_size"):
            if getattr(args, knob) > baked:
                logger.warning("--%s %d exceeds the artifact's baked batch %d; "
                               "clamping", knob, getattr(args, knob), baked)
                setattr(args, knob, baked)
    logger.info("warming predictor (kernel build)...")
    warm(predictor, args.max_batch, grid, device)
    logger.info("predictor ready")

    swap_targets = []  # objects whose .predictor / set_predictor to update
    rpc_server = None

    def start_reloader():
        if args.reload_poll <= 0:
            return None
        from radarml_tpu_torch.serving.reload import ModelReloader

        def build_and_warm():
            # Load and run the new model off the serving path, so the
            # swap is seamless.
            p = build_predictor()
            warm(p, args.max_batch, grid, device)
            return p

        def swap(p):
            for tgt in swap_targets:
                if hasattr(tgt, "set_predictor"):
                    tgt.set_predictor(p)
                else:
                    tgt.predictor = p
            if rpc_server is not None:
                rpc_server.note_model_reload()

        watch = args.serving_artifact or args.svm_model
        reloader = ModelReloader(watch, build_and_warm, swap, poll_s=args.reload_poll)
        reloader.start()
        logger.info("hot-reload watching %s every %.1fs", watch, args.reload_poll)
        return reloader

    def serve_for_duration():
        ended = stop or threading.Event()
        try:
            if args.duration > 0:
                ended.wait(args.duration)
            else:
                while not ended.wait(1):
                    pass
        except KeyboardInterrupt:
            pass

    if args.grpc_port >= 0:
        from radarml_tpu_torch.rpc.radar_server import RadarServingServer

        rpc_server = RadarServingServer(
            predictor, classes=list(le.classes_), grid_shape=grid,
            # an AOT artifact bakes its target-slot axis; match it
            max_targets=int(getattr(predictor, "max_targets", 4)),
            port=args.grpc_port,
            host=args.grpc_host,
            batch_window_ms=args.grpc_batch_window_ms,
            batch_size=args.grpc_batch_size,
            max_concurrent_batches=args.grpc_max_inflight_batches,
        )
        rpc_server.start()
        swap_targets.append(rpc_server)
        print(json.dumps({"grpc_port": rpc_server.port}), flush=True)
        if not args.grpc_publish:
            # Endpoint-only mode: no local sensor loop.
            reloader = start_reloader()
            try:
                serve_for_duration()
            finally:
                if reloader:
                    reloader.stop()
                    reloader.join(timeout=60)
                rpc_server.stop()
            out = {"grpc_port": rpc_server.port}
            if reloader:
                out["model_reloads"] = reloader.reloads
            return out

    def on_detection(d):
        if rpc_server is None and not args.log_detections:
            return
        name = "" if d.label_index == UNKNOWN else le.classes_[d.label_index]
        if rpc_server is not None:
            rpc_server.publish(
                d.seq, d.target_index, name, d.proba, d.latency_ms
            )
        if args.log_detections:
            logger.info(
                "scan %d target %d: %s (%.3f) %.1fms",
                d.seq, d.target_index, name or "Unknown", d.proba,
                d.latency_ms,
            )

    # Shallow queue = low latency: beyond ~2 batches of backlog the
    # newest-wins drop policy should kick in rather than queueing
    # stale scans (a 5 Hz sensor's scan is worthless 2 s later).
    svc = StreamingClassifier(
        predictor,
        StreamConfig(
            max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms / 1e3,
            queue_depth=2 * args.max_batch,
        ),
        on_detection=on_detection,
    )
    swap_targets.append(svc)
    if rpc_server is not None:
        rpc_server.set_loop_stats_fn(svc.stats)

    if args.driver == "native":
        from radarml_tpu_torch.drivers import NativeScanSource

        src = NativeScanSource(
            arena=scan_arena, seed=args.driver_seed,
            scan_period_us=args.scan_period * 1e6,
        )
        src.start()
        source = native_scan_source(src, scan_arena)
        cleanup = src.close
    else:
        from radarml_tpu_torch.drivers import RadarSession

        sessions = []
        sources = []
        for s in range(max(args.sensors, 1)):
            sensor_args = argparse.Namespace(**vars(args))
            sensor_args.driver_seed = args.driver_seed + s
            driver = build_driver(sensor_args, scan_arena)
            session = RadarSession(driver)
            session.__enter__()
            sessions.append(session)
            sources.append(driver_scan_source(driver))
        source = sources if len(sources) > 1 else sources[0]

        def cleanup():
            for session in sessions:
                session.__exit__(None, None, None)

    reloader = start_reloader()
    svc.start(source)
    try:
        serve_for_duration()
    finally:
        if reloader:
            reloader.stop()
            reloader.join(timeout=60)
        svc.stop()
        cleanup()
        if rpc_server is not None:
            rpc_server.stop()
    stats = svc.stats()
    if reloader:
        stats["model_reloads"] = reloader.reloads
    print(json.dumps({k: round(v, 2) if isinstance(v, float) else v
                      for k, v in stats.items()}), flush=True)
    return stats


if __name__ == "__main__":
    main()
