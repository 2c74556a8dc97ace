"""CLI: capture labeled ground-truth samples via radar/camera fusion.

Port of radarml_tpu/apps/ground_truth_samples.py. Capture runs on the
host (fusion/capture.py); nothing here uses the card, and `--platform`
is accepted and unused. Mirror of the reference's ground_truth_samples.py entry point
(ground_truth_samples.py:474-594): radar session + detection-server
RPC, the association capture loop, optional realtime plotting or movie
save, and append-or-create dataset pickling.

Hardware-free default: with --fake_camera, an in-process fake
DetectionServer is started on loopback whose detections track the
synthetic radar's planted targets — the full gRPC + fusion path runs
end-to-end with no camera, network, or radar. Point --detect_server at
a real goruck/detection_server to capture live.
"""

from __future__ import annotations

import argparse
import logging

from radarml_tpu_torch.apps.common_cli import (
    add_common_flags,
    add_driver_flags,
    build_driver,
    setup_logging,
)
from radarml_tpu_torch.core.arena import DEFAULT_ARENA
from radarml_tpu_torch.drivers import RadarSession
from radarml_tpu_torch.fusion import CaptureConfig, capture_samples
from radarml_tpu_torch.data.store import save_dataset
from radarml_tpu_torch.rpc import (
    Centroid,
    Detection,
    DetectionClient,
    FakeDetectionServer,
)

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num_samples", type=int, default=500,
                   help="number of samples to capture")
    p.add_argument("--desired_labels", nargs="+", type=str,
                   default=["person", "dog", "cat"])
    p.add_argument("--realtime_plot", action="store_true",
                   help="plot radar results in real-time")
    p.add_argument("--save_plot", action="store_true",
                   help="save radar realtime plot as movie")
    p.add_argument("--save_plot_path", type=str,
                   default="ground-truth-samples.mp4")
    p.add_argument("--dataset", type=str,
                   default="datasets/radar_samples.pickle",
                   help="output captured dataset name")
    p.add_argument("--detect_server", type=str, default="",
                   help="detection server address host:port")
    p.add_argument("--fake_camera", action="store_true",
                   help="serve detections from an in-process fake that "
                        "tracks the synthetic radar's targets")
    p.add_argument("--max_scans", type=int, default=0,
                   help="bound on scans (0 = unbounded)")
    p.add_argument("--log_file", type=str, default="ground_truth_samples.log")
    add_driver_flags(p)
    add_common_flags(p)
    return p


def _pixel_for(x, y, z, cam, mount):
    """Inverse camera projection: centroid that lands on radar (x, y, z)."""
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_file, args.logging_level)

    arena = DEFAULT_ARENA
    driver = build_driver(args, arena)
    cfg = CaptureConfig(
        num_samples=args.num_samples,
        desired_labels=tuple(args.desired_labels),
        max_scans=args.max_scans or None,
    )

    fake = None
    if args.fake_camera or not args.detect_server:
        if not args.fake_camera:
            logger.info("No --detect_server given; using --fake_camera mode.")

        def tracked(desired):
            cam = fake.camera
            out = []
            targets = getattr(driver, "_targets", [])
            labels = getattr(driver, "truth_labels", [])
            for t, label in zip(targets, labels):
                out.append(
                    Detection(
                        label, 0.9, 0.1,
                        _pixel_for(t.x, t.y, t.z, cam, cfg.mount),
                    )
                )
            return out

        fake = FakeDetectionServer(script=tracked)
        address = fake.start()
        logger.info("Started in-process fake detection server at %s", address)
    else:
        address = args.detect_server

    captured = 0
    try:
        with DetectionClient(address) as client:
            camera = client.get_camera_info()
            logger.info("Camera: %s", camera)
            with RadarSession(driver) as radar:
                stream = capture_samples(
                    radar, client.get_detected_objects, camera, cfg
                )
                if args.realtime_plot or args.save_plot:
                    from radarml_tpu_torch.viz import CaptureView

                    view = CaptureView(arena)
                    ani = view.animate(stream)
                    if args.realtime_plot:
                        import matplotlib.pyplot as plt

                        plt.show()
                    else:
                        import shutil

                        from matplotlib import animation as mpl_anim

                        if not shutil.which("ffmpeg"):
                            raise SystemExit(
                                "--save_plot needs ffmpeg on PATH"
                            )
                        writer = mpl_anim.FFMpegWriter(fps=10)
                        ani.save(args.save_plot_path, writer=writer)
                else:
                    samples, labels = [], []
                    for s in stream:
                        samples.append(s.projections)
                        labels.append(s.label)
                    captured = len(labels)
                    if captured:
                        save_dataset(args.dataset, samples, labels, append=True)
                        logger.info(
                            "Saved %d samples to %s", captured, args.dataset
                        )
    finally:
        if fake is not None:
            fake.stop()
    return captured


if __name__ == "__main__":
    main()
