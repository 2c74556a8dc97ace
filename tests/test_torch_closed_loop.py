"""The full capture → retrain → hot-reload loop through the port's apps,
zero restarts: tests/test_closed_loop.py re-run on radarml_tpu_torch with
--platform cpu, at the JAX test's own sizes (the service runs 30 s, the
JAX test's 60; the swap comes within a few seconds of the retrain).

Ground-truth capture over the fake-camera gRPC fusion path, `train
--online_learn` rewriting the served artifact in place, and `serve
--reload_poll` swapping the new model into the running gRPC endpoint:
one process, one port, the served probabilities change.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest


@pytest.fixture()
def workdir(tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    yield tmp_path
    os.chdir(cwd)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_capture_retrain_reload_in_one_running_service(workdir):
    from radarml_tpu_torch.apps import ground_truth_samples as gts_app
    from radarml_tpu_torch.apps import serve as serve_app
    from radarml_tpu_torch.apps import train as train_app
    from radarml_tpu_torch.core.arena import DEFAULT_ARENA
    from radarml_tpu_torch.data.store import load_datasets
    from radarml_tpu_torch.rpc.radar_server import RadarServingClient

    # 1. Initial model from synthetic data (the artifact to be served).
    train_app.main([
        "--platform", "cpu",
        "--synthetic", "45",
        "--datasets", "ds0.pickle",
        "--grid_epochs", "8",
        "--folds", "3",
    ])
    model_path = "train-results/svm_radar_classifier.pickle"
    le_path = "train-results/radar_labels.pickle"
    assert os.path.exists(model_path)

    # 2. Capture fresh ground truth through the fake-camera gRPC fusion
    #    path (radar targets associated with camera detections).
    n = gts_app.main([
        "--num_samples", "24",
        "--max_scans", "400",
        "--dataset", "captured.pickle",
        "--driver_seed", "9",
        "--log_file", "",
    ])
    assert n == 24
    captured = load_datasets(["captured.pickle"])
    assert len(captured["labels"]) == 24
    assert captured["samples"][0][0].shape == DEFAULT_ARENA.xz_shape

    # 3. Serve the artifact on a gRPC endpoint with hot reload on.
    port = _free_port()
    out = {}

    def run_serve():
        out["res"] = serve_app.main([
            "--platform", "cpu",
            "--svm_model", model_path, "--label_encoder", le_path,
            "--grpc_port", str(port), "--duration", "30",
            "--min_proba", "0.0", "--reload_poll", "0.3",
        ])

    th = threading.Thread(target=run_serve, daemon=True)
    th.start()

    rng = np.random.default_rng(4)
    cube = np.rint(rng.random(DEFAULT_ARENA.grid_shape) * 255).astype(np.float32)
    targets = [(5.0, 5.0, 100.0)]

    client = None
    deadline = time.time() + 50
    while client is None and time.time() < deadline:
        try:
            c = RadarServingClient(f"127.0.0.1:{port}")
            c.classify(cube, targets, dtype="uint8")
            client = c
        except Exception:
            time.sleep(0.5)
    assert client is not None, "serving endpoint never came up"

    try:
        before = np.asarray(client.classify(cube, targets, dtype="uint8")[0].class_probas)
        reloads0 = int(client.get_stats().model_reloads)

        # 4. Online-retrain on the captured data; rewrites the served
        #    artifact in place.
        train_app.main([
            "--platform", "cpu",
            "--online_learn",
            "--datasets", "captured.pickle",
            "--grid_epochs", "3",
            "--folds", "3",
        ])

        # 5. The running service must notice and swap — no restart.
        deadline = time.time() + 40
        while time.time() < deadline:
            if int(client.get_stats().model_reloads) > reloads0:
                break
            time.sleep(0.3)
        stats = client.get_stats()
        assert int(stats.model_reloads) > reloads0, "hot reload never fired"

        after = np.asarray(client.classify(cube, targets, dtype="uint8")[0].class_probas)
        # Same endpoint, same channel, same process — new model.
        assert not np.allclose(before, after, atol=1e-8), (
            "served predictions unchanged after online retrain + reload"
        )
    finally:
        client.close()
        th.join(timeout=90)
    assert not th.is_alive()
    assert out["res"]["grpc_port"] == port
