"""The port's model hot reload: the cases of tests/test_reload.py re-run
against radarml_tpu_torch.serving.reload and the port's serve app on the
CPU (--platform cpu).

ModelReloader is a copy of the JAX package's (no JAX in it), so its
three unit cases run unchanged. The serve cases rewrite an
intercept-only model mid-serve and check that the loop's detections
follow it without a restart, in fast and fused mode. The JAX package's
fifth case, which reloads an ahead-of-time serving artifact, is in
tests/test_torch_export.py with the port's other artifact cases.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from radarml_tpu_torch.apps import serve as serve_app
from radarml_tpu_torch.apps.common_cli import save_label_encoder, save_model
from radarml_tpu_torch.core.arena import DEFAULT_ARENA
from radarml_tpu_torch.data.labels import LabelEncoder
from radarml_tpu_torch.serving.reload import ModelReloader

torch.set_num_threads(1)

CLASSES = ["cat", "dog", "person"]


def test_reloader_detects_change_and_swaps(tmp_path):
    path = tmp_path / "artifact.bin"
    path.write_bytes(b"v1")
    swapped = []
    r = ModelReloader(
        str(path), build=lambda: path.read_bytes(),
        on_swap=swapped.append, poll_s=0.1,
    )
    r.start()
    time.sleep(0.3)
    path.write_bytes(b"v2")
    deadline = time.time() + 10
    while not swapped and time.time() < deadline:
        time.sleep(0.1)
    r.stop()
    r.join(timeout=5)
    assert swapped == [b"v2"]
    assert r.reloads == 1


def test_reloader_survives_bad_artifact(tmp_path):
    path = tmp_path / "artifact.bin"
    path.write_bytes(b"v1")
    calls = []

    def build():
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("corrupt")
        return "good"

    swapped = []
    r = ModelReloader(str(path), build, swapped.append, poll_s=0.1)
    r.start()
    time.sleep(0.3)
    path.write_bytes(b"v2")  # triggers the failing build
    deadline = time.time() + 10
    while r.failures == 0 and time.time() < deadline:
        time.sleep(0.1)
    path.write_bytes(b"v3")  # second change: build succeeds
    deadline = time.time() + 10
    while not swapped and time.time() < deadline:
        time.sleep(0.1)
    r.stop()
    r.join(timeout=5)
    assert r.failures == 1
    assert swapped == ["good"]


def test_reloader_backs_off_on_repeated_failures(tmp_path):
    """A deterministically bad artifact must not spin build() every
    poll. Retries continue (a transient race heals) but on a doubling
    backoff."""
    path = tmp_path / "artifact.bin"
    path.write_bytes(b"v1")
    calls = []

    def build():
        calls.append(time.time())
        raise ValueError("always corrupt")

    r = ModelReloader(str(path), build, lambda _: None, poll_s=0.05)
    r.start()
    time.sleep(0.2)
    path.write_bytes(b"v2")  # triggers the always-failing build
    time.sleep(1.5)
    r.stop()
    r.join(timeout=5)
    # no-backoff would attempt ~25+ builds in 1.5 s at poll 0.05
    assert 2 <= len(calls) <= 10, calls
    # and the reloader still retried rather than giving up after one
    assert r.failures == len(calls)


def _write_model(path, boost_class):
    """Intercept-only model: always predicts boost_class confidently."""
    C, F = len(CLASSES), DEFAULT_ARENA.feature_length
    intercept = np.full((C,), -5.0, np.float32)
    intercept[boost_class] = 5.0
    save_model(
        str(path), "linear",
        coef=np.zeros((C, F), np.float32), intercept=intercept,
        calib_a=-np.ones((C,), np.float32), calib_b=np.zeros((C,), np.float32),
        classes=CLASSES,
    )


@pytest.mark.parametrize("mode", ["fast", "fused"])
def test_serve_cli_hot_reload_swaps_predictions(tmp_path, mode):
    """Rewrite the model mid-serve; the loop's predictions flip class
    without a restart, and no batch fails across the swap."""
    model_path = tmp_path / "svm.pickle"
    _write_model(model_path, 0)
    le_path = str(tmp_path / "le.pickle")
    save_label_encoder(le_path, LabelEncoder(classes_=tuple(CLASSES)))

    labels_seen = []
    out = {}

    class Grab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "target" in msg and "(" in msg:
                for name in CLASSES:
                    if f" {name} " in msg:
                        labels_seen.append(name)

    def run():
        out["res"] = serve_app.main([
            "--platform", "cpu", "--mode", mode,
            "--svm_model", str(model_path), "--label_encoder", le_path,
            "--duration", "10", "--scan_period", "0.02",
            "--max_batch", "4", "--min_proba", "0.0",
            "--reload_poll", "0.2", "--log_detections",
        ])

    grab = Grab()
    log = logging.getLogger("radarml_tpu_torch.apps.serve")
    log.addHandler(grab)
    try:
        th = threading.Thread(target=run)
        th.start()
        deadline = time.time() + 30
        while "cat" not in labels_seen and time.time() < deadline:
            time.sleep(0.05)
        _write_model(model_path, 2)  # swap to always-person
        th.join(timeout=120)
        assert not th.is_alive()
    finally:
        log.removeHandler(grab)

    res = out["res"]
    assert res["model_reloads"] >= 1 and res["predict_errors"] == 0
    assert "cat" in labels_seen  # before reload
    assert "person" in labels_seen  # after reload
    first_person = labels_seen.index("person")
    assert set(labels_seen[first_person:]) == {"person"}
