"""The port's entry points compute on the card unless told otherwise.

Each entry point that makes tensors takes `device=None`, which
core/device.resolve_device turns into the CUDA card; with no card it
raises and says to pass device="cpu" instead of carrying on quietly on
the CPU. Here the card is hidden (torch.cuda.is_available() is False),
as it is on a host without one.
"""

import numpy as np
import pytest
import torch

from radarml_tpu_torch.apps import common_cli
from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.models import linear, svc
from radarml_tpu_torch.ops import features

torch.set_num_threads(1)

NO_CARD = "pass device='cpu'"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _planes(n=2):
    rng = np.random.default_rng(0)
    return [rng.random((n, 7, 26)), rng.random((n, 7, 26)), rng.random((n, 7, 7))]


def _linear_artifact(tmp_path):
    path = tmp_path / "m.pkl"
    common_cli.save_model(str(path), "linear", coef=np.zeros((3, 4), np.float32),
                          intercept=np.zeros(3, np.float32), calib_a=None, calib_b=None)
    return str(path)


ENTRY_POINTS = {
    "linear.from_numpy": lambda tmp: linear.from_numpy(np.zeros((3, 4)), np.zeros(3)),
    "svc.from_numpy": lambda tmp: svc.from_numpy(
        np.zeros((2, 4)), np.zeros((1, 2)), np.zeros(1), (1, 1)),
    "svc.svc_fit": lambda tmp: svc.svc_fit(
        np.zeros((4, 3), np.float32), np.array([0, 1, 0, 1]), svc.SVCConfig()),
    "common_cli.load_model": lambda tmp: common_cli.load_model(_linear_artifact(tmp)),
    "features.process_samples": lambda tmp: features.process_samples(
        list(zip(*_planes()))),
    "features.process_views": lambda tmp: features.process_views(*_planes()),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(no_card, tmp_path, name):
    with pytest.raises(RuntimeError, match=NO_CARD):
        ENTRY_POINTS[name](tmp_path)


def test_resolve_device(no_card, monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match=NO_CARD):
        resolve_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)


def test_explicit_cpu_and_tensor_input_stay_on_the_cpu(no_card, tmp_path):
    """device="cpu" computes on the CPU, and svc_fit keeps a tensor X
    where it lies."""
    model, _ = common_cli.load_model(_linear_artifact(tmp_path), device="cpu")
    assert model.coef.device.type == "cpu"
    assert features.process_views(*_planes(), device="cpu").device.type == "cpu"
    rng = np.random.default_rng(1)
    X = torch.from_numpy(np.concatenate([rng.normal(size=(6, 3)) - 2,
                                         rng.normal(size=(6, 3)) + 2]).astype(np.float32))
    m = svc.svc_fit(X, np.repeat([0, 1], 6), svc.SVCConfig(probability=False))
    assert m.support_vectors.device.type == "cpu"
