"""The SGD walk's CUDA graph on the card (models/linear.py `_Walk`).

On the card each epoch of the per-sample walk is captured once as a
CUDA graph and replayed; the captured epoch must compute bit for bit
what the same walk computes eagerly, and early stopping must stop each
candidate at the epoch the CPU stops it on easy data. The file imports
no JAX, so on the card (no JAX there) it runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sgd_walk_card.py
"""

import numpy as np
import pytest
import torch

from radarml_tpu_torch.models import linear as tl


def _blobs(seed=1234, n=50, k=3, f=300):
    rng = np.random.default_rng(seed)
    y = (np.arange(n) % k).astype(np.int64)
    centers = rng.normal(size=(k, f)).astype(np.float32) * 3
    return centers[y] + rng.normal(size=(n, f)).astype(np.float32), y


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_walk_equals_eager_walk_on_card():
    dev = _card()
    X, y = _blobs()
    n, F = X.shape
    alphas = np.asarray([1e-4, 1e-3], np.float32)
    t0 = np.asarray([tl._init_t(a) for a in alphas], np.float32)
    out = []
    for capture in (True, False):
        walk = tl._Walk("elasticnet", True, 3, 1, 2, n, F, dev, True)
        state = tl._many_state((1, 2), 3, F, t0, dev)
        walk.load(torch.as_tensor(X[None], device=dev), torch.as_tensor(y[None], device=dev),
                  torch.as_tensor(alphas), torch.full((2,), 0.15), torch.as_tensor(t0), state)
        perms = np.random.default_rng(0)
        for _ in range(3):
            walk.epoch(perms.permutation(n), capture=capture)
        assert (walk.graph is not None) == capture
        out.append([f.clone() for f in walk.state] + [walk.sumloss.clone()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_early_stop_epochs_on_card_equal_cpu():
    dev = _card()
    X, y = _blobs(f=40)
    alphas = [1e-3, 1e-2]
    kw = dict(epochs=100, seed=0, tol=1e-3)
    tl.WALK_LOG.clear()
    card = tl.sgd_fit_many(X, y, 3, "l2", False, alphas, [0.0, 0.0], device=dev, **kw)
    assert tl.WALK_LOG[-1]["graph"]
    cpu = tl.sgd_fit_many(X, y, 3, "l2", False, alphas, [0.0, 0.0], device="cpu", **kw)
    np.testing.assert_array_equal(card.t.cpu().numpy(), cpu.t.numpy())
    scale = float(cpu.coef.abs().max())
    assert float((card.coef.cpu() - cpu.coef).abs().max()) <= 1e-5 * scale
