"""The port's data helpers (store, balance, split) against the JAX package's.

Re-runs the store, balance and split cases of tests/test_data.py with
the port beside the JAX package on the same numpy inputs: pickles
written by either package load in the other; balanced sets and split
indices are bit-equal (both draw from np.random.RandomState); a feature
tensor balances on its own device.
"""

import numpy as np
import pytest
import torch

from radarml_tpu.data import balance as jbalance
from radarml_tpu.data import split as jsplit
from radarml_tpu.data import store as jstore
from radarml_tpu.data.synthetic import make_dataset
from radarml_tpu_torch.data import balance as tbalance
from radarml_tpu_torch.data import split as tsplit
from radarml_tpu_torch.data import store as tstore


@pytest.mark.parametrize("writer,reader", [(jstore, tstore), (tstore, jstore)],
                         ids=["jax_writes", "port_writes"])
def test_store_roundtrip_across_packages(tmp_path, writer, reader):
    samples, labels = make_dataset(6, seed=7)
    path = str(tmp_path / "ds.pickle")
    writer.save_dataset(path, samples[:4], labels[:4])
    reader.save_dataset(path, samples[4:], labels[4:])  # append
    for pkg in (jstore, tstore):
        data = pkg.load_datasets([path])
        assert data["labels"] == list(labels)
        assert len(data["samples"]) == 6
        for got, want in zip(data["samples"], samples):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_store_sup_mask_and_stacks_match(tmp_path):
    samples, labels = make_dataset(5, seed=3)
    a, b = str(tmp_path / "a.pickle"), str(tmp_path / "b.pickle")
    tstore.save_dataset(a, samples[:2], labels[:2], append=False)
    tstore.save_dataset(b, samples[2:], labels[2:], append=False)
    for sup_paths in ([b], []):
        want = jstore.load_datasets_with_sup_mask([a, b], sup_paths)
        got = tstore.load_datasets_with_sup_mask([a, b], sup_paths)
        assert got[1] == want[1] and got[2] == want[2]
    stacks_j, stacks_t = jstore.stack_samples(samples), tstore.stack_samples(samples)
    for x, y in zip(stacks_j, stacks_t):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    back = tstore.unstack_samples(*stacks_t)
    np.testing.assert_array_equal(back[4][2], stacks_j[2][4])


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_balance_classes_bit_equal(rng, as_tensor):
    y = np.array([0] * 10 + [1] * 4 + [2] * 7)
    X = rng.random((21, 5)).astype(np.float32)
    yj, Xj = jbalance.balance_classes(y, X)
    yt, Xt = tbalance.balance_classes(y, torch.as_tensor(X) if as_tensor else X)
    np.testing.assert_array_equal(yt, yj)
    if as_tensor:
        assert isinstance(Xt, torch.Tensor) and Xt.device.type == "cpu"
        Xt = Xt.numpy()
    np.testing.assert_array_equal(Xt, Xj)
    _, counts = np.unique(yt, return_counts=True)
    assert set(counts) == {10}


def test_balance_classes_sup_mask_and_shuffle_bit_equal(rng):
    y = np.array([0] * 6 + [1] * 3)
    X = rng.random((9, 4))
    sup = np.array([True] * 5 + [False] * 4)
    for shuffle in (False, True):
        want = jbalance.balance_classes(y, X, sup_mask=sup, shuffle=shuffle)
        got = tbalance.balance_classes(y, X, sup_mask=sup, shuffle=shuffle)
        assert got[0].shape[0] == got[1].size == got[2].size == 12
        for a, b in zip(got, want):  # (data, labels, sup): the SGAN order
            np.testing.assert_array_equal(a, b)


def test_balance_classes_early_return_order(rng):
    """Already balanced: unchanged and unshuffled, in the SGAN variant's
    (data, labels, sup) order with a mask and (labels, data) without."""
    y = np.array([0] * 4 + [1] * 4 + [2] * 4)
    X = rng.random((12, 4))
    sup = np.array([True] * 6 + [False] * 6)
    Xb, yb, supb = tbalance.balance_classes(y, X, sup_mask=sup, shuffle=True)
    np.testing.assert_array_equal(Xb, X)
    np.testing.assert_array_equal(yb, y)
    np.testing.assert_array_equal(supb, sup)
    yb, Xt = tbalance.balance_classes(y, torch.as_tensor(X))
    np.testing.assert_array_equal(yb, y)
    assert torch.equal(Xt, torch.as_tensor(X))


@pytest.mark.parametrize("n,fractions", [(50, (0.8, 0.1, 0.1)), (37, (0.6, 0.3, 0.1))])
def test_split_indices_equal(rng, n, fractions):
    X = rng.random((n, 3))
    y = rng.integers(0, 3, n)
    want = jsplit.train_val_test_split(X, y, fractions)
    got = tsplit.train_val_test_split(X, y, fractions)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    # a list of samples splits into lists, by the same indices
    listed = tsplit.train_val_test_split(list(range(n)), y, fractions)
    for (gx, _), (wx, _) in zip(listed, jsplit.train_val_test_split(
            list(range(n)), y, fractions)):
        assert isinstance(gx, list) and gx == wx
    for frac in (0.2, 0.35):
        for a, b in zip(tsplit.train_test_split_indices(n, frac),
                        jsplit.train_test_split_indices(n, frac)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsplit.train_val_test_split(X, y, (0.5, 0.1, 0.1))
