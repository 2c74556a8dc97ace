"""data/preprocess.py of the port against the JAX package's.

The same seeded samples go through both packages' preprocess_multiview:
the views agree within 1e-6 (both resize with PIL-parity bicubic
matrices in float32, in a different summation order), and the labels,
class weights, supervised masks and encoders are equal, because the
shuffle, the split and the balancing draw from the same numpy streams.
Augmentation is switched off by an identity augment function, which on
the JAX side makes the one `rng.integers(2**31)` draw its apps' augment
functions make (and the port makes for its torch.Generator).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarml_tpu.data import preprocess as jpre
from radarml_tpu_torch.data import preprocess as tpre
from radarml_tpu_torch.data.synthetic import make_dataset

VIEW_ATOL = 1e-6
RESCALE = (16, 16)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    samples, labels = make_dataset(30, seed=7)
    # an unbalanced set, so that balancing resamples
    keep = [i for i, l in enumerate(labels) if l != "cat" or i % 3 == 0]
    sup = [i % 4 != 1 for i in range(len(keep))]
    return [samples[i] for i in keep], [labels[i] for i in keep], sup


def jax_identity(views, rng):
    rng.integers(2**31)
    return views


def torch_identity(views, generator):
    assert isinstance(generator, torch.Generator)
    return views


def check_equal(j, t):
    assert set(j) == set(t)
    for key in ("X_train", "X_val"):
        tv = t[key].cpu().numpy() if isinstance(t[key], torch.Tensor) else t[key]
        assert tv.shape == tuple(np.asarray(j[key]).shape) and tv.dtype == np.float32
        np.testing.assert_allclose(tv, np.asarray(j[key]), rtol=0, atol=VIEW_ATOL)
    for key in ("y_train", "y_val", "sup_train"):
        if key in j:
            np.testing.assert_array_equal(t[key], np.asarray(j[key]))
    assert t["w_classes"] == j["w_classes"]
    assert t["n_classes"] == j["n_classes"]
    assert tuple(t["label_encoder"].classes_) == tuple(j["label_encoder"].classes_)


@pytest.mark.parametrize("case", [
    dict(),
    dict(train_split=0.6, augment="replace"),
    dict(augment="train_concat", augment_copies=2),
    dict(sup=True, balance=True),
    dict(sup=True, balance=True, train_split=1.0),
    dict(sup=True, balance=True, augment="train_concat", augment_copies=1),
    dict(balance=True, device="cpu"),
], ids=["split", "replace", "train_concat", "sup_balance", "sup_balance_no_val",
        "sup_balance_train_concat", "balance_on_device"])
def test_preprocess_multiview_matches_jax(data, case):
    samples, labels, sup = data
    kw = dict(train_split=case.get("train_split", 0.8), balance=case.get("balance", False),
              augment_copies=case.get("augment_copies", 1), seed=11)
    if case.get("sup"):
        kw["sup_mask"] = sup
    mode = case.get("augment")
    j = jpre.preprocess_multiview(
        samples, labels, RESCALE, augment_fn=jax_identity if mode else None,
        augment_mode=mode or "replace", **kw)
    t = tpre.preprocess_multiview(
        samples, labels, RESCALE, augment_fn=torch_identity if mode else None,
        augment_mode=mode or "replace", device=case.get("device", False), **kw)
    if case.get("device"):
        assert isinstance(t["X_train"], torch.Tensor)
        assert t["X_train"].device.type == "cpu"
    check_equal(j, t)


def test_resize_views_and_scalings_match_jax(data):
    samples, _, _ = data
    xz, yz, xy = (np.stack([s[i] for s in samples]).astype(np.float32) for i in range(3))
    got = tpre.resize_views(*map(tpre.scale_to_symmetric, (xz, yz, xy)), (80, 80),
                            device="cpu")
    want = jpre.resize_views(*map(jpre.scale_to_symmetric, (xz, yz, xy)), (80, 80))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=VIEW_ATOL)
    np.testing.assert_allclose(tpre.unscale_from_symmetric(tpre.scale_to_symmetric(xz)),
                               xz, atol=1e-4)
    np.testing.assert_array_equal(tpre.scale_to_unit_interval(xz),
                                  np.asarray(jpre.scale_to_unit_interval(jnp.asarray(xz))))


def test_preprocess_rejects_bad_modes(data):
    samples, labels, _ = data
    with pytest.raises(ValueError):
        tpre.preprocess_multiview(samples, labels, RESCALE, augment_mode="bogus")
    with pytest.raises(ValueError):
        tpre.preprocess_multiview(samples, labels, RESCALE, augment_copies=-1)


def test_augment_multiview_runs_in_the_pipeline(data):
    from radarml_tpu_torch.ops.augment import augment_multiview

    samples, labels, _ = data
    out = tpre.preprocess_multiview(samples, labels, RESCALE, augment_fn=augment_multiview,
                                    augment_mode="train_concat", device="cpu")
    clean = tpre.preprocess_multiview(samples, labels, RESCALE, device="cpu")
    n_train = int(len(labels) * 0.8)
    assert out["X_train"].shape == (2 * n_train,) + RESCALE + (3,)
    assert torch.isfinite(out["X_train"]).all()
    # the clean training set first, then its augmented copy; validation clean
    torch.testing.assert_close(out["X_train"][:n_train], clean["X_train"], rtol=0, atol=0)
    torch.testing.assert_close(out["X_val"], clean["X_val"], rtol=0, atol=0)
    assert not torch.equal(out["X_train"][n_train:], clean["X_train"])
