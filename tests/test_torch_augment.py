"""The port's augmentation ops against the JAX package's (ops/augment.py).

Re-runs the cases of tests/test_augment.py. The applying functions are
held to the JAX package's at the same draws: rotation at the same angles
(within 1e-5: a 16-tap spline sum of float32 coefficients whose
coordinates come from float32 sin/cos), the clipped-zoom operators equal
(both are numpy float64 on the same resample matrices), the palette zoom
at the same indices and the noise at the same scalars (within 1e-6).
The draws themselves come from a torch.Generator and differ from JAX's
keyed PRNG by design; the pipelines are checked for their counts,
balance and clamping.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from radarml_tpu.ops import augment as ja
from radarml_tpu.ops.features import process_samples as j_process_samples
from radarml_tpu_torch.ops import augment as ta
from radarml_tpu_torch.ops.features import process_samples, process_views


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("angle", [-10.0, -1.0, 0.0, 0.7, 5.0, 33.0])
def test_rotate_matches_jax_and_scipy(rng, angle):
    img = rng.random((22, 176)).astype(np.float32)
    want = np.asarray(ja.rotate(jnp.asarray(img), jnp.asarray(angle, jnp.float32)))
    got = ta.rotate(torch.as_tensor(img), angle).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    scipy_ref = ndimage.rotate(img.astype(np.float64), angle, reshape=False)
    np.testing.assert_allclose(got, scipy_ref, atol=5e-5, rtol=1e-4)


def test_rotate_batch_per_sample_angles(rng):
    imgs = rng.random((4, 31, 40)).astype(np.float32)
    angles = np.array([-3.0, 0.0, 1.5, 12.0], np.float32)
    want = np.asarray(ja.rotate_batch(jnp.asarray(imgs), jnp.asarray(angles)))
    got = ta.rotate_batch(torch.as_tensor(imgs), torch.as_tensor(angles)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for i in range(4):  # each plane as if rotated alone
        np.testing.assert_allclose(
            got[i], ta.rotate(torch.as_tensor(imgs[i]), float(angles[i])).numpy(),
            atol=1e-6)


@pytest.mark.parametrize("factor", [0.7, 0.93, 1.0, 1.12, 1.3])
@pytest.mark.parametrize("shape", [(22, 176), (31, 40), (9, 13)])
def test_clipped_zoom_operator_equal(factor, shape):
    for got, want in zip(ta.clipped_zoom_operator(shape, factor),
                         ja.clipped_zoom_operator(shape, factor)):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    fj, rj, cj = ja.zoom_palette(shape, 0.3, 16)
    ft, rt, ct = ta.zoom_palette(shape, 0.3, 16)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(rt, rj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ct, cj, atol=1e-6, rtol=0)


def test_clipped_zoom_batch_same_palette_indices(rng):
    planes = rng.random((5, 31, 40)).astype(np.float32)
    idx = np.array([0, 7, 63, 31, 40])
    _, rows, cols = ja.zoom_palette((31, 40), 0.25, 64)
    want = np.asarray(ja.clipped_zoom_batch(
        jnp.asarray(planes), jnp.asarray(idx),
        jnp.asarray(rows, jnp.float32), jnp.asarray(cols, jnp.float32)))
    got = ta.clipped_zoom_batch(
        torch.as_tensor(planes), torch.as_tensor(idx),
        torch.as_tensor(rows, dtype=torch.float32),
        torch.as_tensor(cols, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sparse_and_add_noise_same_draws(rng):
    planes = rng.random((6, 12, 16)).astype(np.float32)
    planes[planes < 0.5] = 0.0
    key, sd = jax.random.PRNGKey(5), 0.3
    draws = np.array(jax.random.normal(key, (6, 1, 1), jnp.float32) * sd)[:, 0, 0]
    want = np.asarray(ja.sparse_noise(jnp.asarray(planes), key, sd))
    got = ta.sparse_noise(torch.as_tensor(planes), torch.as_tensor(draws)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[planes == 0] == 0).all()  # sparsity kept
    assert got.min() >= 0.0 and got.max() <= 1.0
    signed = planes * 2 - 1
    want = np.asarray(ja.add_noise(jnp.asarray(signed), key, sd))
    got = ta.add_noise(torch.as_tensor(signed), torch.as_tensor(draws)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_draws_are_seeded_and_in_range():
    a = ta.draw_angles(64, 15.0, _gen(3))
    assert torch.equal(a, ta.draw_angles(64, 15.0, _gen(3)))
    assert float(a.abs().max()) <= 15.0 and a.dtype == torch.float32
    z = ta.draw_zoom_indices(64, 8, _gen(3))
    assert int(z.min()) >= 0 and int(z.max()) < 8
    n = ta.draw_noise(4096, 0.2, _gen(3))
    assert abs(float(n.std()) - 0.2) < 0.02


def test_augment_samples_counts_and_balance(rng):
    # 3 samples of class 0, 1 of class 1 → balance weight 3 for class 1.
    views = tuple(rng.random((4, 12, 16)).astype(np.float32) for _ in range(3))
    labels = np.array([0, 0, 0, 1])
    (axz, ayz, axy), ay = ta.augment_samples(
        views, labels, _gen(2),
        rotation_range=5.0, zoom_range=0.2, noise_sd=0.1, balance=True,
    )
    # replication: class0 ×1 each, class1 ×3 → 6 replicated samples,
    # ×3 transforms = 18 augmented samples.
    assert len(ay) == 18
    assert axz.shape == (18, 12, 16) and axz.device.type == "cpu"
    assert (ay == 1).sum() == 9
    for v in (axz, ayz, axy):
        assert float(v.min()) >= 0.0 and float(v.max()) <= 1.0
    (nz, _, _), ny = ta.augment_samples(views, labels, _gen(2))
    assert nz.shape == (0, 12, 16) and ny.shape == (0,)


def test_augment_samples_rotation_block_is_rotate_batch(rng):
    """The rotated block is rotate_batch of the replicated views at the
    generator's first draws (one angle set a view), clamped to [0, 1]."""
    views = tuple(rng.random((3, 12, 16)).astype(np.float32) for _ in range(3))
    (axz, ayz, _), ay = ta.augment_samples(views, np.array([0, 1, 2]), _gen(9),
                                           rotation_range=20.0)
    g = _gen(9)
    for v, got in zip(views, (axz, ayz)):
        angles = ta.draw_angles(3, 20.0, g)
        want = np.asarray(ja.rotate_batch(jnp.asarray(v), jnp.asarray(angles.numpy())))
        np.testing.assert_allclose(got.numpy(), np.clip(want, 0, 1), atol=1e-5)
    np.testing.assert_array_equal(ay, [0, 1, 2])


def test_augment_multiview_shapes_and_clamp(rng):
    views = tuple(
        (rng.random((5, 16, 20)).astype(np.float32) - 0.5) * 2 for _ in range(3)
    )
    out = ta.augment_multiview(views, _gen(3), rotation_range=1.0,
                               zoom_range=0.3, noise_sd=0.2)
    assert all(tuple(o.shape) == v.shape for o, v in zip(out, views))
    assert all(float(o.min()) >= -1.0 and float(o.max()) <= 1.0 for o in out)


def test_process_views_of_augmented_stacks_equals_process_samples(rng):
    views = tuple(
        rng.random((6, h, w)).astype(np.float32)
        for h, w in ((22, 176), (31, 176), (22, 31))
    )
    (axz, ayz, axy), ay = ta.augment_samples(
        views, np.array([0, 0, 1, 1, 2, 2]), _gen(4),
        rotation_range=10.0, zoom_range=0.25, noise_sd=0.15, balance=True,
    )
    samples = [(axz[i].numpy(), ayz[i].numpy(), axy[i].numpy()) for i in range(len(ay))]
    a = process_samples(samples, scale=True, device="cpu")
    b = process_views(axz, ayz, axy, scale=True, device="cpu")
    assert torch.equal(a, b)
    j = j_process_samples(samples, scale=True)
    np.testing.assert_allclose(b.numpy(), j, atol=1e-6, rtol=0)
