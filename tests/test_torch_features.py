"""Port parity: the batched featurizers of ops/features (process_samples,
process_views, make_feature_fn) against the JAX package's.

The same synthetic samples (numpy, from a seed) go through both
packages on the CPU. Both run two float32 zoom products per plane in
another summation order, so features agree within atol 1e-6 on the
[0, 1] scale and 1e-6 * 255 unscaled.
"""

import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import ProjMask as JMask, ProjZoom as JZoom
from radarml_tpu.ops import features as jfeat
from radarml_tpu_torch.core.arena import Arena, ProjMask, ProjZoom
from radarml_tpu_torch.data.synthetic import make_dataset
from radarml_tpu_torch.ops import features as tfeat

torch.set_num_threads(1)

SMALL = Arena(r_min=10.0, r_max=60.0, r_res=2.0, theta_min=-12.0,
              theta_max=12.0, theta_res=4.0, phi_min=-6.0, phi_max=6.0,
              phi_res=2.0)  # (7, 7, 26) cube


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("mask", [(True, True, True), (True, False, True)])
def test_process_samples_matches_jax(scale, mask):
    samples, _ = make_dataset(6, seed=3, hardness=1.0)
    got = tfeat.process_samples(samples, proj_mask=ProjMask(*mask), scale=scale,
                                device="cpu")
    want = jfeat.process_samples(samples, proj_mask=JMask(*mask), scale=scale)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape
    atol = 1e-6 if scale else 1e-6 * 255
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize(
    "zoom", [((1.0, 1.0),) * 3, ((1.5, 0.8), (1.2, 0.8), (1.5, 1.2))]
)
def test_process_views_matches_jax(rng, zoom):
    xz = rng.random((5, 7, 26), dtype=np.float32) * 255
    yz = rng.random((5, 7, 26), dtype=np.float32) * 255
    xy = rng.random((5, 7, 7), dtype=np.float32) * 255
    got = tfeat.process_views(torch.from_numpy(xz), yz, xy,
                              proj_zoom=ProjZoom(*zoom), scale=True,
                              device="cpu")
    want = jfeat.process_views(xz, yz, xy, proj_zoom=JZoom(*zoom), scale=True,
                               device=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    spec = tfeat.FeatureSpec(xz_shape=(7, 26), yz_shape=(7, 26), xy_shape=(7, 7),
                             proj_zoom=ProjZoom(*zoom), scale=True)
    assert got.shape == (5, spec.feature_length)


def test_make_feature_fn_on_small_arena_samples():
    samples, _ = make_dataset(4, arena=SMALL, seed=9)
    spec = tfeat.FeatureSpec.for_arena(SMALL, scale=True)
    stacks = [torch.from_numpy(np.stack([s[p] for s in samples])) for p in range(3)]
    got = tfeat.make_feature_fn(spec)(*stacks)
    assert got.shape == (4, spec.feature_length)
    torch.testing.assert_close(got, tfeat.process_samples(samples, scale=True, device="cpu"),
                               rtol=0, atol=0)

