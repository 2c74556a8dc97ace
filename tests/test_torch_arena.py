"""Port parity: core/arena against the JAX package's arena.

Cube indices are integers and must be equal (tolerance 0), including
targets that sit exactly on grid nodes (the 1e-3 nudge before
truncation) and out-of-arena sentinels (clamping). Float coordinate
transforms agree to 1e-4 cm (float32 trig in two libraries).
"""

import numpy as np
import pytest
import torch

from radarml_tpu.core import arena as ja
from radarml_tpu_torch.core import arena as ta

torch.set_num_threads(1)

ARENAS = [
    {},
    dict(r_min=10.0, r_max=60.0, r_res=2.0, theta_min=-12.0, theta_max=12.0,
         theta_res=4.0, phi_min=-6.0, phi_max=6.0, phi_res=2.0),
]


def _targets(rng, arena):
    """Grid nodes (float32, like a sensor's report), jittered points
    and sentinels far outside the arena."""
    n = 400
    cells = np.stack([rng.integers(0, s, n) for s in arena.grid_shape])
    on_grid = np.stack(arena.grid_to_cartesian_np(*cells.astype(np.float64)), -1)
    jitter = on_grid + rng.normal(scale=2.0, size=on_grid.shape)
    sentinels = np.array([
        [0.0, 0.0, 0.0], [0.0, 0.0, 1e4], [500.0, 0.0, 1.0],
        [-500.0, -500.0, -500.0], [0.0, 300.0, 1.0], [1e-3, -1e-3, 5.0],
    ])
    return np.concatenate([on_grid, jitter, sentinels]).astype(np.float32), cells


@pytest.mark.parametrize("kw", ARENAS)
def test_indices_equal_jax(rng, kw):
    jar, tar = ja.Arena(**kw), ta.Arena(**kw)
    assert tar.grid_shape == jar.grid_shape
    assert tar.feature_length == jar.feature_length
    xyz, cells = _targets(rng, jar)
    x, y, z = xyz.T
    for name in ("matrix_indices", "clamped_matrix_indices"):
        want = getattr(jar, name)(x, y, z)
        got = getattr(tar, name)(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(z))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # grid nodes land on their own cell (the nudge before truncation)
    n = cells.shape[1]
    got = tar.matrix_indices(*torch.from_numpy(xyz[:n]).T)
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), cells)


def test_transforms_match_jax(rng):
    arena = ja.DEFAULT_ARENA
    xyz, _ = _targets(rng, arena)
    for g, w in zip(ta.cartesian_to_spherical(*torch.from_numpy(xyz).T),
                    ja.cartesian_to_spherical(*xyz.T)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    ijk = rng.integers(0, 22, (3, 50)).astype(np.float32)
    for g, w in zip(ta.DEFAULT_ARENA.grid_to_cartesian(*ijk),
                    arena.grid_to_cartesian(*ijk)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    for g, w in zip(ta.DEFAULT_ARENA.grid_to_cartesian_np(*ijk),
                    arena.grid_to_cartesian_np(*ijk)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ta.DEFAULT_ARENA.r_axis(), arena.r_axis())


def test_slice_projections_and_validation(rng):
    cube = rng.random(ja.DEFAULT_ARENA.grid_shape).astype(np.float32)
    got = ta.slice_projections(torch.from_numpy(cube), 3, 5, 7)
    want = ja.slice_projections(cube, 3, 5, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="integral"):
        ta.Arena(r_res=3.0)
    assert ta.ProjMask() == tuple(ja.ProjMask())
    assert ta.RADAR_MAX == ja.RADAR_MAX
