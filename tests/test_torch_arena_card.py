"""Cube indices on a CUDA card against the CPU's (ROADMAP.md C).

`clamped_matrix_indices` truncates float32 spherical coordinates, as the
JAX package does on its device. The card's atan2 / asin / sqrt may round
an ulp away from the CPU's, so an index value within float32 rounding of
an integer can truncate to the neighbouring cell. On the 40,000-target
probe that chip_smoke.py phase 4 also uses (`make_grid_probe()`: 20,000
grid nodes of the default arena and the same nodes jittered by 1 cm),
the card-only test pins what may differ: every difference is one cell,
both devices' values lie within 1e-4 of an integer there, and at most
1e-4 of the 120,000 indices differ. On an H100 two j indices of this
probe differ from the CPU's by one cell (17.9999981 on the CPU against
18.0000000 on the card, and 23.9999981 against 24.0000000). The index math stays in float32 on
the device; it is not moved to the host or to float64.

The file imports JAX only inside the CPU test that uses it, so on the
card (no JAX there) the card-only test runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_arena_card.py
"""

import numpy as np
import pytest
import torch

from radarml_tpu_torch.core.arena import DEFAULT_ARENA
from radarml_tpu_torch.data.synthetic import make_grid_probe

torch.set_num_threads(1)


def test_probe_indices_equal_jax_on_cpu():
    """On the CPU the probe's indices equal the JAX package's, and
    matrix_indices is index_values truncated."""
    from radarml_tpu.core.arena import DEFAULT_ARENA as J_DEFAULT

    pts = make_grid_probe()
    assert pts.shape == (40000, 3) and pts.dtype == np.float32
    got = DEFAULT_ARENA.clamped_matrix_indices(*torch.from_numpy(pts).T)
    for g, w in zip(got, J_DEFAULT.clamped_matrix_indices(*pts.T)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vals = DEFAULT_ARENA.index_values(*torch.from_numpy(pts).T)
    for v, m in zip(vals, DEFAULT_ARENA.matrix_indices(*torch.from_numpy(pts).T)):
        assert v.dtype == torch.float32
        assert torch.equal(torch.trunc(v).to(torch.int32), m)


@pytest.mark.cuda
def test_card_indices_differ_from_cpu_only_at_cell_boundaries():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pts = torch.from_numpy(make_grid_probe())
    on_card = pts.to("cuda")
    n_diff = 0
    for a, b, v, w in zip(
        DEFAULT_ARENA.clamped_matrix_indices(*pts.T),
        DEFAULT_ARENA.clamped_matrix_indices(*on_card.T),
        DEFAULT_ARENA.index_values(*pts.T),
        DEFAULT_ARENA.index_values(*on_card.T),
    ):
        b, w = b.cpu(), w.cpu()
        d = a != b
        n_diff += int(d.sum())
        assert ((a[d] - b[d]).abs() == 1).all()
        for u in (v[d], w[d]):
            assert ((u - u.round()).abs() <= 1e-4).all()
    assert n_diff <= 1e-4 * 3 * len(pts)
