"""Port parity: ops/i8_score (the one-pass int8 tables) against the JAX
Pallas kernel and an int64 einsum oracle.

The tables are exact integers, so every comparison here is bit for bit
(tolerance 0). On the CPU the port's wrapper runs its plain version; the
CUDA kernel itself is compared with that plain version on the card by
chip_smoke.py. The JAX kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU.
"""

import numpy as np
import pytest
import torch

from radarml_tpu.core.arena import DEFAULT_ARENA
from radarml_tpu.ops import pallas_i8_score as jk
from radarml_tpu_torch.ops import i8_score as tk

torch.set_num_threads(1)


def _quant(rng, dims, levels, C=3, masked=None):
    """Random per-plane int8 templates as (q, s1, s2, const) tuples."""
    X, Y, Z = dims
    C2 = levels * C
    out = []
    for p, shape in enumerate(((X, Z), (Y, Z), (X, Y))):
        if p == masked:
            out.append(None)
            continue
        q = rng.integers(-127, 128, (C2,) + shape).astype(np.int8)
        s = np.ones((C,), np.float32)
        out.append((q, s, s if levels == 2 else None, s))
    return out


def _oracle(quant, cubes_u8, dims):
    """int64 numpy einsums of the JAX package's test oracle."""
    X, Y, Z = dims
    B = cubes_u8.shape[0]
    v = cubes_u8.astype(np.int64) - 128
    C2 = next(q[0].shape[0] for q in quant if q is not None)
    specs = ("cxz,bxyz->cyb", "cyz,bxyz->cxb", "cxy,bxyz->zcb")
    shapes = ((C2, Y, B), (C2, X, B), (Z, C2, B))
    return [
        np.zeros(shape, np.int64) if q is None
        else np.einsum(spec, q[0].astype(np.int64), v)
        for q, spec, shape in zip(quant, specs, shapes)
    ]


def _jax_tables(quant, cubes_u8, dims, levels):
    """The JAX combo kernel (interpret mode), sliced to [:, :Y, :B]."""
    Y = dims[1]
    B = cubes_u8.shape[0]
    w = jk.build_combined_weights(quant, dims, levels=levels)
    ck = jk.pack_cubes_i8(cubes_u8, y_group=w.y_group)
    m1, m2, m3 = jk.onepass_tables_combined_i8(ck, w, interpret=True)
    return (
        np.asarray(m1)[:, :Y, :B],
        np.asarray(m2)[..., :B],
        np.asarray(m3)[..., :B],
    )


@pytest.mark.parametrize(
    "dims,B,levels,masked",
    [
        ((5, 7, 9), 3, 2, None),
        ((5, 7, 9), 3, 1, None),
        ((4, 35, 9), 3, 2, None),
        ((4, 35, 9), 3, 1, None),
        ((4, 35, 9), 3, 2, 0),  # masked xz plane
        ((5, 7, 9), 3, 1, 2),  # masked xy plane
        (DEFAULT_ARENA.grid_shape, 2, 2, None),
        (DEFAULT_ARENA.grid_shape, 2, 1, 1),  # masked yz plane
    ],
)
def test_tables_match_jax_kernel_and_oracle(rng, dims, B, levels, masked):
    """Plain version == JAX kernel [:, :Y, :B] == int64 oracle, exactly,
    in the JAX axis order; a masked plane gives a zero table."""
    quant = _quant(rng, dims, levels, masked=masked)
    cubes = rng.integers(0, 256, (B,) + dims).astype(np.uint8)
    w = tk.build_combined_weights(quant, dims, levels=levels)
    assert w.dims == dims + (3,) and w.c2 == 3 * levels
    got = tk.onepass_tables_combined_i8(tk.pack_cubes_i8(cubes), w)
    want = _oracle(quant, cubes, dims)
    ref = _jax_tables(
        [None if q is None else (q[0], None, None, None) for q in quant],
        cubes, dims, levels,
    )
    for g, o, j in zip(got, want, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().astype(np.int64), o)
        np.testing.assert_array_equal(g.numpy(), j)
    if masked is not None:
        assert not got[masked].any()


def test_wrapper_on_cpu_is_the_plain_version(rng):
    """On a CPU tensor the wrapper is the plain version and launches
    nothing; the plain version's int64 path equals its float64 path."""
    dims = (4, 35, 9)
    quant = _quant(rng, dims, 2)
    w = tk.build_combined_weights(quant, dims)
    cube = tk.encode_int8_cubes(rng.integers(0, 256, (4,) + dims).astype(np.uint8))
    before = tk.KERNEL_LAUNCHES
    a = tk.onepass_tables_combined_i8(cube, w)
    b = tk.onepass_tables_combined_i8_ref(cube, w)
    assert tk.KERNEL_LAUNCHES == before
    v = cube.to(torch.float64)
    for x, y, (q, spec) in zip(
        a, b,
        zip((w.q_xz, w.q_yz, w.q_xy),
            ("cxz,bxyz->cyb", "cyz,bxyz->cxb", "cxy,bxyz->zcb")),
    ):
        assert torch.equal(x, y)
        assert torch.equal(
            x, torch.einsum(spec, q.to(torch.float64), v).to(torch.int32)
        )


def test_int8_einsum_wraps_so_the_plain_version_widens(rng):
    """torch.einsum on int8 tensors returns int8 and wraps silently; the
    plain version must not."""
    q = torch.full((1, 2, 4), 100, dtype=torch.int8)
    v = torch.full((1, 2, 3, 4), 100, dtype=torch.int8)
    assert torch.einsum("cxz,bxyz->cyb", q, v).dtype == torch.int8
    w = tk.build_combined_weights(
        [(q.numpy(), 1.0, None, 0.0), None, None], (2, 3, 4), levels=1
    )
    m1, _, _ = tk.onepass_tables_combined_i8(v, w)
    assert (m1 == 8 * 100 * 100).all()


def test_weights_check_levels_against_quant(rng):
    dims = (5, 7, 9)
    split = _quant(rng, dims, 2)
    single = _quant(rng, dims, 1)
    with pytest.raises(ValueError, match="levels=1"):
        tk.build_combined_weights(split, dims, levels=1)
    with pytest.raises(ValueError, match="levels=2"):
        tk.build_combined_weights(single, dims, levels=2)
    with pytest.raises(ValueError, match="masked"):
        tk.build_combined_weights([None, None, None], dims)
    w = tk.build_combined_weights(single, dims, levels=1)
    with pytest.raises(ValueError, match="arena dims"):
        tk.onepass_tables_combined_i8(torch.zeros((1, 5, 7, 8), dtype=torch.int8), w)
    with pytest.raises(ValueError, match="int8"):
        tk.onepass_tables_combined_i8(torch.zeros((1, 5, 7, 9)), w)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int8])
def test_encode_matches_jax(rng, dtype):
    """encode_int8_cubes == the JAX package's, on host and tensor input."""
    from radarml_tpu.models.pipeline import encode_int8_cubes as jax_encode

    cubes = rng.integers(0, 256, (2, 3, 4, 5)).astype(dtype)
    want = np.asarray(jax_encode(cubes))
    np.testing.assert_array_equal(tk.encode_int8_cubes(cubes).numpy(), want)
    np.testing.assert_array_equal(
        tk.encode_int8_cubes(torch.from_numpy(cubes)).numpy(), want
    )
    packed = tk.pack_cubes_i8(cubes)
    assert packed.is_contiguous() and packed.dtype == torch.int8
