"""Port parity: ops/score (kernel B7, the one-read bf16 table kernel of
mode="pallas") against the JAX package's fused_native_score.

The same cubes, indices and templates (numpy, from a seed) go through
the JAX kernel in interpret mode and the port's plain version on the
CPU, at three arenas (the default, one with Z not a multiple of 8, a
tiny one), batches that are not multiples of the TPU kernel's 8 scans
per step, indices at 0 and at each axis's end, and integer 0..255 and
non-integer float cubes (both packages round the cube to bf16, to
nearest even, before the contraction). Tolerances, with their reasons:

* port and JAX differ by at most 1e-5 x max|JAX|: the JAX kernel splits
  each float32 template into bf16 hi + lo halves (~3e-6 relative), the
  port keeps the float32 template (float32 sums);
* each side errs by at most 1e-5 x max|JAX| against a float64 oracle on
  the bf16-rounded cube;
* on the CPU the wrapper IS the plain version (torch.equal).

The CUDA kernel itself runs only on a card: the one test that needs it
is marked `cuda` and skips here. The file imports JAX only inside the
tests that use it, so on the card (no JAX there) that test runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_native_score.py

chip_smoke.py phase 3 holds the kernel to its plain version and a
float64 oracle at the pipeline's shapes.
"""

import numpy as np
import pytest
import torch

from radarml_tpu_torch.ops import score

torch.set_num_threads(1)

DIMS = [(5, 7, 9), (9, 13, 180), (22, 31, 176)]
TOL = 1e-5


def _templates(rng, dims, C=3):
    X, Y, Z = dims
    return [(rng.normal(size=(C,) + s) * 0.01).astype(np.float32)
            for s in ((X, Z), (Y, Z), (X, Y))]


def _cubes(rng, B, dims, kind):
    if kind == "int":
        return rng.integers(0, 256, (B,) + dims).astype(np.float32)
    return (rng.random((B,) + dims) * 255).astype(np.float32)


def _indices(rng, B, dims, T=4):
    """Random cells, with slot 0 at index 0 and slot 1 at each axis's end."""
    ijk = np.stack([rng.integers(0, n, (B, T)) for n in dims], -1).astype(np.int32)
    ijk[:, 0] = 0
    ijk[:, 1] = np.asarray(dims) - 1
    return ijk


def _oracle(cubes, ijk, t, b):
    """float64 decisions on the bf16-rounded cube."""
    v = torch.from_numpy(cubes).to(torch.bfloat16).double().numpy()
    t64 = [a.astype(np.float64) for a in t]
    m1 = np.einsum("cxz,bxyz->bcy", t64[0], v)
    m2 = np.einsum("cyz,bxyz->bcx", t64[1], v)
    m3 = np.einsum("cxy,bxyz->bcz", t64[2], v)
    bi = np.arange(cubes.shape[0])[:, None]
    return m1[bi, :, ijk[..., 1]] + m2[bi, :, ijk[..., 0]] + m3[bi, :, ijk[..., 2]] + b


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_matches_jax_kernel_and_float64(rng, dims, B, kind):
    import jax.numpy as jnp

    from radarml_tpu.ops.pallas_score import fused_native_score as jax_score

    t = _templates(rng, dims)
    b = rng.normal(size=3).astype(np.float32)
    cubes = _cubes(rng, B, dims, kind)
    ijk = _indices(rng, B, dims)
    want = np.asarray(jax_score(jnp.asarray(cubes), jnp.asarray(ijk),
                                *map(jnp.asarray, t), jnp.asarray(b), interpret=True))
    got = score.fused_native_score(torch.from_numpy(cubes), torch.from_numpy(ijk), *t, b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 4, 3)
    got = got.numpy()
    bar = TOL * np.abs(want).max()
    assert np.abs(got - want).max() <= bar
    oracle = _oracle(cubes, ijk, t, b)
    assert np.abs(got - oracle).max() <= bar
    assert np.abs(want - oracle).max() <= bar
    ref = score.fused_native_score_ref(torch.from_numpy(cubes), torch.from_numpy(ijk), *t, b)
    assert torch.equal(ref, torch.from_numpy(got))


def test_wrapper_on_cpu_is_the_plain_version(rng):
    dims = (9, 13, 180)
    tm = score.native_templates(*_templates(rng, dims, C=2))
    cube = torch.from_numpy(_cubes(rng, 5, dims, "float")).to(torch.bfloat16)
    before = score.KERNEL_LAUNCHES
    for g, r in zip(score.native_tables(cube, tm), score.native_tables_ref(cube, tm)):
        assert torch.equal(g, r)
    assert [tuple(m.shape) for m in score.native_tables(cube, tm)] == [
        (5, 2, 13), (5, 2, 9), (5, 2, 180)]
    assert score.KERNEL_LAUNCHES == before  # only a CUDA launch counts


def test_float32_stream_is_cast_to_bf16_first(rng):
    """A float32 cube scores as its bf16 rounding does (JAX's `:220`)."""
    dims = (5, 7, 9)
    t = _templates(rng, dims)
    cubes = torch.from_numpy(_cubes(rng, 3, dims, "float"))
    ijk = torch.from_numpy(_indices(rng, 3, dims))
    b = np.zeros(3, np.float32)
    assert torch.equal(score.fused_native_score(cubes, ijk, *t, b),
                       score.fused_native_score(cubes.to(torch.bfloat16), ijk, *t, b))


def test_shared_memory_check_raises_before_launch(rng):
    """Up to seven classes fit a block's 227 KB at the default arena, eight
    do not; the wrapper refuses on every device, before any launch."""
    dims = (22, 31, 176)
    assert score.shared_memory_bytes(*dims, 5) <= score.SMEM_MAX
    assert score.shared_memory_bytes(*dims, 7) <= score.SMEM_MAX
    assert score.shared_memory_bytes(*dims, 8) > score.SMEM_MAX
    cube = torch.zeros((1,) + dims, dtype=torch.bfloat16)
    score.native_tables(cube, score.native_templates(*_templates(rng, dims, C=7)))
    with pytest.raises(ValueError, match="232448 bytes"):
        score.native_tables(cube, score.native_templates(*_templates(rng, dims, C=8)))
    with pytest.raises(ValueError, match="232448 bytes"):
        score.fused_native_score(cube, np.zeros((1, 1, 3), np.int32),
                                 *_templates(rng, dims, C=8), np.zeros(8, np.float32))


def _earlier_smem_bytes(X, Y, Z, C):
    """Shared memory of the kernel's earlier layout: all three templates
    resident, two slabs, per-slab m2 partials of 8 warps."""
    r, zp = score._round4, (Z + 1) // 2
    zs = 2 * zp
    return 4 * (r(C * X * zs) + r(C * Y * zs) + r(C * X * Y) + 2 * r(Y * zp) + r(C * Y)
                + r(8 * C) + r(C * zs))


@pytest.mark.parametrize("Z", [1, 9, 64, 176, 180, 256])
def test_no_model_that_fitted_stops_fitting(Z):
    """Every (dims, C) that fitted the earlier layout fits this one, and
    the ring holds 2 to 8 stages of which at least 3 at the default
    arena's Y and Z for every C that fits there."""
    for X in range(1, 48, 3):
        for Y in (1, 7, 13, 31, 61, 120, 200):
            for C in range(1, score.MAX_C + 1):
                need = score.shared_memory_bytes(X, Y, Z, C)
                if _earlier_smem_bytes(X, Y, Z, C) <= score.SMEM_MAX:
                    assert need <= score.SMEM_MAX, (X, Y, Z, C)
                assert 2 <= score._layout(X, Y, Z, C)[3] <= 8
    if Z == 176:
        for C in range(1, 8):
            assert score._layout(22, 31, Z, C)[3] >= 3, C


def test_probe_patches_fit_the_source():
    """The kernel probe's native variants patch native_score.cu as it is
    (each patch matches the source exactly once)."""
    from radarml_tpu_torch.utils import kernel_probe

    texts = kernel_probe.variant_sources("native_score", kernel_probe.NATIVE_VARIANTS)
    assert set(texts) == set(kernel_probe.NATIVE_VARIANTS)


@pytest.mark.parametrize(
    "case,err",
    [("cube_dtype", "bfloat16"), ("cube_shape", "does not match"),
     ("templates", "disagree"), ("classes", "at most 8 classes")],
)
def test_wrapper_checks_operands(rng, case, err):
    dims = (5, 7, 9)
    t = _templates(rng, dims)
    cube = torch.zeros((2,) + dims, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=err):
        if case == "cube_dtype":
            score.native_tables(cube.float(), score.native_templates(*t))
        elif case == "cube_shape":
            score.native_tables(cube[:, :, :6], score.native_templates(*t))
        elif case == "templates":
            score.native_templates(t[0], t[1][:, :6], t[2])
        else:
            score.native_tables(cube, score.native_templates(*_templates(rng, dims, C=9)))


# (dims, B, C, misaligned): several scans a block so that the ring wraps
# (B = 300 on 132 SMs), one class, the most that fit at the default arena,
# all eight at a tiny arena, Z = 180 (not a multiple of 8) and a cube 2
# bytes off 16-byte alignment (both the copy route).
CARD_CASES = [((22, 31, 176), 37, 3, False), ((22, 31, 176), 300, 3, False),
              ((22, 31, 176), 9, 1, False), ((22, 31, 176), 9, 5, False),
              ((22, 31, 176), 9, 7, False), ((5, 7, 9), 3, 8, False),
              ((9, 13, 180), 5, 2, False), ((22, 31, 180), 7, 3, False),
              ((5, 7, 9), 3, 5, False), ((22, 31, 176), 7, 3, True)]


@pytest.mark.cuda
def test_kernel_on_the_card():
    """On a card: the wrapper launches the kernel (counted), its tables
    err against float64 at most 2x as much as the plain float32 version's
    (+1e-6 x max|oracle|), are the same bits on a second call, and agree
    with the library's own shared-memory count; a non-contiguous cube
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for dims, B, C, misaligned in CARD_CASES:
        tm = score.native_templates(*_templates(rng, dims, C), device=dev)
        assert score._library().native_score_smem_bytes(*dims, C) == \
            score.shared_memory_bytes(*dims, C)
        values = torch.from_numpy(_cubes(rng, B, dims, "float")).to(dev).to(torch.bfloat16)
        flat = torch.zeros(values.numel() + 1, dtype=torch.bfloat16, device=dev)
        cube = flat[int(misaligned):values.numel() + int(misaligned)].view(values.shape)
        cube.copy_(values)
        assert cube.is_contiguous() and (cube.data_ptr() % 16 != 0) == misaligned
        before = score.KERNEL_LAUNCHES
        got = score.native_tables(cube, tm)
        torch.cuda.synchronize()
        assert score.KERNEL_LAUNCHES == before + 1
        again = score.native_tables(cube, tm)
        v = cube.double()
        oracle = (torch.einsum("cxz,bxyz->bcy", tm.t_xz.double(), v),
                  torch.einsum("cyz,bxyz->bcx", tm.t_yz.double(), v),
                  torch.einsum("cxy,bxyz->bcz", tm.t_xy.double(), v))
        for g, a, r, o in zip(got, again, score.native_tables_ref(cube, tm), oracle):
            assert torch.equal(g, a)
            err_kernel = float((g.double() - o).abs().max())
            err_plain = float((r.double() - o).abs().max())
            assert err_kernel <= 2.0 * err_plain + 1e-6 * float(o.abs().max())
        with pytest.raises(ValueError, match="contiguous"):
            score.native_tables(cube.transpose(1, 2).contiguous().transpose(1, 2), tm)
