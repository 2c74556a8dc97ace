"""Port parity: ops/rbf (kernel B6, the fused RBF Gram matrix) against
the JAX package's rbf_gram and kernel_matrix.

The same rows (numpy, from a seed) go through both packages on the CPU.
Tolerances, with their reasons:

* at F=50 the plain version and the JAX kernel (interpret mode) and XLA
  formulation agree within atol 1e-5, the bar of
  tests/test_svc.py::test_pallas_rbf_gram_matches_xla;
* at F=10,010 (the default arena) the plain version is held to a
  float64 oracle: |x|^2 + |s|^2 - 2<x,s> cancels for near points, and a
  float32 sum of F terms errs by at most F * 2^-24 times the sum of their
  magnitudes (the standard bound), which over the three sums is at most
  2 (|x|^2 + |s|^2); so the distance errs by at most
  2 F 2^-24 (|x|^2 + |s|^2) and K, whose slope is at most gamma, by gamma
  times that;
* on the CPU the wrapper IS the plain version (torch.equal);
* the CUDA kernel's formulation (3xTF32: hi = tf32(a), lo = a - hi, the
  product summed as lo*hi + hi*lo + hi*hi from zero for every stage of 32
  columns, those sums added in float32 in two more levels, norms and
  distance in double) is emulated here in numpy at F=10,010 and held to
  the bar chip_smoke.py holds the kernel to: its error against float64 is
  at most 2x the plain version's + 1e-6. The emulation sums the products
  of a stage exactly, where the tensor core truncates; that part only a
  run on the card shows. Dropping the two correction terms breaks the bar, so the
  test can fail.

The CUDA kernel itself runs only on a card: the one test that needs it
is marked `cuda` and skips here. The file imports JAX only inside the
tests that use it, so on the card (no JAX there) that test runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rbf.py

chip_smoke.py phase 7 holds the kernel to the float64 oracle at the
serving and training shapes.
"""

import numpy as np
import pytest
import torch

from radarml_tpu_torch.ops import rbf

torch.set_num_threads(1)


def _rows(rng, n, m, F, near=False):
    X = rng.normal(size=(n, F)).astype(np.float32)
    if near:  # rows of S close to rows of X: the cancelling case
        S = X[rng.integers(0, n, m)] + 0.01 * rng.normal(size=(m, F))
    else:
        S = rng.normal(size=(m, F))
    return X, S.astype(np.float32)


@pytest.mark.parametrize("n,m", [(37, 23), (1, 5), (16, 16), (33, 130)])
@pytest.mark.parametrize("near", [False, True])
def test_plain_matches_jax_kernel_and_xla(rng, n, m, near):
    import jax.numpy as jnp

    from radarml_tpu.models import svc as jsvc
    from radarml_tpu.ops.pallas_rbf import rbf_gram as jax_rbf_gram

    X, S = _rows(rng, n, m, 50, near)
    got = rbf.rbf_gram_ref(torch.from_numpy(X), torch.from_numpy(S), 0.05).numpy()
    assert got.shape == (n, m) and got.dtype == np.float32
    pallas = np.asarray(jax_rbf_gram(jnp.asarray(X), jnp.asarray(S), 0.05,
                                     tile_n=16, tile_m=16, interpret=True))
    xla = np.asarray(jsvc.kernel_matrix(jnp.asarray(X), jnp.asarray(S), "rbf", 0.05))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    X, S = (torch.from_numpy(a) for a in _rows(rng, 20, 9, 31))
    before = rbf.KERNEL_LAUNCHES
    assert torch.equal(rbf.rbf_gram(X, S, 0.1), rbf.rbf_gram_ref(X, S, 0.1))
    assert rbf.KERNEL_LAUNCHES == before  # only a CUDA launch counts


def _features(n, seed):
    """Scaled radar features at the default arena (F = 10,010)."""
    from radarml_tpu_torch.data.synthetic import make_dataset
    from radarml_tpu_torch.ops.features import process_samples

    samples, _ = make_dataset(n, seed=seed, hardness=1.0)
    return process_samples(samples, scale=True, device="cpu").numpy()


@pytest.mark.parametrize("kind", ["radar", "uniform"])
@pytest.mark.parametrize("gamma", [0.001, 0.01, 0.1])
def test_plain_at_full_width_against_float64(rng, kind, gamma):
    if kind == "radar":
        base = _features(12, seed=5)
        X = base[rng.integers(0, 12, 24)] + 0.02 * rng.normal(size=(24, base.shape[1]))
        X = np.clip(X, 0.0, None).astype(np.float32)
        S = np.concatenate([base, X[:4]]).astype(np.float32)
    else:
        X = rng.random((24, 10010), dtype=np.float32)
        S = rng.random((16, 10010), dtype=np.float32)
    got = rbf.rbf_gram_ref(torch.from_numpy(X), torch.from_numpy(S), gamma).numpy()
    X64, S64 = X.astype(np.float64), S.astype(np.float64)
    xx, ss = (X64 ** 2).sum(1), (S64 ** 2).sum(1)
    d2 = np.maximum(xx[:, None] + ss[None, :] - 2.0 * X64 @ S64.T, 0.0)
    want = np.exp(-gamma * d2)
    bound = 2.0 * gamma * X.shape[1] * 2.0 ** -24 * (xx[:, None] + ss[None, :])
    assert (np.abs(got - want) <= bound + 1e-7).all()


K_STAGE = 32  # columns of F the tensor core sums from zero (a stage of 4 k-steps)
K_GROUP = 20  # stages added in registers before they join the running tile


def _tf32_hi(a):
    """cvt.rna.tf32.f32 on finite float32: round to nearest, ties away,
    by bit arithmetic on the words."""
    bits = a.view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(a):
    """What the tensor core reads of a float32 operand: the low 13 bits dropped."""
    return (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulated_kernel(X, S, gamma, corrections=True):
    """csrc/rbf_gram.cu's arithmetic in numpy. X is split in registers (lo
    keeps its low bits, which the tensor core drops), S by the pack pass
    (lo rounded to TF32); TF32 x TF32 products are exact in float64."""
    x_hi = _tf32_hi(X)
    x_lo = _tf32_trunc(X - x_hi)
    s_hi = _tf32_hi(S)
    s_lo = _tf32_hi(S - s_hi)
    n, F = X.shape
    run = np.zeros((n, S.shape[0]), np.float32)
    mid = np.zeros_like(run)
    f64 = np.float64
    for k in range(0, F, K_STAGE):
        sl = slice(k, k + K_STAGE)
        part = x_hi[:, sl].astype(f64) @ s_hi[:, sl].astype(f64).T
        if corrections:
            part += x_lo[:, sl].astype(f64) @ s_hi[:, sl].astype(f64).T
            part += x_hi[:, sl].astype(f64) @ s_lo[:, sl].astype(f64).T
        mid += part.astype(np.float32)
        if (k + K_STAGE) % (K_STAGE * K_GROUP) == 0:
            run += mid
            mid[:] = 0
    run += mid
    xx = (X.astype(f64) ** 2).sum(1)
    ss = (S.astype(f64) ** 2).sum(1)
    d2 = np.maximum(xx[:, None] + ss[None, :] - 2.0 * run.astype(f64), 0.0)
    return np.exp(-np.float32(gamma) * d2.astype(np.float32))


@pytest.mark.parametrize("kind", ["radar", "uniform"])
@pytest.mark.parametrize("gamma", [0.001, 0.01, 0.1])
def test_kernel_formulation_at_full_width_against_float64(rng, kind, gamma):
    if kind == "radar":
        base = _features(12, seed=5)
        X = base[rng.integers(0, 12, 24)] + 0.02 * rng.normal(size=(24, base.shape[1]))
        X = np.clip(X, 0.0, None).astype(np.float32)
        far = base
    else:
        X = rng.random((24, 10010), dtype=np.float32)
        far = rng.random((12, 10010), dtype=np.float32)
    # exact copies (d2 = 0, clamped from one side) and near rows (d2 ~ 1,
    # where an error of either sign shows)
    near = X[4:8] + 0.01 * rng.normal(size=(4, X.shape[1]))
    S = np.concatenate([far, X[:4], near]).astype(np.float32)
    X64, S64 = X.astype(np.float64), S.astype(np.float64)
    d2 = np.maximum((X64 ** 2).sum(1)[:, None] + (S64 ** 2).sum(1)[None, :]
                    - 2.0 * X64 @ S64.T, 0.0)
    want = np.exp(-gamma * d2)
    plain = rbf.rbf_gram_ref(torch.from_numpy(X), torch.from_numpy(S), gamma).numpy()
    bar = 2.0 * np.abs(plain - want).max() + 1e-6
    assert np.abs(_emulated_kernel(X, S, gamma) - want).max() <= bar
    # one TF32 product alone keeps 11 bits of each factor: not enough
    assert np.abs(_emulated_kernel(X, S, gamma, corrections=False) - want).max() > bar


@pytest.mark.parametrize(
    "X,S,err",
    [
        (torch.zeros(4, 3, dtype=torch.float64), torch.zeros(2, 3), "float32"),
        (torch.zeros(4), torch.zeros(2, 4), "2-D"),
        (torch.zeros(4, 3), torch.zeros(2, 5), "features"),
    ],
)
def test_wrapper_checks_inputs(X, S, err):
    with pytest.raises(ValueError, match=err):
        rbf.rbf_gram(X, S, 0.1)


def _probe_variants():
    from radarml_tpu_torch.utils import kernel_probe

    return sorted(kernel_probe.RBF_VARIANTS)


@pytest.mark.parametrize("variant", _probe_variants())
def test_probe_patches_fit_the_source(variant):
    """utils/kernel_probe.py builds variants of csrc/rbf_gram.cu by text
    patches; every patch must match the committed source exactly once, and
    only `as_committed` leaves it as it is."""
    from radarml_tpu_torch.ops import _cuda_build
    from radarml_tpu_torch.utils import kernel_probe

    source = (_cuda_build.CSRC / "rbf_gram.cu").read_text()
    text = kernel_probe.patched(source, kernel_probe.RBF_VARIANTS[variant])
    assert (text == source) == (variant == "as_committed")
    with pytest.raises(RuntimeError, match="matches 0 times"):
        kernel_probe.patched(source, [("no such line in the source", "")])


@pytest.mark.cuda
def test_kernel_on_the_card():
    """On a card: the wrapper launches the kernel (counted), agrees with a
    float64 oracle as closely as the plain version at an odd F, on views
    that start one row into their buffer, at F = 1 and 7 and on ragged
    shapes, and raises on a non-contiguous input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def held(X, S, gamma, slack=1e-6):
        before = rbf.KERNEL_LAUNCHES
        got = rbf.rbf_gram(X, S, gamma)
        torch.cuda.synchronize()
        assert rbf.KERNEL_LAUNCHES == before + 1
        assert got.shape == (X.shape[0], S.shape[0]) and got.dtype == torch.float32
        X64, S64 = X.double(), S.double()
        d2 = ((X64 ** 2).sum(1)[:, None] + (S64 ** 2).sum(1)[None, :]
              - 2.0 * X64 @ S64.T).clamp(min=0.0)
        want = torch.exp(-gamma * d2)
        err_kernel = float((got.double() - want).abs().max())
        err_plain = float((rbf.rbf_gram_ref(X, S, gamma).double() - want).abs().max())
        assert err_kernel <= 2.0 * err_plain + slack, (tuple(X.shape), tuple(S.shape), gamma)

    X, S = (torch.from_numpy(a).to(dev) for a in _rows(rng, 300, 131, 10009, True))
    held(X, S, 0.01)  # odd F: rows 4-byte aligned
    held(X[1:], S[1:], 0.01)  # contiguous views one row into their buffers
    X, S = (torch.from_numpy(a).to(dev) for a in _rows(rng, 301, 257, 10010, True))
    held(X[1:], S, 0.1)  # 8-byte aligned rows, more than one tile each way
    for n, m, F in [(5, 7, 1), (130, 129, 7), (37, 23, 50), (130, 70, 33), (129, 65, 64)]:
        X, S = (torch.from_numpy(a).to(dev) for a in _rows(rng, n, m, F, n >= m))
        held(X, S, 0.05)
    # One row or column: with a single near pair the plain version's worst
    # error is luck (it can be 0: 4e-8 to 2e-7 here, the kernel's 4e-7 to
    # 8e-7 on an NVIDIA H100 80GB HBM3), so these edges get 2e-6 absolute.
    for n, m, F in [(1, 1, 33), (129, 1, 64), (1, 130, 40)]:
        X, S = (torch.from_numpy(a).to(dev) for a in _rows(rng, n, m, F, n >= m))
        held(X, S, 0.05, slack=2e-6)
    with pytest.raises(ValueError, match="contiguous"):
        rbf.rbf_gram(X[:, ::2], S[:, ::2], 0.01)
