"""Port parity: ops/i8_score (the one-pass int8 tables) against the JAX
Pallas kernel and an int64 einsum oracle.

The tables are exact integers, so every comparison here is bit for bit
(tolerance 0). On the CPU the port's wrapper runs its plain version; the
CUDA kernel itself is compared with that plain version on the card by
chip_smoke.py and by the one test here that is marked `cuda` and skips
without a card. The JAX kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU. The file imports the JAX package
only inside the tests that use it, so on the card (no JAX there) that
test runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_i8_score.py
"""

import numpy as np
import pytest
import torch

from radarml_tpu_torch.core.arena import DEFAULT_ARENA
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
    from radarml_tpu.ops import pallas_i8_score as jk

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


def _probe_variants():
    from radarml_tpu_torch.utils import kernel_probe

    return sorted(kernel_probe.I8_VARIANTS) + sorted(kernel_probe.BATCH_VARIANTS)


@pytest.mark.parametrize("Z", [9, 176, 180, 351, 400])
def test_int8_plan_mirror_keeps_every_shape(Z):
    """The host mirror of the int8 kernels' plan (ops/i8_score.
    whole_scan_plan, which chip_smoke.py's phase 3 holds to the CUDA
    source's): every shape the layout without a staged route took (qxz
    resident, slabs by whole 16-byte units or byte loads) still has a
    plan; shapes whose rows are whole 16-byte units keep it, but where one
    block of two n-tiles takes all the class rows at slabs at least
    WIDE_SLAB x rows wide; rows that are not take the staged route
    wherever one class row fits it (its staging area costs a slab, so at a
    small X its slabs can be narrower than the byte-load route's were)."""

    def unstaged(X, Y, C2):
        for ng in range(-(-C2 // tk.MAX_GROUP_ROWS), C2 + 1):
            cg = -(-C2 // ng)
            xs = tk._width(X, Y, Z, cg, (True,) * 3, False)
            if xs:
                return cg, xs
        return None

    for X in (1, 5, 22, 43):
        for Y in (1, 7, 31, 61, 120, 144, 150):
            for C2 in (1, 3, 6, 9, 16):
                old, new = unstaged(X, Y, C2), tk.whole_scan_plan(X, Y, Z, C2)
                where = (X, Y, Z, C2)
                if old is not None:
                    assert new is not None, where
                if new is not None:
                    rows, xs = new
                    staged = tk.staged_route(X, Y, Z)
                    assert tk.layout_bytes(xs, 1, X, Y, Z, rows, staged=staged) <= tk.SMEM_MAX
                    assert staged == (Z % 16 != 0 and tk._width(X, Y, Z, 1, (True,) * 3,
                                                                 True) > 0), where
                    if rows > tk.MAX_GROUP_ROWS:  # one block of two n-tiles, wide slabs
                        assert rows == C2 and xs >= min(X, tk.WIDE_SLAB), where
                    elif Z % 16 == 0:
                        assert new == old, where
    if Z == 351:  # the finer arena: slabs five x rows wide where they were one
        assert unstaged(43, 31, 6) == (6, 1) and tk.whole_scan_plan(43, 31, 351, 6) == (6, 5)


# The listed shapes: the default arena and the three finer ones.
LISTED_DIMS = [(22, 31, 176), (43, 31, 351), (22, 31, 351), (43, 61, 351)]


@pytest.mark.parametrize("C2", range(1, 33))
@pytest.mark.parametrize("dims", LISTED_DIMS, ids=lambda d: "x".join(map(str, d)))
def test_int8_plan_takes_one_block_where_slabs_stay_wide(dims, C2):
    """Every class row count the JAX package serves at the listed shapes
    (C2 = levels x C: 1 to 32 at levels 1, the even ones at levels 2) has a
    plan, and its block fits SMEM_MAX. Past one n-tile, all the class rows
    go to one block a scan (up to MAX_TILES n-tiles) exactly where that
    block's slabs are at least WIDE_SLAB x rows wide (t2's 16-row tiles
    half full); otherwise the blocks a scan are the fewest class groups of
    at most MAX_GROUP_ROWS rows that fit. At the default arena the plan
    up to 8 rows is the earlier one (C2 rows, slabs 11 x rows wide), 9 and
    10 rows (9 classes at levels 1, 5 at levels 2) take one block with
    slabs 8 x rows wide, and the rest class groups at 11. A batch of fewer
    than ONE_BLOCK_SCANS_PER_SM scans an SM takes class groups in place of
    the one block (ops/i8_score.batch_plan)."""
    X, Y, Z = dims
    rows, xs = tk.whole_scan_plan(*dims, C2)
    staged = tk.staged_route(*dims)
    assert tk.layout_bytes(xs, 1, X, Y, Z, rows, staged=staged) <= tk.SMEM_MAX
    one = (tk.MAX_GROUP_ROWS < C2 <= tk.MAX_TILES * tk.MAX_GROUP_ROWS
           and tk._width(X, Y, Z, C2, (True,) * 3, staged) >= min(X, tk.WIDE_SLAB))
    if one:
        assert rows == C2 and xs == tk._width(X, Y, Z, C2, (True,) * 3, staged)
    else:
        assert rows <= tk.MAX_GROUP_ROWS
        for ng in range(-(-C2 // tk.MAX_GROUP_ROWS), -(-C2 // rows)):
            assert tk.layout_bytes(1, 1, X, Y, Z, -(-C2 // ng), staged=staged) > tk.SMEM_MAX
    if dims == (22, 31, 176):
        assert (rows, xs) == ((C2, 11) if C2 <= 8 else (C2, 8) if C2 <= 10
                              else (-(-C2 // -(-C2 // 8)), 11))
    elif C2 <= 8:
        assert not one
    # below a batch of five scans an SM the one block gives way to class groups
    assert tk.batch_plan(660, 132, *dims, C2) == tk.batch_plan(4096, 132, *dims, C2) == (rows, xs)
    for B in (64, 659):
        groups = tk.batch_plan(B, 132, *dims, C2)
        assert groups == (rows, xs) if not one else groups[0] <= tk.MAX_GROUP_ROWS


@pytest.mark.parametrize("variant", _probe_variants())
def test_probe_patches_fit_the_source(variant):
    """utils/kernel_probe.py builds variants of csrc/i8_score.cu by text
    patches (its i8 and batches sections); every patch must match the committed source exactly once, and
    only `as_committed` leaves it as it is."""
    from radarml_tpu_torch.ops import _cuda_build
    from radarml_tpu_torch.utils import kernel_probe

    source = (_cuda_build.CSRC / "i8_score.cu").read_text()
    text = kernel_probe.patched(
        source, (kernel_probe.I8_VARIANTS | kernel_probe.BATCH_VARIANTS)[variant])
    assert (text == source) == (variant == "as_committed")
    with pytest.raises(RuntimeError, match="matches 0 times"):
        kernel_probe.patched(source, [("no such line in the source", "")])


@pytest.mark.cuda
def test_kernel_on_the_card():
    """On a card: the wrapper launches the kernel (counted) and every table
    equals the plain version bit for bit, at B = 1, 7 and 300, an odd and a
    small arena, each plane masked, levels 1 and 2, 1 to 8 class rows and
    past them (one block of two n-tiles: 9, 10 rows, also each plane
    masked; class groups: 11, 16, 18, 32 rows), the finer scan arenas (Z =
    351, the staged route), and a cube view that starts one byte into its
    buffer (at the default arena the byte-copy path, at 3 and 5 classes,
    at 43 x 31 x 351 the staged route); a shape no plan takes is refused
    before any launch, naming the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    default = DEFAULT_ARENA.grid_shape

    def held(dims, B, w, offset=0):
        n = B * dims[0] * dims[1] * dims[2]
        flat = torch.from_numpy(rng.integers(-128, 128, n + 1, dtype=np.int8)).to(dev)
        cube = flat[offset:n + offset].view((B,) + dims)
        before = tk.KERNEL_LAUNCHES
        got = tk.onepass_tables_combined_i8(cube, w)
        torch.cuda.synchronize()
        assert tk.KERNEL_LAUNCHES == before + 1
        for g, r, q in zip(got, tk.onepass_tables_combined_i8_ref(cube, w),
                           (w.q_xz, w.q_yz, w.q_xy)):
            assert g.dtype == torch.int32 and torch.equal(g, r), (dims, B, w.c2, offset)
            assert q is not None or not g.any()

    for dims, B, levels, masked in (
        [(default, B, 2, None) for B in (1, 7, 300)]
        + [(default, 7, 2, m) for m in (0, 1, 2)]
        + [(default, 7, 1, None), (default, 300, 1, 1)]
        + [((9, 13, 180), 33, 2, None), ((9, 13, 180), 5, 1, 2),
           ((5, 7, 9), 5, 2, None), ((5, 7, 9), 1, 1, 0)]
    ):
        held(dims, B, tk.build_combined_weights(
            _quant(rng, dims, levels, masked=masked), dims, levels=levels, device=dev))
    for dims, rows in ((default, (*range(1, 9), 9, 10, 11, 16, 18, 32)),
                       ((9, 13, 180), (*range(1, 9), 10, 18)), ((5, 7, 9), (*range(1, 9), 9, 16)),
                       ((43, 31, 351), (3, 6, 9, 10)), ((22, 31, 351), (6, 10)),
                       ((43, 61, 351), (6, 10))):
        X, Y, Z = dims
        for c2 in rows:
            q = [torch.from_numpy(rng.integers(-127, 128, (c2,) + s).astype(np.int8)).to(dev)
                 for s in ((X, Z), (Y, Z), (X, Y))]
            # past one n-tile a batch of at least five scans an SM (one block
            # of two n-tiles a scan where the slabs stay wide)
            held(dims, 700 if c2 > 8 else 9, tk.CombinedWeights(*q, dims=dims + (c2,), levels=1))
    held(default, 7, tk.build_combined_weights(_quant(rng, default, 2), default, device=dev),
         offset=1)
    five = tk.build_combined_weights(_quant(rng, default, 2, C=5), default, device=dev)  # 2 n-tiles
    held(default, 700, five, offset=1)
    for m in (0, 1, 2):
        held(default, 700, tk.build_combined_weights(_quant(rng, default, 2, masked=m, C=5),
                                                     default, device=dev))
    fine = (43, 31, 351)
    held(fine, 7, tk.build_combined_weights(_quant(rng, fine, 2), fine, device=dev), offset=1)
    huge = (43, 200, 400)  # one class row's whole-scan block needs ~320 KB
    w_huge = tk.CombinedWeights(*[torch.zeros((1,) + s, dtype=torch.int8, device=dev)
                                  for s in ((43, 400), (200, 400), (43, 200))],
                                dims=huge + (1,), levels=1)
    before = tk.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="232448 bytes"):
        tk.onepass_tables_combined_i8(torch.zeros((1,) + huge, dtype=torch.int8, device=dev),
                                      w_huge)
    assert tk.KERNEL_LAUNCHES == before


def test_count_launch_is_exact_under_threads():
    """Leader threads of the serving layers call one predictor at once;
    the launch counters go through one locked increment, so 8 threads
    lose no count (a bare `+= 1` on a module global can). Driven on a
    plain dict and on a module counter, as the wrappers call it."""
    import sys
    import threading
    from pathlib import Path

    from radarml_tpu_torch.ops import _cuda_build, i8_tails, rbf, score

    for wrapper in (tk, rbf, score, i8_tails):
        assert "count_launch(" in Path(wrapper.__file__).read_text()
    n_threads, per_thread = 8, 20000
    counts = {"n": 0}
    saved = rbf.KERNEL_LAUNCHES
    rbf.KERNEL_LAUNCHES = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                _cuda_build.count_launch(counts, "n")
                _cuda_build.count_launch(vars(rbf), "KERNEL_LAUNCHES")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert counts["n"] == n_threads * per_thread
        assert rbf.KERNEL_LAUNCHES == n_threads * per_thread
    finally:
        sys.setswitchinterval(interval)
        rbf.KERNEL_LAUNCHES = saved
