"""Port parity: ops/i8_tails (the lookup, glookup, sel and sel3 kernels'
entry points) against the JAX Pallas kernels and an int64 einsum oracle.

The tables and reads are exact integers, so every comparison is bit for
bit (tolerance 0). On the CPU each wrapper runs its plain version; the
JAX kernels run in interpret mode on the JAX-packed batch, as the JAX
package's own tests run them (tests/test_pallas_i8.py), and are sliced
to [:, :Y, :B] / [:, :T, :B]. The JAX package is imported inside the
tests that use it, so that the one card-only test (marked `cuda`, skipped
here) runs on the card without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_i8_tails.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from radarml_tpu_torch.ops import i8_score as ts
from radarml_tpu_torch.ops import i8_tails as tt

torch.set_num_threads(1)

DEFAULT = (22, 31, 176)  # the default arena's grid
SMALL = [  # (dims, masked plane)
    ((5, 7, 9), None),
    ((4, 35, 9), None),
    ((5, 7, 9), 0),
    ((4, 35, 9), 1),
    ((5, 7, 9), 2),
]


def _quant(rng, dims, masked=None, C=3, levels=2):
    """Random templates of `levels` levels (2: split): the port's
    (q, s1, s2, const) tuples and the JAX builders' (q, None, None, None)."""
    X, Y, Z = dims
    port, jax_q = [], []
    for p, shape in enumerate(((X, Z), (Y, Z), (X, Y))):
        if p == masked:
            port.append(None)
            jax_q.append(None)
            continue
        q = rng.integers(-127, 128, (levels * C,) + shape).astype(np.int8)
        s = np.ones((C,), np.float32)
        port.append((q, s, s if levels == 2 else None, s))
        jax_q.append((q, None, None, None))
    return port, jax_q


def _oracle(quant, cubes_u8):
    """int64 numpy einsums of the JAX package's test oracle: m1, m2, m3."""
    v = cubes_u8.astype(np.int64) - 128
    B, X, Y, Z = cubes_u8.shape
    C2 = next(q[0].shape[0] for q in quant if q is not None)
    specs = ("cxz,bxyz->cyb", "cyz,bxyz->cxb", "cxy,bxyz->zcb")
    shapes = ((C2, Y, B), (C2, X, B), (Z, C2, B))
    return [
        np.zeros(shape, np.int64) if q is None
        else np.einsum(spec, q[0].astype(np.int64), v)
        for q, spec, shape in zip(quant, specs, shapes)
    ]


def _oracle_reads(tables, ijk, valid):
    """(C2, T, B) reads m1[c, j], m2[c, i], m3[k, c] of the oracle
    tables; an index outside its range or an invalid slot reads zero."""
    m1, m2, m3 = tables
    B, T, _ = ijk.shape
    C2 = m1.shape[0]
    out = [np.zeros((C2, T, B), np.int64) for _ in range(3)]
    for b in range(B):
        for t in range(T):
            if valid is not None and not valid[b, t]:
                continue
            i, j, k = ijk[b, t]
            if 0 <= j < m1.shape[1]:
                out[0][:, t, b] = m1[:, j, b]
            if 0 <= i < m2.shape[1]:
                out[1][:, t, b] = m2[:, i, b]
            if 0 <= k < m3.shape[0]:
                out[2][:, t, b] = m3[k, :, b]
    return out


def _cubes(rng, B, dims):
    return rng.integers(0, 256, (B,) + dims).astype(np.uint8)


def _jax_tables(entry, jax_q, cubes, dims):
    """The JAX lookup (onepass) or glookup (grouped) kernel, interpret
    mode, sliced to [:, :Y, :B]."""
    from radarml_tpu.ops import pallas_i8_score as jk

    Y, B = dims[1], cubes.shape[0]
    if entry == "grouped":
        w = jk.build_grouped_weights(jax_q, dims)
        ck = jk.pack_cubes_i8(cubes, y_group=w.y_group)
        m = jk.onepass_tables_grouped_i8(ck, w, interpret=True)
    else:
        w = jk.build_onepass_weights(jax_q, dims)
        m = jk.onepass_tables_i8(jk.pack_cubes_i8(cubes), w, interpret=True)
    return (np.asarray(m[0])[:, :Y, :B], np.asarray(m[1])[..., :B],
            np.asarray(m[2])[..., :B])


def _ijk(rng, dims, B, T):
    """Slot indices in range, with -1 in one slot of each axis and one
    index past the end of z."""
    ijk = np.stack([rng.integers(0, n, (B, T)) for n in dims], -1).astype(np.int32)
    ijk[0, -1] = -1
    ijk[-1, 0, 1] = -1
    ijk[-1, -1, 2] = dims[2]
    return ijk


def _equal(got, *wants):
    for g, ws in zip(got, zip(*wants)):
        assert g.dtype == torch.int32
        for w in ws:
            np.testing.assert_array_equal(g.numpy().astype(np.int64), w)


@pytest.mark.parametrize("entry", ["onepass", "grouped"])
@pytest.mark.parametrize("dims,masked", SMALL)
def test_tables_match_jax_kernel_and_oracle(rng, entry, dims, masked):
    """onepass_tables_i8 / onepass_tables_grouped_i8 (plain version) ==
    JAX kernel [:, :Y, :B] == int64 oracle; a masked plane is zero."""
    port_q, jax_q = _quant(rng, dims, masked)
    cubes = _cubes(rng, 3, dims)
    cube = ts.pack_cubes_i8(cubes)
    if entry == "grouped":
        got = tt.onepass_tables_grouped_i8(cube, tt.build_grouped_weights(port_q, dims, 4))
    else:
        got = tt.onepass_tables_i8(cube, tt.build_onepass_weights(port_q, dims))
    _equal(got, _oracle(port_q, cubes), _jax_tables(entry, jax_q, cubes, dims))
    if masked is not None:
        assert not got[masked].any()


@pytest.mark.parametrize("entry", ["onepass", "grouped", "sel", "scores"])
def test_default_arena_matches_jax_kernel(rng, entry):
    """One case per entry point at the default arena (B=2): the JAX
    interpreter walks every z-step of the 22x31x176 grid."""
    dims = DEFAULT
    port_q, jax_q = _quant(rng, dims)
    cubes = _cubes(rng, 2, dims)
    cube = ts.pack_cubes_i8(cubes)
    oracle = _oracle(port_q, cubes)
    if entry in ("onepass", "grouped"):
        w = (tt.build_grouped_weights(port_q, dims) if entry == "grouped"
             else tt.build_onepass_weights(port_q, dims))
        fn = tt.onepass_tables_grouped_i8 if entry == "grouped" else tt.onepass_tables_i8
        _equal(fn(cube, w), oracle, _jax_tables(entry, jax_q, cubes, dims))
        return
    ijk = _ijk(rng, dims, 2, 3)
    valid = np.array([[True, False, True], [True, True, True]])
    w = tt.build_onepass_weights(port_q, dims)
    if entry == "sel":
        got = tt.onepass_tables_sel_i8(cube, w, ijk[..., 2])
        want = _oracle_reads(oracle, ijk, None)
        _equal(got, (oracle[0], oracle[1], want[2]), _jax_sel(jax_q, cubes, dims, ijk))
    else:
        got = tt.onepass_scores_i8(cube, w, ijk, valid)
        _equal(got, _oracle_reads(oracle, ijk, valid),
               _jax_scores(jax_q, cubes, dims, ijk, valid))


def _jax_sel(jax_q, cubes, dims, ijk):
    from radarml_tpu.ops import pallas_i8_score as jk

    Y, B, T = dims[1], cubes.shape[0], ijk.shape[1]
    w = jk.build_onepass_weights(jax_q, dims)
    m1, m2, d3 = jk.onepass_tables_sel_i8(
        jk.pack_cubes_i8(cubes), w, ijk[..., 2], interpret=True
    )
    return (np.asarray(m1)[:, :Y, :B], np.asarray(m2)[..., :B],
            np.asarray(d3)[:, :T, :B])


def _jax_scores(jax_q, cubes, dims, ijk, valid):
    from radarml_tpu.ops import pallas_i8_score as jk

    B, T = cubes.shape[0], ijk.shape[1]
    w = jk.build_grouped_weights(jax_q, dims)
    out = jk.onepass_scores_i8(
        jk.pack_cubes_i8(cubes, y_group=w.y_group), w, ijk, valid, interpret=True
    )
    return tuple(np.asarray(s)[:, :T, :B] for s in out)


@pytest.mark.parametrize("dims,masked", SMALL)
def test_sel_matches_jax_kernel_and_oracle(rng, dims, masked):
    """onepass_tables_sel_i8: m1, m2 as the tables, d3 = the z-table read
    at kidx; -1 and an index past Z read zero, as in the JAX kernel."""
    port_q, jax_q = _quant(rng, dims, masked)
    cubes = _cubes(rng, 3, dims)
    ijk = _ijk(rng, dims, 3, 4)
    got = tt.onepass_tables_sel_i8(
        ts.pack_cubes_i8(cubes), tt.build_onepass_weights(port_q, dims),
        torch.from_numpy(ijk[..., 2]),
    )
    oracle = _oracle(port_q, cubes)
    want = (oracle[0], oracle[1], _oracle_reads(oracle, ijk, None)[2])
    _equal(got, want, _jax_sel(jax_q, cubes, dims, ijk))
    assert got[2].shape == (6, 4, 3)
    assert not got[2][:, -1, 0].any()


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("dims,masked", SMALL)
def test_scores_match_jax_kernel_and_oracle(rng, dims, masked, with_valid):
    """onepass_scores_i8: the three reads of every slot; -1, an index past
    the end and an invalid slot read zero, as in the JAX kernel."""
    port_q, jax_q = _quant(rng, dims, masked)
    cubes = _cubes(rng, 3, dims)
    ijk = _ijk(rng, dims, 3, 4)
    valid = None
    if with_valid:
        valid = np.ones((3, 4), bool)
        valid[1, 2] = False
    got = tt.onepass_scores_i8(
        ts.pack_cubes_i8(cubes), tt.build_grouped_weights(port_q, dims, 3), ijk, valid
    )
    want = _oracle_reads(_oracle(port_q, cubes), ijk, valid)
    _equal(got, want, _jax_scores(jax_q, cubes, dims, ijk, valid))
    if with_valid:
        assert all(not g[:, 2, 1].any() for g in got)


@pytest.mark.parametrize("y_group", [1, 5, 16, 31])
def test_grouped_takes_any_y_group(rng, y_group):
    """Any y-group from 1 to Y builds, groups that do not divide Y
    included, and the tables do not depend on it."""
    dims = (4, 31, 9)
    port_q, _ = _quant(rng, dims)
    cubes = _cubes(rng, 2, dims)
    w = tt.build_grouped_weights(port_q, dims, y_group=y_group)
    assert w.y_group == y_group and w.c2 == 6
    _equal(tt.onepass_tables_grouped_i8(ts.pack_cubes_i8(cubes), w),
           _oracle(port_q, cubes))


@pytest.mark.parametrize("entry", ["onepass", "grouped", "sel", "scores"])
def test_single_level_weights_match_oracle(rng, entry):
    """Levels-1 templates (C2 = 3) through each entry point equal the
    int64 oracle, tables and reads alike."""
    dims = (5, 7, 9)
    port_q, _ = _quant(rng, dims, masked=1, levels=1)
    cubes = _cubes(rng, 3, dims)
    cube = ts.pack_cubes_i8(cubes)
    ijk = _ijk(rng, dims, 3, 4)
    valid = rng.random((3, 4)) < 0.7
    want = _oracle(port_q, cubes)
    if entry == "grouped":
        got = tt.onepass_tables_grouped_i8(
            cube, tt.build_grouped_weights(port_q, dims, y_group=3, levels=1))
    else:
        w = tt.build_onepass_weights(port_q, dims, levels=1)
        if entry == "onepass":
            got = tt.onepass_tables_i8(cube, w)
        elif entry == "sel":
            got = tt.onepass_tables_sel_i8(cube, w, ijk[..., 2])
            want = want[:2] + _oracle_reads(want, ijk, None)[2:]
        else:
            got = tt.onepass_scores_i8(cube, w, ijk, valid)
            want = _oracle_reads(want, ijk, valid)
    assert got[0].shape[0] == 3
    _equal(got, want)


def test_wrappers_check_their_operands(rng):
    dims = (5, 7, 9)
    port_q, _ = _quant(rng, dims)
    single = [None if q is None else (q[0][:3], q[1], None, q[3]) for q in port_q]
    with pytest.raises(ValueError, match="levels=2"):
        tt.build_onepass_weights(single, dims)
    with pytest.raises(ValueError, match="levels=1"):
        tt.build_grouped_weights(port_q, dims, y_group=4, levels=1)
    for bad in (0, 8):
        with pytest.raises(ValueError, match="y_group"):
            tt.build_grouped_weights(port_q, dims, y_group=bad)
    w = tt.build_onepass_weights(port_q, dims)
    cube = ts.pack_cubes_i8(_cubes(rng, 2, dims))
    with pytest.raises(TypeError, match="GroupedWeights"):
        tt.onepass_tables_grouped_i8(cube, w)
    with pytest.raises(ValueError, match="kidx"):
        tt.onepass_tables_sel_i8(cube, w, np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="kidx"):
        tt.onepass_tables_sel_i8(cube, w, np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="ijk"):
        tt.onepass_scores_i8(cube, w, np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="valid"):
        tt.onepass_scores_i8(cube, w, np.zeros((2, 2, 3), np.int32),
                             np.ones((2, 3), bool))
    with pytest.raises(ValueError, match="arena dims"):
        tt.onepass_tables_i8(torch.zeros((1, 5, 7, 8), dtype=torch.int8), w)
    with pytest.raises(ValueError, match="cube on meta"):
        tt.onepass_tables_i8(cube.to("meta"), w)


def test_wrappers_on_cpu_are_the_plain_versions(rng):
    """On a CPU tensor each wrapper is its plain version and launches
    nothing; the CPU plain versions (int64) equal the float64 einsums the
    card's plain versions use."""
    dims = (4, 35, 9)
    port_q, _ = _quant(rng, dims)
    w = tt.build_grouped_weights(port_q, dims)
    cube = ts.pack_cubes_i8(_cubes(rng, 4, dims))
    ijk = torch.from_numpy(_ijk(rng, dims, 4, 3))
    before = dict(tt.LAUNCHES)
    pairs = [
        (tt.onepass_tables_i8(cube, w), tt.onepass_tables_i8_ref(cube, w)),
        (tt.onepass_tables_grouped_i8(cube, w), tt.onepass_tables_grouped_i8_ref(cube, w)),
        (tt.onepass_tables_sel_i8(cube, w, ijk[..., 2]),
         tt.onepass_tables_sel_i8_ref(cube, w, ijk[..., 2])),
        (tt.onepass_scores_i8(cube, w, ijk), tt.onepass_scores_i8_ref(cube, w, ijk)),
    ]
    assert tt.LAUNCHES == before
    for got, ref in pairs:
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    v = cube.to(torch.float64)
    m1 = torch.einsum("cxz,bxyz->cyb", w.q_xz.to(torch.float64), v).to(torch.int32)
    assert torch.equal(pairs[0][0][0], m1)


# (B, X, resident blocks, whole-scan slab width): the default arena on 132
# SMs at one block each, a wide arena whose whole scans take several slabs,
# one slab a scan, and a card with two blocks an SM.
PLANS = [(B, 22, 132, 11) for B in (1, 2, 7, 33, 44, 64, 65, 66, 67, 100, 131)]
PLANS += [(B, 40, 132, 6) for B in (1, 3, 10, 64)]
PLANS += [(B, 5, 132, 5) for B in (1, 5, 33, 70)]
PLANS += [(B, 22, 264, 11) for B in (1, 64, 132, 200)]


def _busiest_rows(B, X, resident, P, XS):
    """x rows the busiest block of the lookup kernel walks: it runs
    min(B, resident // P) scans at a time, one block a part."""
    rounds = -(-B // min(B, max(1, resident // P)))
    return rounds * max(min(X, s1 * XS) - s0 * XS for s0, s1 in tt.part_slabs(X, XS, P))


@pytest.mark.parametrize("B,X,resident,width", PLANS)
def test_lookup_plan_covers_every_slab_once(B, X, resident, width):
    """lookup_plan cuts a scan into 1..(its slab count) parts, each at
    least one slab, together every slab exactly once, no wider than the
    whole-scan slab; its busiest block walks no more x rows than with
    whole scans, and it cuts scans whenever two parts a scan run at once."""
    P, XS = tt.lookup_plan(B, X, resident, width)
    nslab = -(-X // XS)
    assert 1 <= XS <= width and 1 <= P <= nslab
    parts = tt.part_slabs(X, XS, P)
    assert len(parts) == P and all(s1 > s0 for s0, s1 in parts)
    assert [s for s0, s1 in parts for s in range(s0, s1)] == list(range(nslab))
    assert _busiest_rows(B, X, resident, P, XS) <= _busiest_rows(B, X, resident, 1, width)
    if resident // B >= 2 and X > 1:
        assert P > 1


@pytest.mark.parametrize("X,resident,width", [(22, 132, 11), (40, 132, 6), (5, 132, 5)])
def test_lookup_plan_takes_whole_scans_at_and_above_the_resident_blocks(X, resident, width):
    """From one scan a resident block on, the lookup kernel walks whole
    scans with the combo kernel's slab width."""
    for B in (resident, resident + 1, 2 * resident, 4096):
        assert tt.lookup_plan(B, X, resident, width) == (1, width)


PARTS = [((5, 7, 9), 1), ((9, 13, 180), 7), (DEFAULT, 64)]


@pytest.mark.parametrize("dims,B,y_group", [
    pytest.param(dims, B, y_group, id=f"dims{n}-{B}" + (f"-yg{y_group}" if y_group else ""))
    for y_group in (None, 5, 16, 31) for n, (dims, B) in enumerate(PARTS)])
def test_parts_add_up_to_the_tables(rng, dims, B, y_group):
    """The lookup kernel's split, worked in int64 numpy: each part's m1 and
    m3 over its x rows, added, and its own m2 rows give the oracle tables.
    The glookup kernel takes the same plan whatever its weights' y-group
    (5, 16 or 31, at most Y): the parts add up to its tables too."""
    port_q, _ = _quant(rng, dims)
    cubes = _cubes(rng, B, dims)
    v = cubes.astype(np.int64) - 128
    qxz, qyz, qxy = (q[0].astype(np.int64) for q in port_q)
    X = dims[0]
    P, XS = tt.lookup_plan(B, X, 132, -(-X // 2))
    assert P > 1
    m1, m3 = 0, 0
    m2 = np.full((qyz.shape[0], X, B), -1, np.int64)
    for s0, s1 in tt.part_slabs(X, XS, P):
        x = slice(s0 * XS, min(X, s1 * XS))
        m1 = m1 + np.einsum("cxz,bxyz->cyb", qxz[:, x], v[:, x])
        m3 = m3 + np.einsum("cxy,bxyz->zcb", qxy[:, x], v[:, x])
        assert (m2[:, x] == -1).all()  # each m2 row is stored by one part
        m2[:, x] = np.einsum("cyz,bxyz->cxb", qyz, v[:, x])
    for got, want in zip((m1, m2, m3), _oracle(port_q, cubes)):
        np.testing.assert_array_equal(got, want)
    if y_group is not None:
        w = tt.build_grouped_weights(port_q, dims, min(y_group, dims[1]))
        _equal(tt.onepass_tables_grouped_i8(ts.pack_cubes_i8(cubes), w), (m1, m2, m3))


# A __global__ function's name, past its return type and launch bounds.
KERNEL_NAME = r"__global__\s+void\s+(?:__launch_bounds__\(.*\)\s*)?(\w+)\s*\("


def test_kernel_symbols_name_one_kernel_each():
    """Each profiler symbol chip_smoke.py times a kernel by names exactly
    one __global__ function of csrc/*.cu, and none is a substring of
    another (a trace's kernel names are matched by substring)."""
    import importlib.util
    import re

    from radarml_tpu_torch.ops import _cuda_build

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kernels = [name for src in sorted(_cuda_build.CSRC.glob("*.cu"))
               for name in re.findall(KERNEL_NAME, src.read_text())]
    symbols = list(smoke.KERNEL_SYMBOLS.values())
    for sym in symbols:
        assert kernels.count(sym) == 1, (sym, kernels)
        assert not [o for o in symbols if o != sym and sym in o], sym
    assert "i8_tails.cu" not in {p.name for p in _cuda_build.CSRC.glob("*.cu")}


def _probe_variants():
    from radarml_tpu_torch.utils import kernel_probe

    return sorted(kernel_probe.TAILS_VARIANTS)


@pytest.mark.parametrize("variant", _probe_variants())
def test_probe_patches_fit_the_source(variant):
    """utils/kernel_probe.py's tails section builds variants of
    csrc/i8_score.cu by text patches that must each match the committed
    source exactly once: an edit to the lookup, glookup, sel or sel3
    kernels that moves a patched line must bring the patch along."""
    from radarml_tpu_torch.ops import _cuda_build
    from radarml_tpu_torch.utils import kernel_probe

    source = (_cuda_build.CSRC / "i8_score.cu").read_text()
    text = kernel_probe.patched(source, kernel_probe.TAILS_VARIANTS[variant])
    assert (text == source) == (variant == "as_committed")


@pytest.mark.cuda
def test_kernels_on_the_card():
    """On a card: each of the four wrappers launches its kernel (counted)
    and equals its plain version bit for bit, at the default arena with
    small and odd batches on both sides of the batch below which the
    lookup and glookup kernels cut scans, each plane masked, levels 2 and
    1, y-groups 1 / 5 / 16 / Y (some not dividing Y), -1 / past-the-end /
    invalid slots, and sel with no slot (T = 0) and with one slab a scan
    at (5, 7, 9), where it reads, waits and clears; at 5 classes (10 class
    rows) one block of two n-tiles a scan from a batch of five scans an
    SM on (also with a plane masked) and class groups below it, at the
    default arena and at (9, 13, 180)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    quant = _quant(rng, DEFAULT)[0]
    w = tt.build_onepass_weights(quant, DEFAULT, device=dev)
    plans = {yg: tt.build_grouped_weights(quant, DEFAULT, yg, device=dev) for yg in (1, 31)}
    for kernel in ("lookup", "grouped"):
        assert tt.lookup_plan_on_card(1, w, kernel)[0] > 1
        assert tt.lookup_plan_on_card(64, w, kernel)[0] > 1
        assert tt.lookup_plan_on_card(133, w, kernel)[0] == 1
    for B in (1, 64, 133):
        assert (tt.lookup_plan_on_card(B, plans[1], "grouped")
                == tt.lookup_plan_on_card(B, plans[31], "grouped"))
    assert ts.slab_width(tt.build_onepass_weights(_quant(rng, (5, 7, 9))[0], (5, 7, 9),
                                                  device=dev)) == 5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    five = tt.build_onepass_weights(_quant(rng, DEFAULT, C=5)[0], DEFAULT, device=dev)
    assert tt.lookup_plan_on_card(5 * sms, five)[1] == 8  # one block a scan, slabs 8 x rows wide
    assert tt.lookup_plan_on_card(64, five)[1] == 11  # class groups
    for dims, B, masked, levels, C in [case + (3,) for case in (
            (DEFAULT, 7, None, 2), (DEFAULT, 3, 0, 2), (DEFAULT, 2, 1, 2),
            (DEFAULT, 1, 2, 2), ((5, 7, 9), 5, None, 2), ((9, 13, 180), 3, None, 2),
            (DEFAULT, 5, None, 1), ((5, 7, 9), 4, 2, 1),
            (DEFAULT, 64, None, 2), (DEFAULT, 64, 0, 2), (DEFAULT, 64, 1, 2),
            (DEFAULT, 64, 2, 2), (DEFAULT, 64, None, 1), (DEFAULT, 131, None, 2),
            (DEFAULT, 132, None, 2), (DEFAULT, 133, 1, 2), (DEFAULT, 300, None, 2),
            (DEFAULT, 300, None, 1), ((9, 13, 180), 131, 0, 1), ((5, 7, 9), 133, None, 2))] + [
            (DEFAULT, 64, None, 2, 5), (DEFAULT, 700, None, 2, 5), (DEFAULT, 700, 1, 2, 5),
            (DEFAULT, 300, 2, 1, 10), ((9, 13, 180), 700, None, 2, 5)]:
        port_q, _ = _quant(rng, dims, masked, C=C, levels=levels)
        cube = ts.pack_cubes_i8(_cubes(rng, B, dims)).to(dev)
        ijk = torch.from_numpy(_ijk(rng, dims, B, 4)).to(dev)
        valid = torch.from_numpy(rng.random((B, 4)) < 0.7).to(dev)
        w = tt.build_onepass_weights(port_q, dims, levels=levels, device=dev)
        runs = [
            ("onepass_tables_i8", lambda: tt.onepass_tables_i8(cube, w),
             lambda: tt.onepass_tables_i8_ref(cube, w)),
            ("onepass_tables_sel_i8", lambda: tt.onepass_tables_sel_i8(cube, w, ijk[..., 2]),
             lambda: tt.onepass_tables_sel_i8_ref(cube, w, ijk[..., 2])),
            ("onepass_tables_sel_i8", lambda: tt.onepass_tables_sel_i8(cube, w, ijk[:, :0, 2]),
             lambda: tt.onepass_tables_sel_i8_ref(cube, w, ijk[:, :0, 2])),
            ("onepass_scores_i8", lambda: tt.onepass_scores_i8(cube, w, ijk, valid),
             lambda: tt.onepass_scores_i8_ref(cube, w, ijk, valid)),
        ]
        for yg in (16, 5, 1, dims[1]):
            wg = tt.build_grouped_weights(port_q, dims, min(yg, dims[1]),
                                          levels=levels, device=dev)
            runs.append(("onepass_tables_grouped_i8",
                         lambda wg=wg: tt.onepass_tables_grouped_i8(cube, wg),
                         lambda wg=wg: tt.onepass_tables_grouped_i8_ref(cube, wg)))
        for name, kernel, plain in runs:
            before = tt.LAUNCHES[name]
            got = kernel()
            torch.cuda.synchronize()
            assert tt.LAUNCHES[name] == before + 1
            for g, r in zip(got, plain()):
                assert g.shape == r.shape and torch.equal(g, r), (name, dims, B, masked, levels)
