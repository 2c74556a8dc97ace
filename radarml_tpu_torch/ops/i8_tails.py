"""The other four one-pass int8 kernels of the fused predict path.

Port of radarml_tpu/ops/pallas_i8_score.py :: onepass_tables_i8 (the
"lookup" tail), onepass_tables_grouped_i8 ("glookup"),
onepass_tables_sel_i8 ("sel") and onepass_scores_i8 ("sel3"). Each
reads every int8 cube (value-128) of a (B, X, Y, Z) batch once against
the quantized per-plane templates of ops/i8_score.py and computes, exactly
in int32, the tables

    m1[c, y] = Σ_{x,z} q_xz[c, x, z] · v[x, y, z]
    m2[c, x] = Σ_{y,z} q_yz[c, y, z] · v[x, y, z]
    m3[z, c] = Σ_{x,y} q_xy[c, x, y] · v[x, y, z]

— the values of onepass_tables_combined_i8 — or the target reads of them:

* onepass_tables_i8: the three tables, a scan cut into parts of
  contiguous x-slabs across CUDA blocks when the batch is too small to
  fill the card (more blocks in flight at small batches; `lookup_plan`);
* onepass_tables_grouped_i8: the same tables under the same plan from
  GroupedWeights, whose `y_group` is the JAX kernel's tiling and does not
  change the card's work;
* onepass_tables_sel_i8: m1 and m2, and d3[c, t, b] = m3[kidx[b, t], c]
  selected in the kernel, so m3 never reaches device memory;
* onepass_scores_i8: only the three reads m1[c, j], m2[c, i], m3[k, c]
  of every target slot.

A selection index outside its table's range (-1 for a padded slot), or a
slot whose `valid` is False, reads zero. Selected reads come back as
(C2, T, B), the JAX contract without its padding.

On a CUDA tensor each entry point launches its hand-written Hopper
kernel or raises: the lookup, glookup, sel and sel3 kernels of
`csrc/i8_score.cu`, each the combo kernel's int8 mma walk with another
work plan or epilogue under a profiler symbol of its own; its header says
what bounds the kernels and how they cut the work. On a CPU tensor each
runs its plain version `*_ref`. Nothing falls back from one to the other.
Both go through a torch op of ops/library.py (`radarml_torch::
lookup_tables_i8`, `grouped_tables_i8`, `sel_tables_i8`,
`sel3_scores_i8`), which torch.export records in a serving artifact.
The TPU kernels' δ-block and grouped weight arrays, scan-minor packing,
y-groups, lane padding and SEL_TP slot padding are not carried over: the
weights are the quantized templates themselves, as for the combo kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from radarml_tpu_torch.ops import i8_score
from radarml_tpu_torch.ops._cuda_build import count_launch
from radarml_tpu_torch.ops.i8_score import (
    CombinedWeights,
    build_combined_weights,
    card_operands,
    check_operands,
    onepass_tables_combined_i8_ref,
)

__all__ = [
    "GroupedWeights",
    "LAUNCHES",
    "OnepassWeights",
    "build_grouped_weights",
    "build_onepass_weights",
    "lookup_plan",
    "lookup_plan_on_card",
    "onepass_scores_i8",
    "onepass_scores_i8_ref",
    "onepass_tables_grouped_i8",
    "onepass_tables_grouped_i8_ref",
    "onepass_tables_i8",
    "onepass_tables_i8_ref",
    "onepass_tables_sel_i8",
    "onepass_tables_sel_i8_ref",
    "part_slabs",
]

#: Launches of each CUDA kernel in this process, by entry point. Only the
#: wrappers add to it, once per launch; callers reset it to count a run.
LAUNCHES = dict.fromkeys(
    ("onepass_tables_i8", "onepass_tables_grouped_i8",
     "onepass_tables_sel_i8", "onepass_scores_i8"),
    0,
)

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


#: The weights of the lookup, sel and sel3 kernels: the quantized
#: templates, as the combo kernel takes them.
OnepassWeights = CombinedWeights


@dataclasses.dataclass(frozen=True)
class GroupedWeights(CombinedWeights):
    """The quantized templates plus the y-group size of the JAX grouped
    kernel (any 1..Y). The y-group is TPU tiling: the card's glookup
    kernel takes the lookup kernel's plan whatever its value."""

    y_group: int = 16


def build_onepass_weights(
    quant: Sequence[Optional[tuple]],
    dims: Tuple[int, int, int],
    levels: int = 2,
    device=None,
) -> OnepassWeights:
    """OnepassWeights from the per-plane quantized templates, checked as
    build_combined_weights checks them."""
    return build_combined_weights(quant, dims, levels=levels, device=device)


def build_grouped_weights(
    quant: Sequence[Optional[tuple]],
    dims: Tuple[int, int, int],
    y_group: int = 16,
    levels: int = 2,
    device=None,
) -> GroupedWeights:
    """GroupedWeights: the templates of build_onepass_weights and the
    y-group size (1..Y; groups need not divide Y), kept as the JAX
    package's contract has it; it does not change the card's work."""
    if not 1 <= y_group <= dims[1]:
        raise ValueError(f"y_group must be in 1..{dims[1]}, got {y_group}")
    w = build_combined_weights(quant, dims, levels=levels, device=device)
    return GroupedWeights(
        w.q_xz, w.q_yz, w.q_xy, dims=w.dims, levels=w.levels, y_group=y_group
    )


# -- plain versions -----------------------------------------------------------


def _read(table: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Gather a (C2, D, B) table (axis 1) or a (D, C2, B) table (axis 0)
    at (B, T) indices → (C2, T, B) int32; an index outside [0, D) reads 0."""
    D = table.shape[axis]
    idx = idx.to(device=table.device, dtype=torch.int64)
    inside = (idx >= 0) & (idx < D)
    at = idx.clamp(0, D - 1).T  # (T, B)
    if axis == 1:
        C2 = table.shape[0]
        got = table.gather(1, at[None].expand(C2, -1, -1))
    else:
        C2 = table.shape[1]
        got = table.gather(0, at[:, None, :].expand(-1, C2, -1)).transpose(0, 1)
    return torch.where(inside.T[None], got, torch.zeros_like(got)).contiguous()


# The plain versions of the two table kernels are the combo kernel's exact
# einsums (int64 on the CPU, float64 on the card): the cut of a scan (or
# the y-group) changes only how a kernel shares out the work.
onepass_tables_i8_ref = onepass_tables_combined_i8_ref
onepass_tables_grouped_i8_ref = onepass_tables_combined_i8_ref


def onepass_tables_sel_i8_ref(
    cube: torch.Tensor, weights: CombinedWeights, kidx
) -> Tables:
    """Plain version of onepass_tables_sel_i8: m1, m2 and the z-table read
    at kidx (B, T), as (C2, T, B)."""
    m1, m2, m3 = onepass_tables_combined_i8_ref(cube, weights)
    return m1, m2, _read(m3, torch.as_tensor(kidx), 0)


def _masked_ijk(ijk, valid) -> torch.Tensor:
    ijk = torch.as_tensor(ijk)
    if valid is None:
        return ijk
    valid = torch.as_tensor(valid, device=ijk.device, dtype=torch.bool)
    return torch.where(valid[..., None], ijk, torch.full_like(ijk, -1))


def onepass_scores_i8_ref(
    cube: torch.Tensor, weights: CombinedWeights, ijk, valid=None
) -> Tables:
    """Plain version of onepass_scores_i8: the three tables read at each
    slot's (i, j, k) of ijk (B, T, 3), each as (C2, T, B)."""
    m1, m2, m3 = onepass_tables_combined_i8_ref(cube, weights)
    idx = _masked_ijk(ijk, valid)
    return _read(m1, idx[..., 1], 1), _read(m2, idx[..., 0], 1), _read(m3, idx[..., 2], 0)


# -- the lookup and glookup kernels' work plan ---------------------------------


def lookup_plan(B: int, X: int, resident: int, slab_width: int) -> Tuple[int, int]:
    """How the lookup and glookup kernels cut a batch of B scans: (P, XS),
    each scan in P parts of contiguous x-slabs XS wide (`part_slabs`).

    `resident` is the number of its blocks the card holds at once with
    whole scans, over the class groups (one block a group of a scan takes
    a slot: the resident blocks divided by the groups), and `slab_width`
    that plan's slab width (the combo kernel's). From B = resident on,
    P = 1: whole scans, one persistent block per SM and group, as the
    combo kernel walks them. Below that, idle blocks
    can take parts: resident / B of them a scan, rounded down or up, with a
    narrower slab where that gives more slabs and never more parts than
    slabs, so each part is at least one slab. The kernel runs min(B,
    resident / P) scans at a time, so a block may walk its part of several
    scans; of whole scans and the two roundings, the plan whose busiest
    block walks the fewest x rows wins, the one with more parts on a tie
    (a part's block loads fewer template rows).
    """

    def cdiv(a: int, b: int) -> int:
        return -(-a // b)

    def cut(want: int) -> Tuple[int, int]:
        xs = min(slab_width, cdiv(X, want))
        return min(want, cdiv(X, xs)), xs

    def busiest(P: int, XS: int) -> int:  # x rows of the busiest block
        rounds = cdiv(B, min(B, max(1, resident // P)))
        return rounds * min(X, cdiv(cdiv(X, XS), P) * XS)

    best = (1, slab_width)
    for want in (resident // B, -(-resident // B)):
        if want >= 2 and busiest(*cut(want)) <= busiest(*best):
            best = cut(want)
    return best


def part_slabs(X: int, XS: int, P: int) -> List[Tuple[int, int]]:
    """The slab ranges [s0, s1) of a scan's P parts, as the kernel cuts
    them: part p takes slabs p·n/P up to (p+1)·n/P of the n = ⌈X/XS⌉."""
    n = -(-X // XS)
    return [(p * n // P, (p + 1) * n // P) for p in range(P)]


# -- CUDA kernels --------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def _plan_shape(device: int, kernel: str, B: int, dims: Tuple[int, int, int], c2: int,
                planes: Tuple[bool, bool, bool]) -> Tuple[int, int]:
    """(resident blocks over the blocks a scan, slab width) of the lookup or
    glookup kernel's whole-scan plan for a batch of B scans on CUDA card
    `device` (the plan's rows a block depend on the batch,
    csrc/i8_score.cu batch_rows); raises on a CUDA error."""
    lib = i8_score._library()
    fn = f"i8_score_{kernel}_resident_at"
    with torch.cuda.device(device):
        resident = getattr(lib, fn)(B, *dims, c2, *planes)
        if resident <= 0:
            raise RuntimeError(f"{fn} failed: CUDA error {-resident} (dims={dims}, C2={c2})")
        groups = -(-c2 // lib.i8_score_batch_rows(B, *dims, c2, *planes))
        return max(1, resident // groups), lib.i8_score_batch_width(B, *dims, c2, *planes)


def lookup_plan_on_card(B: int, weights: CombinedWeights,
                        kernel: str = "lookup") -> Tuple[int, int]:
    """`lookup_plan` for B scans with these weights on their CUDA card:
    (P, XS), as onepass_tables_i8 (kernel "lookup") or
    onepass_tables_grouped_i8 ("grouped") launches it, from that kernel's
    own resident-block count over its class groups at this batch (builds
    the kernels if needed)."""
    if kernel not in ("lookup", "grouped"):
        raise ValueError(f"kernel must be 'lookup' or 'grouped', got {kernel!r}")
    planes = tuple(q is not None for q in (weights.q_xz, weights.q_yz, weights.q_xy))
    resident, width = _plan_shape(weights.device.index, kernel, B, weights.dims[:3], weights.c2,
                                  planes)
    return lookup_plan(B, weights.dims[0], resident, width)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, fn: str, cube: torch.Tensor, weights: CombinedWeights,
            extra_in: tuple, outs: tuple, *ints: int) -> None:
    """Call csrc/i8_score.cu's `fn` on the cube's current stream, raise on
    a CUDA error, and count the launch under `name`."""
    X, Y, Z, _ = weights.dims
    dev = cube.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(i8_score._library(), fn)(
            cube.data_ptr(), _ptr(weights.q_xz), _ptr(weights.q_yz),
            _ptr(weights.q_xy), *extra_in, *(o.data_ptr() for o in outs),
            cube.shape[0], X, Y, Z, weights.c2, *ints, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{fn} launch failed: CUDA error {err} (B={cube.shape[0]}, "
            f"dims={(X, Y, Z)}, C2={weights.c2}, args={ints})"
        )
    count_launch(LAUNCHES, name)


def _card_slots(t: torch.Tensor, cube: torch.Tensor, shape: tuple, dtype: torch.dtype,
                what: str) -> None:
    """Raise unless a kernel's slot operand is a contiguous `dtype` tensor
    of `shape` on the cube's device, as the kernel reads it by pointer."""
    if (t.dtype != dtype or tuple(t.shape) != shape or t.device != cube.device
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be contiguous {dtype} {shape} on {cube.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _int32(cube: torch.Tensor, *shapes) -> tuple:
    """Uninitialised int32 outputs of these shapes on the cube's device
    (each kernel writes every element)."""
    return tuple(torch.empty(s, dtype=torch.int32, device=cube.device) for s in shapes)


def split_tables_cuda(kernel: str, cube: torch.Tensor, weights: CombinedWeights) -> Tables:
    """Launch the lookup ("lookup") or glookup ("grouped") kernel on CUDA
    operands, checked here, under its plan: scan-major int32 t1 (B, C2,
    Y), t2 (B, C2, X), t3 (B, Z, C2). The CUDA implementation of
    `radarml_torch::lookup_tables_i8` / `grouped_tables_i8`."""
    card_operands(cube, weights)
    X, Y, Z, _ = weights.dims
    B, C2 = cube.shape[0], weights.c2
    P, XS = lookup_plan_on_card(B, weights, kernel)
    # at P > 1 the C entry zeroes the m1 and m3 that the parts add into
    outs = _int32(cube, (B, C2, Y), (B, C2, X), (B, Z, C2))
    name = {"lookup": "onepass_tables_i8", "grouped": "onepass_tables_grouped_i8"}[kernel]
    _launch(name, f"i8_score_{kernel}_tables", cube, weights, (), outs, XS, P)
    return outs


def sel_tables_cuda(cube: torch.Tensor, weights: CombinedWeights, k: torch.Tensor) -> Tables:
    """Launch the sel kernel on CUDA operands, checked here (k: contiguous
    int32 (B, T)): scan-major t1 (B, C2, Y), t2 (B, C2, X), d3 (B, T, C2).
    The CUDA implementation of `radarml_torch::sel_tables_i8`."""
    _card_slots(k, cube, (cube.shape[0], k.shape[1] if k.dim() == 2 else -1), torch.int32,
                "kidx")
    card_operands(cube, weights)
    X, Y, _, _ = weights.dims
    B, T, C2 = cube.shape[0], k.shape[1], weights.c2
    outs = _int32(cube, (B, C2, Y), (B, C2, X), (B, T, C2))
    _launch("onepass_tables_sel_i8", "i8_score_sel_tables", cube, weights, (k.data_ptr(),),
            outs, T)
    return outs


def sel3_scores_cuda(cube: torch.Tensor, weights: CombinedWeights, idx: torch.Tensor,
                     ok: Optional[torch.Tensor]) -> Tables:
    """Launch the sel3 kernel on CUDA operands, checked here (idx:
    contiguous int32 (B, T, 3), ok: contiguous bool (B, T) or None): three
    scan-major (B, T, C2) reads. The CUDA implementation of
    `radarml_torch::sel3_scores_i8`."""
    B, T = cube.shape[0], idx.shape[1] if idx.dim() == 3 else -1
    _card_slots(idx, cube, (B, T, 3), torch.int32, "ijk")
    if ok is not None:
        _card_slots(ok, cube, (B, T), torch.bool, "valid")
    card_operands(cube, weights)
    outs = _int32(cube, *[(B, T, weights.c2)] * 3)
    _launch("onepass_scores_i8", "i8_score_sel3_scores", cube, weights,
            (idx.data_ptr(), _ptr(ok)), outs, T)
    return outs


def _planes(weights: CombinedWeights) -> tuple:
    return weights.q_xz, weights.q_yz, weights.q_xy, weights.levels


def _jax_order(tables: Tables) -> Tables:
    """Scan-major t1 (B, C2, Y), t2 (B, C2, X), t3 (B, Z, C2) → views in
    the JAX axis order (C2, Y, B), (C2, X, B), (Z, C2, B)."""
    return tuple(t.permute(1, 2, 0) for t in tables)


def onepass_tables_i8(cube: torch.Tensor, weights: CombinedWeights) -> Tables:
    """The three one-pass tables of a (B, X, Y, Z) int8 cube batch, the
    kernel cutting each scan into the parts of `lookup_plan`.

    Returns int32 m1 (C2, Y, B), m2 (C2, X, B), m3 (Z, C2, B), permuted
    views of the scan-major buffers of `radarml_torch::lookup_tables_i8`
    (ops/library.py).
    """
    check_operands(cube, weights)
    return _jax_order(torch.ops.radarml_torch.lookup_tables_i8(cube, *_planes(weights)))


def onepass_tables_grouped_i8(cube: torch.Tensor, weights: GroupedWeights) -> Tables:
    """The three one-pass tables from GroupedWeights. Same contract as
    onepass_tables_i8, and on the card the same plan (its own kernel
    symbol and resident-block count, `radarml_torch::grouped_tables_i8`):
    the y-group, the JAX kernel's tiling, does not change the card's work."""
    if not isinstance(weights, GroupedWeights):
        raise TypeError(
            "onepass_tables_grouped_i8 takes GroupedWeights (build_grouped_weights)"
        )
    check_operands(cube, weights)
    return _jax_order(torch.ops.radarml_torch.grouped_tables_i8(cube, *_planes(weights)))


def _slots(idx, cube: torch.Tensor, trailing: tuple, what: str) -> torch.Tensor:
    """Integer (B, T) + trailing slot indices → contiguous int32 on the
    cube's device; raises on another shape or type."""
    idx = torch.as_tensor(idx, device=cube.device)
    B = cube.shape[0]
    if (idx.is_floating_point() or idx.is_complex() or idx.dtype == torch.bool
            or idx.dim() != 2 + len(trailing) or idx.shape[0] != B
            or tuple(idx.shape[2:]) != trailing):
        raise ValueError(
            f"{what} must be integer (B={B}, T){''.join(f', {n}' for n in trailing)}"
            f", got {idx.dtype} {tuple(idx.shape)}"
        )
    return idx.to(torch.int32).contiguous()


def onepass_tables_sel_i8(
    cube: torch.Tensor, weights: CombinedWeights, kidx
) -> Tables:
    """m1 (C2, Y, B), m2 (C2, X, B) and d3 (C2, T, B) with d3[c, t, b] =
    m3[kidx[b, t], c, b] for the (B, T) z indices kidx; -1 reads zero.
    Views of `radarml_torch::sel_tables_i8`'s scan-major buffers."""
    check_operands(cube, weights)
    k = _slots(kidx, cube, (), "kidx")
    t1, t2, d3 = torch.ops.radarml_torch.sel_tables_i8(cube, *_planes(weights), k)
    return t1.permute(1, 2, 0), t2.permute(1, 2, 0), d3.permute(2, 1, 0)


def onepass_scores_i8(
    cube: torch.Tensor, weights: CombinedWeights, ijk, valid=None
) -> Tables:
    """The three target reads s1 = m1[c, j], s2 = m2[c, i], s3 = m3[k, c]
    of every slot of ijk (B, T, 3) (i = x, j = y, k = z), each (C2, T, B);
    an index of -1, or a slot whose optional (B, T) `valid` is False,
    reads zero. No table leaves the kernel. Views of
    `radarml_torch::sel3_scores_i8`'s scan-major (B, T, C2) buffers."""
    check_operands(cube, weights)
    idx = _slots(ijk, cube, (3,), "ijk")
    B, T = idx.shape[:2]
    ok = None
    if valid is not None:
        ok = torch.as_tensor(valid, device=cube.device)
        if ok.dtype != torch.bool or tuple(ok.shape) != (B, T):
            raise ValueError(f"valid must be bool {(B, T)}, got {ok.dtype} "
                             f"{tuple(ok.shape)}")
        ok = ok.contiguous()
    outs = torch.ops.radarml_torch.sel3_scores_i8(cube, *_planes(weights), idx, ok)
    return tuple(o.permute(2, 1, 0) for o in outs)
