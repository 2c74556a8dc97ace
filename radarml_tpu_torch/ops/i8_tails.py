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

* onepass_tables_i8: the three tables, the scan cut along z across
  several CUDA blocks (more blocks in flight at small batches);
* onepass_tables_grouped_i8: the three tables, the scan cut into groups
  of `y_group` rows across blocks;
* onepass_tables_sel_i8: m1 and m2, and d3[c, t, b] = m3[kidx[b, t], c]
  selected in the kernel, so m3 never reaches device memory;
* onepass_scores_i8: only the three reads m1[c, j], m2[c, i], m3[k, c]
  of every target slot.

A selection index outside its table's range (-1 for a padded slot), or a
slot whose `valid` is False, reads zero. Selected reads come back as
(C2, T, B), the JAX contract without its padding.

On a CUDA tensor each entry point launches its hand-written Hopper
kernel in `csrc/i8_tails.cu` (its header says what bounds the kernels
and how they cut the work) or raises; on a CPU tensor it runs its plain
version `*_ref`. Nothing falls back from one to the other. The TPU
kernels' δ-block and grouped weight arrays, scan-minor packing, lane
padding and SEL_TP slot padding are not carried over: the weights are
the quantized templates themselves, as for the combo kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from radarml_tpu_torch.ops.i8_score import (
    CombinedWeights,
    build_combined_weights,
    launches_kernel,
    onepass_tables_combined_i8_ref,
)

__all__ = [
    "GroupedWeights",
    "LAUNCHES",
    "OnepassWeights",
    "build_grouped_weights",
    "build_onepass_weights",
    "onepass_scores_i8",
    "onepass_scores_i8_ref",
    "onepass_tables_grouped_i8",
    "onepass_tables_grouped_i8_ref",
    "onepass_tables_i8",
    "onepass_tables_i8_ref",
    "onepass_tables_sel_i8",
    "onepass_tables_sel_i8_ref",
]

#: Launches of each CUDA kernel in this process, by entry point. Only the
#: wrappers add to it, once per launch; callers reset it to count a run.
LAUNCHES = dict.fromkeys(
    ("onepass_tables_i8", "onepass_tables_grouped_i8",
     "onepass_tables_sel_i8", "onepass_scores_i8"),
    0,
)

Z_CHUNK = 16  # z-extent of one block of the z-split kernel (16-byte loads)

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


#: The weights of the z-split, sel and sel3 kernels: the quantized
#: templates, as the combo kernel takes them.
OnepassWeights = CombinedWeights


@dataclasses.dataclass(frozen=True)
class GroupedWeights(CombinedWeights):
    """The quantized templates plus the y-group size of the y-split
    kernel: a block takes `y_group` rows of one scan (any 1..Y)."""

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
    y-group size (1..Y; groups need not divide Y)."""
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
# einsums (int64 on the CPU, float64 on the card): the cut of a scan
# changes only how a kernel shares out the work.
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


# -- CUDA kernels --------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from radarml_tpu_torch.ops._cuda_build import load_library

    lib = load_library("i8_tails")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, nptr in (("i8_tails_tables_zsplit", 7), ("i8_tails_tables_ysplit", 7)):
        getattr(lib, fn).argtypes = [p] * nptr + [i] * 6 + [p]
    lib.i8_tails_tables_sel.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.i8_tails_scores.argtypes = [p] * 9 + [i] * 6 + [p]
    for fn in ("i8_tails_tables_zsplit", "i8_tails_tables_ysplit",
               "i8_tails_tables_sel", "i8_tails_scores"):
        getattr(lib, fn).restype = i
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, fn: str, cube: torch.Tensor, weights: CombinedWeights,
            extra_in: tuple, outs: tuple, extra_int: int) -> None:
    """Call the library's `fn` on the cube's current stream, raise on a
    CUDA error, and count the launch under `name`."""
    X, Y, Z, _ = weights.dims
    lib = _library()
    dev = cube.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(
            cube.data_ptr(), _ptr(weights.q_xz), _ptr(weights.q_yz),
            _ptr(weights.q_xy), *extra_in, *(o.data_ptr() for o in outs),
            cube.shape[0], X, Y, Z, weights.c2, extra_int, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{fn} launch failed: CUDA error {err} (B={cube.shape[0]}, "
            f"dims={(X, Y, Z)}, C2={weights.c2}, arg={extra_int})"
        )
    LAUNCHES[name] += 1


def _table_outputs(cube, weights, zeroed: Tuple[bool, bool, bool]):
    """Scan-major int32 outputs (B, C2, Y), (B, C2, X), (B, Z, C2); the
    ones the kernel adds into start at zero."""
    X, Y, Z, _ = weights.dims
    B, C2 = cube.shape[0], weights.c2
    return tuple(
        (torch.zeros if z else torch.empty)(shape, dtype=torch.int32, device=cube.device)
        for z, shape in zip(zeroed, ((B, C2, Y), (B, C2, X), (B, Z, C2)))
    )


def _jax_order(t1, t2, t3) -> Tables:
    return t1.permute(1, 2, 0), t2.permute(1, 2, 0), t3.permute(1, 2, 0)


def onepass_tables_i8(cube: torch.Tensor, weights: CombinedWeights) -> Tables:
    """The three one-pass tables of a (B, X, Y, Z) int8 cube batch, the
    kernel cutting each scan into ⌈Z / Z_CHUNK⌉ blocks along z.

    Returns int32 m1 (C2, Y, B), m2 (C2, X, B), m3 (Z, C2, B); on a CUDA
    tensor these are permuted views of scan-major buffers.
    """
    if not launches_kernel(cube, weights):
        return onepass_tables_i8_ref(cube, weights)
    outs = _table_outputs(cube, weights, (True, True, False))
    _launch("onepass_tables_i8", "i8_tails_tables_zsplit", cube, weights, (),
            outs, Z_CHUNK)
    return _jax_order(*outs)


def onepass_tables_grouped_i8(cube: torch.Tensor, weights: GroupedWeights) -> Tables:
    """The three one-pass tables, the kernel cutting each scan into
    ⌈Y / y_group⌉ blocks of y rows. Same contract as onepass_tables_i8."""
    if not isinstance(weights, GroupedWeights):
        raise TypeError(
            "onepass_tables_grouped_i8 takes GroupedWeights (build_grouped_weights)"
        )
    if not launches_kernel(cube, weights):
        return onepass_tables_grouped_i8_ref(cube, weights)
    outs = _table_outputs(cube, weights, (False, True, True))
    _launch("onepass_tables_grouped_i8", "i8_tails_tables_ysplit", cube,
            weights, (), outs, weights.y_group)
    return _jax_order(*outs)


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
    m3[kidx[b, t], c, b] for the (B, T) z indices kidx; -1 reads zero."""
    cuda = launches_kernel(cube, weights)
    k = _slots(kidx, cube, (), "kidx")
    if not cuda:
        return onepass_tables_sel_i8_ref(cube, weights, k)
    B = cube.shape[0]
    t1, t2, _ = _table_outputs(cube, weights, (False, False, False))
    d3 = torch.empty((B, k.shape[1], weights.c2), dtype=torch.int32, device=cube.device)
    _launch("onepass_tables_sel_i8", "i8_tails_tables_sel", cube, weights,
            (k.data_ptr(),), (t1, t2, d3), k.shape[1])
    return t1.permute(1, 2, 0), t2.permute(1, 2, 0), d3.permute(2, 1, 0)


def onepass_scores_i8(
    cube: torch.Tensor, weights: CombinedWeights, ijk, valid=None
) -> Tables:
    """The three target reads s1 = m1[c, j], s2 = m2[c, i], s3 = m3[k, c]
    of every slot of ijk (B, T, 3) (i = x, j = y, k = z), each (C2, T, B);
    an index of -1, or a slot whose optional (B, T) `valid` is False,
    reads zero. No table leaves the kernel."""
    cuda = launches_kernel(cube, weights)
    idx = _slots(ijk, cube, (3,), "ijk")
    B, T = idx.shape[:2]
    ok = None
    if valid is not None:
        ok = torch.as_tensor(valid, device=cube.device)
        if ok.dtype != torch.bool or tuple(ok.shape) != (B, T):
            raise ValueError(f"valid must be bool {(B, T)}, got {ok.dtype} "
                             f"{tuple(ok.shape)}")
        ok = ok.contiguous()
    if not cuda:
        return onepass_scores_i8_ref(cube, weights, idx, ok)
    outs = tuple(
        torch.empty((B, T, weights.c2), dtype=torch.int32, device=cube.device)
        for _ in range(3)
    )
    _launch("onepass_scores_i8", "i8_tails_scores", cube, weights,
            (idx.data_ptr(), _ptr(ok)), outs, T)
    return tuple(o.permute(2, 1, 0) for o in outs)
