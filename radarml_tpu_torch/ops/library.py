"""The seven hand-written kernels as torch ops, namespace `radarml_torch`.

torch.export traces with fake tensors, which have no data pointer, so it
cannot go through the ctypes call that launches a kernel. Each kernel is
therefore an op of the `torch.library.Library` defined here:

* its CUDA implementation launches the hand-written kernel (the
  `*_cuda` functions of ops/i8_score.py, ops/i8_tails.py, ops/rbf.py and
  ops/score.py, each of which checks the layout of what the kernel reads
  by pointer, since an exported program calls the op directly, and
  counts its launches);
* its CPU implementation is the kernel's plain version (`*_ref`);
* its fake implementation gives the output shapes and dtypes.

No other device has an implementation, so an op on one raises, and no
op has an autograd formula (nothing differentiates through them). The
ops are registered with `Library.define` / `Library.impl` rather than
`torch.library.custom_op`, whose Python autograd and dispatch layers
add host time to every call (`utils/op_dispatch.py` measures both). The
public wrappers (`onepass_tables_combined_i8`, ..., `rbf_gram`,
`native_tables`) check their operands' shapes, types and devices, call
the op and lay out its result; the live predictor and an exported
serving artifact (serving/export.py) run the same ops. An op whose
schema declares no alias may not return a view of its input or of
another output, so the int8 ops return fresh
scan-major buffers and the wrappers permute them into the JAX axis
order. Template planes that a projection mask drops are `None`
(`Tensor?`). The lookup and glookup kernels' work plan queries the card,
so it is made inside the CUDA implementation, never in a traced graph.

Importing `radarml_tpu_torch.ops` imports this module, so the ops exist
before any wrapper runs and before a serving artifact is loaded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from radarml_tpu_torch.ops import i8_score, i8_tails, rbf, score
from radarml_tpu_torch.ops.i8_score import CombinedWeights

__all__ = ["NAMESPACE", "OPS"]

NAMESPACE = "radarml_torch"

#: The ops' names, one for each kernel.
OPS = ("combo_tables_i8", "lookup_tables_i8", "grouped_tables_i8", "sel_tables_i8",
       "sel3_scores_i8", "rbf_gram", "native_tables")

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Plane = Optional[torch.Tensor]


def _weights(cube: torch.Tensor, q_xz: Plane, q_yz: Plane, q_xy: Plane,
             levels: int) -> CombinedWeights:
    """The CombinedWeights of an op's flattened operands."""
    X, Y, Z = cube.shape[1:]
    return CombinedWeights(q_xz, q_yz, q_xy, dims=(X, Y, Z, _c2(q_xz, q_yz, q_xy) // levels),
                           levels=levels)


def _c2(q_xz: Plane, q_yz: Plane, q_xy: Plane):
    """Class rows of the templates (the wrappers refuse all three None)."""
    return next(q.shape[0] for q in (q_xz, q_yz, q_xy) if q is not None)


def _scan_major(tables: Tables) -> Tables:
    """JAX-order m1 (C2, Y, B), m2 (C2, X, B), m3 (Z, C2, B) → fresh
    scan-major (B, C2, Y), (B, C2, X), (B, Z, C2)."""
    return tuple(t.permute(2, 0, 1).contiguous() for t in tables)


def _empty_tables(cube: torch.Tensor, c2) -> Tables:
    B, X, Y, Z = cube.shape
    return (cube.new_empty((B, c2, Y), dtype=torch.int32),
            cube.new_empty((B, c2, X), dtype=torch.int32),
            cube.new_empty((B, Z, c2), dtype=torch.int32))


_LIB = torch.library.Library(NAMESPACE, "DEF")
_PLANES = "Tensor cube, Tensor? q_xz, Tensor? q_yz, Tensor? q_xy, int levels"
_THREE = "(Tensor, Tensor, Tensor)"


def _define(schema: str, cpu, cuda, fake) -> None:
    """Define the op `schema` with its CPU (plain version), CUDA (kernel)
    and fake implementations."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


def _fake_tables(cube, q_xz, q_yz, q_xy, levels):
    return _empty_tables(cube, _c2(q_xz, q_yz, q_xy))


# -- B1: the combo kernel; B3 and B2: the lookup and glookup kernels -------------


_define(
    f"combo_tables_i8({_PLANES}) -> {_THREE}",
    lambda cube, q_xz, q_yz, q_xy, levels: _scan_major(
        i8_score.onepass_tables_combined_i8_ref(cube, _weights(cube, q_xz, q_yz, q_xy, levels))),
    lambda cube, q_xz, q_yz, q_xy, levels: i8_score.combo_tables_cuda(
        cube, _weights(cube, q_xz, q_yz, q_xy, levels)),
    _fake_tables)
_define(
    f"lookup_tables_i8({_PLANES}) -> {_THREE}",
    lambda cube, q_xz, q_yz, q_xy, levels: _scan_major(
        i8_tails.onepass_tables_i8_ref(cube, _weights(cube, q_xz, q_yz, q_xy, levels))),
    lambda cube, q_xz, q_yz, q_xy, levels: i8_tails.split_tables_cuda(
        "lookup", cube, _weights(cube, q_xz, q_yz, q_xy, levels)),
    _fake_tables)
_define(
    f"grouped_tables_i8({_PLANES}) -> {_THREE}",
    lambda cube, q_xz, q_yz, q_xy, levels: _scan_major(
        i8_tails.onepass_tables_grouped_i8_ref(cube, _weights(cube, q_xz, q_yz, q_xy, levels))),
    lambda cube, q_xz, q_yz, q_xy, levels: i8_tails.split_tables_cuda(
        "grouped", cube, _weights(cube, q_xz, q_yz, q_xy, levels)),
    _fake_tables)


# -- B4: the sel kernel -----------------------------------------------------------


def _sel_cpu(cube, q_xz, q_yz, q_xy, levels, kidx):
    m1, m2, d3 = i8_tails.onepass_tables_sel_i8_ref(
        cube, _weights(cube, q_xz, q_yz, q_xy, levels), kidx)
    return (m1.permute(2, 0, 1).contiguous(), m2.permute(2, 0, 1).contiguous(),
            d3.permute(2, 1, 0).contiguous())


def _sel_fake(cube, q_xz, q_yz, q_xy, levels, kidx):
    t1, t2, _ = _empty_tables(cube, _c2(q_xz, q_yz, q_xy))
    return t1, t2, cube.new_empty((cube.shape[0], kidx.shape[1], t1.shape[1]),
                                  dtype=torch.int32)


_define(
    f"sel_tables_i8({_PLANES}, Tensor kidx) -> {_THREE}",
    _sel_cpu,
    lambda cube, q_xz, q_yz, q_xy, levels, kidx: i8_tails.sel_tables_cuda(
        cube, _weights(cube, q_xz, q_yz, q_xy, levels), kidx),
    _sel_fake)


# -- B5: the sel3 kernel ----------------------------------------------------------


def _sel3_cpu(cube, q_xz, q_yz, q_xy, levels, ijk, valid):
    reads = i8_tails.onepass_scores_i8_ref(
        cube, _weights(cube, q_xz, q_yz, q_xy, levels), ijk, valid)
    return tuple(r.permute(2, 1, 0).contiguous() for r in reads)


def _sel3_fake(cube, q_xz, q_yz, q_xy, levels, ijk, valid):
    shape = (cube.shape[0], ijk.shape[1], _c2(q_xz, q_yz, q_xy))
    return tuple(cube.new_empty(shape, dtype=torch.int32) for _ in range(3))


_define(
    f"sel3_scores_i8({_PLANES}, Tensor ijk, Tensor? valid) -> {_THREE}",
    _sel3_cpu,
    lambda cube, q_xz, q_yz, q_xy, levels, ijk, valid: i8_tails.sel3_scores_cuda(
        cube, _weights(cube, q_xz, q_yz, q_xy, levels), ijk, valid),
    _sel3_fake)


# -- B6: the RBF Gram kernel ------------------------------------------------------


_define(
    "rbf_gram(Tensor X, Tensor S, float gamma) -> Tensor",
    lambda X, S, gamma: rbf.rbf_gram_ref(X, S, gamma).contiguous(),
    rbf.rbf_gram_cuda,
    lambda X, S, gamma: X.new_empty((X.shape[0], S.shape[0]), dtype=torch.float32))


# -- B7: the bf16 table kernel ----------------------------------------------------


def _native_fake(cubes, t_xz, t_yz, t_xy):
    B, X, Y, Z = cubes.shape
    C = t_xz.shape[0]
    return tuple(cubes.new_empty((B, C, n), dtype=torch.float32) for n in (Y, X, Z))


_define(
    f"native_tables(Tensor cubes, Tensor t_xz, Tensor t_yz, Tensor t_xy) -> {_THREE}",
    lambda cubes, t_xz, t_yz, t_xy: tuple(t.contiguous() for t in score.native_tables_ref(
        cubes, score.NativeTemplates(t_xz, t_yz, t_xy))),
    lambda cubes, t_xz, t_yz, t_xy: score.native_tables_cuda(
        cubes, score.NativeTemplates(t_xz, t_yz, t_xy)),
    _native_fake)
