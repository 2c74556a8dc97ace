"""Fused scan→scores in bf16 for the folded linear pipeline (mode="pallas").

Port of radarml_tpu/ops/pallas_score.py :: fused_native_score. Against
the per-plane float32 class templates A_xz (C, X, Z), A_yz (C, Y, Z)
and A_xy (C, X, Y) (already /RADAR_MAX-scaled), each scan cube v
(X, Y, Z), cast to bf16, gives three tables

    M1[c, y] = Σ_{x,z} A_xz[c, x, z] · v[x, y, z]
    M2[c, x] = Σ_{y,z} A_yz[c, y, z] · v[x, y, z]
    M3[c, z] = Σ_{x,y} A_xy[c, x, y] · v[x, y, z]

from ONE read of the cube, and a target at cell (i, j, k) scores
M1[c, j] + M2[c, i] + M3[c, k] + b_c, in that float order.

The cube is cast to bf16 before the contraction, for a float32 stream
too, as in the JAX package (`Tensor.to(torch.bfloat16)` rounds to
nearest even, like XLA's convert): exact for 8-bit radar cubes, ≤2⁻⁹
relative input rounding for arbitrary float cubes. The templates stay
float32. The TPU kernel splits them into bf16 hi + lo halves only
because Mosaic's f32 dot is one bf16 pass; the CUDA kernel multiplies
the exact bf16 values by the float32 templates with FP32 FMAs, so the
port computes the same function without the split's ~3e-6 relative
error.

On a CUDA tensor `native_tables` launches the hand-written Hopper kernel
`csrc/native_score.cu` (its header says what bounds it and how it is
laid out) or raises; on a CPU tensor it runs the plain version
`native_tables_ref`. Nothing falls back from one to the other. The
templates must fit the kernel's shared memory on every device
(`shared_memory_bytes`; about 5 classes at the default arena), so a
model that scores on the CPU also scores on the card. None of the TPU
kernel's tiling (scans padded to a multiple of 8, Y padded to 16) is
carried over. The per-target reads are three gathers in PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

__all__ = [
    "KERNEL_LAUNCHES",
    "NativeTemplates",
    "fused_native_score",
    "fused_native_score_ref",
    "native_tables",
    "native_tables_ref",
    "native_templates",
    "shared_memory_bytes",
]

#: Launches of the CUDA kernel in this process. Only the wrapper adds to
#: it, once per launch; callers reset it to 0 to count a run.
KERNEL_LAUNCHES = 0

# The kernel's limits (csrc/native_score.cu: kMaxC, kMaxPairs, kWarps,
# kSmemMax).
MAX_C = 8
MAX_Z = 2 * 32 * 4
SMEM_MAX = 232448
_WARPS = 8


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def shared_memory_bytes(X: int, Y: int, Z: int, C: int) -> int:
    """Dynamic shared memory of one kernel block, in bytes: the three
    float32 templates (z padded to even), two bf16 slabs of Y rows and
    the block's accumulators. The same carve-up as make_layout in
    csrc/native_score.cu, region by region, each rounded to 16 bytes."""
    zp = (Z + 1) // 2
    zs = 2 * zp
    words = (_round4(C * X * zs) + _round4(C * Y * zs) + _round4(C * X * Y)
             + 2 * _round4(Y * zp) + _round4(C * Y) + _round4(_WARPS * C)
             + _round4(C * zs))
    return 4 * words


@dataclasses.dataclass(frozen=True)
class NativeTemplates:
    """The three folded float32 templates, as the kernel takes them:
    contiguous (C, X, Z), (C, Y, Z) and (C, X, Y) on one device. Build
    once per predictor with `native_templates`."""

    t_xz: torch.Tensor
    t_yz: torch.Tensor
    t_xy: torch.Tensor

    @property
    def dims(self) -> Tuple[int, int, int, int]:
        """(X, Y, Z, C)."""
        C, X, Z = self.t_xz.shape
        return X, self.t_yz.shape[1], Z, C

    @property
    def device(self) -> torch.device:
        return self.t_xz.device


def native_templates(tmpl_xz, tmpl_yz, tmpl_xy, device=None) -> NativeTemplates:
    """Lay the three templates out for the kernel: float32, contiguous, on
    `device` (default: where `tmpl_xz` lies). A no-op for templates that
    are laid out already. Raises on shapes that do not belong together."""
    ts = [torch.as_tensor(t) for t in (tmpl_xz, tmpl_yz, tmpl_xy)]
    dev = torch.device(device) if device is not None else ts[0].device
    ts = [t.to(dev, torch.float32).contiguous() for t in ts]
    if any(t.dim() != 3 for t in ts):
        raise ValueError("templates must be (C, X, Z), (C, Y, Z), (C, X, Y)")
    (C, X, Z), (C2, Y, Z2), (C3, X3, Y3) = (t.shape for t in ts)
    if not (C == C2 == C3 and Z == Z2 and X == X3 and Y == Y3):
        raise ValueError(
            "templates disagree: "
            + ", ".join(str(tuple(t.shape)) for t in ts)
            + " are not (C, X, Z), (C, Y, Z), (C, X, Y)"
        )
    return NativeTemplates(*ts)


def native_tables_ref(
    cubes: torch.Tensor, templates: NativeTemplates
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the bf16 cubes widened to
    float32 (exact) and three full-float32 einsums (no TF32). Returns
    float32 M1 (B, C, Y), M2 (B, C, X), M3 (B, C, Z)."""
    # models.linear.full_f32, inlined: ops/ must not import models/
    torch.backends.cuda.matmul.allow_tf32 = False
    v = cubes.to(torch.float32)
    return (
        torch.einsum("cxz,bxyz->bcy", templates.t_xz, v),
        torch.einsum("cyz,bxyz->bcx", templates.t_yz, v),
        torch.einsum("cxy,bxyz->bcz", templates.t_xy, v),
    )


def _check(cubes: torch.Tensor, templates: NativeTemplates) -> None:
    X, Y, Z, C = templates.dims
    if cubes.dtype != torch.bfloat16 or cubes.dim() != 4:
        raise ValueError(
            f"cubes must be (B, X, Y, Z) bfloat16, got {cubes.dtype} "
            f"{tuple(cubes.shape)}"
        )
    if tuple(cubes.shape[1:]) != (X, Y, Z):
        raise ValueError(
            f"cube shape {tuple(cubes.shape)} does not match the templates' "
            f"dims {(X, Y, Z)}"
        )
    if templates.device != cubes.device:
        raise ValueError(f"cubes on {cubes.device}, templates on {templates.device}")
    if C > MAX_C or Z > MAX_Z:
        raise ValueError(
            f"the kernel takes at most {MAX_C} classes and Z <= {MAX_Z}, "
            f"got C={C}, Z={Z}"
        )
    need = shared_memory_bytes(X, Y, Z, C)
    if need > SMEM_MAX:
        raise ValueError(
            f"templates of {C} classes at dims {(X, Y, Z)} need {need} bytes "
            f"of shared memory, over the kernel's limit of {SMEM_MAX} bytes "
            f"(227 KB a block on an H100)"
        )


def _library() -> ctypes.CDLL:
    from radarml_tpu_torch.ops._cuda_build import load_library

    lib = load_library("native_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.native_score_tables.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.native_score_tables.restype = i
    lib.native_score_smem_bytes.argtypes = [i] * 4
    lib.native_score_smem_bytes.restype = ctypes.c_long
    return lib


def native_tables(
    cubes: torch.Tensor, templates: NativeTemplates
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three float32 tables of a (B, X, Y, Z) bfloat16 cube batch:
    M1 (B, C, Y), M2 (B, C, X), M3 (B, C, Z).

    On a CUDA tensor the kernel writes them on the current stream, each
    element once, summed in a fixed order (the same bits on every run);
    it takes a contiguous cube and raises on any other. On a CPU tensor
    this is `native_tables_ref`.
    """
    global KERNEL_LAUNCHES
    _check(cubes, templates)
    if cubes.device.type == "cpu":
        return native_tables_ref(cubes, templates)
    if cubes.device.type != "cuda":
        raise ValueError(f"no native_score kernel for device {cubes.device}")
    if not cubes.is_contiguous():
        raise ValueError("the kernel takes a contiguous (B, X, Y, Z) cube")
    X, Y, Z, C = templates.dims
    B = cubes.shape[0]
    dev = cubes.device
    m1 = torch.empty((B, C, Y), dtype=torch.float32, device=dev)
    m2 = torch.empty((B, C, X), dtype=torch.float32, device=dev)
    m3 = torch.empty((B, C, Z), dtype=torch.float32, device=dev)
    if B == 0:
        return m1, m2, m3
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.native_score_tables(
            cubes.data_ptr(), templates.t_xz.data_ptr(), templates.t_yz.data_ptr(),
            templates.t_xy.data_ptr(), m1.data_ptr(), m2.data_ptr(), m3.data_ptr(),
            B, X, Y, Z, C, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"native_score_tables launch failed: CUDA error {err} "
            f"(B={B}, dims={(X, Y, Z)}, C={C})"
        )
    KERNEL_LAUNCHES += 1
    return m1, m2, m3


def _scores(tables, ijk: torch.Tensor, intercept: torch.Tensor) -> torch.Tensor:
    """(B, C, ·) tables + (B, T, 3) cell indices → (B, T, C) decisions,
    d1 + d2 + d3 + intercept in the JAX package's float order. Indices
    must lie inside the cube (the predictor clamps them)."""
    ijk = ijk.long()

    def read(m, idx):
        return m.gather(2, idx[:, None, :].expand(-1, m.shape[1], -1)).transpose(1, 2)

    m1, m2, m3 = tables
    d1 = read(m1, ijk[..., 1])
    d2 = read(m2, ijk[..., 0])
    d3 = read(m3, ijk[..., 2])
    return d1 + d2 + d3 + intercept.to(torch.float32)[None, None, :]


def _prepare(cubes, ijk, tmpl_xz, tmpl_yz, tmpl_xy, intercept):
    cubes = torch.as_tensor(cubes)
    dev = cubes.device
    templates = native_templates(tmpl_xz, tmpl_yz, tmpl_xy, device=dev)
    ijk = torch.as_tensor(ijk).to(dev)
    intercept = torch.as_tensor(intercept).to(dev)
    return cubes.to(torch.bfloat16).contiguous(), ijk, templates, intercept


def fused_native_score(cubes, ijk, tmpl_xz, tmpl_yz, tmpl_xy, intercept) -> torch.Tensor:
    """(B, X, Y, Z) cubes + (B, T, 3) int cell indices → (B, T, C) float32.

    Templates are (C, X, Z), (C, Y, Z), (C, X, Y) folded class templates
    (already /RADAR_MAX-scaled), intercept is (C,); everything moves to
    the cubes' device. The cubes are cast to bf16 first (a no-op for a
    bf16 stream); the tables come from `native_tables` (the kernel on a
    card), the reads from three gathers.
    """
    cubes, ijk, templates, intercept = _prepare(
        cubes, ijk, tmpl_xz, tmpl_yz, tmpl_xy, intercept)
    return _scores(native_tables(cubes, templates), ijk, intercept)


def fused_native_score_ref(cubes, ijk, tmpl_xz, tmpl_yz, tmpl_xy, intercept) -> torch.Tensor:
    """Plain version of `fused_native_score`: the same cast and reads
    around `native_tables_ref`."""
    cubes, ijk, templates, intercept = _prepare(
        cubes, ijk, tmpl_xz, tmpl_yz, tmpl_xy, intercept)
    return _scores(native_tables_ref(cubes, templates), ijk, intercept)
