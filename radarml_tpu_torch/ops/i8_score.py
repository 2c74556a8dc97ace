"""One-pass int8 contraction tables for the fused predict path.

Port of radarml_tpu/ops/pallas_i8_score.py :: onepass_tables_combined_i8.
The folded predict path scores a target at cube cell (i, j, k) by three
table reads: against the per-plane int8 class templates q_xz (C2, X, Z),
q_yz (C2, Y, Z) and q_xy (C2, X, Y) (C2 = levels · C), each int8 scan
cube v (value-128) gives

    m1[c, y] = Σ_{x,z} q_xz[c, x, z] · v[x, y, z]
    m2[c, x] = Σ_{y,z} q_yz[c, y, z] · v[x, y, z]
    m3[z, c] = Σ_{x,y} q_xy[c, x, y] · v[x, y, z]

and the target reads m1[·, j], m2[·, i], m3[k, ·]. All three come from
ONE read of each cube, exactly, in int32.

On a CUDA tensor `onepass_tables_combined_i8` launches the hand-written
Hopper kernel `csrc/i8_score.cu` (its header says what bounds it and how
it is laid out) or raises; on a CPU tensor it runs the plain version
`onepass_tables_combined_i8_ref`. Nothing falls back from one to the
other. Both go through the torch op `radarml_torch::combo_tables_i8`
(ops/library.py), which torch.export records in a serving artifact.

The wire layout is the plain contiguous (B, X, Y, Z) int8 tensor: none
of the TPU kernel's tiling (scan-minor packing, y-groups, δ-block
weights, lane padding, z-chunks) is carried over, and the weights are
the quantized templates themselves.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from radarml_tpu_torch.ops._cuda_build import count_launch

__all__ = [
    "CombinedWeights",
    "KERNEL_LAUNCHES",
    "build_combined_weights",
    "encode_int8_cubes",
    "onepass_tables_combined_i8",
    "onepass_tables_combined_i8_ref",
    "pack_cubes_i8",
]

#: Calls that launched the CUDA kernel in this process. Only the wrapper
#: adds to it, once a call; callers reset it to 0 to count a run.
KERNEL_LAUNCHES = 0

SMEM_MAX = 232448  # one block's dynamic shared memory on an H100 (kSmemMax)


def encode_int8_cubes(cubes, device=None) -> torch.Tensor:
    """Raw 0..255 scan cubes → the int8 wire format (value-128).

    Lossless for integer-valued radar data; non-integer values truncate
    toward zero first, like the JAX package's cast. uint8 converts with
    an xor of the top bit; int8 input is taken as already encoded and
    passes through. Returns a tensor on `device` (default: where the
    input lies; numpy input lands on the CPU).
    """
    if isinstance(cubes, np.ndarray):
        if cubes.dtype == np.int8:
            v = cubes
        elif cubes.dtype == np.uint8:
            v = (cubes ^ np.uint8(0x80)).view(np.int8)
        else:
            v = (np.asarray(cubes, np.int16) - 128).astype(np.int8)
        out = torch.from_numpy(np.ascontiguousarray(v))
    else:
        out = torch.as_tensor(cubes)
        if out.dtype == torch.uint8:
            out = (out ^ 0x80).view(torch.int8)
        elif out.dtype != torch.int8:
            out = (out.to(torch.int16) - 128).to(torch.int8)
    if device is not None:
        out = out.to(device, non_blocking=True)
    return out


def pack_cubes_i8(cubes) -> torch.Tensor:
    """The fused path's wire layout: (B, X, Y, Z) cubes → contiguous int8
    (value-128) on the host. One packed batch serves every fused tail."""
    return encode_int8_cubes(cubes).contiguous()


@dataclasses.dataclass(frozen=True)
class CombinedWeights:
    """The quantized per-plane templates, as the kernel takes them.

    `levels` quantization levels stack on the class axis: 2 = the
    error-compensated hi/lo split (C2 = 2C), 1 = single-level (C2 = C).
    A masked plane is None and gives a zero table.
    """

    q_xz: Optional[torch.Tensor]  # (C2, X, Z) int8
    q_yz: Optional[torch.Tensor]  # (C2, Y, Z) int8
    q_xy: Optional[torch.Tensor]  # (C2, X, Y) int8
    dims: Tuple[int, int, int, int]  # (X, Y, Z, C)
    levels: int = 2

    @property
    def c2(self) -> int:
        return self.levels * self.dims[3]

    @property
    def device(self) -> torch.device:
        return next(
            q.device for q in (self.q_xz, self.q_yz, self.q_xy) if q is not None
        )


def build_combined_weights(
    quant: Sequence[Optional[tuple]],
    dims: Tuple[int, int, int],
    levels: int = 2,
    device=None,
) -> CombinedWeights:
    """CombinedWeights from the per-plane quantized templates of
    RadarPredictor._quantized_split_templates: (q (C2, ·, ·) int8, s1,
    s2, const) per plane, None where the plane is masked.

    Checks each plane's tuple against `levels` (s2 is None exactly when
    levels == 1), so a single-level build cannot take split templates.
    """
    X, Y, Z = dims
    if levels not in (1, 2):
        raise ValueError(f"levels must be 1 or 2, got {levels}")
    shapes = ((X, Z), (Y, Z), (X, Y))
    qs = []
    C2 = None
    for q, shape in zip(quant, shapes):
        if q is None:
            qs.append(None)
            continue
        if (q[2] is None) != (levels == 1):
            raise ValueError(
                f"levels={levels} does not match the quant tuples "
                f"({'no ' if q[2] is None else ''}residual scale s2)"
            )
        t = torch.as_tensor(np.asarray(q[0]), device=device)
        if t.dtype != torch.int8 or tuple(t.shape[1:]) != shape:
            raise ValueError(
                f"template must be int8 (C2,) + {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if C2 is None:
            C2 = t.shape[0]
        elif t.shape[0] != C2:
            raise ValueError("templates disagree on C2")
        qs.append(t.contiguous())
    if C2 is None:
        raise ValueError("every plane is masked")
    if C2 % levels:
        raise ValueError(f"levels {levels} does not divide C2={C2}")
    return CombinedWeights(*qs, dims=(X, Y, Z, C2 // levels), levels=levels)


def onepass_tables_combined_i8_ref(
    cube: torch.Tensor, weights: CombinedWeights
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the three einsums, exact.

    int64 on the CPU, float64 on the card (every partial sum is an
    integer below 2^53); never float32, which cannot hold |m2| up to
    ~8.9e7 > 2^24 exactly, and never int8, where einsum wraps. Returns
    contiguous int32 m1 (C2, Y, B), m2 (C2, X, B), m3 (Z, C2, B).
    """
    X, Y, Z, _ = weights.dims
    B = cube.shape[0]
    C2 = weights.c2
    acc = torch.int64 if cube.device.type == "cpu" else torch.float64
    v = cube.to(acc)

    def table(q, spec, shape):
        if q is None:
            return torch.zeros(shape, dtype=torch.int32, device=cube.device)
        return torch.einsum(spec, q.to(acc), v).to(torch.int32)

    return (
        table(weights.q_xz, "cxz,bxyz->cyb", (C2, Y, B)),
        table(weights.q_yz, "cyz,bxyz->cxb", (C2, X, B)),
        table(weights.q_xy, "cxy,bxyz->zcb", (Z, C2, B)),
    )


def _check(cube: torch.Tensor, weights: CombinedWeights) -> None:
    X, Y, Z, _ = weights.dims
    if cube.dtype != torch.int8 or cube.dim() != 4:
        raise ValueError(
            f"cube must be (B, X, Y, Z) int8, got {cube.dtype} "
            f"{tuple(cube.shape)}"
        )
    if tuple(cube.shape[1:]) != (X, Y, Z):
        raise ValueError(
            f"cube shape {tuple(cube.shape)} does not match arena dims "
            f"{(X, Y, Z)}"
        )
    if weights.device != cube.device:
        raise ValueError(
            f"cube on {cube.device}, weights on {weights.device}"
        )


def check_operands(cube: torch.Tensor, weights: CombinedWeights) -> None:
    """Check a one-pass kernel op's operands in its wrapper: raises on a
    wrong shape, type or device. A CPU cube goes to the plain version; a
    CUDA cube's layout is checked by `card_operands` in the op."""
    _check(cube, weights)
    if cube.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no one-pass kernel for device {cube.device}")


def card_operands(cube: torch.Tensor, weights: CombinedWeights) -> None:
    """Check what a one-pass kernel reads through raw pointers, in the
    CUDA implementation of its op: an exported program calls the op
    directly, so this runs there on every call. Raises unless the cube
    and every template are contiguous, typed and shaped as the kernels
    take them, on one CUDA device, at a shape the built kernels' work
    plan takes (their `i8_score_batch_rows`: every class count; at X =
    43, Z = 351 up to 144 y values)."""
    _check(cube, weights)
    X, Y, Z, _ = weights.dims
    C2 = weights.c2
    shapes = ((C2, X, Z), (C2, Y, Z), (C2, X, Y))
    for q, shape in zip((weights.q_xz, weights.q_yz, weights.q_xy), shapes):
        if q is not None and (q.dtype != torch.int8 or tuple(q.shape) != shape
                              or q.device != cube.device or not q.is_contiguous()):
            raise ValueError(
                f"templates must be contiguous int8 {shape} on {cube.device}, "
                f"got {q.dtype} {tuple(q.shape)} on {q.device}"
            )
    if not cube.is_contiguous():
        raise ValueError("the kernels take a contiguous (B, X, Y, Z) cube")
    if cube.device.type != "cuda":
        raise ValueError(f"no one-pass kernel for device {cube.device}")
    planes = [int(q is not None) for q in (weights.q_xz, weights.q_yz, weights.q_xy)]
    if _library().i8_score_batch_rows(cube.shape[0], X, Y, Z, C2, *planes) == 0:
        raise ValueError(
            f"no int8 table kernel plan fits dims {(X, Y, Z)}: the templates of one class "
            f"row over x-slabs one row wide need more than the kernels' limit of {SMEM_MAX} "
            f"bytes of shared memory (227 KB a block on an H100)")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of csrc/i8_score.cu: the combo kernel's
    here, the lookup, glookup, sel and sel3 kernels' for ops/i8_tails.py."""
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        "i8_score_onepass_tables": [p] * 7 + [i] * 5 + [p],
        "i8_score_lookup_tables": [p] * 7 + [i] * 7 + [p],
        "i8_score_grouped_tables": [p] * 7 + [i] * 7 + [p],
        "i8_score_sel_tables": [p] * 8 + [i] * 6 + [p],
        "i8_score_sel3_scores": [p] * 9 + [i] * 6 + [p],
        "i8_score_batch_rows": [i] * 8,
        "i8_score_batch_width": [i] * 8,
        "i8_score_lookup_resident_at": [i] * 8,
        "i8_score_grouped_resident_at": [i] * 8,
    }
    for fn, types in argtypes.items():
        if hasattr(lib, fn):  # an earlier source's build lacks the newer entries
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = i
    return lib


def _library() -> ctypes.CDLL:
    from radarml_tpu_torch.ops._cuda_build import load_library

    return _bind(load_library("i8_score"))


def slab_width(weights: CombinedWeights, B: int = 1 << 30) -> int:
    """The x-slab width the CUDA kernel launches whole scans of a batch of
    B with for these weights (by default a large batch), under its plan
    (builds the kernel if needed)."""
    X, Y, Z, _ = weights.dims
    has = [int(q is not None) for q in (weights.q_xz, weights.q_yz, weights.q_xy)]
    return _library().i8_score_batch_width(B, X, Y, Z, weights.c2, *has)


MAX_GROUP_ROWS = 8  # class rows of one class group (kMaxC2: one mma n-tile)
MAX_TILES = 2  # n-tiles of a block's class rows (kMaxTiles)
WIDE_SLAB = 8  # x rows a slab of a block of several n-tiles needs at least (kWideSlab)
ONE_BLOCK_SCANS_PER_SM = 5  # scans an SM from which that block runs (kOneBlockScansPerSM)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def layout_bytes(XS: int, P: int, X: int, Y: int, Z: int, C2: int,
                 planes: Tuple[bool, bool, bool] = (True, True, True),
                 staged: bool = False) -> int:
    """Dynamic shared memory of one int8 kernel block, in bytes: make_layout
    in csrc/i8_score.cu, region by region, for scans in P parts of x-slabs
    XS wide and C2 class rows a block (`planes`: which templates are
    present), in ⌈C2 / 8⌉ mma n-tiles (the packed qxy words hold 8 rows a
    tile). On the staged route (`staged_route`) qxz travels with the
    slabs: one buffer holds a slab and its qxz rows, and one staging area
    holds the next unit's runs as the copy engine brought them."""
    h1, h2, h3 = planes
    nslab = -(-X // XS)
    nsp = -(-nslab // P)
    XP = min(X, nsp * XS)
    NR = _round_up(XS * Y, 4)
    SW = _round_up(Z, 16) // 4
    TW = -(-SW * 4 // 32) * 8 + 4
    KQ = -(-XS * Y // 32) * 8
    words = (C2 * XP * TW if h1 and not staged else 0) + (C2 * Y * TW if h2 else 0) + TW
    words += nsp * _round_up(C2, MAX_GROUP_ROWS) * KQ if h3 else 0
    slab = _round_up(NR * SW + 4, 4) + (XS * C2 * TW if staged and h1 else 0)
    stc = _round_up((XS * Y * Z + 30) // 4 + 8, 4) if staged else 0
    stq = _round_up((XS * Z + 30) // 4 + 8, 4) if staged and h1 else 0
    words += (1 if staged else 2) * slab + stc + C2 * stq
    words += 2 * (_round_up(C2 * Y, 4) + _round_up(C2 * X, 4) + _round_up(Z * C2, 4))
    return 4 * words


def _width(X, Y, Z, cg, planes, staged) -> int:
    """width_on in csrc/i8_score.cu: the widest balanced slab that fits."""
    for XS in range(X, 0, -1):
        if layout_bytes(XS, 1, X, Y, Z, cg, planes, staged) <= SMEM_MAX:
            n = -(-X // XS)
            return -(-X // n)
    return 0


def staged_route(X: int, Y: int, Z: int,
                 planes: Tuple[bool, bool, bool] = (True, True, True)) -> bool:
    """Whether whole scans at these dims take the staged route: rows of Z
    bytes that are not whole 16-byte units, wherever one class row fits it
    (staged_route in csrc/i8_score.cu); else slabs come by whole 16-byte
    units (or, past the staged route's fit, by byte loads)."""
    return Z % 16 != 0 and _width(X, Y, Z, 1, planes, True) > 0


def whole_scan_plan(X: int, Y: int, Z: int, C2: int,
                    planes: Tuple[bool, bool, bool] = (True, True, True)
                    ) -> Optional[Tuple[int, int]]:
    """The int8 kernels' whole-scan plan for C2 class rows: (rows a block,
    x-slab width), as group_rows and slab_width in csrc/i8_score.cu make
    them on the route of these dims (`staged_route`). Past one n-tile of
    rows, all C2 rows in one block (up to MAX_TILES n-tiles) where its
    slabs are at least WIDE_SLAB x rows wide (or X); otherwise the fewest
    class groups of at most MAX_GROUP_ROWS rows whose block fits SMEM_MAX
    with some slab width. The width is the widest that fits, balanced over
    the slabs; None where not even one row fits. A mirror for the tests:
    the CUDA implementation asks the built kernels (i8_score_batch_rows,
    i8_score_batch_width), whose plan for a large batch this is."""
    if MAX_GROUP_ROWS < C2 <= MAX_TILES * MAX_GROUP_ROWS:
        xs = _width(X, Y, Z, C2, planes, staged_route(X, Y, Z, planes))
        if xs >= min(X, WIDE_SLAB):
            return C2, xs
    return _groups_plan(X, Y, Z, C2, planes)


def _groups_plan(X: int, Y: int, Z: int, C2: int,
                 planes: Tuple[bool, bool, bool]) -> Optional[Tuple[int, int]]:
    """group_rows's class groups in csrc/i8_score.cu: the fewest groups of
    at most MAX_GROUP_ROWS rows whose block fits SMEM_MAX with some slab
    width, and that width; None where not even one row fits."""
    staged = staged_route(X, Y, Z, planes)
    for ng in range(-(-C2 // MAX_GROUP_ROWS), C2 + 1):
        cg = -(-C2 // ng)
        xs = _width(X, Y, Z, cg, planes, staged)
        if xs:
            return cg, xs
    return None


def batch_plan(B: int, sms: int, X: int, Y: int, Z: int, C2: int,
               planes: Tuple[bool, bool, bool] = (True, True, True)
               ) -> Optional[Tuple[int, int]]:
    """The plan at a batch of B scans on a card of `sms` SMs (batch_rows in
    csrc/i8_score.cu): `whole_scan_plan`, but that its block of several
    n-tiles needs a batch of at least ONE_BLOCK_SCANS_PER_SM scans an SM
    (one_block_pays); a smaller batch takes the class groups, whose
    cheaper first rounds win there."""
    plan = whole_scan_plan(X, Y, Z, C2, planes)
    if plan is None or plan[0] <= MAX_GROUP_ROWS or B >= ONE_BLOCK_SCANS_PER_SM * sms:
        return plan
    return _groups_plan(X, Y, Z, C2, planes)


def onepass_tables_combined_i8(
    cube: torch.Tensor, weights: CombinedWeights
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three one-pass tables of a (B, X, Y, Z) int8 cube batch.

    Returns int32 m1 (C2, Y, B), m2 (C2, X, B), m3 (Z, C2, B) — the JAX
    kernel's axis order without its padding — as permuted views of the
    scan-major buffers of the torch op `radarml_torch::combo_tables_i8`
    (ops/library.py): the kernel on a CUDA tensor (coalesced per scan),
    the plain version on a CPU tensor.
    """
    check_operands(cube, weights)
    t1, t2, t3 = torch.ops.radarml_torch.combo_tables_i8(
        cube, weights.q_xz, weights.q_yz, weights.q_xy, weights.levels)
    return t1.permute(1, 2, 0), t2.permute(1, 2, 0), t3.permute(1, 2, 0)


def combo_tables_cuda(
    cube: torch.Tensor, weights: CombinedWeights
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the combo kernel on CUDA operands, checked here: scan-major
    int32 t1 (B, C2, Y), t2 (B, C2, X), t3 (B, Z, C2). The CUDA
    implementation of `radarml_torch::combo_tables_i8`; counts the launch."""
    card_operands(cube, weights)
    X, Y, Z, _ = weights.dims
    B = cube.shape[0]
    C2 = weights.c2
    lib = _library()
    dev = cube.device
    t1 = torch.empty((B, C2, Y), dtype=torch.int32, device=dev)
    t2 = torch.empty((B, C2, X), dtype=torch.int32, device=dev)
    t3 = torch.empty((B, Z, C2), dtype=torch.int32, device=dev)

    def ptr(q):
        return None if q is None else q.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.i8_score_onepass_tables(
            cube.data_ptr(), ptr(weights.q_xz), ptr(weights.q_yz),
            ptr(weights.q_xy), t1.data_ptr(), t2.data_ptr(), t3.data_ptr(),
            B, X, Y, Z, C2, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"i8_score_onepass_tables launch failed: CUDA error {err} "
            f"(B={B}, dims={(X, Y, Z)}, C2={C2})"
        )
    count_launch(globals(), "KERNEL_LAUNCHES")
    return t1, t2, t3
