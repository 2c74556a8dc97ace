"""The real-time predict pipeline on PyTorch.

Port of radarml_tpu/models/pipeline.py. Per scan, each target's three
2-D projections are sliced at its cube indices, zoomed into the
training arena, concatenated into the feature vector and scored by the
calibrated linear model, then thresholded. Four modes compute that:

* ``exact`` — the reference math stage by stage (slice, spline-zoom
  matrix products, concat, scale, score);
* ``fast`` — the model folded into per-plane class templates at the
  scan's native resolution, so a target costs three table reads after
  three whole-cube contractions, products on the cube as it lies
  (`folded_tables`); with ``cube_dtype="int8"`` the contractions run
  exactly in integers against error-compensated int8 templates
  (`folded_tables_exact` on the card, int64 einsums on the CPU);
* ``fused`` — the same int8 tables from ONE read of each cube by a
  hand-written CUDA kernel, then a plain-PyTorch tail that dequantizes,
  looks up, calibrates and thresholds. ``fused_tail`` picks the kernel:
  ``combo`` (ops/i8_score.py), ``lookup``, ``glookup``, ``sel`` or
  ``sel3`` (ops/i8_tails.py; the last two select the target reads in
  the kernel). Its split decisions equal ``fast`` + int8's under every
  tail;
* ``pallas`` — the float32 templates against the cube cast to bf16, all
  three tables from ONE read of each cube by a hand-written CUDA kernel
  (ops/score.py), then three reads and the intercept. Takes float32 and
  bfloat16 streams and the full projection mask only, as in the JAX
  package.

A kernel SVM (models/svc.SVCModel) has no linear fold: ``exact`` and
``fast`` both score its exact features with its Platt-coupled
``predict_proba`` (the fused RBF Gram kernel, ops/rbf.py); ``pallas``
builds the same exact path and ``fused`` refuses it, as in the JAX
package. A NeuralClassifier (the CNN, or the SGAN's classifier head) is
served by one path in every mode but ``fused``, which refuses it: each
target's planes are scaled, bicubic-resized as in training and run
through the network.

Dynamic target counts are a static ``max_targets`` axis with a validity
mask, as in the JAX package. Results are tensors on the predictor's
``device``.
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from radarml_tpu_torch.core.arena import RADAR_MAX, Arena, ProjMask
from radarml_tpu_torch.models.linear import (
    LinearModel,
    SigmoidCalibration,
    calibrated_from_decision,
    full_f32,
    predict_proba_calibrated,
    predict_proba_log_loss,
    proba_from_decision,
)
from radarml_tpu_torch.models.svc import SVCModel, predict_proba as svc_predict_proba
from radarml_tpu_torch.ops.features import predict_zoom
from radarml_tpu_torch.ops.i8_score import (
    build_combined_weights,
    encode_int8_cubes,
    onepass_tables_combined_i8,
    pack_cubes_i8,
)
from radarml_tpu_torch.ops.i8_tails import (
    build_grouped_weights,
    build_onepass_weights,
    onepass_scores_i8,
    onepass_tables_grouped_i8,
    onepass_tables_i8,
    onepass_tables_sel_i8,
)
from radarml_tpu_torch.ops.resample import bicubic_pair, spline_zoom_pair
from radarml_tpu_torch.ops.score import fused_native_score, native_templates
from radarml_tpu_torch.parallel.mesh import check_mesh

UNKNOWN = -1  # prediction index when below min_proba (the "Unknown" label)

_CUBE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
}

__all__ = [
    "UNKNOWN",
    "NeuralClassifier",
    "RadarPredictor",
    "encode_host_cubes",
    "encode_int8_cubes",
    "exact_tables",
    "folded_tables",
    "folded_tables_exact",
    "pad_targets",
]


def encode_host_cubes(cubes: np.ndarray, cube_dtype: str) -> torch.Tensor:
    """Narrow a canonical 0..255 host cube to a stream dtype, on the host.

    Serving layers call this at ingest so every later copy moves 1 B per
    voxel (2 for bfloat16). int8 output carries the value-128 wire
    encoding; non-integer input truncates like the device-side cast.
    Returns a CPU tensor.
    """
    cubes = np.asarray(cubes)
    if cube_dtype == "uint8":
        u8 = cubes if cubes.dtype == np.uint8 else cubes.astype(np.uint8)
        return torch.from_numpy(np.ascontiguousarray(u8))
    if cube_dtype == "int8":
        return encode_int8_cubes(
            cubes if cubes.dtype in (np.int8, np.uint8) else cubes.astype(np.uint8)
        )
    if cube_dtype == "bfloat16":
        return torch.from_numpy(np.asarray(cubes, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(cubes, np.float32))


def folded_tables(cubes: torch.Tensor, templates) -> List[Optional[torch.Tensor]]:
    """The fast path's three float32 tables of a (B, X, Y, Z) float32 cube
    batch against the class templates t_xz (C, X, Z), t_yz (C, Y, Z), t_xy
    (C, X, Y) (None for a masked plane): M1 (B, C, Y), M2 (B, C, X), M3
    (B, C, Z), each None where its template is.

    The cube is contracted as it lies, with no permuted copy: M2 is one
    product of the (C, Y·Z) template by the (B·X, Y·Z) view, transposed;
    M3 a batched product over the scans of each scan's (Z, X·Y) view (the
    (X·Y, Z) rows, transposed) by the (X·Y, C) template; M1 a batched
    product over the scans of each x's (Y, Z) rows by that x's (Z, C)
    template, summed over x in order. At a small batch (`one_product_m1`)
    M1 is instead one product of a (B·Y, X·Z) permuted copy of the cube
    by the (X·Z, C) template; under a symbolic batch (torch.export) a
    `torch.cond` makes the same choice at each call, so an exported
    program keeps the live predictor's bits. Full float32 (TF32 off); the
    sums run in another order than the JAX package's einsums.
    """
    full_f32()
    B, X, Y, Z = cubes.shape
    t_xz, t_yz, t_xy = templates
    m1 = m2 = m3 = None
    if t_yz is not None:
        C = t_yz.shape[0]
        m2 = torch.mm(t_yz.reshape(C, Y * Z), cubes.reshape(B * X, Y * Z).T)
        m2 = m2.view(C, B, X).transpose(0, 1)
    if t_xy is not None:
        C = t_xy.shape[0]
        m3 = torch.matmul(cubes.reshape(B, X * Y, Z).transpose(1, 2), t_xy.reshape(C, X * Y).T)
        m3 = m3.transpose(1, 2)
    if t_xz is not None:
        one = one_product_m1(cubes.shape)
        if isinstance(one, bool):
            m1 = (_m1_one_product if one else _m1_per_x)(cubes, t_xz)
        else:  # a symbolic batch: the program chooses at each call
            m1 = torch.cond(one, _m1_one_product, _m1_per_x, (cubes, t_xz))
    return [None if m1 is None else m1.transpose(1, 2), m2, m3]


def _m1_one_product(cubes: torch.Tensor, t_xz: torch.Tensor) -> torch.Tensor:
    """M1 (B, Y, C) as one product of a (B·Y, X·Z) permuted copy of the
    cube by the (X·Z, C) template."""
    B, X, Y, Z = cubes.shape
    C = t_xz.shape[0]
    rows = cubes.permute(0, 2, 1, 3).reshape(B * Y, X * Z)  # the copy
    return torch.mm(rows, t_xz.permute(1, 2, 0).reshape(X * Z, C)).view(B, Y, C)


def _m1_per_x(cubes: torch.Tensor, t_xz: torch.Tensor) -> torch.Tensor:
    """M1 (B, Y, C) as a batched product a x over the scans of that x's (Y,
    Z) rows by its (Z, C) template, summed over x in order."""
    B = cubes.shape[0]
    acc = torch.bmm(cubes[:, 0], t_xz[:, 0, :].T.expand(B, -1, -1))
    for x in range(1, cubes.shape[1]):
        acc = torch.baddbmm(acc, cubes[:, x], t_xz[:, x, :].T.expand(B, -1, -1))
    return acc


# float32 holds every integer of magnitude up to 2^24. A product of an
# int8 template value (|q| <= 127) and an int8 cube value (|v| <= 128) is
# at most 16,256 in magnitude, so a sum of at most this many of them has
# every partial sum exact, in whatever order a product kernel adds them.
EXACT_F32_TERMS = (1 << 24) // (127 * 128)  # 1032


# The float32 route (`folded_tables`) takes M1 in one product over a
# permuted copy of the cube while one x's float32 slab of the batch,
# B·Y·Z·4 bytes, stays within this many; past it, one product a x on the
# cube as it lies. The copy does not grow with the classes. The product a
# x launches X times, and a launch pays for itself once its slab takes
# long enough to read. Measured on an H100 (utils/route_bench.py, the demo
# model's step with each route forced): the one product won or tied at
# slabs up to 21 MiB (1024 scans at 22 x 31 x 176, 512 at 43 x 31 x 351),
# the product a x won at 32 MiB (768 scans at 43 x 31 x 351); so too for
# 9- and 16-class models (--table class_steps). Under a symbolic batch
# (torch.export) a torch.cond chooses at each call.
M1_SLAB_BYTES = 24 << 20


def one_product_m1(shape):
    """Whether `folded_tables` computes M1 of a (B, X, Y, Z) batch in one
    product (True) or one a x: a bool, or under a symbolic batch a
    SymBool."""
    B, X, Y, Z = shape
    return B * Y * Z * 4 <= M1_SLAB_BYTES


# The int8 route (`exact_tables`) takes m1 and m3 in one batched product
# each over the batch's (scan, x) blocks while the bytes those products
# move stay within this many: each reads the float32-widened cube (4·B·X·
# Y·Z), copies its template once a scan and writes each block's partial
# table (together 4·B·X·(Y + Z) a template row); past it, the products a
# x and the runs of (x, y), whose launches cost the same at any batch.
# The copies grow with the class rows, so the last block batch falls as
# they grow. Measured on an H100 (utils/route_bench.py --table
# class_steps: the fast int8 steps of 3-, 9- and 16-class models with
# each route forced, 64 to 1024 scans, both arenas; and the demo model's
# steps to 4096): at this budget every step took its faster route or one
# within 10% of it (the blocks' last batch: 1593 / 414 scans at 3 classes
# at 22 x 31 x 176 / 43 x 31 x 351, 1162 / 307 at 9, 883 / 236 at 16).
EXACT_BLOCK_BYTES = 1792 << 20


def block_products_exact(shape, rows):
    """Whether `exact_tables` computes m1 and m3 of a (B, X, Y, Z) batch
    over the (scan, x) blocks, `rows` the template rows of each unmasked
    plane of the two (xz, xy): a bool, or under a symbolic batch a
    SymBool."""
    B, X, Y, Z = shape
    return sum(4 * B * X * (Y * Z + (Y + Z) * r) for r in rows) <= EXACT_BLOCK_BYTES


def _runs(n: int) -> List[slice]:
    """[0, n) in consecutive runs of at most EXACT_F32_TERMS."""
    return [slice(a, min(n, a + EXACT_F32_TERMS)) for a in range(0, n, EXACT_F32_TERMS)]


def folded_tables_exact(cubes: torch.Tensor, quant) -> List[Optional[torch.Tensor]]:
    """`exact_tables` as int64 (see there)."""
    return [None if m is None else m.to(torch.int64) for m in exact_tables(cubes, quant)]


def exact_tables(cubes: torch.Tensor, quant) -> List[Optional[torch.Tensor]]:
    """The fast int8 path's raw integer tables on any device: a (B, X, Y,
    Z) int8 cube batch against the int8 templates q_xz (C2, X, Z), q_yz
    (C2, Y, Z), q_xy (C2, X, Y) (None for a masked plane; int8, or their
    values as float32) gives float64 m1 (B, C2, Y), m2 (B, C2, X), m3 (B,
    C2, Z), exactly: integers, the values of the int64 einsums and of the
    JAX package's int32 ones.

    The cube is widened to float32 once and contracted as it lies, in runs
    of at most EXACT_F32_TERMS products (each run's float32 result is an
    exact integer), the runs summed in float64 (exact below 2^53): m1 over
    each run of z for each x (a batched product over the scans of its (Y,
    Z) rows by that x's (Z, C2) template), m2 over each run of z for each
    y (one batched product over y of the (C2, Z) template by the (Z, B·X)
    rows), m3 over runs of the flattened (x, y) of each scan's (X·Y, Z)
    view. At a small batch (`block_products_exact`) m1 and m3 take one
    batched product each over the (scan, x) blocks instead
    (`_small_batch_exact`); under a symbolic batch (torch.export) a
    `torch.cond` makes the same choice at each call. On the card this is
    the fast int8 path; the CPU predictor keeps its int64 einsums, which
    the tests hold this to.
    """
    full_f32()  # a TF32 product would round
    B, X, Y, Z = cubes.shape
    v = cubes.to(torch.float32).contiguous()
    q_xz, q_xy = (None if q is None else q.to(torch.float32) for q in (quant[0], quant[2]))
    m2 = None
    if quant[1] is not None:
        q_yz = quant[1].to(torch.float32)
        C2 = q_yz.shape[0]
        rows = v.view(B * X, Y, Z).permute(1, 2, 0)  # (Y, Z, B·X), no copy
        tq = q_yz.permute(1, 0, 2)  # (Y, C2, Z), no copy
        m2 = reduce(torch.add, (torch.bmm(tq[:, :, r], rows[:, r]).sum(0, dtype=torch.float64)
                                for r in _runs(Z)))
        m2 = m2.view(C2, B, X).transpose(0, 1)
    present = [q for q in (q_xz, q_xy) if q is not None]
    if not present:
        return [None, m2, None]
    small = block_products_exact(cubes.shape, [q.shape[0] for q in present])
    if isinstance(small, bool):
        m1, m3 = (_small_batch_exact if small else _per_x_exact)(v, q_xz, q_xy)
    else:  # a symbolic batch: the program chooses at each call

        def branch(fn):
            def run(v, *qs):
                it = iter(qs)
                out = fn(v, *(None if q is None else next(it) for q in (q_xz, q_xy)))
                # contiguous: both branches' outputs must have one layout
                return tuple(m.contiguous() for m in out if m is not None)
            return run

        out = iter(torch.cond(small, branch(_small_batch_exact), branch(_per_x_exact),
                              (v, *present)))
        m1, m3 = (None if q is None else next(out) for q in (q_xz, q_xy))
    return [m1, m2, m3]


def _per_x_exact(v: torch.Tensor, q_xz, q_xy) -> Tuple:
    """Exact float64 m1 (B, C2, Y) and m3 (B, C2, Z) of a float32-widened
    int8 batch `v` on the cube as it lies: m1 a batched product over the
    scans for each x and run of z, m3 a batched product over the scans for
    each run of the flattened (x, y)."""
    B, X, Y, Z = v.shape
    f64 = torch.float64
    m1 = m3 = None
    if q_xy is not None:
        C2 = q_xy.shape[0]
        flat, tq = v.view(B, X * Y, Z), q_xy.reshape(C2, X * Y)
        m3 = reduce(torch.add, (torch.matmul(flat[:, r].transpose(1, 2), tq[:, r].T).to(f64)
                                for r in _runs(X * Y)))
        m3 = m3.transpose(1, 2)
    if q_xz is not None:
        # stacked, not written through bmm's out=: torch.export on the card
        # then specialized the batch
        part = torch.stack([torch.bmm(v[:, x, :, r], q_xz[:, x, r].T.expand(B, -1, -1))
                            for x in range(X) for r in _runs(Z)])
        m1 = part.sum(0, dtype=f64).transpose(1, 2)
    return m1, m3


def _per_scan_x(t: torch.Tensor, B: int) -> torch.Tensor:
    """A (X, ·, ·) template as (B·X, ·, ·), its x-th block at b·X + x: one
    product over the batch's (scan, x) blocks then takes one launch."""
    return t.expand((B,) + tuple(t.shape)).reshape((B * t.shape[0],) + tuple(t.shape[1:]))


def _small_batch_exact(v: torch.Tensor, q_xz, q_xy) -> Tuple:
    """Exact float64 m1 (B, C2, Y) and m3 (B, C2, Z) of a float32-widened
    int8 batch `v` in one batched product each, over its (scan, x) blocks:
    m1 from each block's (Y, Z) rows by that x's (Z, C2) template, m3 from
    that x's (C2, Y) template by the block; each block's sum (at most Z
    or Y products) is an exact float32 integer, and the blocks add up
    over x in float64. The templates are copied once a scan (B·X·Z·C2 and
    B·X·C2·Y values); the cube is not."""
    B, X, Y, Z = v.shape
    blocks = v.view(B * X, Y, Z)
    m1 = m3 = None
    if q_xz is not None:
        C2 = q_xz.shape[0]
        t = _per_scan_x(q_xz.permute(1, 2, 0), B)  # (B·X, Z, C2)
        part = reduce(torch.add, (torch.bmm(blocks[:, :, r], t[:, r]).view(B, X, Y, C2)
                                  .sum(1, dtype=torch.float64) for r in _runs(Z)))
        m1 = part.transpose(1, 2)
    if q_xy is not None:
        C2 = q_xy.shape[0]
        t = _per_scan_x(q_xy.permute(1, 0, 2), B)  # (B·X, C2, Y)
        m3 = reduce(torch.add, (torch.bmm(t[:, :, r], blocks[:, r]).view(B, X, C2, Z)
                                .sum(1, dtype=torch.float64) for r in _runs(Y)))
    return m1, m3


@dataclasses.dataclass(frozen=True)
class NeuralClassifier:
    """Serving wrapper for the neural families (CNN / SGAN classifier).

    Targets slice out of the cube, each projection scales to [-1, 1] and
    bicubic-resizes to `rescale` exactly as training preprocessing did
    (dnn.py:202-245, data/preprocess.py), and `apply` maps the (N, h, w, 3)
    view stack on `device` to (N, n_classes) logits in inference mode.
    """

    apply: Callable
    rescale: Tuple[int, int]
    n_classes: int
    device: torch.device = torch.device("cpu")


_FUSED_TAILS = ("lookup", "glookup", "combo", "sel", "sel3")


@dataclasses.dataclass(frozen=True)
class RadarPredictor:
    """Batched scan→detections predictor.

    Args mirror the reference CLI (predict.py:133-157): a training
    arena (fixes feature geometry), a scan arena (may differ → zoom),
    projection mask, calibrated linear model or SVC, and the min_proba
    threshold below which a target is 'Unknown'. `device` is where the
    predictor computes (default: where the model's parameters lie);
    inputs are moved there, and results come back there.
    """

    train_arena: Arena
    scan_arena: Arena
    model: Union[LinearModel, SVCModel, NeuralClassifier]
    calibration: Optional[SigmoidCalibration] = None
    proj_mask: ProjMask = ProjMask(True, True, True)
    min_proba: float = 0.7
    # "exact" | "fast" | "fused" | "pallas". "fused" is the bulk path: the
    # one-pass int8 kernel over pack_host batches, decisions equal to
    # fast+int8. "pallas" is the one-pass bf16 kernel (ops/score.py) over
    # float32 or bfloat16 streams, with the full projection mask.
    mode: str = "exact"
    # Fused-mode kernel and tail: "combo", "lookup" (scans cut across
    # blocks at small batches) and "glookup" (y-split kernel) emit the raw
    # tables, which PyTorch dequantizes and reads; "sel" selects the
    # z-table reads in the kernel, "sel3" all three. Same decisions under
    # every tail.
    fused_tail: str = "combo"
    # Template quantization of the fused path:
    #   "split"  — error-compensated hi/lo int8 pair (C2 = 2C), decisions
    #              bit-identical to mode="fast" + cube_dtype="int8";
    #   "single" — q1-only templates (C2 = C): half the template rows,
    #              template error up to max|t|/254 per element, so its
    #              decisions are not guaranteed to equal fast+int8's.
    fused_quant: str = "split"
    # A parallel.mesh.Mesh: each rank scores its contiguous slice of the
    # batch on its own device and every rank returns the whole batch's
    # outputs. The batch must divide by the mesh's data ranks.
    mesh: object = None
    # Device dtype of the scan stream: "float32" | "bfloat16" | "uint8" |
    # "int8" (value-128 on the wire). All four are lossless for 8-bit
    # radar cubes; the 8-bit ones truncate non-integer values.
    cube_dtype: str = "float32"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.mode == "pallas" and self.cube_dtype in ("uint8", "int8"):
            raise ValueError("pallas mode supports float32/bfloat16 "
                             "streams; use mode='fused' for int8")
        check_mesh(self.mesh)
        is_svc = isinstance(self.model, SVCModel)
        is_neural = isinstance(self.model, NeuralClassifier)
        if not (is_svc or is_neural or isinstance(self.model, LinearModel)):
            raise TypeError(f"cannot serve a {type(self.model).__name__}")
        if self.mode not in ("exact", "fast", "fused", "pallas"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "fused" and (is_svc or is_neural):
            raise ValueError("fused mode folds linear models only")
        if self.cube_dtype not in _CUBE_DTYPES:
            raise ValueError(f"unknown cube_dtype {self.cube_dtype!r}")
        if self.device is not None:
            dev = torch.device(self.device)
        elif self.mesh is not None:
            dev = self.mesh.device
        elif is_svc or is_neural:
            dev = self.model.device
        else:
            dev = self.model.coef.device
        object.__setattr__(self, "device", dev)
        full_f32()
        if self.mode == "fused":
            if self.fused_tail not in _FUSED_TAILS:
                raise ValueError(
                    "fused_tail must be 'lookup', 'glookup', 'combo', "
                    "'sel' or 'sel3'"
                )
            if self.fused_quant not in ("split", "single"):
                raise ValueError("fused_quant must be 'split' or 'single'")
            if self.fused_quant == "single" and self.fused_tail != "combo":
                raise ValueError(
                    "fused_quant='single' applies to fused_tail='combo' only"
                )
            # The kernel's wire format IS int8 (value-128); every stream
            # dtype resolves to it, losslessly for 8-bit radar cubes.
            object.__setattr__(self, "cube_dtype", "int8")
            object.__setattr__(self, "_fn", self._build_fused())
        elif is_neural:  # every non-fused mode serves the network as it is
            object.__setattr__(self, "_fn", self._build_neural())
        elif self.mode == "pallas" and not is_svc:
            object.__setattr__(self, "_fn", self._build_pallas())
        elif self.mode == "fast" and not is_svc:
            object.__setattr__(self, "_fn", self._build_folded())
        else:  # exact, and fast / pallas for an SVC (nothing to fold)
            object.__setattr__(self, "_fn", self._build())

    # -- host-side template folding (float64 numpy, as in the JAX package) --
    def _folded_templates(self) -> np.ndarray:
        """Fold zoom matrices + /255 scale + linear weights into
        per-class templates at the scan's NATIVE plane resolution.

        The per-target slice→zoom→flatten→concat→scale→score is linear
        in the raw planes, so for each plane p with zoom operators R_p,
        C_p and weight block W_c^p, decision contributions collapse to
        ⟨R_pᵀ W_c^p C_p, X_p⟩ / RADAR_MAX. Returns (C, F_native) float32.
        """
        scan = self.scan_arena
        zoom = predict_zoom(self.train_arena, scan)
        coef = self.model.coef.detach().cpu().numpy().astype(np.float64)
        C = coef.shape[0]
        parts = []
        off = 0
        for shape, z, keep in zip(
            (scan.xz_shape, scan.yz_shape, scan.xy_shape), zoom, self.proj_mask
        ):
            if not keep:
                continue
            r, c, (o_h, o_w) = spline_zoom_pair(tuple(shape), tuple(z))
            W = coef[:, off : off + o_h * o_w].reshape(C, o_h, o_w)
            A = np.einsum("oh,cop,pw->chw", r, W, c) / RADAR_MAX
            parts.append(A.reshape(C, -1))
            off += o_h * o_w
        return np.concatenate(parts, axis=1).astype(np.float32)

    def _split_templates(self) -> List[Optional[np.ndarray]]:
        """Folded templates as per-plane (C, ·, ·) float32 arrays (None
        where the plane is masked out)."""
        scan = self.scan_arena
        templates = self._folded_templates()
        C = templates.shape[0]
        out = []
        off = 0
        for shape, keep in zip(
            (scan.xz_shape, scan.yz_shape, scan.xy_shape), self.proj_mask
        ):
            if not keep:
                out.append(None)
                continue
            size = shape[0] * shape[1]
            out.append(templates[:, off : off + size].reshape((C,) + shape))
            off += size
        return out

    def _quantized_split_templates(self, levels: int = 2):
        """Per-plane error-compensated int8 templates + scales.

        For each plane template t (C, H, W): q1 = rint(t/s1) with
        s1 = max|t_c|/127, and a second int8 pass q2 over the residual
        r = t - s1*q1 with s2 = max|r_c|/127, so ⟨t, x⟩ ≈ s1⟨q1, x⟩ +
        s2⟨q2, x⟩ with per-element error ≤ s2/2 ≈ max|t|/32k. q1 and q2
        concatenate on the class axis. const_c = 128*Σt folds the int8
        wire format's -128 shift: ⟨t, u⟩ = ⟨t, u-128⟩ + 128Σt.

        Returns per plane (q (C2, H, W) int8, s1, s2, const) numpy —
        s1/s2/const float32 — or None for a masked plane. `levels=1`
        skips the residual pass: (q1 (C, H, W), s1, None, const). The
        float64 arithmetic is the JAX package's, so the int8 templates
        are equal to its byte for byte.
        """
        outs = []
        for t in self._split_templates():
            if t is None:
                outs.append(None)
                continue
            t = np.asarray(t, np.float64)
            a1 = np.abs(t).max(axis=(1, 2))
            s1 = np.where(a1 > 0, a1 / 127.0, 1.0)
            q1 = np.rint(t / s1[:, None, None])
            const = np.asarray(128.0 * t.sum(axis=(1, 2)), np.float32)
            if levels == 1:
                outs.append(
                    (q1.astype(np.int8), s1.astype(np.float32), None, const)
                )
                continue
            r = t - q1 * s1[:, None, None]
            a2 = np.abs(r).max(axis=(1, 2))
            s2 = np.where(a2 > 0, a2 / 127.0, 1.0)
            q2 = np.rint(r / s2[:, None, None])
            outs.append(
                (
                    np.concatenate([q1, q2]).astype(np.int8),
                    s1.astype(np.float32),
                    s2.astype(np.float32),
                    const,
                )
            )
        return outs

    # -- device programs ----------------------------------------------------
    def _tensor(self, a) -> Optional[torch.Tensor]:
        return None if a is None else torch.as_tensor(a, device=self.device)

    def _indices(self, xyz: torch.Tensor):
        """(B, T, 3) cm → clamped int64 cube indices (i, j, k), each (B, T)."""
        i, j, k = self.scan_arena.clamped_matrix_indices(
            xyz[..., 0], xyz[..., 1], xyz[..., 2]
        )
        return i.long(), j.long(), k.long()

    def _finish(self, dec: torch.Tensor, valid: torch.Tensor):
        """(B, T, C) decisions → (pred, best_p, proba), as the JAX tail."""
        B, T, C = dec.shape
        dec = dec.reshape(B * T, C)
        if self.calibration is not None:
            proba = calibrated_from_decision(dec, self.calibration)
        else:
            proba = proba_from_decision(dec)
        return self._threshold(proba.reshape(B, T, -1), valid)

    def _threshold(self, proba: torch.Tensor, valid: torch.Tensor):
        best = torch.argmax(proba, dim=-1).to(torch.int32)
        best_p = torch.amax(proba, dim=-1)
        unknown = torch.full_like(best, UNKNOWN)
        pred = torch.where(best_p >= self.min_proba, best, unknown)
        pred = torch.where(valid, pred, unknown)
        return pred, best_p, proba

    def _build_folded(self) -> Callable:
        """Template-contraction scoring: per-target cost is 3 lookups.

        M1[c, y] = Σ_xz A_xz[c, x, z]·cube[x, y, z] turns every target's
        xz contribution into the read M1[c, j] (likewise M2[c, i] for yz
        and M3[c, k] for xy). The contractions read the cube as it lies
        (`folded_tables`). With cube_dtype="int8" they run against the
        quantized templates exactly — int64 einsums on the CPU,
        `folded_tables_exact` on the card (float32 products summed in
        runs whose every partial sum is an integer below 2^24, the runs
        added in int64; an int8 einsum wraps) — and dequantize in float32
        as the JAX package does.
        """
        int8 = self.cube_dtype == "int8"
        if int8:
            quant = [
                None if q is None else tuple(self._tensor(a) for a in q)
                for q in self._quantized_split_templates()
            ]
            # the int8 templates' values as float32 once (exact_tables' operands)
            q32 = [None if q is None else q[0].to(torch.float32) for q in quant]
        templates = [self._tensor(t) for t in self._split_templates()]
        intercept = self.model.intercept
        specs = ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz")

        def dequantize(q, raw):
            """Raw (B, C2, ·) integer table → float32 (B, C, ·)."""
            _, s1, s2, const = q
            raw = raw.to(torch.float32)
            C = s1.shape[0]
            return (
                raw[:, :C] * s1[None, :, None]
                + raw[:, C:] * s2[None, :, None]
                + const[None, :, None]
            )

        def tables(cubes):
            """The three (B, C, ·) float32 tables, None for a masked plane."""
            if not int8:
                return folded_tables(cubes.to(torch.float32), templates)
            if cubes.device.type == "cpu":
                v = cubes.to(torch.int64)
                raws = [None if q is None else torch.einsum(sp, q[0].to(torch.int64), v)
                        for sp, q in zip(specs, quant)]
            else:
                raws = exact_tables(cubes, q32)
            return [None if r is None else dequantize(q, r) for q, r in zip(quant, raws)]

        def read(m_bcd, idx):
            """(B, C, D) table, (B, T) indices → (B, T, C)."""
            C = m_bcd.shape[1]
            return m_bcd.gather(
                2, idx[:, None, :].expand(-1, C, -1)
            ).transpose(1, 2)

        def predict_batch(cubes, target_xyz, target_valid):
            B, T = target_xyz.shape[:2]
            i, j, k = self._indices(target_xyz)
            dec = intercept[None, None, :].expand(B, T, -1)
            for m, idx in zip(tables(cubes), (j, i, k)):
                if m is not None:
                    dec = dec + read(m, idx)
            return self._finish(dec, target_valid)

        return predict_batch

    def _build_pallas(self) -> Callable:
        """Folded templates + the one-read bf16 table kernel.

        ops/score.fused_native_score casts each cube to bf16, contracts
        it against the three float32 templates in one read (the CUDA
        kernel on the card) and reads each target's rows, d1 + d2 + d3 +
        intercept; then calibrate, argmax and threshold as the JAX
        package's _build_pallas does. The kernel contracts every plane,
        so a partial proj_mask is refused.
        """
        if not all(self.proj_mask):
            raise ValueError("pallas mode requires the full ProjMask")
        templates = native_templates(*self._split_templates(), device=self.device)
        intercept = self.model.intercept

        def predict_batch(cubes, target_xyz, target_valid):
            ijk = torch.stack(self._indices(target_xyz), -1)
            dec = fused_native_score(cubes, ijk, templates.t_xz, templates.t_yz,
                                     templates.t_xy, intercept)
            return self._finish(dec, target_valid)

        return predict_batch

    def _build_fused(self) -> Callable:
        """One-read int8 kernel + its tail, per fused_tail.

        combo / lookup / glookup: the kernel (onepass_tables_combined_i8,
        onepass_tables_i8, onepass_tables_grouped_i8) reads each int8 cube
        once and emits the raw int32 tables m1 (C2, Y, B), m2 (C2, X, B),
        m3 (Z, C2, B); the tail mirrors the JAX package's
        (pipeline.py:713-726): dequantize each table before the lookup
        (s1·hi [+ s2·lo]), read each target's row, add the per-plane
        constant, in the order m3, m1, m2.
        sel: onepass_tables_sel_i8 returns the selected z-table reads d3,
        which go first as s1·hi + s2·lo + const (pipeline.py:688-693),
        then m1 and m2 as above.
        sel3: onepass_scores_i8 returns all three planes' reads, each
        added as s1·hi + s2·lo + const in the order xz, yz, xy
        (pipeline.py:678-686).
        Each tail keeps its JAX twin's float order. sel and sel3 select on
        every slot's clamped indices; target_valid masks afterwards. Then
        calibrate, argmax and threshold. Split decisions equal
        mode="fast" + int8's under every tail (same quantized templates,
        exact integer tables on both sides).
        """
        scan = self.scan_arena
        tail = self.fused_tail
        levels = 1 if self.fused_quant == "single" else 2
        quant = self._quantized_split_templates(levels=levels)
        dims = scan.grid_shape
        if tail == "combo":
            weights = build_combined_weights(quant, dims, levels, device=self.device)
        elif tail == "glookup":  # the JAX kernel's y-group; the card's plan ignores it
            weights = build_grouped_weights(
                quant, dims, y_group=min(16, dims[1]), device=self.device
            )
        else:
            weights = build_onepass_weights(quant, dims, device=self.device)
        tables = {"combo": onepass_tables_combined_i8, "lookup": onepass_tables_i8,
                  "glookup": onepass_tables_grouped_i8}.get(tail)
        scales = [
            None if q is None else tuple(self._tensor(a) for a in q[1:])
            for q in quant
        ]
        intercept = self.model.intercept
        C = intercept.shape[0]

        def dequant_cd(m_c2db, sc):
            """(C2, D, B) int32 raw table → (C, D, B) float32."""
            s1, s2, _ = sc
            hi = m_c2db[:C].to(torch.float32) * s1[:, None, None]
            if s2 is None:
                return hi
            return hi + m_c2db[C:].to(torch.float32) * s2[:, None, None]

        def lookup_cd(m_cdb, idx):
            """(C, D, B) table, (B, T) indices → (B, T, C)."""
            T = idx.shape[1]
            g = m_cdb.gather(1, idx.T[None].expand(C, T, -1))  # (C, T, B)
            return g.permute(2, 1, 0)

        def dequant_dc(m_dc2b, sc):
            """(D, C2, B) int32 raw table → (D, C, B) float32."""
            s1, s2, _ = sc
            hi = m_dc2b[:, :C].to(torch.float32) * s1[None, :, None]
            if s2 is None:
                return hi
            return hi + m_dc2b[:, C:].to(torch.float32) * s2[None, :, None]

        def lookup_dc(m_dcb, idx):
            """(D, C, B) table, (B, T) indices → (B, T, C)."""
            T = idx.shape[1]
            g = m_dcb.gather(0, idx.T[:, None, :].expand(T, C, -1))  # (T, C, B)
            return g.permute(2, 0, 1)

        def combine(s_c2tb, sc):
            """(C2, T, B) selected int32 reads → (B, T, C) s1·hi + s2·lo + const."""
            r = s_c2tb.permute(2, 1, 0).to(torch.float32)
            s1, s2, const = sc
            return r[..., :C] * s1 + r[..., C:] * s2 + const

        def predict_packed(cube, target_xyz, target_valid):
            B, T = target_xyz.shape[:2]
            i, j, k = self._indices(target_xyz)
            dec = intercept[None, None, :].expand(B, T, C)
            if tail == "sel3":
                ijk = torch.stack((i, j, k), -1).to(torch.int32)
                for s, sc in zip(onepass_scores_i8(cube, weights, ijk), scales):
                    if sc is not None:
                        dec = dec + combine(s, sc)
                return self._finish(dec, target_valid)
            if tail == "sel":
                m1, m2, d3 = onepass_tables_sel_i8(cube, weights, k.to(torch.int32))
                if scales[2] is not None:
                    dec = dec + combine(d3, scales[2])
            else:
                m1, m2, m3 = tables(cube, weights)
                if scales[2] is not None:
                    dec = dec + lookup_dc(dequant_dc(m3, scales[2]), k) + scales[2][2]
            if scales[0] is not None:
                dec = dec + lookup_cd(dequant_cd(m1, scales[0]), j) + scales[0][2]
            if scales[1] is not None:
                dec = dec + lookup_cd(dequant_cd(m2, scales[1]), i) + scales[1][2]
            return self._finish(dec, target_valid)

        return predict_packed

    def _build_neural(self) -> Callable:
        """Serving path for NeuralClassifier models (CNN / SGAN c-head).

        Per target: slice the three projections, decode the int8 wire
        format (value − 128), reproduce the training preprocessing —
        scale [0, RADAR_MAX] → [-1, 1] (dnn.py:202-204), PIL-parity
        bicubic resize to the model's rescale (data/preprocess.
        resize_views) — then run the network in inference mode, softmax
        and threshold.
        """
        scan = self.scan_arena
        model: NeuralClassifier = self.model
        half = RADAR_MAX / 2.0
        shift = 128.0 if self.cube_dtype == "int8" else 0.0
        mats = [
            tuple(torch.as_tensor(m, dtype=torch.float32, device=self.device)
                  for m in bicubic_pair(tuple(shape), tuple(model.rescale)))
            for shape in (scan.xz_shape, scan.yz_shape, scan.xy_shape)
        ]

        @torch.no_grad()
        def predict_batch(cubes, target_xyz, target_valid):
            B, T = target_xyz.shape[:2]
            cube = cubes.to(torch.float32) + shift
            i, j, k = self._indices(target_xyz)
            b = torch.arange(B, device=cube.device)[:, None].expand(B, T)
            planes = (cube.permute(0, 2, 1, 3)[b, j],  # xz (B, T, X, Z)
                      cube[b, i],  # yz (B, T, Y, Z)
                      cube.permute(0, 3, 1, 2)[b, k])  # xy (B, T, X, Y)
            views = []
            for plane, (r, c) in zip(planes, mats):
                sym = (plane - half) / half
                out = torch.einsum("oh,bthw->btow", r, sym)
                views.append(torch.einsum("btow,pw->btop", out, c))
            views = torch.stack(views, dim=-1).reshape((B * T,) + tuple(model.rescale) + (3,))
            proba = torch.softmax(model.apply(views), dim=-1)
            return self._threshold(proba.reshape(B, T, -1), target_valid)

        return predict_batch

    def _build(self) -> Callable:
        """Reference math: slice the three planes of every target, zoom
        them with the spline matrices, concatenate, scale, score."""
        train, scan = self.train_arena, self.scan_arena
        zoom = predict_zoom(train, scan)
        mats = []
        for shape, z, keep in zip(
            (scan.xz_shape, scan.yz_shape, scan.xy_shape), zoom, self.proj_mask
        ):
            if not keep:
                mats.append(None)
                continue
            r, c, _ = spline_zoom_pair(tuple(shape), tuple(z))
            mats.append(
                (
                    torch.as_tensor(r, dtype=torch.float32, device=self.device),
                    torch.as_tensor(c, dtype=torch.float32, device=self.device),
                )
            )
        # int8 wire format carries value-128; decode restores 0..255.
        shift = 128.0 if self.cube_dtype == "int8" else 0.0
        # An SVC scores on the predictor's device (its Platt-coupled
        # probabilities; a calibration is not applied to it).
        svc = self.model.to(self.device) if isinstance(self.model, SVCModel) else None
        if svc is not None:
            svc.fold()

        def predict_batch(cubes, target_xyz, target_valid):
            B, T = target_xyz.shape[:2]
            cube = cubes.to(torch.float32) + shift
            i, j, k = self._indices(target_xyz)
            b = torch.arange(B, device=cube.device)[:, None].expand(B, T)
            xz = cube.permute(0, 2, 1, 3)[b, j]  # (B, T, X, Z)
            yz = cube[b, i]  # (B, T, Y, Z)
            xy = cube.permute(0, 3, 1, 2)[b, k]  # (B, T, X, Y)
            parts = []
            for plane, mat in zip((xz, yz, xy), mats):
                if mat is None:
                    continue
                out = torch.einsum("oh,bthw->btow", mat[0], plane)
                out = torch.einsum("btow,pw->btop", out, mat[1])
                parts.append(out.reshape(B * T, -1))
            feats = torch.cat(parts, dim=1) / RADAR_MAX
            if svc is not None:
                proba = svc_predict_proba(svc, feats)
            elif self.calibration is not None:
                proba = predict_proba_calibrated(self.model, self.calibration, feats)
            else:
                proba = predict_proba_log_loss(self.model, feats)
            return self._threshold(proba.reshape(B, T, -1), target_valid)

        return predict_batch

    # -- host encode / entry point -----------------------------------------
    def encode_host(self, cubes: np.ndarray) -> torch.Tensor:
        """Narrow a canonical 0..255 host cube to the stream dtype at
        ingest (a CPU tensor); __call__ takes the result directly."""
        return encode_host_cubes(cubes, self.cube_dtype)

    def pack_host(self, cubes) -> torch.Tensor:
        """Pack (B, X, Y, Z) cubes into the fused path's wire layout: int8
        (value-128), contiguous, on the host. One packed batch serves
        every fused tail."""
        return pack_cubes_i8(cubes)

    def __call__(
        self,
        cubes,
        target_xyz,
        target_valid=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Classify targets in a batch of scans.

        Args:
            cubes: (B, size_x, size_y, size_z) raw scan cubes (numpy or
                tensor; pack_host / encode_host output included).
            target_xyz: (B, T, 3) target positions in cm (padded).
            target_valid: (B, T) bool mask of real targets.

        Returns:
            (pred, best_proba, proba) on `device`: (B, T) int32 class
            index or UNKNOWN; (B, T) best probability; (B, T, C) full
            matrix.

        With a mesh, this rank scores its contiguous slice of the B scans
        and the slices are gathered, so every rank returns all B rows. B
        must divide by the mesh's data ranks; fused mode takes (B, X, Y,
        Z) cubes only, as each rank packs its own shard.
        """
        if self.mesh is not None:
            return self._call_sharded(cubes, target_xyz, target_valid)
        return self._call(cubes, target_xyz, target_valid)

    def _call_sharded(self, cubes, target_xyz, target_valid):
        if self.mode == "fused" and getattr(cubes, "ndim", None) != 4:
            raise ValueError(
                "fused mesh serving takes (B, X, Y, Z) cubes: a packed batch "
                "cannot be split on the scan axis, so packing happens per shard"
            )
        rows = self.mesh.rows(len(cubes), "scan batch")
        out = self._call(cubes[rows], target_xyz[rows],
                         None if target_valid is None else target_valid[rows])
        return tuple(self.mesh.all_gather(o) for o in out)

    def _call(self, cubes, target_xyz, target_valid):
        dev = self.device
        xyz = torch.as_tensor(target_xyz, dtype=torch.float32).to(dev)
        if target_valid is None:
            valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
        else:
            valid = torch.as_tensor(target_valid, dtype=torch.bool).to(dev)
        if self.cube_dtype == "int8":
            cubes = encode_int8_cubes(cubes, dev).contiguous()
        else:
            cubes = torch.as_tensor(cubes).to(
                dev, dtype=_CUBE_DTYPES[self.cube_dtype]
            )
        return self._fn(cubes, xyz, valid)


def pad_targets(
    target_lists, max_targets: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-scan variable-length target lists into padded arrays:
    (B, max_targets, 3) float32 positions and the (B, max_targets) bool
    validity mask."""
    B = len(target_lists)
    xyz = np.zeros((B, max_targets, 3), dtype=np.float32)
    valid = np.zeros((B, max_targets), dtype=bool)
    for b, targets in enumerate(target_lists):
        for t, tgt in enumerate(targets[:max_targets]):
            xyz[b, t] = (tgt[0], tgt[1], tgt[2])
            valid[b, t] = True
    return xyz, valid
