"""The real-time predict pipeline on PyTorch.

Port of radarml_tpu/models/pipeline.py. Per scan, each target's three
2-D projections are sliced at its cube indices, zoomed into the
training arena, concatenated into the feature vector and scored by the
calibrated linear model, then thresholded. Four modes compute that:

* ``exact`` — the reference math stage by stage (slice, spline-zoom
  matrix products, concat, scale, score);
* ``fast`` — the model folded into per-plane class templates at the
  scan's native resolution, so a target costs three table reads after
  three whole-cube contractions; with ``cube_dtype="int8"`` the
  contractions run exactly in integers against error-compensated int8
  templates;
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
    mesh: object = None  # sharded serving is not ported yet
    # Device dtype of the scan stream: "float32" | "bfloat16" | "uint8" |
    # "int8" (value-128 on the wire). All four are lossless for 8-bit
    # radar cubes; the 8-bit ones truncate non-integer values.
    cube_dtype: str = "float32"
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.mode == "pallas" and self.cube_dtype in ("uint8", "int8"):
            raise ValueError("pallas mode supports float32/bfloat16 "
                             "streams; use mode='fused' for int8")
        if self.mesh is not None:
            raise NotImplementedError(
                "mesh-sharded serving is not ported yet (ROADMAP A15)"
            )
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
        and M3[c, k] for xy). With cube_dtype="int8" the contractions
        run against the quantized templates exactly — int64 on the CPU,
        float64 on the card (every sum is an integer below 2^53; float32
        is not exact here and int8 einsum wraps) — and dequantize in
        float32 as the JAX package does.
        """
        int8 = self.cube_dtype == "int8"
        if int8:
            quant = [
                None if q is None else tuple(self._tensor(a) for a in q)
                for q in self._quantized_split_templates()
            ]
        templates = [self._tensor(t) for t in self._split_templates()]
        intercept = self.model.intercept

        def table(plane_i, cubes, spec):
            """One plane's (B, C, ·) lookup table."""
            if not int8:
                return torch.einsum(spec, templates[plane_i], cubes)
            q, s1, s2, const = quant[plane_i]
            raw = torch.einsum(spec, q.to(cubes.dtype), cubes).to(torch.float32)
            C = s1.shape[0]
            return (
                raw[:, :C] * s1[None, :, None]
                + raw[:, C:] * s2[None, :, None]
                + const[None, :, None]
            )

        def read(m_bcd, idx):
            """(B, C, D) table, (B, T) indices → (B, T, C)."""
            C = m_bcd.shape[1]
            return m_bcd.gather(
                2, idx[:, None, :].expand(-1, C, -1)
            ).transpose(1, 2)

        specs = ("cxz,bxyz->bcy", "cyz,bxyz->bcx", "cxy,bxyz->bcz")

        def predict_batch(cubes, target_xyz, target_valid):
            B, T = target_xyz.shape[:2]
            if int8:
                acc = torch.int64 if cubes.device.type == "cpu" else torch.float64
                cubes = cubes.to(acc)
            else:
                cubes = cubes.to(torch.float32)
            i, j, k = self._indices(target_xyz)
            dec = intercept[None, None, :].expand(B, T, -1)
            for plane_i, idx in zip(range(3), (j, i, k)):
                if templates[plane_i] is not None:
                    dec = dec + read(table(plane_i, cubes, specs[plane_i]), idx)
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
        """
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
