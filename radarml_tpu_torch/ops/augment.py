"""Batched data augmentation: rotation, clipped zoom, sparse noise.

Port of radarml_tpu/ops/augment.py, the reference's two augmentation
stacks: the SVM path's `DataGenerator.augment` (reference
train.py:85-213: scipy `ndimage.rotate`, a constant-size "clipped zoom",
one sparse Gaussian noise draw a plane, clamped to [0, 1]) and the
DNN/SGAN path's `augment_data` (reference dnn.py:94-182: the same chain
on [-1, 1] data).

* **Rotation** keeps the plane's shape, so the cubic B-spline prefilter
  is two fixed matrix products over the plane; the rotated resample is a
  16-tap gather of the spline coefficients at coordinates computed from
  each sample's angle.
* **Clipped zoom** is, for a fixed factor, the linear separable operator
  `out = A @ img @ B.T`. The zoom range is quantized to a palette of K
  factors whose (h, h) and (w, w) operators are built once on the host
  (numpy float64, from ops/resample.py); a batch gathers each sample's
  pair and applies it as two batched products.
* **Noise** is one scalar normal draw a plane, added to the nonzero
  entries only (SVM path) or to every entry (DNN path).

The random draws (angles, palette indices, noise scalars) come from a
`torch.Generator` on the planes' device and are made apart from the
functions that apply them (`draw_angles`, `draw_zoom_indices`,
`draw_noise`), so the applying functions can be held to the JAX
package's at the same draws. The draws themselves differ from the JAX
package's keyed PRNG; the reference's unseeded numpy draws are not
reproducible either (train.py:85).

Float32 products run in full float32 (no TF32), as the JAX package
computes them at Precision.HIGHEST.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.ops.resample import (
    _prefilter_matrix,
    bspline_zoom_matrix,
    zoom_output_size,
)

__all__ = [
    "spline_coeffs2d",
    "bspline_sample2d",
    "rotate",
    "rotate_batch",
    "clipped_zoom_operator",
    "zoom_palette",
    "clipped_zoom_batch",
    "sparse_noise",
    "add_noise",
    "draw_angles",
    "draw_zoom_indices",
    "draw_noise",
    "augment_multiview",
    "augment_samples",
]


def _no_tf32() -> None:
    # models.linear.full_f32, inlined: ops/ must not import models/
    torch.backends.cuda.matmul.allow_tf32 = False


# --------------------------------------------------------------------------
# Cubic B-spline sampling at computed coordinates
# --------------------------------------------------------------------------

def _bspline3(x: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline basis."""
    x = torch.abs(x)
    lo = 2.0 / 3.0 - x * x + 0.5 * x * x * x
    hi = ((2.0 - x) ** 3) / 6.0
    return torch.where(x < 1.0, lo, torch.where(x < 2.0, hi, torch.zeros_like(x)))


def _mirror_index(j: torch.Tensor, n: int) -> torch.Tensor:
    """Whole-sample mirror reflection of integer indices into [0, n-1]."""
    if n == 1:
        return torch.zeros_like(j)
    period = 2 * (n - 1)
    j = torch.abs(j) % period
    return torch.where(j > n - 1, period - j, j)


def spline_coeffs2d(planes: torch.Tensor) -> torch.Tensor:
    """(..., H, W) plane values → cubic B-spline coefficients (mirror
    boundary): P_h @ plane @ P_w.T with the exact collocation-inverse
    matrices of ops/resample."""
    _no_tf32()
    h, w = planes.shape[-2], planes.shape[-1]
    ph = torch.as_tensor(_prefilter_matrix(h), dtype=planes.dtype, device=planes.device)
    pw = torch.as_tensor(_prefilter_matrix(w), dtype=planes.dtype, device=planes.device)
    out = torch.einsum("ih,...hw->...iw", ph, planes)
    return torch.einsum("...iw,jw->...ij", out, pw)


def bspline_sample2d(
    coeffs: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    cval: float = 0.0,
) -> torch.Tensor:
    """Evaluate 2-D cubic B-splines at (row, col) coordinates.

    Args:
        coeffs: (B, H, W) spline coefficients from spline_coeffs2d.
        rows, cols: (B, ...) sample coordinates, one set per spline.
        cval: value for coordinates outside [0, H-1] x [0, W-1]
            (scipy constant-mode semantics, the rotate/zoom default).

    Returns:
        (B, ...) interpolated values, shaped like `rows`.
    """
    b, h, w = coeffs.shape
    flat = coeffs.reshape(b, h * w)
    r0 = torch.floor(rows).to(torch.int64)
    c0 = torch.floor(cols).to(torch.int64)
    out = torch.zeros(rows.shape, dtype=coeffs.dtype, device=coeffs.device)
    for dr in range(-1, 3):
        rj = r0 + dr
        wr = _bspline3(rows - rj.to(rows.dtype))
        rjm = _mirror_index(rj, h)
        for dc in range(-1, 3):
            cj = c0 + dc
            wc = _bspline3(cols - cj.to(cols.dtype))
            cjm = _mirror_index(cj, w)
            vals = torch.gather(flat, 1, (rjm * w + cjm).reshape(b, -1))
            out = out + wr * wc * vals.reshape(rows.shape)
    inside = (rows >= 0) & (rows <= h - 1) & (cols >= 0) & (cols <= w - 1)
    return torch.where(inside, out, torch.full_like(out, cval))


# --------------------------------------------------------------------------
# Rotation (scipy ndimage.rotate reshape=False, order=3, constant mode)
# --------------------------------------------------------------------------

def rotate_batch(planes: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """Rotate each (H, W) plane of a (B, H, W) stack about its center by
    its own angle in degrees.

    Matches `ndimage.rotate(p, angle, reshape=False)` (reference
    train.py:88-95): output coordinate y maps to input coordinate
    R(angle) @ (y - center) + center with the scipy sign convention.
    """
    b, h, w = planes.shape
    dt, dev = planes.dtype, planes.device
    coeffs = spline_coeffs2d(planes)
    theta = torch.deg2rad(torch.as_tensor(angles_deg, device=dev).to(dt))
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    cr, cc = (h - 1) / 2.0, (w - 1) / 2.0
    rr, cc_grid = torch.meshgrid(
        torch.arange(h, dtype=dt, device=dev),
        torch.arange(w, dtype=dt, device=dev),
        indexing="ij",
    )
    dy, dx = rr - cr, cc_grid - cc
    rows = cos * dy + sin * dx + cr
    cols = -sin * dy + cos * dx + cc
    return bspline_sample2d(coeffs, rows, cols)


def rotate(plane: torch.Tensor, angle_deg) -> torch.Tensor:
    """Rotate one (H, W) plane about its center by `angle_deg` degrees."""
    angle = torch.as_tensor(angle_deg, dtype=plane.dtype, device=plane.device)
    return rotate_batch(plane[None], angle.reshape(1))[0]


# --------------------------------------------------------------------------
# Clipped zoom (constant output size) as a palette of linear operators
# --------------------------------------------------------------------------

def _zoom_axis_operator(n: int, factor: float) -> np.ndarray:
    """1-D linear operator of the reference's clipped_zoom along one axis.

    Composes the exact integer crop/zoom/pad/trim arithmetic of
    reference train.py:96-146 into an (n, n) matrix. Linear because
    every stage (crop, cubic-spline zoom, zero-pad, trim) is linear.
    """
    if factor == 1.0:
        return np.eye(n)
    if factor < 1.0:
        zn = int(np.round(n * factor))
        top = (n - zn) // 2
        # zoom of the full axis to size round(n * factor), pasted at top.
        zmat = bspline_zoom_matrix(n, zoom_output_size(n, factor))
        out = np.zeros((n, n))
        out[top : top + zmat.shape[0], :] = zmat[: n - top, :]
        return out
    # factor > 1: crop the center, zoom it up, trim to n.
    zn = int(np.ceil(n / factor))
    top = (n - zn) // 2
    crop = np.zeros((zn, n))
    crop[np.arange(zn), top + np.arange(zn)] = 1.0
    zoomed = bspline_zoom_matrix(zn, zoom_output_size(zn, factor))
    trim_top = (zoomed.shape[0] - n) // 2
    full = zoomed @ crop
    return full[trim_top : trim_top + n, :]


@functools.lru_cache(maxsize=1024)
def clipped_zoom_operator(
    shape: Tuple[int, int], factor: float
) -> Tuple[np.ndarray, np.ndarray]:
    """(row_op, col_op) pair: clipped_zoom(img) == row_op @ img @ col_op.T."""
    return (
        _zoom_axis_operator(shape[0], factor),
        _zoom_axis_operator(shape[1], factor),
    )


@functools.lru_cache(maxsize=64)
def zoom_palette(
    shape: Tuple[int, int],
    zoom_range: float,
    n_factors: int = 64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Operators for quantized factors over [1-zr, 1+zr].

    Returns:
        (factors, row_ops, col_ops): (K,), (K, H, H), (K, W, W) float64
        numpy. A per-sample uniform factor draw becomes a uniform index
        draw.
    """
    factors = np.linspace(1.0 - zoom_range, 1.0 + zoom_range, n_factors)
    rows, cols = [], []
    for f in factors:
        r, c = clipped_zoom_operator(tuple(shape), float(f))
        rows.append(r)
        cols.append(c)
    return factors, np.stack(rows), np.stack(cols)


def clipped_zoom_batch(
    planes: torch.Tensor,
    idx: torch.Tensor,
    row_ops: torch.Tensor,
    col_ops: torch.Tensor,
) -> torch.Tensor:
    """Apply per-sample palette operators to a (B, H, W) stack.

    idx: (B,) palette indices (one shared factor per sample, as the
    reference shares one factor across projections of a sample).
    """
    _no_tf32()
    idx = torch.as_tensor(idx, dtype=torch.int64, device=planes.device)
    r = row_ops.index_select(0, idx)  # (B, H, H)
    c = col_ops.index_select(0, idx)  # (B, W, W)
    out = torch.einsum("bih,bhw->biw", r, planes)
    return torch.einsum("biw,bjw->bij", out, c)


def _palette_on(shape, zoom_range, n_factors, dtype, device):
    _, rows, cols = zoom_palette(tuple(int(s) for s in shape), float(zoom_range),
                                 int(n_factors))
    return (torch.as_tensor(rows, dtype=dtype, device=device),
            torch.as_tensor(cols, dtype=dtype, device=device))


# --------------------------------------------------------------------------
# Noise
# --------------------------------------------------------------------------

def sparse_noise(
    planes: torch.Tensor, noise: torch.Tensor, lo: float = 0.0, hi: float = 1.0,
) -> torch.Tensor:
    """Add one scalar a plane (`noise`, (B,)) to the nonzero entries only.

    Reference train.py:148-156: `qc[qc != 0] += rg.normal(scale=sd)` —
    a single broadcast scalar, preserving sparsity; clamped to [lo, hi].
    """
    draws = noise.to(planes.device, planes.dtype).reshape(-1, 1, 1)
    out = torch.where(planes != 0, planes + draws, planes)
    return torch.clamp(out, lo, hi)


def add_noise(
    planes: torch.Tensor, noise: torch.Tensor, lo: float = -1.0, hi: float = 1.0,
) -> torch.Tensor:
    """Add one scalar a plane (`noise`, (B,)) to every entry.

    Reference dnn.py:159-162 (`p += rng.normal(scale=sd)`), [-1,1] clamp.
    """
    draws = noise.to(planes.device, planes.dtype).reshape(-1, 1, 1)
    return torch.clamp(planes + draws, lo, hi)


# --------------------------------------------------------------------------
# Draws
# --------------------------------------------------------------------------

def draw_angles(b: int, rotation_range: float, generator: torch.Generator) -> torch.Tensor:
    """(b,) float32 angles, uniform in [-range, range), on the
    generator's device."""
    u = torch.rand(b, generator=generator, device=generator.device)
    return u * (2.0 * rotation_range) - rotation_range


def draw_zoom_indices(b: int, n_factors: int, generator: torch.Generator) -> torch.Tensor:
    """(b,) int64 palette indices, uniform in [0, n_factors)."""
    return torch.randint(0, n_factors, (b,), generator=generator,
                         device=generator.device)


def draw_noise(b: int, sd: float, generator: torch.Generator) -> torch.Tensor:
    """(b,) float32 N(0, sd) scalars, one a plane."""
    return torch.randn(b, generator=generator, device=generator.device) * sd


# --------------------------------------------------------------------------
# High-level augmentation pipelines
# --------------------------------------------------------------------------

def augment_multiview(
    views: Sequence,
    generator: torch.Generator,
    rotation_range: Optional[float] = 1.0,
    zoom_range: Optional[float] = 0.3,
    noise_sd: Optional[float] = 1.0,
    clamp: Tuple[float, float] = (-1.0, 1.0),
    n_zoom_factors: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DNN/SGAN-path in-place augmentation chain (dnn.py:94-182).

    Applies rotate → clipped-zoom → noise to each (B, H, W) projection
    stack on the generator's device: independent per-plane angles and
    noise draws, one shared zoom factor per sample across its three
    projections.
    """
    lo, hi = clamp
    dev = generator.device
    b = views[0].shape[0]
    zoom_idx = (draw_zoom_indices(b, n_zoom_factors, generator)
                if zoom_range is not None else None)
    out = []
    for v in views:
        planes = torch.as_tensor(v, dtype=torch.float32, device=dev)
        if rotation_range is not None:
            angles = draw_angles(b, rotation_range, generator)
            planes = torch.clamp(rotate_batch(planes, angles), lo, hi)
        if zoom_range is not None:
            rows, cols = _palette_on(planes.shape[1:], zoom_range, n_zoom_factors,
                                     planes.dtype, dev)
            planes = torch.clamp(clipped_zoom_batch(planes, zoom_idx, rows, cols), lo, hi)
        if noise_sd is not None:
            planes = add_noise(planes, draw_noise(b, noise_sd, generator), lo, hi)
        out.append(planes)
    return tuple(out)


def augment_samples(
    views: Sequence,
    labels: np.ndarray,
    generator: torch.Generator,
    rotation_range: Optional[float] = None,
    zoom_range: Optional[float] = None,
    noise_sd: Optional[float] = None,
    balance: bool = False,
    n_zoom_factors: int = 64,
    device: torch.device | str | None = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], np.ndarray]:
    """SVM-path generative augmentation (DataGenerator, train.py:34-213).

    For each input sample, *appends* one new sample per enabled
    transform (rotate / zoom / noise), replicated round(class_weight)
    times when balancing (majority_count / class_count). Data is in
    [0, 1]; all outputs clamp there. Returns the augmented samples only
    (the reference extends the training set with these): three (N, H, W)
    float32 stacks on `device` (default: the generator's device) and the
    (N,) numpy labels. Each view uploads once and is replicated there.
    """
    dev = resolve_device(device if device is not None else generator.device)
    labels = np.asarray(labels)
    if balance:
        vals, counts = np.unique(labels, return_counts=True)
        top = counts.max()
        weight = {int(v): top / c for v, c in zip(vals, counts)}
    else:
        weight = {int(v): 1.0 for v in np.unique(labels)}
    reps = np.array(
        [int(np.round(weight[int(y)])) for y in labels], dtype=np.int64
    )
    rep_idx = np.repeat(np.arange(len(labels)), reps)
    y_rep = labels[rep_idx]

    def empty():
        return (tuple(torch.zeros((0,) + tuple(v.shape[1:]), dtype=torch.float32,
                                  device=dev) for v in views),
                np.zeros((0,), labels.dtype))

    b = len(rep_idx)
    if b == 0 or (rotation_range is None and zoom_range is None and noise_sd is None):
        return empty()

    rep_idx_d = torch.as_tensor(rep_idx, dtype=torch.int64, device=dev)
    views_rep = tuple(
        torch.as_tensor(v, dtype=torch.float32, device=dev).index_select(0, rep_idx_d)
        for v in views
    )
    out_views = [[], [], []]
    out_labels = []
    if rotation_range is not None:
        for v_i, planes in enumerate(views_rep):
            angles = draw_angles(b, rotation_range, generator)
            out_views[v_i].append(torch.clamp(rotate_batch(planes, angles), 0.0, 1.0))
        out_labels.append(y_rep)
    if zoom_range is not None:
        zoom_idx = draw_zoom_indices(b, n_zoom_factors, generator)
        for v_i, planes in enumerate(views_rep):
            rows, cols = _palette_on(planes.shape[1:], zoom_range, n_zoom_factors,
                                     planes.dtype, dev)
            zoomed = clipped_zoom_batch(planes, zoom_idx, rows, cols)
            out_views[v_i].append(torch.clamp(zoomed, 0.0, 1.0))
        out_labels.append(y_rep)
    if noise_sd is not None:
        for v_i, planes in enumerate(views_rep):
            noise = draw_noise(b, noise_sd, generator)
            out_views[v_i].append(sparse_noise(planes, noise))
        out_labels.append(y_rep)
    aug = tuple(torch.cat(parts) for parts in out_views)
    return aug, np.concatenate(out_labels)
