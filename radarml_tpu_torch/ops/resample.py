"""Exact separable resampling as precomputed matrices.

Port of the float64 host-side operator constructors of
radarml_tpu/ops/resample.py. They are numpy, so the matrices are
byte-identical to the JAX package's (scipy's endpoint artifact
included); the device applies them as plain matrix products.

The reference preprocesses every radar projection on the host CPU with
two different resamplers: `scipy.ndimage.zoom` (cubic B-spline with
prefilter; reference common.py:143, train.py:120) and PIL's BICUBIC
`Image.resize` (reference dnn.py:243-245, sgan.py:679-681). Both are
*linear* and *separable* operators on a fixed grid, so the 1-D
interpolation matrices are computed once on the host and applied as
batched matrix products:

    out[b] = R @ img[b] @ C.T

with R: (out_h, in_h) and C: (out_w, in_w).

Both matrix constructions below are independent re-implementations of
the published resampler algorithms (Unser's cubic B-spline
interpolation for ndimage; Catmull-Rom a=-0.5 window filtering for
PIL), not translations of either library's source.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

__all__ = [
    "bspline_zoom_matrix",
    "bicubic_resize_matrix",
    "zoom_output_size",
    "spline_zoom_pair",
    "bicubic_pair",
]


# --------------------------------------------------------------------------
# Cubic B-spline zoom (scipy.ndimage.zoom order=3 semantics)
# --------------------------------------------------------------------------

def _bspline3(x: np.ndarray) -> np.ndarray:
    """The cubic B-spline basis function."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    out = np.zeros_like(x)
    lo = x < 1.0
    hi = (x >= 1.0) & (x < 2.0)
    out[lo] = 2.0 / 3.0 - x[lo] ** 2 + 0.5 * x[lo] ** 3
    out[hi] = ((2.0 - x[hi]) ** 3) / 6.0
    return out


def _mirror_index(j: np.ndarray, n: int) -> np.ndarray:
    """Reflect an index into [0, n-1] with whole-sample symmetry.

    Mirror boundary: ..., 2, 1, 0, 1, 2, ..., n-2, n-1, n-2, ...
    This is the boundary the cubic prefilter assumes.
    """
    if n == 1:
        return np.zeros_like(j)
    period = 2 * (n - 1)
    j = np.abs(j) % period
    return np.where(j > n - 1, period - j, j)


@functools.lru_cache(maxsize=256)
def _prefilter_matrix(n: int) -> np.ndarray:
    """Inverse of the B-spline collocation matrix (mirror boundary).

    Maps sample values to B-spline coefficients: the direct linear-solve
    equivalent of the recursive IIR prefilter, exact for finite n.
    """
    if n == 1:
        return np.ones((1, 1))
    taps = np.arange(-2, 3)
    M = np.zeros((n, n))
    for i in range(n):
        j = i + taps
        w = _bspline3(taps)
        jj = _mirror_index(j, n)
        np.add.at(M[i], jj, w)
    return np.linalg.inv(M)


def zoom_output_size(n: int, factor: float) -> int:
    """Output length for a zoom factor (round-half-even, as the reference
    relies on via scipy)."""
    return int(round(n * factor))


@functools.lru_cache(maxsize=256)
def bspline_zoom_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D cubic-B-spline zoom operator matrix of shape (n_out, n_in).

    Output coordinate i samples the spline at i * (n_in-1) / (n_out-1)
    (endpoint-aligned grid). Composing the sampling matrix with the
    prefilter inverse yields the full interpolation operator.
    """
    if n_in == 1:
        return np.ones((n_out, 1))
    if n_out == 1:
        coords = np.array([0.0])
    else:
        # scipy precomputes the per-axis step (in-1)/(out-1) in float64
        # and multiplies; the rounding of that product decides whether
        # the endpoint lands at exactly in-1 or epsilon outside (where
        # constant mode yields cval=0). Reproduce the same op order.
        step = np.float64(n_in - 1) / np.float64(n_out - 1)
        coords = np.arange(n_out, dtype=np.float64) * step
    S = np.zeros((n_out, n_in))
    base = np.floor(coords).astype(int)
    for t in range(-1, 3):
        j = base + t
        w = _bspline3(coords - j)
        jj = _mirror_index(j, n_in)
        np.add.at(S, (np.arange(n_out), jj), w)
    # Constant-mode boundary: coordinates strictly outside [0, n_in-1]
    # read cval (=0 throughout the reference) instead of the spline.
    outside = (coords < 0) | (coords > n_in - 1)
    S[outside] = 0.0
    return S @ _prefilter_matrix(n_in)


# --------------------------------------------------------------------------
# Bicubic window resize (PIL Image.BICUBIC semantics)
# --------------------------------------------------------------------------

def _catmull_rom(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel with a = -0.5."""
    x = np.abs(np.asarray(x, dtype=np.float64))
    out = np.zeros_like(x)
    lo = x < 1.0
    hi = (x >= 1.0) & (x < 2.0)
    out[lo] = ((a + 2.0) * x[lo] - (a + 3.0)) * x[lo] * x[lo] + 1.0
    out[hi] = (((x[hi] - 5.0) * x[hi] + 8.0) * x[hi] - 4.0) * a
    return out


@functools.lru_cache(maxsize=256)
def bicubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D PIL-style bicubic resize operator matrix of shape (n_out, n_in).

    Pixel-center coordinate mapping with kernel-width scaling on
    downsample and per-output weight normalization — the standard
    area-correct windowed resampling PIL implements.
    """
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    M = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        taps = np.arange(xmin, xmax)
        w = _catmull_rom((taps + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        M[i, xmin:xmax] = w
    return M


# --------------------------------------------------------------------------
# Operator pairs for 2-D planes
# --------------------------------------------------------------------------

def spline_zoom_pair(
    in_shape: Tuple[int, int], zoom: Tuple[float, float]
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """(row_mat, col_mat, out_shape) for an ndimage-style 2-D zoom."""
    out_h = zoom_output_size(in_shape[0], zoom[0])
    out_w = zoom_output_size(in_shape[1], zoom[1])
    return (
        bspline_zoom_matrix(in_shape[0], out_h),
        bspline_zoom_matrix(in_shape[1], out_w),
        (out_h, out_w),
    )


def bicubic_pair(
    in_shape: Tuple[int, int], out_shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """(row_mat, col_mat) for a PIL-style bicubic resize."""
    return (
        bicubic_resize_matrix(in_shape[0], out_shape[0]),
        bicubic_resize_matrix(in_shape[1], out_shape[1]),
    )

