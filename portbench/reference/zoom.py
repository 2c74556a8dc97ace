"""Cubic B-spline zoom (scipy.ndimage.zoom, order 3, constant mode) as
float64 matrices, for the reference's features.

The reference zooms each plane of a scan arena into the training arena
(common.py:143, predict.py:34-54): out = R @ plane @ C.T with one 1-D
operator per axis. An operator samples the prefiltered spline at
i * (n_in - 1) / (n_out - 1); a coordinate outside [0, n_in - 1] reads 0.
"""

from __future__ import annotations

import functools

import numpy as np


def _bspline3(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 2.0 / 3.0 - x ** 2 + 0.5 * x ** 3,
                    np.where(x < 2.0, (2.0 - x) ** 3 / 6.0, 0.0))


def _mirror(j: np.ndarray, n: int) -> np.ndarray:
    """Whole-sample symmetric reflection into [0, n - 1]."""
    if n == 1:
        return np.zeros_like(j)
    period = 2 * (n - 1)
    j = np.abs(j) % period
    return np.where(j > n - 1, period - j, j)


def _prefilter(n: int) -> np.ndarray:
    """Samples → spline coefficients: the inverse of the collocation matrix."""
    if n == 1:
        return np.ones((1, 1))
    M = np.zeros((n, n))
    taps = np.arange(-2, 3)
    for i in range(n):
        np.add.at(M[i], _mirror(i + taps, n), _bspline3(taps.astype(np.float64)))
    return np.linalg.inv(M)


@functools.lru_cache(maxsize=None)
def zoom_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The (n_out, n_in) operator of one axis; the identity when n_out = n_in."""
    if n_in == n_out:
        return np.eye(n_in)
    if n_in == 1:
        return np.ones((n_out, 1))
    coords = (np.arange(n_out, dtype=np.float64) * (np.float64(n_in - 1) / np.float64(n_out - 1))
              if n_out > 1 else np.zeros(1))
    S = np.zeros((n_out, n_in))
    base = np.floor(coords).astype(int)
    for t in range(-1, 3):
        j = base + t
        np.add.at(S, (np.arange(n_out), _mirror(j, n_in)), _bspline3(coords - j))
    S[(coords < 0) | (coords > n_in - 1)] = 0.0
    return S @ _prefilter(n_in)


def out_size(n: int, factor: float) -> int:
    """The zoomed length (round half to even, as scipy rounds)."""
    return int(round(n * factor))
