"""Deterministic synthetic radar scans and datasets.

Port of radarml_tpu/data/synthetic.py. The generator is pure numpy, so
the same seed gives byte-identical cubes in both packages.

The reference's datasets are external pickles captured from live
Walabot hardware (datasets/README.md points at a Google Drive link) and
are not available here, so the framework ships a synthetic generator
that plays the role of both test fixture and demo data source
(SURVEY.md §4's "fixtures must be synthesized").

A scan cube is a (theta, phi, r) grid holding a class-dependent 3-D
Gaussian target blob plus background speckle, scaled to the radar's
[0, 255] signal range. Class signatures differ in angular extent,
range spread, amplitude and lobe count so that any competent classifier
separates them — giving training pipelines a real gradient to descend
in CI.

`hardness` (0..1) dials in realism that erodes separability — per-
sample signature jitter pulled toward the cross-class mean, clutter
blobs, multipath ghost lobes, heavier speckle, and (in make_dataset)
label noise — so that accuracy benchmarks land in a discriminative
band instead of saturating at 1.0. Tests default to hardness=0 (fast,
deterministic convergence); benchmarks/quality_report.py runs hard.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from radarml_tpu_torch.core.arena import DEFAULT_ARENA, RADAR_MAX, Arena

DEFAULT_CLASSES = ("person", "dog", "cat")

# Class signature parameters: (theta_sd, phi_sd, r_sd cells, amplitude,
# n_lobes, lobe_r_gap). Persons are angularly wide with multiple range
# lobes; cats are compact single-lobe targets.
_SIGNATURES = {
    "person": (2.5, 3.5, 6.0, 230.0, 3, 14),
    "dog": (1.6, 2.2, 4.0, 190.0, 2, 9),
    "cat": (1.0, 1.4, 2.5, 150.0, 1, 0),
}


@dataclasses.dataclass(frozen=True)
class SyntheticTarget:
    """Ground truth for a planted target."""

    x: float
    y: float
    z: float
    i: int
    j: int
    k: int
    label: str
    amplitude: float


def _signature(label: str):
    if label in _SIGNATURES:
        return _SIGNATURES[label]
    # Derive a stable signature for unknown labels from a hash.
    h = abs(hash(label)) % 1000
    return (1.0 + h % 3, 1.5 + h % 4, 3.0 + h % 5, 140.0 + h % 80, 1 + h % 3, 8)


def _harden_signature(rng: np.random.Generator, sig, hardness: float):
    """Blend a class signature toward the cross-class mean and jitter it.

    At hardness 0 this is the identity; at 1 the continuous parameters
    sit ~55% of the way to the population mean with ~30% lognormal
    per-sample spread, so class-conditional distributions overlap.
    """
    if hardness <= 0.0:
        return sig
    t_sd, p_sd, r_sd, amp, n_lobes, gap = sig
    means = np.mean(
        [v[:4] for v in _SIGNATURES.values()], axis=0
    )  # (t_sd, p_sd, r_sd, amp)
    pull = 0.55 * hardness
    vals = np.asarray([t_sd, p_sd, r_sd, amp], dtype=np.float64)
    vals = vals + (means - vals) * pull
    vals = vals * np.exp(rng.normal(0.0, 0.30 * hardness, size=4))
    gap_j = gap * float(np.exp(rng.normal(0.0, 0.25 * hardness))) if gap else gap
    return (vals[0], vals[1], vals[2], vals[3], n_lobes, gap_j)


def synth_cube(
    rng: np.random.Generator,
    label: str,
    arena: Arena = DEFAULT_ARENA,
    noise_level: float = 8.0,
    target_cell: Optional[Tuple[int, int, int]] = None,
    hardness: float = 0.0,
) -> Tuple[np.ndarray, SyntheticTarget]:
    """Generate one scan cube with a planted target.

    Returns:
        (cube, target): cube is (size_x, size_y, size_z) float32 in
        [0, RADAR_MAX]; target carries the planted ground truth.
    """
    sx, sy, sz = arena.grid_shape
    t_sd, p_sd, r_sd, amp, n_lobes, gap = _harden_signature(
        rng, _signature(label), hardness
    )
    noise_level = noise_level * (1.0 + 2.0 * hardness)

    if target_cell is None:
        # Margins scale down for small arenas (tests use grids as
        # small as 7x7x26); the defaults match the 22x31x176 arena.
        mx, my = min(3, sx // 3), min(3, sy // 3)
        k_lo, k_hi = min(20, sz // 4), sz - min(30, sz // 3)
        ti = int(rng.integers(mx, sx - mx))
        tj = int(rng.integers(my, sy - my))
        tk = int(rng.integers(k_lo, max(k_hi, k_lo + 1)))
    else:
        ti, tj, tk = target_cell

    ii = np.arange(sx)[:, None, None]
    jj = np.arange(sy)[None, :, None]
    kk = np.arange(sz)[None, None, :]

    cube = np.zeros((sx, sy, sz), dtype=np.float64)
    for lobe in range(n_lobes):
        lk = tk + lobe * gap
        lobe_amp = amp * (0.85 ** lobe)
        cube += lobe_amp * np.exp(
            -(
                (ii - ti) ** 2 / (2 * t_sd**2)
                + (jj - tj) ** 2 / (2 * p_sd**2)
                + (kk - lk) ** 2 / (2 * r_sd**2)
            )
        )

    if hardness > 0.0:
        # Multipath ghost: attenuated copy of the main lobe at a
        # range offset (radar reflections off walls/floor).
        if rng.random() < 0.7 * hardness:
            gk = tk + int(rng.integers(10, 35))
            cube += (amp * rng.uniform(0.15, 0.45)) * np.exp(
                -(
                    (ii - ti) ** 2 / (2 * t_sd**2)
                    + (jj - tj) ** 2 / (2 * p_sd**2)
                    + (kk - gk) ** 2 / (2 * (r_sd * 1.5) ** 2)
                )
            )
        # Static clutter blobs at random cells (furniture, walls).
        for _ in range(rng.poisson(2.5 * hardness)):
            ci = rng.integers(0, sx)
            cj = rng.integers(0, sy)
            ck = rng.integers(0, sz)
            c_amp = rng.uniform(30.0, 140.0)
            c_sd = rng.uniform(1.0, 4.0, size=3)
            cube += c_amp * np.exp(
                -(
                    (ii - ci) ** 2 / (2 * c_sd[0] ** 2)
                    + (jj - cj) ** 2 / (2 * c_sd[1] ** 2)
                    + (kk - ck) ** 2 / (2 * c_sd[2] ** 2)
                )
            )

    # Background speckle plus range-decaying clutter.
    cube += rng.exponential(noise_level, size=cube.shape)
    cube += 12.0 * np.exp(-kk / 25.0)

    cube = np.clip(cube, 0.0, RADAR_MAX).astype(np.float32)

    x, y, z = arena.grid_to_cartesian_np(float(ti), float(tj), float(tk))
    target = SyntheticTarget(
        x=float(x), y=float(y), z=float(z),
        i=ti, j=tj, k=tk, label=label, amplitude=float(amp),
    )
    return cube, target


def synth_sample(
    rng: np.random.Generator,
    label: str,
    arena: Arena = DEFAULT_ARENA,
    hardness: float = 0.0,
) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], SyntheticTarget]:
    """One (xz, yz, xy) projection tuple sliced at the planted target,
    exactly as the capture loop slices real scans
    (reference ground_truth_samples.py:413-419)."""
    cube, t = synth_cube(rng, label, arena, hardness=hardness)
    yz = cube[t.i, :, :]
    xz = cube[:, t.j, :]
    xy = cube[:, :, t.k]
    return (xz, yz, xy), t


def make_dataset(
    n_samples: int,
    classes: Sequence[str] = DEFAULT_CLASSES,
    arena: Arena = DEFAULT_ARENA,
    seed: int = 1234,
    class_fractions: Optional[Sequence[float]] = None,
    hardness: float = 0.0,
    label_noise: Optional[float] = None,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray, np.ndarray]], List[str]]:
    """Build a dataset in the reference pickle layout (samples, labels).

    `label_noise` (default 0.05·hardness) flips that fraction of labels
    to a uniformly-drawn other class — the camera-labeled ground truth
    of the reference capture loop mislabels in exactly this way when
    the wrong detection wins the association gate.
    """
    rng = np.random.default_rng(seed)
    if class_fractions is None:
        class_fractions = [1.0 / len(classes)] * len(classes)
    if label_noise is None:
        label_noise = 0.05 * hardness
    labels: List[str] = []
    samples = []
    for i in range(n_samples):
        label = rng.choice(np.asarray(classes), p=np.asarray(class_fractions))
        sample, _ = synth_sample(rng, str(label), arena, hardness=hardness)
        if label_noise > 0.0 and rng.random() < label_noise:
            others = [c for c in classes if c != str(label)]
            label = others[int(rng.integers(0, len(others)))]
        samples.append(sample)
        labels.append(str(label))
    return samples, labels


def make_scan_batch(
    n_scans: int,
    classes: Sequence[str] = DEFAULT_CLASSES,
    arena: Arena = DEFAULT_ARENA,
    seed: int = 1234,
    hardness: float = 0.0,
) -> Tuple[np.ndarray, List[SyntheticTarget]]:
    """Batch of raw cubes + ground-truth targets for the predict path."""
    rng = np.random.default_rng(seed)
    cubes = np.empty((n_scans,) + arena.grid_shape, dtype=np.float32)
    targets = []
    for s in range(n_scans):
        label = str(rng.choice(np.asarray(classes)))
        cubes[s], t = synth_cube(rng, label, arena, hardness=hardness)
        targets.append(t)
    return cubes, targets


def make_grid_probe(
    n_nodes: int = 20000, arena: Arena = DEFAULT_ARENA, seed: int = 88,
    jitter_cm: float = 1.0,
) -> np.ndarray:
    """(2 n_nodes, 3) float32 target positions in cm: random grid nodes
    (every index on a cell boundary before the 1e-3 nudge) followed by
    the same nodes moved by N(0, jitter_cm) on each axis. A fixture for
    comparing cube indices between devices; the defaults are the 40,000
    targets that chip_smoke.py and tests/test_torch_arena_card.py use
    (seed 88: two of their jittered points lie within float32 rounding
    of a cell boundary, where an H100 truncates to the other cell)."""
    rng = np.random.default_rng(seed)
    cells = np.stack([rng.integers(0, s, n_nodes) for s in arena.grid_shape])
    nodes = np.stack(arena.grid_to_cartesian_np(*cells.astype(np.float64)), -1)
    moved = nodes + rng.normal(scale=jitter_cm, size=nodes.shape)
    return np.concatenate([nodes, moved]).astype(np.float32)
