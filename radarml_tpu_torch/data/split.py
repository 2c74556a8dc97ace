"""Train/val/test splitting with the reference's exact RNG behavior.

Copy of radarml_tpu/data/split.py (it has no JAX in it); the port keeps
its own so that it never imports the JAX package.

Reference semantics (train.py:681-693): a seeded shuffled split takes
`val_frac + test_frac` off the top as a combined holdout, then carves
val/test from it in order. The permutation is
`np.random.RandomState(seed).permutation`, bit-compatible with
sklearn.model_selection.train_test_split(random_state=seed), so split
membership matches the reference runs and the JAX package's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["RANDOM_SEED", "train_test_split_indices", "train_val_test_split"]

RANDOM_SEED = 1234


def train_test_split_indices(
    n: int, test_frac: float, seed: int = RANDOM_SEED
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) with sklearn's shuffled-permutation layout."""
    n_test = int(np.ceil(n * test_frac))
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def train_val_test_split(
    samples,
    labels: np.ndarray,
    fractions: Sequence[float] = (0.8, 0.1, 0.1),
    seed: int = RANDOM_SEED,
):
    """Split into train/val/test per the reference's two-stage carve.

    Args:
        samples: indexable sample container (list or array).
        labels: (N,) label array.
        fractions: (train, val, test), summing to 1.0.

    Returns:
        ((X_train, y_train), (X_val, y_val), (X_test, y_test))
    """
    train_frac, val_frac, test_frac = fractions
    if abs(sum(fractions) - 1.0) > 1e-9:
        raise ValueError("fractions must sum to 1.0")
    n = len(labels)
    train_idx, holdout_idx = train_test_split_indices(
        n, val_frac + test_frac, seed
    )

    def take(container, idx):
        if isinstance(container, np.ndarray):
            return container[idx]
        return [container[i] for i in idx]

    val_split = int(len(holdout_idx) * val_frac / (val_frac + test_frac))
    val_idx = holdout_idx[:val_split]
    test_idx = holdout_idx[val_split:]
    return (
        (take(samples, train_idx), labels[train_idx]),
        (take(samples, val_idx), labels[val_idx]),
        (take(samples, test_idx), labels[test_idx]),
    )
