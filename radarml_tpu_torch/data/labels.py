"""Label pipeline: encoding, class filtering, aliasing.

Copy of radarml_tpu/data/labels.py (it has no JAX in it); the port
keeps its own so that it never imports the JAX package.

Covers the reference's label handling (train.py:656-679, dnn.py:35-39
and 310-344, sgan.py:47-51 and 580-614): alias pet names to species,
filter to desired classes, and encode labels as sorted-unique integer
ids (the LabelEncoder contract, reimplemented standalone so trained
models don't drag an sklearn dependency into the serving path).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

# Some reference datasets used pet names instead of species
# (reference dnn.py:37, sgan.py:49).
CLASS_ALIAS: Dict[str, str] = {"polly": "dog", "rebel": "cat"}


@dataclasses.dataclass(frozen=True)
class LabelEncoder:
    """Sorted-unique string→int encoding, sklearn-contract compatible."""

    classes_: Tuple[str, ...]

    @staticmethod
    def fit(labels: Iterable[str]) -> "LabelEncoder":
        return LabelEncoder(classes_=tuple(sorted(set(labels))))

    def transform(self, labels: Iterable[str]) -> np.ndarray:
        index = {c: i for i, c in enumerate(self.classes_)}
        try:
            return np.array([index[l] for l in labels], dtype=np.int32)
        except KeyError as e:
            raise ValueError(f"unseen label {e}") from e

    def inverse_transform(self, encoded: Sequence[int]) -> List[str]:
        return [self.classes_[int(i)] for i in encoded]

    @staticmethod
    def fit_transform(labels: Sequence[str]) -> Tuple["LabelEncoder", np.ndarray]:
        le = LabelEncoder.fit(labels)
        return le, le.transform(labels)


def apply_aliases(
    labels: Sequence[str], alias: Mapping[str, str] = CLASS_ALIAS
) -> List[str]:
    """Rename aliased class labels (reference dnn.py:326-336)."""
    return [alias.get(l, l) for l in labels]


def filter_samples(
    samples: Sequence, labels: Sequence[str], desired_labels: Sequence[str],
    alias: Mapping[str, str] = CLASS_ALIAS,
) -> Tuple[list, List[str]]:
    """Alias then keep only samples whose label is desired
    (reference dnn.py:310-344)."""
    aliased = apply_aliases(labels, alias)
    keep = [l in desired_labels for l in aliased]
    filtered_samples = [s for s, k in zip(samples, keep) if k]
    filtered_labels = [l for l, k in zip(aliased, keep) if k]
    return filtered_samples, filtered_labels


def class_weights(encoded_labels: np.ndarray) -> Dict[int, float]:
    """max-count / count per class, rounded to 2 decimals
    (reference dnn.py:217-219)."""
    classes, counts = np.unique(encoded_labels, return_counts=True)
    max_v = float(counts.max())
    return {int(c): round(max_v / n, 2) for c, n in zip(classes, counts)}
