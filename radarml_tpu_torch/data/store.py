"""Dataset store: the reference's pickle schema, kept wire-compatible.

Schema (reference datasets/README.md:8-20): a pickled dict
``{'samples': [(xz, yz, xy), ...], 'labels': [str, ...]}`` where each
projection is a 2-D numpy array in [0, RADAR_MAX]. Loading concatenates
multiple files (reference train.py:640-654); saving appends to an
existing file when present (reference ground_truth_samples.py:561-587).

Copy of radarml_tpu/data/store.py (it has no JAX in it); the port keeps
its own so that it never imports the JAX package. A file written by
either package loads in the other.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

Sample = Tuple[np.ndarray, np.ndarray, np.ndarray]


def load_datasets(paths: Iterable[str]) -> Dict[str, list]:
    """Load and concatenate one or more dataset pickles."""
    samples: List[Sample] = []
    labels: List[str] = []
    for path in paths:
        logger.info("Opening dataset: %s", path)
        with open(path, "rb") as fp:
            data = pickle.load(fp)
        logger.debug("Found class labels: %s.", set(data["labels"]))
        samples.extend(data["samples"])
        labels.extend(data["labels"])
    return {"samples": samples, "labels": labels}


def load_datasets_with_sup_mask(
    paths: Sequence[str], sup_paths: Sequence[str]
) -> Tuple[List[Sample], List[str], List[bool]]:
    """Load datasets plus the per-sample supervised mask.

    Mirrors the SGAN loader semantics (reference sgan.py:546-577): a
    sample is supervised if its file is listed in `sup_paths`, or if
    `sup_paths` is empty (everything supervised).
    """
    samples: List[Sample] = []
    labels: List[str] = []
    sup: List[bool] = []
    for path in paths:
        with open(path, "rb") as fp:
            data = pickle.load(fp)
        n = len(data["samples"])
        samples.extend(data["samples"])
        labels.extend(data["labels"])
        sup.extend([path in sup_paths or not sup_paths] * n)
    return samples, labels, sup


def save_dataset(
    path: str, samples: Sequence[Sample], labels: Sequence[str], append: bool = True
) -> None:
    """Save a dataset, appending to an existing file when present."""
    data = {"samples": list(samples), "labels": list(labels)}
    if append and os.path.exists(path):
        with open(path, "rb") as fp:
            existing = pickle.load(fp)
        logger.info(
            "Appending existing data file with %d samples (has %d).",
            len(labels),
            len(existing["labels"]),
        )
        existing["samples"].extend(data["samples"])
        existing["labels"] += data["labels"]
        data = existing
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fp:
        pickle.dump(data, fp)


def stack_samples(
    samples: Sequence[Sample],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """List-of-tuples → three (N, H, W) float32 stacks (xz, yz, xy)."""
    xz = np.stack([np.asarray(s[0], dtype=np.float32) for s in samples])
    yz = np.stack([np.asarray(s[1], dtype=np.float32) for s in samples])
    xy = np.stack([np.asarray(s[2], dtype=np.float32) for s in samples])
    return xz, yz, xy


def unstack_samples(xz: np.ndarray, yz: np.ndarray, xy: np.ndarray) -> List[Sample]:
    """Three stacks → the reference's list-of-tuples sample format."""
    return [(xz[i], yz[i], xy[i]) for i in range(xz.shape[0])]
