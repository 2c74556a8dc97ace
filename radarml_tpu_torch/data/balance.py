"""Class balancing by upsample-with-replacement.

Port of radarml_tpu/data/balance.py, the reference's `balance_classes`
(train.py:230-274 and the mask-carrying SGAN variant sgan.py:329-393):
classes ordered most-common-first, each resampled with replacement up
to the majority count with a fixed seed, then stacked back together.
The draws are `np.random.RandomState(seed).randint`, bit-compatible with
the reference's sklearn.utils.resample(random_state=seed) calls and
with the JAX package, so balanced datasets reproduce exactly.

A tensor `data` (a feature matrix on the card) is gathered on its own
device with `index_select`: the pick indices come from the small label
vector on the host, so balancing never copies the features back.
"""

from __future__ import annotations

import collections
import logging
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["RANDOM_SEED", "balance_classes"]

logger = logging.getLogger(__name__)

RANDOM_SEED = 1234  # reference train.py:32


def _resample_indices(n: int, n_out: int, seed: int) -> np.ndarray:
    """Replacement-sampling indices matching sklearn.utils.resample."""
    return np.random.RandomState(seed).randint(0, n, size=n_out)


def balance_classes(
    labels: np.ndarray,
    data,
    sup_mask: Optional[np.ndarray] = None,
    shuffle: bool = False,
    seed: int = RANDOM_SEED,
    shuffle_rng: Optional[np.random.Generator] = None,
) -> Tuple:
    """Upsample every class to the majority count.

    Args:
        labels: (N,) integer class labels.
        data: (N, ...) numpy array or tensor aligned with labels.
        sup_mask: optional (N,) bool supervised mask carried through the
            identical resampling (the SGAN variant).
        shuffle: shuffle the balanced set afterwards (SGAN variant).
        seed: resampling seed (per-class resamples share it, as the
            reference does).
        shuffle_rng: generator for the optional shuffle.

    Returns:
        (labels, data) — or, with sup_mask, (data, labels, sup_mask) in
        the reference SGAN variant's order (sgan.py:336-337). A tensor
        `data` comes back as a tensor on its device.
    """
    labels = np.asarray(labels)
    on_device = isinstance(data, torch.Tensor)
    if not on_device:
        data = np.asarray(data)
    mc = collections.Counter(labels.tolist()).most_common()

    if len(set(c for _, c in mc)) == 1:
        # Reference early-return: unchanged, unshuffled; note the SGAN
        # variant's (data, labels, sup) order (sgan.py:336-337).
        if sup_mask is not None:
            return data, labels, np.asarray(sup_mask)
        return labels, data

    majority = mc[0][1]
    out_labels, picks, out_sup = [], [], []
    for cls, _count in mc:
        idx = np.nonzero(labels == cls)[0]
        pick = idx[_resample_indices(len(idx), majority, seed)]
        out_labels.append(labels[pick])
        picks.append(pick)
        if sup_mask is not None:
            out_sup.append(np.asarray(sup_mask)[pick])

    labels_b = np.concatenate(out_labels)
    pick_all = np.concatenate(picks)
    sup_b = np.concatenate(out_sup) if sup_mask is not None else None

    if shuffle:
        rng = shuffle_rng or np.random.default_rng(seed)
        perm = np.arange(labels_b.size)
        rng.shuffle(perm)
        labels_b, pick_all = labels_b[perm], pick_all[perm]
        if sup_b is not None:
            sup_b = sup_b[perm]

    if on_device:
        data_b = data.index_select(
            0, torch.as_tensor(pick_all, dtype=torch.int64, device=data.device)
        )
    else:
        data_b = data[pick_all]

    logger.debug(
        "balanced %d classes to %d samples each", len(mc), majority
    )
    if sup_mask is not None:
        return data_b, labels_b, sup_b  # SGAN argument order
    return labels_b, data_b
