"""Multi-view preprocessing for the CNN / SGAN families.

Port of radarml_tpu/data/preprocess.py (the reference's `preprocess_data`,
dnn.py:185-277, and its 128×128 SGAN variant, sgan.py:617-727): scale
[0, RADAR_MAX] → [-1, 1], optionally augment, bicubic-resize every
projection to a common square (PIL-parity matrices, two float32 products
a view), stack to (N, H, W, 3) with channel order (xz, yz, xy), shuffle
with the seeded numpy generator, and split.

The shuffle, the split and the balancing draw from
`np.random.default_rng(seed)` exactly as the JAX package does, so both
packages put the same samples in the same places. An augmentation call
takes a `torch.Generator` seeded from one `rng.integers(2**31)` draw,
the draw the JAX apps' augment functions make for their PRNG key, so
the numpy stream stays in step with theirs.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from radarml_tpu_torch.core.arena import RADAR_MAX
from radarml_tpu_torch.core.device import resolve_device
from radarml_tpu_torch.data.balance import balance_classes
from radarml_tpu_torch.data.labels import LabelEncoder, class_weights
from radarml_tpu_torch.data.store import Sample, stack_samples
from radarml_tpu_torch.models.linear import full_f32
from radarml_tpu_torch.ops.resample import bicubic_pair

logger = logging.getLogger(__name__)

__all__ = [
    "RANDOM_SEED",
    "scale_to_unit_interval",
    "scale_to_symmetric",
    "unscale_from_symmetric",
    "resize_views",
    "preprocess_multiview",
]

RANDOM_SEED = 1234


def scale_to_unit_interval(planes):
    """[0, RADAR_MAX] → [0, 1] (the SVM-path convention, train.py:667)."""
    return planes / RADAR_MAX


def scale_to_symmetric(planes):
    """[0, RADAR_MAX] → [-1, 1] (the DNN/SGAN convention, dnn.py:202)."""
    half = RADAR_MAX / 2.0
    return (planes - half) / half


def unscale_from_symmetric(planes):
    """[-1, 1] → [0, RADAR_MAX] (sgan.py:464)."""
    return RADAR_MAX * (planes + 1.0) / 2.0


def resize_views(
    xz, yz, xy, rescale: Tuple[int, int],
    device: Union[torch.device, str, None] = None,
) -> torch.Tensor:
    """Bicubic-resize three (N, H, W) stacks (numpy or tensors) and stack
    them to an (N, h, w, 3) float32 tensor on `device` (default: the
    card). The products run in full float32, as the JAX package's run at
    Precision.HIGHEST."""
    dev = resolve_device(device)
    full_f32()

    def one(batch) -> torch.Tensor:
        r, c = bicubic_pair(tuple(batch.shape[1:]), rescale)
        b = torch.as_tensor(batch, dtype=torch.float32).to(dev)
        out = torch.einsum("oh,bhw->bow", torch.as_tensor(r, dtype=torch.float32, device=dev), b)
        return torch.einsum("bow,pw->bop", out,
                            torch.as_tensor(c, dtype=torch.float32, device=dev))

    return torch.stack([one(xz), one(yz), one(xy)], dim=-1)


def _augment_generator(rng: np.random.Generator, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(int(rng.integers(2**31)))
    return g


def preprocess_multiview(
    samples: Sequence[Sample],
    labels: Sequence[str],
    rescale: Tuple[int, int],
    train_split: float = 0.8,
    sup_mask: Optional[Sequence[bool]] = None,
    balance: bool = False,
    augment_fn=None,
    augment_mode: str = "replace",
    augment_copies: int = 1,
    seed: int = RANDOM_SEED,
    device: Union[bool, torch.device, str] = False,
):
    """Full multi-view preprocessing pipeline.

    Args:
        samples: reference-format [(xz, yz, xy), ...] in [0, RADAR_MAX].
        labels: string labels.
        rescale: target (H, W) — (80, 80) for the CNN, (128, 128) SGAN.
        train_split: leading fraction for training after shuffle.
        sup_mask: optional per-sample supervised flags (SGAN).
        balance: balance the training set by upsampling (SGAN path).
        augment_fn: optional callable (views, generator) → views applied
            after scaling, before resize; `views` is the (xz, yz, xy)
            triple of (N, H, W) stacks and `generator` a torch.Generator
            on the compute device (ops/augment.augment_multiview fits).
        augment_mode: "replace" augments every sample (validation data
            included) in place before the split, as the reference does
            (dnn.py:207-209); "train_concat" keeps validation clean and
            appends `augment_copies` augmented copies of the training
            samples to the clean training set.
        augment_copies: number of augmented copies in "train_concat".
        device: False returns numpy arrays (computed on the CPU); True
            keeps the view stacks as tensors resident on the card; a
            device (e.g. "cpu") keeps them as tensors there.

    Returns:
        dict with X_train, y_train, X_val, y_val, n_classes, w_classes,
        label_encoder, and (when sup_mask given) sup_train.
    """
    if augment_mode not in ("replace", "train_concat"):
        raise ValueError(f"unknown augment_mode: {augment_mode!r}")
    if augment_copies < 0:
        raise ValueError(f"augment_copies must be >= 0, got {augment_copies}")
    on_device = device is not False
    dev = resolve_device(None if device is True else device) if on_device \
        else torch.device("cpu")

    xz, yz, xy = stack_samples(samples)
    xz, yz, xy = map(scale_to_symmetric, (xz, yz, xy))

    rng = np.random.default_rng(seed)
    if augment_fn is not None and augment_mode == "replace":
        xz, yz, xy = augment_fn((xz, yz, xy), _augment_generator(rng, dev))

    le, encoded = LabelEncoder.fit_transform(list(labels))
    w_classes = class_weights(encoded)
    n_classes = len(le.classes_)
    logger.info("Found %d classes and %d samples", n_classes, len(labels))

    def resized(a, b, c):
        out = resize_views(a, b, c, rescale, device=dev)
        return out if on_device else out.numpy()

    views = resized(xz, yz, xy)
    idx = np.arange(views.shape[0])
    rng.shuffle(idx)
    if on_device:
        views = views.index_select(0, torch.as_tensor(idx, device=dev))
    else:
        views = views[idx]
    encoded = encoded[idx]
    sup = np.asarray(sup_mask, dtype=bool)[idx] if sup_mask is not None else None

    split = min(int(views.shape[0] * train_split), views.shape[0])
    X_train, y_train = views[:split], encoded[:split]
    X_val, y_val = views[split:], encoded[split:]

    if augment_fn is not None and augment_mode == "train_concat":
        # Augment only the training originals, at raw resolution, and
        # append the resized copies; validation data is never touched.
        tr_idx = idx[:split]
        xs, ys = [X_train], [y_train]
        for _ in range(augment_copies):
            a = augment_fn((xz[tr_idx], yz[tr_idx], xy[tr_idx]),
                           _augment_generator(rng, dev))
            xs.append(resized(*a))
            ys.append(y_train)
        if len(X_val) == 0:
            # The clean-train fallback (sgan.py:722-723), taken before the
            # growth so validation never sees augmented copies.
            X_val, y_val = X_train, y_train
        if sup is not None:
            # Augmented copies inherit their originals' supervised flags.
            sup = np.concatenate([sup[:split]] * len(ys) + [sup[split:]])
        X_train = torch.cat(xs) if on_device else np.concatenate(xs, axis=0)
        y_train = np.concatenate(ys, axis=0)
        split = int(y_train.shape[0])
    out = {
        "n_classes": n_classes,
        "w_classes": w_classes,
        "label_encoder": le,
    }

    if sup is not None:
        sup_train = sup[:split]
        if balance:
            X_train, y_train, sup_train = balance_classes(
                y_train, X_train, sup_mask=sup_train, shuffle=True,
                shuffle_rng=rng,
            )
        # An empty validation set falls back to the pre-balanced train
        # set (sgan.py:722-723).
        if len(X_val) == 0:
            X_val, y_val = views[:split], encoded[:split]
        out["sup_train"] = sup_train
    elif balance:
        y_train, X_train = balance_classes(y_train, X_train)

    out.update(X_train=X_train, y_train=y_train, X_val=X_val, y_val=y_val)
    return out
