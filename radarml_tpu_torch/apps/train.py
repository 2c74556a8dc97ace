"""CLI: train the classical SVM families (SGD / SVC).

Port of radarml_tpu/apps/train.py, the reference's train.py entry point
(train.py:547-737), with the same flags and flow: load and concatenate
dataset pickles, filter the desired classes, scale to [0, 1], encode the
labels, split 0.8/0.1/0.1 (seeded 1234), fit by grid search (SGD by
default, --use_svc for the kernel family), optional augmentation epochs
with partial fits (SGD) or pre-augmentation (SVC), calibrate on the
validation split, evaluate on the test split (accuracy, confusion-matrix
PNG, report), and write the model and label encoder as `radarml_tpu.v1`
artifacts, which this package's predict and serve apps and the JAX
package's `load_model` both read.

The features are made and the models fitted on the card (`--platform
cpu` for the CPU; without a card the default raises). The SVC refit's
RBF Gram and the test-split decisions run the hand-written kernel
(ops/rbf.py). Where matplotlib is missing, one log line names it and the
run writes no confusion-matrix figure.

Both families featurize planes that are already scaled to [0, 1] (the
division by RADAR_MAX below happens before the split), which is the
scale the predictor serves at.

    python -m radarml_tpu_torch.apps.train --synthetic 2280 --datasets ds.pickle
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import logging
import os
import pickle
import time

import numpy as np
import torch

from radarml_tpu_torch.apps.common_cli import (
    add_common_flags,
    device_of,
    load_model,
    load_model_meta,
    parse_proj_mask,
    save_label_encoder,
    save_model,
    setup_logging,
    warm_transfers,
)
from radarml_tpu_torch.core.arena import RADAR_MAX
from radarml_tpu_torch.data.balance import balance_classes
from radarml_tpu_torch.data.labels import LabelEncoder, filter_samples
from radarml_tpu_torch.data.split import train_val_test_split
from radarml_tpu_torch.data.store import load_datasets, save_dataset, stack_samples
from radarml_tpu_torch.models import linear
from radarml_tpu_torch.models import svc as tsvc
from radarml_tpu_torch.ops.augment import augment_samples
from radarml_tpu_torch.ops.features import process_samples, process_views
from radarml_tpu_torch.train.gridsearch import grid_search_sgd, grid_search_svc
from radarml_tpu_torch.train.metrics import evaluate_model

logger = logging.getLogger(__name__)

RANDOM_SEED = 1234


def dump_augmented(dir_: str, epoch: int, views, y, batch_size: int = 32):
    """Write augmented batches as reference-format pickles.

    The reference's DataGenerator.flow(save_to_dir=..., save_prefix=...)
    writes {'x_batch': ..., 'y_batch': ...} pickles named
    batch_{batch}_{pos}.pickle, one per batch-size chunk
    (train.py:58-67, 209-212). Same schema here: x_batch is a list of
    (xz, yz, xy) numpy projection tuples in [0, 1], y_batch the label
    array (the augmented data, as in the JAX package).
    """
    os.makedirs(dir_, exist_ok=True)
    xz, yz, xy = (
        v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for v in views
    )
    y = np.asarray(y)
    for pos in range(0, len(y), batch_size):
        end = min(pos + batch_size, len(y))
        x_batch = [(xz[i], yz[i], xy[i]) for i in range(pos, end)]
        with open(
            os.path.join(dir_, f"batch_{epoch}_{pos}.pickle"), "wb"
        ) as fp:
            pickle.dump({"x_batch": x_batch, "y_batch": y[pos:end]}, fp)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=0,
                   help="number of augmentation epochs")
    p.add_argument("--save_augmented", type=str, default="",
                   help="directory to dump augmented batches as "
                        "reference-format batch_{epoch}_{pos}.pickle "
                        "files for inspection (train.py:58-67,209-212)")
    p.add_argument("--datasets", nargs="+", type=str,
                   default=["datasets/radar_samples.pickle"],
                   help="paths to training datasets")
    p.add_argument("--desired_labels", nargs="+", type=str,
                   default=["person", "dog", "cat"],
                   help="labels to use for training")
    p.add_argument("--proj_mask", nargs="+", default=[True, True, True],
                   help="projection mask (xz, yz, xy)")
    p.add_argument("--svm_cm", type=str,
                   default="train-results/svm_cm.png",
                   help="path of output confusion matrix png")
    p.add_argument("--svm_model", type=str,
                   default="train-results/svm_radar_classifier.pickle",
                   help="path of output svm model")
    p.add_argument("--label_encoder", type=str,
                   default="train-results/radar_labels.pickle",
                   help="path of output label encoder")
    p.add_argument("--online_learn", action="store_true",
                   help="use dataset(s) for online learning "
                        "(ignored if --use_svc)")
    p.add_argument("--use_svc", action="store_true",
                   help="use the kernel SVC family instead of SGD")
    p.add_argument("--train_val_test_frac", nargs="+", type=float,
                   default=[0.8, 0.1, 0.1])
    p.add_argument("--log_file", type=str, default="train-results/train.log")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic samples if dataset missing")
    p.add_argument("--grid_epochs", type=int, default=None,
                   help="SGD epochs per grid candidate (default: sklearn "
                        "heuristic)")
    p.add_argument("--folds", type=int, default=5)
    add_common_flags(p)
    return p


def _load_or_synthesize(args):
    missing = [d for d in args.datasets if not os.path.exists(d)]
    if missing and args.synthetic:
        from radarml_tpu_torch.data.synthetic import make_dataset

        logger.info("Synthesizing %d samples → %s", args.synthetic, missing[0])
        samples, labels = make_dataset(
            args.synthetic, classes=tuple(args.desired_labels), seed=RANDOM_SEED
        )
        save_dataset(missing[0], samples, labels, append=False)
    try:
        return load_datasets(args.datasets)
    except FileNotFoundError as e:
        logger.error("Dataset not found: %s", e)
        raise SystemExit(1)


def _cm_path(path: str):
    """The confusion-matrix path, or None where matplotlib is missing."""
    if importlib.util.find_spec("matplotlib") is None:
        logger.warning("matplotlib is not installed: no confusion-matrix figure")
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_file, args.logging_level)
    device = device_of(args)
    warm_transfers(device)

    data = _load_or_synthesize(args)
    samples, labels = filter_samples(
        data["samples"], data["labels"], args.desired_labels
    )
    logger.info("Scaling samples.")
    samples = [tuple(np.asarray(p) / RADAR_MAX for p in s) for s in samples]

    logger.info("Encoding labels.")
    le, encoded = LabelEncoder.fit_transform(labels)
    class_names = list(le.classes_)
    logger.info(
        "Found %d classes and %d samples:", len(class_names), len(labels)
    )
    for i, c in enumerate(class_names):
        logger.info(
            '...class: %d "%s" count: %d', i, c, int((encoded == i).sum())
        )

    (X_train, y_train), (X_val, y_val), (X_test, y_test) = train_val_test_split(
        samples, encoded, args.train_val_test_frac, seed=RANDOM_SEED
    )
    logger.info("...training samples: %d", len(X_train))
    logger.info("...validation samples: %d", len(X_val))
    logger.info("...test samples: %d", len(X_test))

    proj_mask = parse_proj_mask(args.proj_mask)
    logger.info("Projection mask: %s", (proj_mask,))

    t0 = time.perf_counter()
    if not args.use_svc:
        result = _fit_sgd(args, device, proj_mask, X_train, y_train, X_test, y_test)
    else:
        result = _fit_svc(args, device, proj_mask, X_train, y_train)
    logger.info("Fit completed in %.1fs", time.perf_counter() - t0)

    X_val_fv = (
        process_samples(X_val, proj_mask=proj_mask, device=device)
        if len(X_val) else None
    )
    X_test_fv = process_samples(X_test, proj_mask=proj_mask, device=device)

    if result["kind"] == "linear":
        model = result["model"]
        calib = None
        if X_val_fv is not None and len(np.unique(y_val)) > 1:
            logger.info("Calibrating classifier.")
            calib = linear.calibrate_ovr(model, X_val_fv, y_val)
        if calib is not None:
            proba = linear.predict_proba_calibrated(model, calib, X_test_fv)
        else:
            proba = linear.predict_proba_log_loss(model, X_test_fv)
        y_pred = proba.cpu().numpy().argmax(1)
        sgd_cfg = result.get("cfg")
        sgd_state = result.get("state")
        save_model(
            args.svm_model, "linear",
            coef=model.coef.cpu().numpy(), intercept=model.intercept.cpu().numpy(),
            calib_a=None if calib is None else calib.a.cpu().numpy(),
            calib_b=None if calib is None else calib.b.cpu().numpy(),
            classes=class_names,
            # Hyperparameters + schedule position so --online_learn can
            # continue this exact estimator (the reference keeps them
            # inside the sklearn pickle, train.py:409-416).
            sgd_cfg=None if sgd_cfg is None else dataclasses.asdict(sgd_cfg),
            sgd_t=None if sgd_state is None else float(sgd_state.t),
        )
    else:
        model = result["model"]
        y_pred = tsvc.predict(model, X_test_fv).cpu().numpy()
        save_model(
            args.svm_model, "svc",
            support_vectors=model.support_vectors.cpu().numpy(),
            dual_coef=model.dual_coef.cpu().numpy(),
            intercept=model.intercept.cpu().numpy(),
            n_support=list(model.n_support),
            kernel=model.kernel, gamma=model.gamma,
            probA=None if model.probA is None else model.probA.cpu().numpy(),
            probB=None if model.probB is None else model.probB.cpu().numpy(),
            classes=class_names,
        )

    logger.info("Evaluating final classifier on test set.")
    metrics = evaluate_model(
        lambda _: y_pred, None, y_test, class_names, cm_path=_cm_path(args.svm_cm)
    )
    logger.info("Saving svm model to: %s.", args.svm_model)

    # Do not overwrite the label encoder after online learning
    # (reference train.py:733-737).
    if not args.online_learn or args.use_svc:
        logger.info("Saving label encoder to: %s.", args.label_encoder)
        save_label_encoder(args.label_encoder, le)
    return {"metrics": metrics, "classes": class_names, "y_test": y_test,
            "y_pred": y_pred, **result}


def _fit_sgd(args, device, proj_mask, X_train, y_train, X_test, y_test) -> dict:
    """Reference sgd_fit flow (train.py:324-440)."""
    logger.info("Using SVM algo: SGD (OvA log-loss).")
    logger.info("Generating feature vectors.")
    F_train = process_samples(X_train, proj_mask=proj_mask, device=device)
    F_test = process_samples(X_test, proj_mask=proj_mask, device=device)
    logger.info("Feature vector length: %d", F_train.shape[1])

    logger.info("Balancing classes.")
    y_bal, F_bal = balance_classes(np.asarray(y_train), F_train)
    n_classes = len(np.unique(y_bal))

    grid = None
    if not args.online_learn:
        logger.info("Running best fit with new data.")
        grid = grid_search_sgd(
            F_bal, y_bal, folds=args.folds, epochs=args.grid_epochs,
            seed=RANDOM_SEED,
        )
        grid.log_summary(args.folds)
        model, cfg = grid.best_model
        state = grid.best_state
    else:
        logger.info("Running partial fit with new data.")
        prev_model, _ = load_model(args.svm_model, device=device)
        # Resume the artifact's hyperparameters and eta-schedule position
        # — the reference partial_fits the unpickled estimator itself,
        # retaining its alpha/penalty/average/t_ (train.py:409-416).
        # Artifacts without the metadata fall back to the defaults.
        meta = load_model_meta(args.svm_model)
        cfg = (
            linear.SGDConfig(**meta["sgd_cfg"]) if meta.get("sgd_cfg")
            else linear.SGDConfig()
        )
        state = linear.sgd_init(n_classes, F_bal.shape[1], cfg, device=device)
        state = state._replace(coef=prev_model.coef, intercept=prev_model.intercept)
        if meta.get("sgd_t") is not None:
            state = state._replace(
                t=torch.tensor(meta["sgd_t"], dtype=torch.float32, device=device))
        state = linear.sgd_fit(
            F_bal, y_bal, n_classes, cfg, state=state, seed=RANDOM_SEED,
            epochs=args.grid_epochs,
        )
        model = linear.sgd_model(state, cfg)

    if args.epochs:
        logger.info(
            "Running partial fit with augmented data (epochs: %d).",
            args.epochs,
        )
        xz, yz, xy = stack_samples(X_train)
        gen = torch.Generator(device=device)
        gen.manual_seed(RANDOM_SEED)
        # Continue with the winner's hyperparameters and schedule state —
        # the reference partial_fits the best estimator itself
        # (train.py:419-438), not a fresh default one.
        for e in range(args.epochs):
            # augment → rescale → featurize → balance-gather → fit, all on
            # the device
            (axz, ayz, axy), ay = augment_samples(
                (xz, yz, xy), np.asarray(y_train), gen,
                rotation_range=5.0, zoom_range=0.2, noise_sd=0.1,
                balance=True, device=device,
            )
            if args.save_augmented:
                dump_augmented(args.save_augmented, e, (axz, ayz, axy), ay)
            F_aug = process_views(
                axz * RADAR_MAX, ayz * RADAR_MAX, axy * RADAR_MAX,
                proj_mask=proj_mask, scale=True, device=device,
            )
            yb, Fb = balance_classes(ay, F_aug)
            state = linear.sgd_fit(Fb, yb, n_classes, cfg, state=state, epochs=1)
            model = linear.sgd_model(state, cfg)
            acc = float(
                (linear.predict(model, F_test).cpu().numpy() == y_test).mean()
            )
            logger.debug("Augment epoch %d accuracy: %.4f", e, acc)

    return {"kind": "linear", "model": model, "cfg": cfg, "state": state,
            "grid": grid}


def _fit_svc(args, device, proj_mask, X_train, y_train) -> dict:
    """Reference svc_fit flow (train.py:442-545): augment first, then
    features, balance and the kernel grid search."""
    logger.info("Using SVM algo: SVC (SMO dual solver).")
    X_train = list(X_train)
    y_train = np.asarray(y_train)
    if args.epochs:
        logger.info("Augmenting data set.")
        logger.info("Original number of training samples: %d", len(y_train))
        xz, yz, xy = stack_samples(X_train)
        gen = torch.Generator(device=device)
        gen.manual_seed(RANDOM_SEED)
        # the original and augmented view stacks gather on the device and
        # featurize in one call
        stacks = [tuple(torch.as_tensor(v, device=device) for v in (xz, yz, xy))]
        ys = [y_train]
        for e in range(args.epochs):
            aug_views, ay = augment_samples(
                (xz, yz, xy), y_train, gen,
                rotation_range=15.0, zoom_range=0.3, noise_sd=0.2,
                device=device,
            )
            if args.save_augmented:
                dump_augmented(args.save_augmented, e, aug_views, ay)
            stacks.append(aug_views)
            ys.append(ay)
        y_train = np.concatenate(ys)
        logger.info("Augmented number of training samples: %d", len(y_train))

        logger.info("Generating feature vectors from radar projections.")
        F = process_views(
            *[torch.cat([s[i] for s in stacks]) for i in range(3)],
            proj_mask=proj_mask, device=device,
        )
    else:
        logger.info("Generating feature vectors from radar projections.")
        F = process_samples(X_train, proj_mask=proj_mask, device=device)
    logger.info("Feature vector length: %d", F.shape[1])
    logger.info("Balancing classes.")
    y_bal, F_bal = balance_classes(y_train, F)
    logger.info("Finding best classifier.")
    grid = grid_search_svc(F_bal, y_bal, folds=args.folds, probability=True)
    grid.log_summary(args.folds)
    return {"kind": "svc", "model": grid.best_model, "params": grid.best_params,
            "grid": grid}


if __name__ == "__main__":
    main()
