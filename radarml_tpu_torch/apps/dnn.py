"""CLI: train the multi-view CNN ("DNN") classifier.

Port of radarml_tpu/apps/dnn.py, the reference's dnn.py entry point
(dnn.py:393-476): load + filter datasets, scale to [-1, 1], optional
augmentation, bicubic resize to 80×80, stack to (N, 80, 80, 3), split,
and train with Adam (2e-4, β1 0.5), class weights, early stopping and
best-checkpoint retention, on the card (`--platform cpu` for the CPU).
Saves the best parameters + label classes to
<results_dir>/c_model.pickle (kind `cnn`, the JAX package's flax tree
layout, so either package serves it), the architecture summary to
c_model_summary.txt and the log to train.log. The PNG summary is drawn
where matplotlib imports.

`--synthetic N` generates data when no dataset is given. `--mesh`
(data-parallel training) is not ported yet.

    python -m radarml_tpu_torch.apps.dnn --datasets ds.pickle
"""

from __future__ import annotations

import argparse
import logging
import os
import time

from radarml_tpu_torch.apps.common_cli import (
    add_common_flags,
    device_of,
    save_model,
    setup_logging,
    warm_transfers,
)
from radarml_tpu_torch.data.labels import filter_samples
from radarml_tpu_torch.data.preprocess import preprocess_multiview
from radarml_tpu_torch.data.store import load_datasets
from radarml_tpu_torch.models.cnn import RESCALE, cnn_params_to_numpy, init_cnn
from radarml_tpu_torch.train.trainer import TrainConfig, train_cnn
from radarml_tpu_torch.utils.summary import plot_model_pngs, write_model_summary

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets", nargs="+", type=str, default=[])
    p.add_argument("--desired_labels", nargs="+", type=str,
                   default=["person", "dog", "cat", "pet"])
    p.add_argument("--train_split", type=float, default=0.8)
    p.add_argument("--results_dir", type=str, default="train-results/dnn")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0,
                   help="shard training over an N-device mesh (not ported yet)")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="write checkpoints every --checkpoint_every epochs "
                        "during training (the reference's ModelCheckpoint "
                        "durability, dnn.py:365-370)")
    p.add_argument("--checkpoint_every", type=int, default=10,
                   help="epochs between checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in "
                        "--checkpoint_dir; reproduces the uninterrupted run")
    add_common_flags(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh (sharded CNN training) is not ported yet "
                                  "(ROADMAP A15)")
    os.makedirs(args.results_dir, exist_ok=True)
    setup_logging(os.path.join(args.results_dir, "train.log"), args.logging_level)
    device = device_of(args)
    warm_transfers(device)

    if not args.datasets and args.synthetic:
        from radarml_tpu_torch.data.synthetic import make_dataset

        samples, labels = make_dataset(args.synthetic, seed=1234)
    else:
        data = load_datasets(args.datasets)
        samples, labels = data["samples"], data["labels"]
    samples, labels = filter_samples(samples, labels, args.desired_labels)
    logger.info("Dataset: %d samples", len(labels))

    augment_fn = None
    if args.augment:
        from radarml_tpu_torch.ops.augment import augment_multiview as augment_fn

    pre = preprocess_multiview(
        samples, labels, rescale=RESCALE, train_split=args.train_split,
        augment_fn=augment_fn, device=device,
    )
    n_classes = pre["n_classes"]
    logger.info("Class weights: %s", pre["w_classes"])

    model = init_cnn(n_classes, RESCALE, seed=1234, device=device)
    # Architecture summary next to the checkpoint (the reference dumps
    # plot_model PNGs here, dnn.py:426-427).
    title = f"MultiViewCNN n_classes={n_classes} rescale={RESCALE}"
    tree = cnn_params_to_numpy(model)
    write_model_summary(os.path.join(args.results_dir, "c_model_summary.txt"), tree,
                        title=title)
    plot_model_pngs([(os.path.join(args.results_dir, "dnn_model.png"), tree, title)])

    cfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs)
    t0 = time.perf_counter()
    best, history = train_cnn(
        model, pre["X_train"], pre["y_train"], pre["X_val"], pre["y_val"],
        w_classes=pre["w_classes"], config=cfg,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
    )
    seconds = time.perf_counter() - t0

    out_path = os.path.join(args.results_dir, "c_model.pickle")
    classes = list(pre["label_encoder"].classes_)
    save_model(out_path, "cnn", params=cnn_params_to_numpy(best), classes=classes,
               rescale=RESCALE, history=history)
    logger.info("Saved classifier to %s", out_path)
    return {"history": history, "model_path": out_path, "model": model,
            "classes": classes, "train_seconds": seconds}


if __name__ == "__main__":
    main()
