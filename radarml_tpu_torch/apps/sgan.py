"""CLI: train the semi-supervised GAN.

Port of radarml_tpu/apps/sgan.py, the reference's sgan.py entry point
(sgan.py:769-850): load datasets (with --datasets_as_sup marking which
carry supervised labels), scale, optional augmentation, bicubic resize
to 128×128, mask-aware balancing, and the four-phase GAN schedule with
per-epoch evaluation + generated-dataset dumps into --results_dir, on
the card (`--platform cpu` for the CPU). Writes the supervised head as
<results_dir>/c_model.pickle (kind `sgan_classifier`: the
discriminator's flax params and batch stats, servable by either
package), g_model_summary.txt and d_model_summary.txt, and train.log;
the four PNG summaries where matplotlib imports.

`--synthetic N` generates data when no dataset is given; `--rescale S`
trains a reduced-resolution pyramid (S = 8·2^n) for fast smoke runs.

    python -m radarml_tpu_torch.apps.sgan --datasets ds.pickle
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
from radarml_tpu_torch.data.store import load_datasets_with_sup_mask
from radarml_tpu_torch.models.sgan import SGAN_RESCALE, sgan_params_to_numpy
from radarml_tpu_torch.train.sgan_trainer import (
    SGANConfig,
    classifier_eval,
    sgan_init,
    train_sgan,
)
from radarml_tpu_torch.utils.summary import plot_model_pngs, write_model_summary

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets", nargs="+", type=str, default=[])
    p.add_argument("--datasets_as_sup", nargs="+", type=str, default=[])
    p.add_argument("--desired_labels", nargs="+", type=str,
                   default=["person", "dog", "cat", "pet"])
    p.add_argument("--train_split", type=float, default=1.0)
    p.add_argument("--results_dir", type=str, default="train-results/sgan")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--sup_samples", type=int, default=150)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--rescale", type=int, default=SGAN_RESCALE[0],
                   help="square training resolution, 8·2^n")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="checkpoint directory (enables mid-run saves)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    add_common_flags(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    os.makedirs(args.results_dir, exist_ok=True)
    setup_logging(os.path.join(args.results_dir, "train.log"), args.logging_level)
    device = device_of(args)
    warm_transfers(device)

    if not args.datasets and args.synthetic:
        from radarml_tpu_torch.data.synthetic import make_dataset

        samples, labels = make_dataset(args.synthetic, seed=1234)
        sup = [True] * len(labels)
    else:
        samples, labels, sup = load_datasets_with_sup_mask(args.datasets,
                                                           args.datasets_as_sup)
    pairs, labels = filter_samples(list(zip(samples, sup)), labels, args.desired_labels)
    samples = [p[0] for p in pairs]
    sup = [p[1] for p in pairs]
    logger.info("Dataset: %d samples (%d supervised)", len(labels), sum(sup))

    augment_fn = None
    if args.augment:
        from radarml_tpu_torch.ops.augment import augment_multiview as augment_fn

    rescale = (args.rescale, args.rescale)
    pre = preprocess_multiview(
        samples, labels, rescale=rescale, train_split=args.train_split,
        sup_mask=sup, balance=True, augment_fn=augment_fn, device=device,
    )
    n_classes = pre["n_classes"]
    cfg = SGANConfig(n_classes=n_classes, n_epochs=args.epochs, n_batch=args.batch_size,
                     n_sup_samples=args.sup_samples)
    gen, disc, state = sgan_init(cfg, rescale, device=device)

    # Architecture summaries next to the checkpoints (the reference dumps
    # four plot_model PNGs here, sgan.py:750-765). The c head shares the
    # d head's weights; the gan composite is generator + discriminator.
    (g_params, _), (d_params, _) = sgan_params_to_numpy(gen), sgan_params_to_numpy(disc)
    g_title = f"SGAN generator rescale={rescale}"
    d_title = f"SGAN discriminator (c+d heads) n_classes={n_classes}"
    write_model_summary(os.path.join(args.results_dir, "g_model_summary.txt"), g_params,
                        title=g_title)
    write_model_summary(os.path.join(args.results_dir, "d_model_summary.txt"), d_params,
                        title=d_title)
    plot_model_pngs([
        (os.path.join(args.results_dir, "sgan_g_model.png"), g_params, g_title),
        (os.path.join(args.results_dir, "sgan_d_model.png"), d_params,
         f"SGAN discriminator (d head) n_classes={n_classes}"),
        (os.path.join(args.results_dir, "sgan_c_model.png"), d_params,
         "SGAN classifier (c head, weights shared with d)"),
        (os.path.join(args.results_dir, "sgan_gan_model.png"),
         {"generator": g_params, "discriminator": d_params},
         "SGAN composite (g → d, BN-only trainable in d)"),
    ])

    t0 = time.perf_counter()
    state = train_sgan(
        gen, disc, state,
        (pre["X_train"], pre["y_train"], pre.get("sup_train")),
        (pre["X_val"], pre["y_val"]),
        cfg, w_classes=pre["w_classes"], results_dir=args.results_dir,
        checkpoint_dir=args.checkpoint_dir or None, resume=args.resume,
    )
    seconds = time.perf_counter() - t0
    val_acc = classifier_eval(disc, state, pre["X_val"], pre["y_val"])

    # The supervised head as a serving artifact (the reference's
    # c_model_%04d.h5 analog, sgan.py:497-500, made directly servable).
    classes = list(pre["label_encoder"].classes_)
    c_path = os.path.join(args.results_dir, "c_model.pickle")
    d_params, d_stats = sgan_params_to_numpy(disc)
    save_model(c_path, "sgan_classifier", d_params=d_params, d_stats=d_stats,
               classes=classes, rescale=rescale)
    logger.info("Saved classifier to %s", c_path)
    steps = max(len(pre["y_train"]) // cfg.n_batch, 1) * cfg.n_epochs  # train_sgan's count
    return {"state": state, "classes": classes, "model_path": c_path,
            "train_seconds": seconds, "steps": steps, "val_accuracy": val_acc}


if __name__ == "__main__":
    main()
