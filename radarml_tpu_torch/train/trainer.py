"""Adam training harness for the multi-view CNN.

Port of radarml_tpu/train/trainer.py, the reference's Keras fit loop
(dnn.py:347-391): Adam (lr 2e-4, β1 0.5), sparse categorical
cross-entropy with class weights (dnn.py:89-90, 379), early stopping on
val loss with patience 10, and best-checkpoint retention
(dnn.py:358-370).

Each epoch visits the batches of `np.random.default_rng(config.seed)`'s
permutations, drawn for all epochs up front exactly as the JAX package
draws them, so both packages visit the same batches. Dropout masks come
from a torch.Generator seeded from (seed, epoch), so a resumed run
replays the uninterrupted one. Data, parameters and the optimizer stay
on the model's device; the host reads the epoch's four metrics once per
epoch, which is when it decides on the best parameters and the stop.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from radarml_tpu_torch.models.cnn import dropout_masks

logger = logging.getLogger(__name__)

__all__ = ["TrainConfig", "weighted_xent_loss", "seeded_generator", "make_cnn_step",
           "train_cnn"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Defaults mirror the reference's dnn.py fit call."""

    batch_size: int = 64
    epochs: int = 100
    learning_rate: float = 2e-4
    beta1: float = 0.5
    patience: int = 10
    seed: int = 1234


def weighted_xent_loss(logits: torch.Tensor, y: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Per-sample class-weighted sparse categorical cross-entropy.

    Keras class_weight semantics: each sample's loss scales by its
    class's weight; the batch loss is the weighted mean.
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y[:, None])[:, 0]
    w = weights[y]
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1e-8)


def seeded_generator(device: torch.device, *entropy: int) -> torch.Generator:
    """A torch.Generator on `device` whose stream is a function of the
    non-negative integers `entropy` only (e.g. (seed, epoch))."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(e) for e in entropy]).generate_state(1)[0]))
    return g


def make_cnn_step(model, opt: torch.optim.Optimizer, weights: torch.Tensor):
    """One Adam step on a batch: step(xb, yb, masks) → (loss, accuracy),
    both 0-d tensors on the device (accuracy from the logits before the
    update, as the JAX step computes it)."""

    def step(xb, yb, masks):
        logits = model(xb, masks)
        loss = weighted_xent_loss(logits, yb, weights)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        acc = (logits.detach().argmax(-1) == yb).to(torch.float32).mean()
        return loss.detach(), acc

    return step


def _clone_state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_cnn(
    model,
    X_train,
    y_train: np.ndarray,
    X_val,
    y_val: np.ndarray,
    w_classes: Optional[Dict[int, float]] = None,
    config: TrainConfig = TrainConfig(),
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    resume: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[float]]]:
    """Train `model` (a MultiViewCNN, on its device) in place, keeping the
    best-val-loss parameters; the model ends holding them.

    With `checkpoint_dir`, a checkpoint (live and best parameters,
    optimizer state, epoch, early-stop state, history) is written every
    `checkpoint_every` epochs and at the end; `resume=True` continues from
    the latest one and reproduces the uninterrupted run.

    Returns:
        (best_state, history): the best state dict and per-epoch loss,
        accuracy, val_loss, val_accuracy (the Keras history contract the
        reference logs, dnn.py:382-389).
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded CNN training is not ported yet (ROADMAP A15)")
    dev = next(model.parameters()).device
    y_train = np.asarray(y_train)
    y_val = np.asarray(y_val)
    n_classes = int(max(y_train.max(), y_val.max() if y_val.size else 0)) + 1
    if w_classes is None:
        weights = np.ones(n_classes, dtype=np.float32)
    else:
        weights = np.array([w_classes.get(c, 1.0) for c in range(n_classes)],
                           dtype=np.float32)
    weights_d = torch.as_tensor(weights, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                           betas=(config.beta1, 0.999), eps=1e-8,
                           fused=dev.type == "cuda")
    step = make_cnn_step(model, opt, weights_d)

    n = len(y_train)
    # Datasets below the batch size train as one full batch; the ragged
    # tail batch of each epoch is dropped.
    bs = max(min(config.batch_size, n), 1)
    n_batches = max(n // bs, 1)
    n_used = n_batches * bs
    Xd = torch.as_tensor(X_train, dtype=torch.float32).to(dev)
    yd = torch.as_tensor(y_train, dtype=torch.int64).to(dev)
    Xv = torch.as_tensor(X_val, dtype=torch.float32).to(dev)
    yv = torch.as_tensor(y_val, dtype=torch.int64).to(dev)
    has_val = len(y_val) > 0
    E = config.epochs
    # patience <= 0 stops at the first epoch that does not improve.
    patience = max(int(config.patience), 1)
    rng = np.random.default_rng(config.seed)
    perms = np.stack([rng.permutation(n)[:n_used] for _ in range(E)]).reshape(
        E, n_batches, bs)

    epoch, best, best_val, stale = 0, _clone_state(model), float("inf"), 0
    hist = np.full((E, 4), np.nan, np.float32)
    store = None
    if checkpoint_dir is not None:
        from radarml_tpu_torch.train.checkpoint import CheckpointStore

        store = CheckpointStore(checkpoint_dir)
        if resume:
            try:
                _, ck, _ = store.restore()
            except FileNotFoundError:
                logger.info("no checkpoint in %s; starting fresh", checkpoint_dir)
            else:
                model.load_state_dict(ck["model"])
                opt.load_state_dict(ck["opt"])
                best = {k: v.to(dev) for k, v in ck["best"].items()}
                epoch, best_val, stale = int(ck["epoch"]), float(ck["best_val"]), int(ck["stale"])
                # The checkpointed run may have had another epoch budget.
                h = ck["hist"].numpy()
                hist[: min(E, h.shape[0])] = h[:E]
                logger.info("resumed CNN training at epoch %d from %s", epoch,
                            checkpoint_dir)

    def save():
        store.save(epoch, {"model": model.state_dict(), "opt": opt.state_dict(),
                           "best": best, "epoch": epoch, "best_val": best_val,
                           "stale": stale, "hist": torch.from_numpy(hist)},
                   meta={"epochs": E, "seed": config.seed, "batch_size": bs,
                         "patience": patience})

    start = epoch
    width = model.dense_width
    t0 = time.perf_counter()
    while epoch < E and stale < patience:
        gen = seeded_generator(dev, config.seed, epoch)
        batches = torch.as_tensor(perms[epoch], device=dev)
        losses = torch.empty(n_batches, device=dev)
        accs = torch.empty(n_batches, device=dev)
        for b in range(n_batches):
            idx = batches[b]
            masks = dropout_masks(2, (bs, width), model.dropout_rate, gen)
            losses[b], accs[b] = step(Xd.index_select(0, idx), yd.index_select(0, idx),
                                      masks)
        row = [losses.mean(), accs.mean()]
        if has_val:
            with torch.no_grad():
                logits = model(Xv)
            nll = -torch.log_softmax(logits, -1).gather(1, yv[:, None])[:, 0]
            row += [nll.mean(), (logits.argmax(-1) == yv).to(torch.float32).mean()]
        else:
            row += [torch.tensor(float("nan"), device=dev)] * 2
        hist[epoch] = torch.stack(row).cpu().numpy()  # the epoch's one host read
        metric = hist[epoch, 2] if has_val else hist[epoch, 0]
        if metric < best_val:
            best, best_val, stale = _clone_state(model), float(metric), 0
        else:
            stale += 1
        epoch += 1
        if store is not None and ((epoch - start) % max(int(checkpoint_every), 1) == 0
                                  or epoch == E or stale >= patience):
            save()
    wall = time.perf_counter() - t0
    model.load_state_dict(best)

    epochs_run = epoch
    history: Dict[str, List[float]] = {
        key: [float(v) for v in hist[:epochs_run, i]]
        for i, key in enumerate(("loss", "accuracy", "val_loss", "val_accuracy"))
    }
    for e in range(epochs_run):
        logger.info(
            "epoch %d: loss %.4f acc %.4f val_loss %.4f val_acc %.4f",
            e + 1, history["loss"][e], history["accuracy"][e],
            history["val_loss"][e], history["val_accuracy"][e],
        )
    if epochs_run < E:
        logger.info("early stopping at epoch %d", epochs_run)
    done = epochs_run - start
    logger.info("%d epochs in %.2fs (%.3fs/epoch, %d steps of %d)", done, wall,
                wall / max(done, 1), n_batches, bs)
    if epochs_run:
        best_idx = int(np.argmin(history["val_loss" if has_val else "loss"]))
        logger.info("Best loss: %.4f, Best acc: %.2f%%", history["loss"][best_idx],
                    history["accuracy"][best_idx] * 100)
        logger.info("Best val loss: %.4f, Best val acc: %.2f%%",
                    history["val_loss"][best_idx], history["val_accuracy"][best_idx] * 100)
    return best, history
